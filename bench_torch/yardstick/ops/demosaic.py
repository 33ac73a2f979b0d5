"""Bayer demosaic: the reference editor's nearest stencil, and the
accurate lane's bilinear, Malvar-He-Cutler and gradient-weighted
interpolators (the JAX package's XLA lane, operation for operation).

With the reference's y+1 CFA offset folded in, the effective storage
pattern at phase (0, 0) is RGGB, and each pixel takes (clamp-to-edge):

    y even, x even  (R):  r = v(x,y)    g = v(x+1,y)  b = v(x,y-1)
    y even, x odd   (G2): g = v(x,y)    r = v(x-1,y)  b = v(x,y-1)
    y odd,  x even  (G1): g = v(x,y)    b = v(x+1,y)  r = v(x,y+1)
    y odd,  x odd   (B):  b = v(x,y)    g = v(x-1,y)  r = v(x-1,y+1)

Other Bayer phases shift the parity labels; the data never moves.

``bilinear`` and ``malvar`` keep the JAX tap tables and their summation
order (``_conv_taps``); ``grad`` is ``ops/cfa_generic.py``'s
gradient-weighted interpolator on the 2x2 Bayer grid. The fused kernels
(``ops/fused_develop.py``) compute the same three in a factored form
that rounds differently by up to 1 ulp before quantisation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Bayer pattern string to (row, col) phase of the R site.
CFA_PHASES = {"RGGB": (0, 0), "GRBG": (0, 1), "GBRG": (1, 0),
              "BGGR": (1, 1)}


def phase_of(cfa_pattern: str):
    """(row, col) phase of a 2x2 Bayer pattern; raises for other CFAs."""
    try:
        return CFA_PHASES[cfa_pattern.upper()]
    except KeyError:
        raise ValueError(f"unsupported CFA pattern {cfa_pattern!r}")


def parity_masks(h: int, w: int, phase=(0, 0), device=None):
    """(H, 1) row-parity and (1, W) column-parity boolean masks."""
    py, px = phase
    ye = ((torch.arange(h, device=device)[:, None] + py) % 2) == 0
    xe = ((torch.arange(w, device=device)[None, :] + px) % 2) == 0
    return ye, xe


def combine(v, left, right, up, down, downleft, ye, xe):
    """The per-site channel selection table of the module docstring."""
    r = torch.where(ye, torch.where(xe, v, left),
                    torch.where(xe, down, downleft))
    g = torch.where(ye, torch.where(xe, right, v), torch.where(xe, v, left))
    b = torch.where(ye, up, torch.where(xe, right, v))
    return r, g, b


def _clamped(n: int, d: int, device):
    return torch.clamp(torch.arange(n, device=device) + d, 0, n - 1)


def demosaic_nearest(mosaic: torch.Tensor, phase=(0, 0)):
    """Full-resolution nearest demosaic of an (..., H, W) f32 mosaic;
    returns (r, g, b) planes of the same shape."""
    h, w = mosaic.shape[-2:]
    dev = mosaic.device
    y_up, y_dn = _clamped(h, -1, dev), _clamped(h, 1, dev)
    x_lt, x_rt = _clamped(w, -1, dev), _clamped(w, 1, dev)
    down = mosaic.index_select(-2, y_dn)
    ye, xe = parity_masks(h, w, phase, dev)
    return combine(mosaic,
                   mosaic.index_select(-1, x_lt),
                   mosaic.index_select(-1, x_rt),
                   mosaic.index_select(-2, y_up),
                   down,
                   down.index_select(-1, x_lt),
                   ye, xe)


def demosaic_nearest_sampled(mosaic: torch.Tensor, yi: torch.Tensor,
                             xi: torch.Tensor, phase=(0, 0)):
    """The nearest stencil evaluated only at the sampled full-res sites
    ``(yi[:, None], xi[None, :])``: the preview and histogram path.
    Returns (r, g, b) (Hp, Wp) planes."""
    h, w = mosaic.shape
    yc = torch.clamp(yi, 0, h - 1)
    xc = torch.clamp(xi, 0, w - 1)
    y_dn = torch.clamp(yi + 1, 0, h - 1)
    y_up = torch.clamp(yi - 1, 0, h - 1)
    x_rt = torch.clamp(xi + 1, 0, w - 1)
    x_lt = torch.clamp(xi - 1, 0, w - 1)

    rows_c = mosaic.index_select(0, yc)
    rows_dn = mosaic.index_select(0, y_dn)
    rows_up = mosaic.index_select(0, y_up)
    ye = ((yc[:, None] + phase[0]) % 2) == 0
    xe = ((xc[None, :] + phase[1]) % 2) == 0
    return combine(rows_c.index_select(1, xc),
                   rows_c.index_select(1, x_lt),
                   rows_c.index_select(1, x_rt),
                   rows_up.index_select(1, xc),
                   rows_dn.index_select(1, xc),
                   rows_dn.index_select(1, x_lt),
                   ye, xe)


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Clamp-to-edge pad of the last two dims (``jnp.pad(mode="edge")``)
    as an exact gather of clamped rows and columns."""
    h, w = x.shape[-2:]
    dev = x.device
    rows = torch.clamp(torch.arange(-top, h + bottom, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-left, w + right, device=dev), 0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def _shifted(padded, dy: int, dx: int, h: int, w: int, pad: int = 1):
    """View of the ``pad``-px edge-padded mosaic shifted by (dy, dx)."""
    return padded[..., pad + dy: pad + dy + h, pad + dx: pad + dx + w]


def _conv_taps(padded, taps, h, w, pad: int = 1):
    """Sum of weighted shifted views in the tap dict's order;
    taps = {(dy, dx): weight}."""
    acc = None
    for (dy, dx), wgt in taps.items():
        t = _shifted(padded, dy, dx, h, w, pad) * float(np.float32(wgt))
        acc = t if acc is None else acc + t
    return acc


@functools.lru_cache(maxsize=None)
def _bilinear_taps():
    hmean = {(0, -1): 0.5, (0, 1): 0.5}
    vmean = {(-1, 0): 0.5, (1, 0): 0.5}
    plus = {(0, -1): 0.25, (0, 1): 0.25, (-1, 0): 0.25, (1, 0): 0.25}
    diag = {(-1, -1): 0.25, (-1, 1): 0.25, (1, -1): 0.25, (1, 1): 0.25}
    return hmean, vmean, plus, diag


def demosaic_bilinear(mosaic: torch.Tensor, phase=(0, 0)):
    """Bilinear demosaic of an (..., H, W) f32 mosaic: each missing
    channel is the mean of its nearest same-channel neighbours."""
    h, w = mosaic.shape[-2:]
    p = edge_pad(mosaic, 1, 1, 1, 1)
    hmean, vmean, plus, diag = _bilinear_taps()
    v = mosaic
    hm = _conv_taps(p, hmean, h, w)
    vm = _conv_taps(p, vmean, h, w)
    pm = _conv_taps(p, plus, h, w)
    dm = _conv_taps(p, diag, h, w)
    ye, xe = parity_masks(h, w, phase, mosaic.device)
    r = torch.where(ye, torch.where(xe, v, hm), torch.where(xe, vm, dm))
    g = torch.where(ye == xe, pm, v)
    b = torch.where(ye, torch.where(xe, dm, vm), torch.where(xe, hm, v))
    return r, g, b


@functools.lru_cache(maxsize=None)
def _malvar_taps():
    """Malvar-He-Cutler (ICASSP 2004) 5x5 gradient-corrected kernels,
    /8-normalised: G at R/B, R/B at a G whose same-colour neighbours are
    horizontal, the 90-degree rotated case, and R at B / B at R."""
    g_cross = {(0, 0): 0.5, (-1, 0): 0.25, (1, 0): 0.25, (0, -1): 0.25,
               (0, 1): 0.25, (-2, 0): -0.125, (2, 0): -0.125,
               (0, -2): -0.125, (0, 2): -0.125}
    rb_row = {(0, 0): 0.625, (0, -1): 0.5, (0, 1): 0.5,
              (0, -2): -0.125, (0, 2): -0.125,
              (-1, -1): -0.125, (-1, 1): -0.125,
              (1, -1): -0.125, (1, 1): -0.125,
              (-2, 0): 0.0625, (2, 0): 0.0625}
    rb_col = {(dx, dy): w for (dy, dx), w in rb_row.items()}
    rb_diag = {(0, 0): 0.75, (-1, -1): 0.25, (-1, 1): 0.25,
               (1, -1): 0.25, (1, 1): 0.25,
               (-2, 0): -0.1875, (2, 0): -0.1875,
               (0, -2): -0.1875, (0, 2): -0.1875}
    return g_cross, rb_row, rb_col, rb_diag


def demosaic_malvar(mosaic: torch.Tensor, phase=(0, 0)):
    """Malvar-He-Cutler gradient-corrected demosaic of an (..., H, W)
    f32 mosaic, floored at 0 (the correction can undershoot on hard
    edges)."""
    h, w = mosaic.shape[-2:]
    p = edge_pad(mosaic, 2, 2, 2, 2)
    g_cross, rb_row, rb_col, rb_diag = _malvar_taps()
    v = mosaic
    gc = _conv_taps(p, g_cross, h, w, pad=2)
    kr = _conv_taps(p, rb_row, h, w, pad=2)
    kc = _conv_taps(p, rb_col, h, w, pad=2)
    kd = _conv_taps(p, rb_diag, h, w, pad=2)
    ye, xe = parity_masks(h, w, phase, mosaic.device)
    r = torch.where(ye, torch.where(xe, v, kr), torch.where(xe, kc, kd))
    g = torch.where(ye == xe, gc, v)
    b = torch.where(ye, torch.where(xe, kd, kc), torch.where(xe, kr, v))
    return tuple(torch.clamp_min(c, 0.0) for c in (r, g, b))


DEMOSAIC_METHODS = ("nearest", "bilinear", "malvar", "grad")


def demosaic(mosaic: torch.Tensor, method: str = "nearest", phase=(0, 0)):
    """Dispatch by method over an (H, W) f32 mosaic; returns (r, g, b)."""
    if method == "nearest":
        return demosaic_nearest(mosaic, phase)
    if method == "bilinear":
        return demosaic_bilinear(mosaic, phase)
    if method == "malvar":
        return demosaic_malvar(mosaic, phase)
    if method == "grad":
        from bench_torch.yardstick.ops.cfa_generic import demosaic_grad_generic

        pattern = {v: k for k, v in CFA_PHASES.items()}[tuple(phase)]
        return demosaic_grad_generic(mosaic, pattern, 2, 2)
    raise ValueError(f"unknown demosaic method {method!r}")
