"""Nearest-neighbour Bayer demosaic, the reference editor's stencil.

With the reference's y+1 CFA offset folded in, the effective storage
pattern at phase (0, 0) is RGGB, and each pixel takes (clamp-to-edge):

    y even, x even  (R):  r = v(x,y)    g = v(x+1,y)  b = v(x,y-1)
    y even, x odd   (G2): g = v(x,y)    r = v(x-1,y)  b = v(x,y-1)
    y odd,  x even  (G1): g = v(x,y)    b = v(x+1,y)  r = v(x,y+1)
    y odd,  x odd   (B):  b = v(x,y)    g = v(x-1,y)  r = v(x-1,y+1)

Other Bayer phases shift the parity labels; the data never moves.
"""

from __future__ import annotations

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


def demosaic(mosaic: torch.Tensor, method: str = "nearest", phase=(0, 0)):
    """Dispatch by method; only the parity stencil is ported so far."""
    if method == "nearest":
        return demosaic_nearest(mosaic, phase)
    if method in ("bilinear", "malvar", "grad"):
        raise NotImplementedError(f"not ported yet: demosaic {method!r}")
    raise ValueError(f"unknown demosaic method {method!r}")
