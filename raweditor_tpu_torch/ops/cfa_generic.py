"""Generic repeating-CFA demosaic (X-Trans and any other periodic grid).

The JAX package's ``ops/cfa_generic.py``, with the same f32 operation
order, so each function aims to be bit-equal to its JAX counterpart on
the CPU. Three tiers over a (ph, pw)-repeating colour-filter pattern
(a 2x2 Bayer grid, the 6x6 Fuji X-Trans grid):

- ``demosaic_nearest_generic``: every missing channel reads the nearest
  sensor site of that channel (``nearest_offsets``, computed once per
  pattern); ``demosaic_nearest_generic_sampled`` evaluates it only at
  sampled sites, for the preview and the histogram;
- ``demosaic_smooth_generic``: normalised convolution, each missing
  channel is conv(value * site mask) / conv(site mask) with a tent sized
  per channel;
- ``demosaic_grad_generic``: directional G blended by inverse gradients,
  R/B by colour differences, two chroma refinements. The Bayer ``grad``
  lane runs it on the 2x2 grid.

One rule holds for every tap of the two convolution tiers: the **value**
is read clamp-to-edge, the **site mask** continues periodically past the
frame, so the denominators are positive everywhere.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from raweditor_tpu_torch.ops.demosaic import edge_pad

# Canonical X-Trans pattern (Fuji sensors), rows of 6.
XTRANS_PATTERN = (
    "GBGGRG"
    "RGRBGB"
    "GBGGRG"
    "GRGGBG"
    "BGBRGR"
    "GRGGBG"
)

_CHAN = {"R": 0, "G": 1, "B": 2}


@functools.lru_cache(maxsize=16)
def channel_grid(pattern: str = XTRANS_PATTERN, ph: int = 6,
                 pw: int = 6) -> np.ndarray:
    """(ph, pw) int32 channel ids (0=R, 1=G, 2=B) of a repeating pattern
    string, row by row; letters in either case, anything else raises."""
    if len(pattern) != ph * pw:
        raise ValueError(f"pattern length {len(pattern)} != {ph}x{pw}")
    pattern = pattern.upper()
    if set(pattern) - set(_CHAN):
        raise ValueError(f"pattern {pattern!r} has letters other than R, G, B")
    return np.array([_CHAN[c] for c in pattern],
                    dtype=np.int32).reshape(ph, pw)


@functools.lru_cache(maxsize=16)
def nearest_offsets(pattern: str, ph: int, pw: int):
    """For each pattern cell and channel, the offset (dy, dx) of the
    nearest site of that channel (Euclidean, ties broken by
    (|dy|+|dx|, dy, dx)). Returns {(py, px, chan): (dy, dx)}."""
    grid = channel_grid(pattern, ph, pw)
    radius = max(ph, pw)
    cands = sorted(
        ((dy, dx) for dy in range(-radius, radius + 1)
         for dx in range(-radius, radius + 1)),
        key=lambda o: (o[0] ** 2 + o[1] ** 2, abs(o[0]) + abs(o[1]),
                       o[0], o[1]))
    table: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
    for py in range(ph):
        for px in range(pw):
            for chan in range(3):
                for dy, dx in cands:
                    if grid[(py + dy) % ph, (px + dx) % pw] == chan:
                        table[(py, px, chan)] = (dy, dx)
                        break
                else:
                    raise ValueError(f"channel {chan} absent from pattern")
    return table


def _cells_by_offset(table, ph: int, pw: int, chan: int):
    """{offset: (ph, pw) bool array of the cells whose nearest ``chan``
    site lies at that offset}, in the table's cell order."""
    cells: Dict[Tuple[int, int], np.ndarray] = {}
    for py in range(ph):
        for px in range(pw):
            cells.setdefault(table[(py, px, chan)],
                             np.zeros((ph, pw), bool))[py, px] = True
    return cells


def _select_by_cell(taps, table, ph, pw, cy, cx):
    """The (r, g, b) planes that take, at each position, the tap
    ``taps[offset]`` of its pattern cell ``(cy[:, None], cx[None, :])``."""
    planes = []
    for chan in range(3):
        acc = None
        for off, cells in _cells_by_offset(table, ph, pw, chan).items():
            if acc is None:
                acc = torch.zeros_like(taps[off])
            mask = torch.as_tensor(cells, device=cy.device).index_select(
                0, cy).index_select(1, cx)
            acc = torch.where(mask, taps[off], acc)
        planes.append(acc)
    return tuple(planes)


def demosaic_nearest_generic(mosaic: torch.Tensor, pattern: str, ph: int,
                             pw: int):
    """Nearest-site demosaic of an (..., H, W) mosaic for a
    (ph, pw)-repeating CFA; returns (r, g, b) planes. Clamp-to-edge, as
    the Bayer stencil."""
    h, w = mosaic.shape[-2:]
    dev = mosaic.device
    table = nearest_offsets(pattern, ph, pw)
    pad = max(max(abs(dy), abs(dx)) for dy, dx in table.values())
    p = edge_pad(mosaic, pad, pad, pad, pad)
    taps = {(dy, dx): p[..., pad + dy: pad + dy + h, pad + dx: pad + dx + w]
            for dy, dx in set(table.values())}
    return _select_by_cell(taps, table, ph, pw,
                           torch.arange(h, device=dev) % ph,
                           torch.arange(w, device=dev) % pw)


def demosaic_nearest_generic_sampled(mosaic: torch.Tensor, yi: torch.Tensor,
                                     xi: torch.Tensor, pattern: str, ph: int,
                                     pw: int):
    """The nearest-site demosaic evaluated only at the sampled full-res
    sites ``(yi[:, None], xi[None, :])``: the preview and histogram path.
    Gathers each tap at the sampled coordinates, then selects per pattern
    cell. Returns (r, g, b) (Hp, Wp) planes."""
    h, w = mosaic.shape
    table = nearest_offsets(pattern, ph, pw)
    yc = torch.clamp(yi, 0, h - 1)
    xc = torch.clamp(xi, 0, w - 1)
    rows, taps = {}, {}
    for dy, dx in sorted(set(table.values())):
        if dy not in rows:
            rows[dy] = mosaic.index_select(0, torch.clamp(yc + dy, 0, h - 1))
        taps[(dy, dx)] = rows[dy].index_select(
            1, torch.clamp(xc + dx, 0, w - 1))
    return _select_by_cell(taps, table, ph, pw, yc % ph, xc % pw)


def demosaic_xtrans(mosaic: torch.Tensor, pattern: str = XTRANS_PATTERN):
    """Fuji X-Trans 6x6 nearest demosaic."""
    return demosaic_nearest_generic(mosaic, pattern, 6, 6)


def is_xtrans(cfa_pattern: str) -> bool:
    return len(cfa_pattern) == 36


def generic_cfa_method(method: str) -> str:
    """Map a Bayer demosaic choice onto the generic-CFA tier: nearest and
    the generic methods pass through; the Bayer quality requests
    (bilinear, malvar) become the isotropic ``"smooth"`` interpolator."""
    return method if method in ("nearest", "smooth", "grad") else "smooth"


@functools.lru_cache(maxsize=32)
def _smooth_radius(pattern: str, ph: int, pw: int, chan: int) -> int:
    """Smallest tent radius whose periodic window always holds at least
    one site of ``chan`` (so the denominator never vanishes)."""
    grid = channel_grid(pattern, ph, pw)
    for radius in range(1, max(ph, pw) + 1):
        ok = all(
            any(grid[(py + dy) % ph, (px + dx) % pw] == chan
                for dy in range(-radius, radius + 1)
                for dx in range(-radius, radius + 1))
            for py in range(ph) for px in range(pw))
        if ok:
            return radius
    raise ValueError(f"channel {chan} absent from pattern")


def _tile_periodic(core: np.ndarray, h: int, w: int, off_y: int,
                   off_x: int, device) -> torch.Tensor:
    """The (h, w) f32 tensor whose [y, x] is
    core[(y + off_y) % ph, (x + off_x) % pw]: an exact gather of the
    constant core."""
    ph, pw = core.shape
    c = torch.as_tensor(np.asarray(core, np.float32), device=device)
    rows = (torch.arange(h, device=device) + off_y) % ph
    cols = (torch.arange(w, device=device) + off_x) % pw
    return c.index_select(0, rows).index_select(1, cols)


def _periodic_mask(grid_np: np.ndarray, chan: int, h: int, w: int, pad,
                   device) -> torch.Tensor:
    """The 0/1 site mask of ``chan`` over the (h, w) frame grown by
    ``pad`` = ((top, bottom), (left, right)), periodic past the edge."""
    base = (grid_np == chan).astype(np.float32)
    hh = h + pad[0][0] + pad[0][1]
    ww = w + pad[1][0] + pad[1][1]
    return _tile_periodic(base, hh, ww, -pad[0][0], -pad[1][0], device)


def _tent_weights(radius: int) -> np.ndarray:
    return np.minimum(np.arange(2 * radius + 1) + 1,
                      np.arange(2 * radius, -1, -1) + 1).astype(np.float32)


def _periodic_den_1d(grid_np, chan, radius, axis):
    """(ph, pw) core of the VALID 1-D tent convolution of the periodic
    site mask along ``axis``, in f32 with _tent_valid_axis's order."""
    t = _tent_weights(radius)
    base = (grid_np == chan).astype(np.float32)
    core = None
    for k in range(2 * radius + 1):
        term = np.float32(t[k]) * np.roll(base, -k, axis)
        core = term if core is None else core + term
    return core


def _periodic_den_2d(grid_np, chan, radius):
    """The 2-D (column, then row) counterpart of _periodic_den_1d."""
    core = _periodic_den_1d(grid_np, chan, radius, 0)
    out = None
    t = _tent_weights(radius)
    for k in range(2 * radius + 1):
        term = np.float32(t[k]) * np.roll(core, -k, 1)
        out = term if out is None else out + term
    return out


def _tent_valid_axis(xp: torch.Tensor, radius: int, axis: int):
    """VALID 1-D tent convolution along ``axis`` (0 rows, 1 columns of
    the last two dims) as a shifted add, taps in order."""
    t = _tent_weights(radius)
    dim = xp.dim() - 2 + axis
    n_out = xp.shape[dim] - 2 * radius
    acc = None
    for k in range(2 * radius + 1):
        term = float(t[k]) * xp.narrow(dim, k, n_out)
        acc = term if acc is None else acc + term
    return acc


def _tent_valid(xp: torch.Tensor, radius: int):
    """VALID 2-D tent convolution: columns first, then rows."""
    return _tent_valid_axis(_tent_valid_axis(xp, radius, 0), radius, 1)


@functools.lru_cache(maxsize=32)
def _dir_radius(pattern: str, ph: int, pw: int, chan: int,
                axis: int) -> int:
    """Smallest 1-D tent radius along ``axis`` (0 = vertical) whose
    window always holds a site of ``chan``; 0 if none up to the period."""
    grid = channel_grid(pattern, ph, pw)
    period = ph if axis == 0 else pw
    for radius in range(1, period + 1):
        ok = all(
            any(grid[(py + (d if axis == 0 else 0)) % ph,
                     (px + (d if axis == 1 else 0)) % pw] == chan
                for d in range(-radius, radius + 1))
            for py in range(ph) for px in range(pw))
        if ok:
            return radius
    return 0


def _nc_1d(mosaic: torch.Tensor, grid_np, chan, h, w, radius: int,
           axis: int):
    """1-D normalised tent convolution of (value * mask) / mask along
    ``axis``: the mask extends periodically, the values edge-clamp."""
    pad = ((0, 0), (radius, radius)) if axis == 1 else \
        ((radius, radius), (0, 0))
    dev = mosaic.device
    mask_p = _periodic_mask(grid_np, chan, h, w, pad, dev)
    pad_v = edge_pad(mosaic, pad[0][0], pad[0][1], pad[1][0],
                     pad[1][1]) * mask_p
    den = _tile_periodic(_periodic_den_1d(grid_np, chan, radius, axis), h,
                         w, -pad[0][0], -pad[1][0], dev)
    return _tent_valid_axis(pad_v, radius, axis) / den


def demosaic_grad_generic(mosaic: torch.Tensor, pattern: str, ph: int,
                          pw: int):
    """Gradient-weighted demosaic of an (H, W) f32 mosaic for a
    (ph, pw)-repeating CFA; returns (r, g, b) planes.

    1. G interpolates directionally: 1-D normalised convolutions along
       rows and columns, blended by the inverse raw gradients.
    2. R/B interpolate the colour differences (value - G) with the 2-D
       tent normalised convolution, and add G back.
    3. Two chroma refinements: a normalised 3x3 tent over the colour
       differences, each channel rebuilt from its own sensor sites.
    """
    h, w = mosaic.shape[-2:]
    dev = mosaic.device
    grid_np = channel_grid(pattern.upper(), ph, pw)

    def chan_mask(chan, pad):
        return _periodic_mask(grid_np, chan, h, w, pad, dev)

    g_chan = _CHAN["G"]
    rh = _dir_radius(pattern.upper(), ph, pw, g_chan, 1)
    rv = _dir_radius(pattern.upper(), ph, pw, g_chan, 0)
    if rh == 0 or rv == 0:
        # G too sparse for 1-D windows: the isotropic interpolator.
        return demosaic_smooth_generic(mosaic, pattern, ph, pw)
    gh = _nc_1d(mosaic, grid_np, g_chan, h, w, rh, 1)
    gv = _nc_1d(mosaic, grid_np, g_chan, h, w, rv, 0)
    pe = edge_pad(mosaic, 1, 1, 1, 1)
    dh = torch.abs(pe[..., 1:-1, 2:] - pe[..., 1:-1, :-2])
    dv = torch.abs(pe[..., 2:, 1:-1] - pe[..., :-2, 1:-1])
    eps = float(np.float32(1e-4))
    wh = 1.0 / (dh + eps)
    wv = 1.0 / (dv + eps)
    g = (wh * gh + wv * gv) / (wh + wv)
    at_g = chan_mask(g_chan, ((0, 0), (0, 0))) > 0
    g = torch.where(at_g, mosaic, g)

    planes = [None, g, None]
    for name in ("R", "B"):
        chan = _CHAN[name]
        r2 = _smooth_radius(pattern.upper(), ph, pw, chan)
        pad = ((r2, r2), (r2, r2))
        mask_p = chan_mask(chan, pad)
        diff = edge_pad(mosaic - g, r2, r2, r2, r2) * mask_p
        den = _tile_periodic(_periodic_den_2d(grid_np, chan, r2), h, w, -r2,
                             -r2, dev)
        interp = g + _tent_valid(diff, r2) / den
        at_site = mask_p[r2: r2 + h, r2: r2 + w] > 0
        planes[chan] = torch.where(at_site, mosaic, interp)

    rpl, gpl, bpl = planes
    at = [chan_mask(c, ((0, 0), (0, 0))) > 0 for c in range(3)]

    def conv_same(x):  # normalised 3x3 tent (sum 16), separable
        return _tent_valid(edge_pad(x, 1, 1, 1, 1), 1) * float(
            np.float32(1.0 / 16.0))

    for _ in range(2):
        cb = conv_same(rpl - gpl)
        cr = conv_same(bpl - gpl)
        gpl = torch.where(at[1], mosaic,
                          torch.where(at[0], mosaic - cb, mosaic - cr))
        rpl = torch.where(at[0], mosaic, gpl + cb)
        bpl = torch.where(at[2], mosaic, gpl + cr)
    return rpl, gpl, bpl


def demosaic_smooth_generic(mosaic: torch.Tensor, pattern: str, ph: int,
                            pw: int):
    """Normalised-convolution demosaic of an (..., H, W) f32 mosaic for a
    (ph, pw)-repeating CFA; returns (r, g, b) planes.

    At sensor sites the raw value passes through; elsewhere each channel
    is conv(value * mask) / conv(mask) with a tent sized per channel
    (radius 1 serves all three X-Trans channels). On a Bayer grid with
    the radius-1 tent this is ``demosaic_bilinear``."""
    h, w = mosaic.shape[-2:]
    dev = mosaic.device
    grid_np = channel_grid(pattern.upper(), ph, pw)
    planes = []
    for chan in range(3):
        r = _smooth_radius(pattern.upper(), ph, pw, chan)
        mask_p = _periodic_mask(grid_np, chan, h, w, ((r, r), (r, r)), dev)
        pad_v = edge_pad(mosaic, r, r, r, r) * mask_p
        den = _tile_periodic(_periodic_den_2d(grid_np, chan, r), h, w, -r,
                             -r, dev)
        sm = _tent_valid(pad_v, r) / den
        at_site = mask_p[r: r + h, r: r + w] > 0
        planes.append(torch.where(at_site, mosaic, sm))
    return tuple(planes)
