"""The fused develop kernels: demosaic, folded edit stack, transfer and
quantisation in one pass over the u16 mosaic, with packed RGBA words or
JPEG YCbCr 4:2:0 planes as output.

Port of the TPU kernel ``raweditor_tpu/ops/pallas_develop.py``
(``pallas_develop_rgba`` / ``pallas_batch_develop_rgba``). ``demosaic``
picks the stencil, as the TPU kernel's argument of that name does. On a
Bayer mosaic (``pattern=None``, ``cfa_phase``):

- ``"nearest"`` (the parity stencil), ``"bilinear"`` and ``"malvar"``
  run ``csrc/develop.cu`` (one thread per two 2x2 quads side by side;
  the TPU kernel's ``_develop_block`` and ``_demosaic_smooth_taps``);
- ``"grad"`` runs ``csrc/develop_grad.cu`` (a warp marches down a
  64-column strip with every stage in registers, ``csrc/grad_tile.cuh``;
  ``_demosaic_grad_window``).

On a square repeating CFA (``pattern=`` a string of side*side letters,
the 6x6 X-Trans grid; ``cfa_phase`` is not read):

- ``"nearest"`` (one of five taps per pixel and channel, chosen by the
  pattern cell) and ``"smooth"`` (radius-1 normalised convolution) run
  the generic-CFA kernels of ``csrc/develop.cu``: nearest one thread per
  2x2 quad, smooth the warp march of ``csrc/band_march.cuh`` with a halo
  of one column (``_develop_block``'s site table,
  ``_demosaic_smooth_generic``);
- ``"grad"`` runs ``csrc/develop_grad_generic.cu``
  (``_demosaic_grad_generic_window``).

The pattern reaches those kernels as small per-cell tables built on the
host (``cfa_tables``). Their taps follow one rule: a tap's **value** is
read at coordinates clamped to the image, its **site mask** is looked up
at the unclamped coordinates modulo the period.

All are CUDA C++ for sm_90a, built by ``ops/_build.py``. Beside them:

- ``fold_scalars``: the edit stack folded into 24 f32 constants per
  image (``_fold_scalars``): WB, temperature/tint and exposure into the
  3x3 matrix, black level into one scale plus an offset vector, contrast
  and levels into one affine. Folding reassociates the float math, so
  this lane differs from the parity chain (``ops/develop.py``) by up to
  1 LSB;
- ``quant_table``: the transfer-and-quantise map of one transfer
  (``_quantize``) as the exact table the kernels look codes up in,
  derived by ``_quantize`` itself on the kernels' device at first use
  (``quant_thresholds``, ``quant_exceptions``, ``QuantTable``);
  ``fused_quantize`` runs the kernels' lookup over any f32 values, the
  check that it equals ``_quantize``;
- ``develop_rgba_folded_plain``: the kernels' math in plain PyTorch ops.
  It demosaics ``raw * scale`` before the black offset is added, in the
  kernels' factored sums, so it rounds differently from the XLA-lane
  demosaics of ``ops/demosaic.py`` by up to 1 ulp before quantisation.
  The wrappers run it for CPU tensors; the card comparisons hold the
  kernels against it;
- ``LAUNCHES``: how many times each kernel was launched, one key per
  output and demosaic (``develop_rgba``, ``develop_ycbcr420`` for
  nearest; ``develop_rgba_malvar``, ``develop_ycbcr420_grad``, ...; the
  generic-CFA kernels ``develop_rgba_cfa_nearest``,
  ``develop_ycbcr420_cfa_smooth``, ...).

For a CUDA tensor the wrappers launch the kernel or raise; nothing falls
back to the plain version there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raweditor_tpu_torch.color import (GAMMA22_POLY, INV_22, INV_24,
                                       SRGB_CUT, SRGB_POLY, horner)
from raweditor_tpu_torch.ops import cfa_generic
from raweditor_tpu_torch.ops.demosaic import (demosaic_nearest,
                                              parity_masks)
from raweditor_tpu_torch.ops.develop import (LUMA, _square_period, pack_rgba,
                                             u16_to_f32)
from raweditor_tpu_torch.ops.jpeg import quantize_u8, rgb_to_ycbcr
from raweditor_tpu_torch.params import EditParams

N_SCALARS = 24
GAMMAS = {"pow": 0, "poly": 1, "srgb": 2, "srgb_poly": 3}
OUTPUTS = {"rgba": 0, "ycbcr420": 1}
# The Bayer stencil ids of csrc/develop.cu; "grad" has its own kernel.
DEMOSAICS = {"nearest": 0, "bilinear": 1, "malvar": 2, "grad": 3}
# The generic-CFA (``pattern=``) tiers: nearest and smooth are stencils
# of csrc/develop.cu's generic kernel, "grad" has its own kernel.
CFA_DEMOSAICS = {"nearest": 0, "smooth": 1, "grad": 2}
# The kernels' tables hold a period of up to 6x6 cells.
MAX_CFA_SIDE = 6
# The five taps of the generic nearest stencil, as the kernel's codes.
NEAREST_TAP_CODES = {(0, 0): 0, (0, -1): 1, (0, 1): 2, (-1, 0): 3, (1, 0): 4}


def variant(demosaic: str, pattern: str = None) -> str:
    """The name of one demosaic variant: the Bayer stencil's own name, or
    ``cfa_<tier>`` for the generic-CFA kernels (any ``pattern``)."""
    return demosaic if pattern is None else "cfa_" + demosaic


def launch_key(output: str, demosaic: str, pattern: str = None) -> str:
    """The ``LAUNCHES`` key of one kernel variant."""
    name = variant(demosaic, pattern)
    base = "develop_" + output
    return base if name == "nearest" else f"{base}_{name}"


# Launch counts: each wrapper adds one where it launches its kernel.
LAUNCHES = {launch_key(o, d): 0 for o in OUTPUTS for d in DEMOSAICS}
LAUNCHES.update({launch_key(o, d, cfa_generic.XTRANS_PATTERN): 0 for o in OUTPUTS
                 for d in CFA_DEMOSAICS})


# The byte layout of ``struct CfaTables`` in csrc/cfa_tables.cuh.
_CELLS = MAX_CFA_SIDE * MAX_CFA_SIDE
_TABLES_DTYPE = np.dtype([("side", "<i4"), ("chan", "u1", _CELLS),
                          ("tap", "u1", (3, _CELLS)),
                          ("den_h", "<f4", _CELLS), ("den_v", "<f4", _CELLS),
                          ("den2", "<f4", (3, _CELLS))])


class CfaTables:
    """The per-cell tables of one square repeating CFA, all (side, side)
    and indexed by ``[y % side, x % side]`` of the output pixel:

    - ``grid``: channel id (0=R, 1=G, 2=B), ``cfa_generic.channel_grid``;
    - ``taps`` (3, side, side) u8: per channel the code of the nearest
      site's tap (``NEAREST_TAP_CODES``), or None when an offset of
      ``cfa_generic.nearest_offsets`` is not one of the five taps;
    - ``den_h``, ``den_v``: the radius-1 1-D tent denominators of G along
      rows and columns (``_periodic_den_1d``), shifted to the pixel;
    - ``den2`` (3, side, side): the radius-1 2-D tent denominators per
      channel (``_periodic_den_2d``), shifted to the pixel.

    ``packed`` is the same as the bytes of the kernels' ``CfaTables``."""

    def __init__(self, pattern: str):
        side = _square_period(pattern)
        if side > MAX_CFA_SIDE:
            raise ValueError(
                f"CFA period {side}x{side} exceeds the kernels' tables "
                f"({MAX_CFA_SIDE}x{MAX_CFA_SIDE})")
        self.side = side
        self.grid = cfa_generic.channel_grid(pattern, side, side)
        offsets = cfa_generic.nearest_offsets(pattern, side, side)
        self.bad_offset = next((o for o in offsets.values()
                                if o not in NEAREST_TAP_CODES), None)
        self.taps = None if self.bad_offset else np.array(
            [[[NEAREST_TAP_CODES[offsets[py, px, c]] for px in range(side)]
              for py in range(side)] for c in range(3)], np.uint8)
        g = cfa_generic._CHAN["G"]
        # The cores index the window's first cell; roll them so [py, px]
        # is the pixel's own cell (the TPU kernel tiles them at offsets
        # (0, -1), (-1, 0) and (-1, -1)).
        self.den_h = np.roll(
            cfa_generic._periodic_den_1d(self.grid, g, 1, 1), 1, 1)
        self.den_v = np.roll(
            cfa_generic._periodic_den_1d(self.grid, g, 1, 0), 1, 0)
        self.den2 = np.stack([np.roll(
            cfa_generic._periodic_den_2d(self.grid, c, 1), (1, 1), (0, 1))
            for c in range(3)])
        rec = np.zeros((), _TABLES_DTYPE)
        n = side * side
        rec["side"] = side
        rec["chan"][:n] = self.grid.reshape(-1)
        if self.taps is not None:
            rec["tap"][:, :n] = self.taps.reshape(3, -1)
        rec["den_h"][:n] = self.den_h.reshape(-1)
        rec["den_v"][:n] = self.den_v.reshape(-1)
        rec["den2"][:, :n] = self.den2.reshape(3, -1)
        self.packed = rec.tobytes()


@functools.lru_cache(maxsize=16)
def _cfa_tables(pattern: str) -> CfaTables:
    return CfaTables(pattern)


def cfa_tables(pattern: str) -> CfaTables:
    """The kernels' tables of a square repeating-CFA pattern string."""
    return _cfa_tables(pattern.upper())


def check_demosaic(demosaic: str, pattern: str = None) -> None:
    """The TPU launchers' argument checks (``pallas_develop_rgba``), as
    ``ValueError``s: which demosaic goes with a Bayer phase and which
    with a ``pattern``, and what the generic-CFA kernels need of the
    pattern (radius-1 windows, nearest sites among the five taps)."""
    if pattern is not None and demosaic not in CFA_DEMOSAICS:
        raise ValueError(
            "generic-CFA patterns support nearest/smooth/grad demosaic")
    if pattern is not None and demosaic in ("smooth", "grad"):
        side = _square_period(pattern)
        if any(cfa_generic._smooth_radius(pattern, side, side, c) != 1
               for c in range(3)):
            raise ValueError(
                "the smooth/grad kernels need per-channel smooth radius 1 "
                "(X-Trans qualifies); use the plain lane")
        g = cfa_generic._CHAN["G"]
        if demosaic == "grad" and any(
                cfa_generic._dir_radius(pattern, side, side, g, a) != 1
                for a in (0, 1)):
            raise ValueError(
                "the grad kernel needs directional-G radius 1 (X-Trans "
                "qualifies); use the plain lane")
    if demosaic not in DEMOSAICS and demosaic not in CFA_DEMOSAICS:
        raise ValueError(f"unknown demosaic {demosaic!r}")
    if pattern is None and demosaic == "smooth":
        raise ValueError("'smooth' is the generic-CFA tier; Bayer uses "
                         "bilinear/malvar/grad")
    if pattern is not None:
        tables = cfa_tables(pattern)  # square, side <= MAX_CFA_SIDE
        if demosaic == "nearest" and tables.taps is None:
            raise ValueError(f"pattern needs offset {tables.bad_offset}; "
                             "only the four +-1 neighbours are supported")


def _tile(table: np.ndarray, like: torch.Tensor, dy: int = 0, dx: int = 0):
    """A (side, side) table as f32 over the last two dims of ``like``:
    [y, x] is ``table[(y + dy) % side, (x + dx) % side]``, periodic in the
    unclamped coordinates."""
    h, w = like.shape[-2:]
    return cfa_generic._tile_periodic(table, h, w, dy, dx, like.device)


def _poly255(coeffs):
    """The polynomial scaled by 255 with the quantiser's +0.5 folded into
    the constant term, as f32 (``pallas_develop._GAMMA_POLY255`` and
    ``_SRGB_POLY255``)."""
    scaled = [float(c) * 255.0 for c in coeffs[:-1]]
    scaled.append(float(coeffs[-1]) * 255.0 + 0.5)
    return tuple(np.float32(k) for k in scaled)


GAMMA_POLY255 = _poly255(GAMMA22_POLY)
SRGB_POLY255 = _poly255(SRGB_POLY)
SRGB_LIN255 = float(np.float32(12.92 * 255.0))


def fold_scalars(params: EditParams, wb, cam_matrix, white_level=4096.0,
                 black_level=0.0, matrix_transpose: bool = True):
    """The (24,) f32 folded-scalar vector of one image, on the CPU, in
    the operation order of the TPU kernel's ``_fold_scalars``."""
    f32 = torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    p = {n: t(float(getattr(params, n))) for n in (
        "exposure", "contrast", "highlights", "shadows", "whites",
        "blacks", "vibrance", "saturation", "temperature", "tint")}
    m = t(cam_matrix).reshape(3, 3)
    if matrix_transpose:
        m = m.T
    gains = t(wb).reshape(3) * torch.stack([
        1.0 + p["temperature"] * 0.3,
        1.0 + p["tint"] * 0.3,
        1.0 - p["temperature"] * 0.3,
    ])
    m = m * gains[None, :] * torch.exp2(p["exposure"])
    black = t(black_level)
    s = 1.0 / (t(white_level) - black)
    b = -black * s
    c0 = m @ torch.full((3,), float(b), dtype=f32)
    cf = 1.0 + p["contrast"] / 100.0
    inv = 1.0 / (p["whites"] - p["blacks"] + 1e-4)
    a = cf * inv
    bb = ((0.5 - 0.5 * cf) - p["blacks"]) * inv
    return torch.cat([
        m.reshape(-1),                          # 0..8 folded matrix
        c0,                                     # 9..11 black offset
        torch.stack([
            s,                                  # 12 norm scale
            a, bb,                              # 13, 14 contrast+levels
            p["highlights"], p["shadows"],      # 15, 16
            1.0 + p["saturation"] / 100.0,      # 17
            p["vibrance"],                      # 18
            -b,                                 # 19 black*s
            1.0 + p["shadows"],                 # 20 shadows tone affine
        ]),
        torch.zeros(N_SCALARS - 21, dtype=f32),
    ]).contiguous()


def scalars_from_numpy(arr) -> torch.Tensor:
    """An (N, 24) f32 numpy table (e.g. the JAX ``_fold_scalars`` of N
    images) as a contiguous CPU tensor."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != N_SCALARS:
        raise ValueError(f"expected (N, {N_SCALARS}) scalars, got {a.shape}")
    return torch.from_numpy(a.copy())


def _quantize(c, gamma: str):
    """Transfer, clamp at 255.5 in the x255 domain, floor (f32)."""
    c = torch.clamp_min(c, 0.0)
    if gamma == "poly":
        v = horner(torch.sqrt(torch.sqrt(torch.clamp_max(c, 1.0))),
                   GAMMA_POLY255)
    elif gamma == "srgb":
        c = torch.clamp_max(c, 1.0)
        hi = torch.pow(c, INV_24) * float(np.float32(1.055)) - float(
            np.float32(0.055))
        v = torch.where(c <= SRGB_CUT, c * float(np.float32(12.92)),
                        hi) * 255.0 + 0.5
    elif gamma == "srgb_poly":
        c = torch.clamp_max(c, 1.0)
        acc = horner(torch.sqrt(torch.sqrt(c)), SRGB_POLY255)
        v = torch.where(c <= SRGB_CUT, c * SRGB_LIN255 + 0.5, acc)
    else:
        v = torch.pow(c, INV_22) * 255.0 + 0.5
    return torch.floor(torch.clamp_max(v, 255.5))


# The kernels' exact quantiser (csrc/develop_common.cuh, struct
# QuantTable): buckets keyed by the f32 bits >> QUANT_SHIFT, at most
# QUANT_COMPARES thresholds in a bucket, up to QUANT_BUCKETS buckets;
# exceptions looked for within QUANT_WINDOW ulps of every threshold.
QUANT_SHIFT = 17
QUANT_BUCKETS = 1344
QUANT_COMPARES = 2
QUANT_WINDOW = 64
_ONE_BITS = 0x3F800000  # f32 1.0
_INT_MAX = 2**31 - 1
_QUANT_DTYPE = np.dtype([("lo", "<i4"), ("n", "<i4"), ("pad", "<i4", 2),
                         ("next", "<i4", (256, 4)),
                         ("base", "u1", QUANT_BUCKETS)])


def quant_thresholds(gamma: str, device="cpu") -> torch.Tensor:
    """The 255 thresholds of ``_quantize`` for ``gamma``, found by the plain
    version itself on ``device``, as int32 bit patterns (INT_MAX where
    ``_quantize(1.0) < k``): t_k (k = 1..255) is where ``_quantize`` steps
    to k. A bisection over the bit patterns of [0, 1] (30 steps of 255
    lanes) finds a value with code >= k after one below k; then t_k moves,
    within QUANT_WINDOW ulps, to the step that leaves the fewest values
    whose code is on the wrong side of k. Where ``_quantize`` never
    decreases, t_k is the smallest f32 with code >= k."""
    dev = torch.device(device)
    k = torch.arange(1, 256, dtype=torch.float32, device=dev)
    lo = torch.zeros(255, dtype=torch.int32, device=dev)  # q(lo) < k
    hi = torch.full((255,), _ONE_BITS, dtype=torch.int32, device=dev)
    for _ in range(30):  # 2**30 > _ONE_BITS: then hi - lo <= 1
        mid = lo + (hi - lo) // 2
        ge = _quantize(mid.view(torch.float32), gamma) >= k
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid)
    near = torch.clamp(hi[:, None] + torch.arange(
        -QUANT_WINDOW, QUANT_WINDOW + 1, dtype=torch.int32, device=dev),
        0, _ONE_BITS)
    up = _quantize(near.view(torch.float32), gamma) >= k[:, None]
    # Values on the wrong side of a step at column i: those up before it
    # and those not up from it on.
    wrong = (torch.cumsum(up, 1) - up.long()
             + torch.flip(torch.cumsum(torch.flip(~up, (1,)), 1), (1,)))
    best = torch.gather(near, 1, torch.argmin(wrong, 1)[:, None])[:, 0]
    top = _quantize(torch.ones(1, device=dev), gamma)
    return torch.where(k <= top, best, _INT_MAX)


def quant_exceptions(gamma: str, thresholds: torch.Tensor):
    """Where ``_quantize`` (on the thresholds' device) leaves the staircase
    of ``thresholds``: the f32 values within QUANT_WINDOW ulps of a
    threshold whose code is not #{k : c >= t_k}, as (int64 bit patterns,
    their codes), on the CPU. Empty where ``_quantize`` never decreases
    there; a transfer built on a ``pow`` that is not monotone steps down
    and up again at a single value (chip_smoke.py sweeps the rest)."""
    t = thresholds.to(torch.int64)
    t = t[t < _INT_MAX]
    near = (t[:, None] + torch.arange(-QUANT_WINDOW, QUANT_WINDOW + 1,
                                      device=t.device)).reshape(-1).unique()
    near = near[(near >= 0) & (near <= _ONE_BITS)]
    q = _quantize(near.to(torch.int32).view(torch.float32),
                  gamma).to(torch.int64)
    off = q != torch.searchsorted(t, near, right=True)
    return near[off].cpu(), q[off].cpu()


class QuantTable:
    """One transfer's transfer-and-quantise map as the kernels' exact
    lookup, from its thresholds (``quant_thresholds``) and the values
    where the map leaves their staircase (``quant_exceptions``). Off the
    exceptions q(c) = #{k : c >= t_k}: the bucket of c's bits gives the
    code at the bucket's first value (``base``), and at most
    QUANT_COMPARES compares against the next thresholds finish it.
    ``lo`` is the bucket just below t_1, ``n`` the buckets up to that of
    1.0;
    ``next[k]`` = (t_{k+1}, t_{k+2}, e, q(e)), thresholds INT_MAX past
    t_255, e the bits of the exception among the values whose bucket has
    the code k (INT_MAX, a NaN, for none). ``packed`` is the bytes of the
    kernels' ``QuantTable``. Raises ValueError where the thresholds or the
    exceptions do not fit that table."""

    def __init__(self, thresholds, exceptions=((), ())):
        t = np.asarray(torch.as_tensor(thresholds).cpu(), np.int64)
        if t.shape != (255,) or np.any(np.diff(t) < 0) or t[0] <= 0:
            raise ValueError("the thresholds are not those of a "
                             "non-decreasing quantiser")
        finite = t[t < _INT_MAX]
        # the bucket of the f32 below t_1: its first value's code is 0, the
        # code of every value below it (-0.0 and negatives clamp to it)
        self.lo = (int(finite[0]) - 1) >> QUANT_SHIFT
        self.n = (_ONE_BITS >> QUANT_SHIFT) - self.lo + 1
        if self.n > QUANT_BUCKETS or finite[-1] > _ONE_BITS:
            raise ValueError(f"thresholds span {self.n} buckets; the "
                             f"kernels' table holds {QUANT_BUCKETS} below 1.0")
        per = np.bincount((finite >> QUANT_SHIFT) - self.lo,
                          minlength=self.n)
        if per.max() > QUANT_COMPARES:
            raise ValueError(f"a bucket holds {per.max()} thresholds; the "
                             f"kernels compare {QUANT_COMPARES}")
        starts = (self.lo + np.arange(self.n, dtype=np.int64)) << QUANT_SHIFT
        self.base = np.searchsorted(finite, starts, side="right").astype(
            np.uint8)
        padded = np.concatenate([t, [_INT_MAX, _INT_MAX]])
        self.next = np.full((256, 4), _INT_MAX, np.int64)
        self.next[:, 0], self.next[:, 1] = padded[:256], padded[1:257]
        for e, code in zip(*(np.asarray(a, np.int64) for a in exceptions)):
            k = self._bucket_code(e)
            if self.next[k, 2] != _INT_MAX:
                raise ValueError(f"two exceptions share the code {k}")
            self.next[k, 2:] = e, code
        rec = np.zeros((), _QUANT_DTYPE)
        rec["lo"], rec["n"] = self.lo, self.n
        rec["next"] = self.next
        rec["base"][:self.n] = self.base
        self.packed = rec.tobytes()

    def _bucket_code(self, bits):
        j = np.clip((np.asarray(bits, np.int64) >> QUANT_SHIFT) - self.lo, 0,
                    self.n - 1)
        return self.base[j].astype(np.int64)

    def lookup(self, c: torch.Tensor) -> torch.Tensor:
        """The kernels' lookup (``quantize`` in csrc/develop_common.cuh) in
        plain ops, on the CPU: the codes of f32 ``c`` as int64."""
        bits = c.to(torch.float32).contiguous().view(torch.int32).to(
            torch.int64)
        j = torch.clamp((bits >> QUANT_SHIFT) - self.lo, 0, self.n - 1)
        k = torch.from_numpy(self.base.astype(np.int64))[j]
        nxt = torch.from_numpy(self.next)[k]
        code = k + (bits >= nxt[..., 0]) + (bits >= nxt[..., 1])
        return torch.where(bits == nxt[..., 2], nxt[..., 3], code)


@functools.lru_cache(maxsize=None)
def quant_table(gamma: str, device: torch.device):
    """(QuantTable, its packed bytes as a uint8 tensor on ``device``) of
    ``gamma``, derived by the plain quantiser on ``device`` at first use
    and cached per transfer and device."""
    if gamma not in GAMMAS:
        raise ValueError(f"unknown gamma {gamma!r}")
    thresholds = quant_thresholds(gamma, device)
    table = QuantTable(thresholds, quant_exceptions(gamma, thresholds))
    data = torch.frombuffer(bytearray(table.packed), dtype=torch.uint8)
    return table, data.to(device)


def _shift(a: torch.Tensor, dim: int, d: int) -> torch.Tensor:
    """The value ``d`` places along ``dim``, clamped at the true edge."""
    n = a.shape[dim]
    idx = torch.clamp(torch.arange(n, device=a.device) + d, 0, n - 1)
    return a.index_select(dim, idx)


def _up(a):
    return _shift(a, -2, -1)


def _dn(a):
    return _shift(a, -2, 1)


def _lf(a):
    return _shift(a, -1, -1)


def _rt(a):
    return _shift(a, -1, 1)


def _smooth_taps_plain(v, phase, method: str, floor):
    """Bilinear or Malvar-He-Cutler on ``raw * scale`` in the kernel's
    factored sums (``_demosaic_smooth_taps``); Malvar is floored at
    ``floor``, the folded black level sc[19]."""
    h, w = v.shape[-2:]
    u, d, l, r = _up(v), _dn(v), _lf(v), _rt(v)
    hsum = l + r
    vsum = u + d
    diag4 = (_lf(u) + _rt(u)) + (_lf(d) + _rt(d))
    ye, xe = parity_masks(h, w, phase, v.device)
    if method == "bilinear":
        hm = hsum * 0.5
        vm = vsum * 0.5
        pm = (hsum + vsum) * 0.25
        dm = diag4 * 0.25
        return (torch.where(ye, torch.where(xe, v, hm),
                            torch.where(xe, vm, dm)),
                torch.where(ye == xe, pm, v),
                torch.where(ye, torch.where(xe, dm, vm),
                            torch.where(xe, hm, v)))
    h2 = _shift(v, -1, -2) + _shift(v, -1, 2)
    v2 = _shift(v, -2, -2) + _shift(v, -2, 2)
    s2 = h2 + v2
    gc = v * 0.5 + (hsum + vsum) * 0.25 - s2 * 0.125
    kr = v * 0.625 + hsum * 0.5 - (h2 + diag4) * 0.125 + v2 * 0.0625
    kc = v * 0.625 + vsum * 0.5 - (v2 + diag4) * 0.125 + h2 * 0.0625
    kd = v * 0.75 + diag4 * 0.25 - s2 * 0.1875
    r = torch.where(ye, torch.where(xe, v, kr), torch.where(xe, kc, kd))
    g = torch.where(ye == xe, gc, v)
    b = torch.where(ye, torch.where(xe, kd, kc), torch.where(xe, kr, v))
    return tuple(torch.maximum(c, floor) for c in (r, g, b))


def _tent3(x):
    """Normalised 3x3 tent: column pass, then row pass, then /16."""
    xv = (_up(x) + x * 2.0) + _dn(x)
    return ((_lf(xv) + xv * 2.0) + _rt(xv)) * 0.0625


def _grad_plain(v, phase):
    """The gradient-weighted Bayer demosaic on ``raw * scale`` in the
    kernel's operation order (``_demosaic_grad_window``): every stage
    clamps its neighbour reads at the true image edge."""
    h, w = v.shape[-2:]
    ye, xe = parity_masks(h, w, phase, v.device)
    at_g = ye != xe
    at_r = ye & xe
    at_b = ~ye & ~xe
    u, d, l, r = _up(v), _dn(v), _lf(v), _rt(v)
    eps = float(np.float32(1e-4))
    wh = 1.0 / (torch.abs(r - l) + eps)
    wv = 1.0 / (torch.abs(d - u) + eps)
    g = torch.where(at_g, v, (wh * ((l + r) * 0.5) + wv * ((u + d) * 0.5))
                    / (wh + wv))
    diff = v - g
    du, dd = _up(diff), _dn(diff)
    hpair = (_lf(diff) + _rt(diff)) * 0.5
    vpair = (du + dd) * 0.5
    diag = ((_lf(du) + _lf(dd)) + (_rt(du) + _rt(dd))) * 0.25
    rpl = torch.where(ye, torch.where(xe, v, g + hpair),
                      torch.where(xe, g + vpair, g + diag))
    bpl = torch.where(ye, torch.where(xe, g + diag, g + vpair),
                      torch.where(xe, g + hpair, v))
    return _chroma_refine(v, rpl, g, bpl, at_g, at_r, at_b)


def _chroma_refine(v, rpl, gpl, bpl, at_g, at_r, at_b):
    """Two chroma refinements (the TPU kernel's ``_chroma_refine``): a
    3x3 tent over R-G and B-G, each channel rebuilt from its own sites."""
    for _ in range(2):
        cb = _tent3(rpl - gpl)
        cr = _tent3(bpl - gpl)
        gpl = torch.where(at_g, v, torch.where(at_r, v - cb, v - cr))
        rpl = torch.where(at_r, v, gpl + cb)
        bpl = torch.where(at_b, v, gpl + cr)
    return rpl, gpl, bpl


def _cfa_nearest_plain(v, tables: CfaTables):
    """The generic nearest stencil: per pixel and channel one of the five
    clamped taps, by the code of the pixel's pattern cell."""
    taps = (v, _lf(v), _rt(v), _up(v), _dn(v))
    planes = []
    for chan in range(3):
        code = _tile(tables.taps[chan], v)
        acc = v
        for k in range(1, 5):
            acc = torch.where(code == k, taps[k], acc)
        planes.append(acc)
    return tuple(planes)


def _cfa_masked(v, tables: CfaTables):
    """``mv(chan, dy, dx, a)``: the tap of ``a`` at (dy, dx), its value
    clamped at the true edge, zero where the unclamped site (y+dy, x+dx)
    is not of ``chan``; and the per-channel site masks of the pixels."""
    is_chan = [tables.grid == c for c in range(3)]

    def mask(chan, dy, dx):
        return _tile(is_chan[chan], v, dy, dx) > 0

    def mv(chan, dy, dx, a):
        return torch.where(mask(chan, dy, dx), _shift(_shift(a, -2, dy), -1,
                                                      dx), 0.0)

    return mv, [mask(c, 0, 0) for c in range(3)]


def _cfa_smooth_plain(v, tables: CfaTables):
    """Radius-1 normalised convolution in the kernel's order
    (``_demosaic_smooth_generic``): per channel the masked 3x3 tent as
    column sums, then the row sum, over the tiled denominator; sensor
    sites pass through."""
    mv, at = _cfa_masked(v, tables)
    planes = []
    for chan in range(3):
        col = {dx: (mv(chan, -1, dx, v) + mv(chan, 0, dx, v) * 2.0)
               + mv(chan, 1, dx, v) for dx in (-1, 0, 1)}
        num = (col[-1] + col[0] * 2.0) + col[1]
        planes.append(torch.where(at[chan], v,
                                  num / _tile(tables.den2[chan], v)))
    return tuple(planes)


def _cfa_grad_plain(v, tables: CfaTables):
    """The generic gradient-weighted demosaic in the kernel's order
    (``_demosaic_grad_generic_window``): directional G from the masked
    1-D tents blended by inverse raw gradients, R/B from the masked 3x3
    tent of ``v - g``, then the two chroma refinements. Every stage reads
    the stage below clamped at the true edge."""
    mv, (at_r, at_g, at_b) = _cfa_masked(v, tables)
    g_chan = cfa_generic._CHAN["G"]
    u, d, l, r = _up(v), _dn(v), _lf(v), _rt(v)
    vg = torch.where(at_g, v, 0.0)
    gh = ((mv(g_chan, 0, -1, v) + vg * 2.0) + mv(g_chan, 0, 1, v)) \
        / _tile(tables.den_h, v)
    gv = ((mv(g_chan, -1, 0, v) + vg * 2.0) + mv(g_chan, 1, 0, v)) \
        / _tile(tables.den_v, v)
    eps = float(np.float32(1e-4))
    wh = 1.0 / (torch.abs(r - l) + eps)
    wv = 1.0 / (torch.abs(d - u) + eps)
    g = torch.where(at_g, v, (wh * gh + wv * gv) / (wh + wv))
    diff = v - g
    planes = {}
    for chan, at_c in ((0, at_r), (2, at_b)):
        num = None
        for dx in (-1, 0, 1):
            col = (mv(chan, -1, dx, diff) + mv(chan, 0, dx, diff) * 2.0) \
                + mv(chan, 1, dx, diff)
            term = col * 2.0 if dx == 0 else col
            num = term if num is None else num + term
        planes[chan] = torch.where(at_c, v,
                                   g + num / _tile(tables.den2[chan], v))
    return _chroma_refine(v, planes[0], g, planes[2], at_g, at_r, at_b)


def develop_rgba_folded_plain(mosaics: torch.Tensor, scal: torch.Tensor,
                              cfa_phase=(0, 0), gamma: str = "pow",
                              output: str = "rgba",
                              demosaic: str = "nearest",
                              pattern: str = None):
    """The kernels' math in plain PyTorch ops, on any device.

    mosaics (N, H, W) u16, scal (N, 24) f32. ``pattern`` (a square
    repeating-CFA string) selects the generic-CFA stencils, else
    ``cfa_phase`` the Bayer ones. Returns (N, H, W) u32 RGBA words, or
    for ``output="ycbcr420"`` (Y (N, H, W) u8, CbCr (N, H/2, W) u8 with
    Cb at even and Cr at odd columns)."""
    check_demosaic(demosaic, pattern)
    sc = scal.to(torch.float32)[:, :, None, None]
    v = u16_to_f32(mosaics) * sc[:, 12]
    if pattern is not None:
        cfa_plain = {"nearest": _cfa_nearest_plain,
                     "smooth": _cfa_smooth_plain, "grad": _cfa_grad_plain}
        r, g, b = cfa_plain[demosaic](v, cfa_tables(pattern))
    elif demosaic == "nearest":
        r, g, b = demosaic_nearest(v, cfa_phase)
    elif demosaic == "grad":
        r, g, b = _grad_plain(v, cfa_phase)
    else:
        r, g, b = _smooth_taps_plain(v, cfa_phase, demosaic, sc[:, 19])
    r, g, b = (sc[:, 0] * r + sc[:, 1] * g + sc[:, 2] * b + sc[:, 9],
               sc[:, 3] * r + sc[:, 4] * g + sc[:, 5] * b + sc[:, 10],
               sc[:, 6] * r + sc[:, 7] * g + sc[:, 8] * b + sc[:, 11])
    lum = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    tone = (1.0 + lum * sc[:, 15]) * (sc[:, 20] - lum * sc[:, 16]) * sc[:, 13]
    r, g, b = r * tone + sc[:, 14], g * tone + sc[:, 14], b * tone + sc[:, 14]
    luma = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    spread = torch.maximum(r, torch.maximum(g, b)) - torch.minimum(
        r, torch.minimum(g, b))
    sf = sc[:, 17]
    f = sf * (1.0 + sc[:, 18] * (1.0 - spread * torch.abs(sf)))
    rq, gq, bq = (_quantize(luma + (c - luma) * f, gamma) for c in (r, g, b))
    if output == "rgba":
        return pack_rgba(rq, gq, bq)
    return emit_ycbcr420(rq, gq, bq)


def emit_ycbcr420(rq, gq, bq):
    """The kernels' JPEG 4:2:0 emission (``store_quad<true>`` in
    ``csrc/develop_common.cuh``) from quantised f32 (N, H, W) planes:
    Y (N, H, W) u8 and NV12-interleaved CbCr (N, H/2, W) u8, the chroma
    box summed over the row pair, then the column pair."""
    y, cb, cr = rgb_to_ycbcr(rq, gq, bq)

    def box(p):
        return ((p[..., 0::2, 0::2] + p[..., 1::2, 0::2])
                + (p[..., 0::2, 1::2] + p[..., 1::2, 1::2])) * 0.25

    n, h, w = rq.shape
    cbcr = torch.stack([quantize_u8(box(cb)), quantize_u8(box(cr))],
                       dim=-1).reshape(n, h // 2, w)
    return quantize_u8(y), cbcr


def _check_inputs(mosaics, scal, cfa_phase, gamma, output, demosaic,
                  pattern):
    if not isinstance(mosaics, torch.Tensor) or mosaics.dtype != torch.uint16:
        raise TypeError("mosaics must be a torch.uint16 tensor")
    if mosaics.dim() != 3 or 0 in mosaics.shape:
        raise ValueError(f"mosaics must be (N, H, W), got {tuple(mosaics.shape)}")
    n, h, w = mosaics.shape
    if not isinstance(scal, torch.Tensor) or scal.dtype != torch.float32:
        raise TypeError("scalars must be a torch.float32 tensor")
    if tuple(scal.shape) != (n, N_SCALARS):
        raise ValueError(
            f"scalars must be ({n}, {N_SCALARS}), got {tuple(scal.shape)}")
    if scal.device != mosaics.device:
        raise ValueError("mosaics and scalars must be on one device")
    if not (mosaics.is_contiguous() and scal.is_contiguous()):
        raise ValueError("mosaics and scalars must be contiguous")
    if gamma not in GAMMAS:
        raise ValueError(f"unknown gamma {gamma!r}")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output {output!r}")
    check_demosaic(demosaic, pattern)
    if output == "ycbcr420" and (h % 2 or w % 2):
        raise ValueError("ycbcr420 output requires even H and W")
    if tuple(cfa_phase) not in ((0, 0), (0, 1), (1, 0), (1, 1)):
        raise ValueError(f"bad Bayer phase {cfa_phase!r}")


def fused_batch_develop_rgba(mosaics: torch.Tensor, scal: torch.Tensor,
                             cfa_phase=(0, 0), gamma: str = "pow",
                             output: str = "rgba",
                             demosaic: str = "nearest",
                             pattern: str = None):
    """Batched fused develop with per-image folded scalars.

    mosaics (N, H, W) u16 and scal (N, 24) f32, contiguous, on one
    device. ``gamma`` is the transfer lane ("pow", "poly", "srgb",
    "srgb_poly"); ``demosaic`` the Bayer stencil ("nearest", "bilinear",
    "malvar", "grad") at ``cfa_phase``, or with ``pattern`` (a square
    repeating-CFA string of period up to 6x6) the generic-CFA tier
    ("nearest", "smooth", "grad"). Returns (N, H, W) u32 RGBA words, or for
    ``output="ycbcr420"`` (even H and W) the Y (N, H, W) u8 and
    NV12-interleaved CbCr (N, H/2, W) u8 planes. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    _check_inputs(mosaics, scal, cfa_phase, gamma, output, demosaic, pattern)
    dev = mosaics.device
    if dev.type == "cpu":
        return develop_rgba_folded_plain(mosaics, scal, cfa_phase, gamma,
                                         output, demosaic, pattern)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from raweditor_tpu_torch.ops import _build

    lib = _build.load()
    n, h, w = mosaics.shape
    with torch.cuda.device(dev):
        quant = quant_table(gamma, dev)[1].data_ptr()
        if output == "rgba":
            out0 = torch.empty((n, h, w), dtype=torch.uint32, device=dev)
            out1 = None
        else:
            out0 = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
            out1 = torch.empty((n, h // 2, w), dtype=torch.uint8, device=dev)
        args = (mosaics.data_ptr(), scal.data_ptr(), out0.data_ptr(),
                None if out1 is None else out1.data_ptr(), n, h, w)
        phase = (int(cfa_phase[0]), int(cfa_phase[1]))
        out_code = OUTPUTS[output]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pattern is not None:
            packed = cfa_tables(pattern).packed
            if demosaic == "grad":
                code = lib.rtt_develop_grad_cfa_launch(
                    *args, out_code, packed, quant, stream)
            else:
                code = lib.rtt_develop_cfa_launch(
                    *args, out_code, CFA_DEMOSAICS[demosaic], packed, quant,
                    stream)
        elif demosaic == "grad":
            code = lib.rtt_develop_grad_launch(*args, *phase, out_code, quant,
                                               stream)
        else:
            code = lib.rtt_develop_launch(*args, *phase, out_code,
                                          DEMOSAICS[demosaic], quant, stream)
    what = "develop kernel" if pattern is None else "generic-CFA develop kernel"
    _build.check(lib, code, f"{what} ({output}, {gamma}, {demosaic})")
    LAUNCHES[launch_key(output, demosaic, pattern)] += 1
    return out0 if output == "rgba" else (out0, out1)


def fused_develop_rgba(mosaic: torch.Tensor, scal: torch.Tensor,
                       cfa_phase=(0, 0), gamma: str = "pow",
                       demosaic: str = "nearest", pattern: str = None):
    """Single-image fused develop: (H, W) u16 and (24,) f32 scalars to
    (H, W) u32 RGBA words."""
    if mosaic.dim() != 2:
        raise ValueError(f"mosaic must be (H, W), got {tuple(mosaic.shape)}")
    return fused_batch_develop_rgba(mosaic[None], scal.reshape(1, N_SCALARS),
                                    cfa_phase, gamma, demosaic=demosaic,
                                    pattern=pattern)[0]


def fused_quantize(c: torch.Tensor, gamma: str = "pow") -> torch.Tensor:
    """The u8 codes of f32 ``c`` (any shape, contiguous) under the transfer
    ``gamma``: on the card the kernels' table quantiser over every value (a
    check of the table, not a kernel of the develop path), on the CPU its
    plain version ``_quantize``. Returns uint8 of ``c``'s shape."""
    if not isinstance(c, torch.Tensor) or c.dtype != torch.float32:
        raise TypeError("values must be a torch.float32 tensor")
    if not c.is_contiguous():
        raise ValueError("values must be contiguous")
    if gamma not in GAMMAS:
        raise ValueError(f"unknown gamma {gamma!r}")
    dev = c.device
    if dev.type == "cpu":
        return _quantize(c, gamma).to(torch.uint8)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if c.numel() >= 2**31:
        raise ValueError("at most 2**31 - 1 values per call")
    from raweditor_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        quant = quant_table(gamma, dev)[1]
        out = torch.empty(c.shape, dtype=torch.uint8, device=dev)
        code = lib.rtt_quant_sweep_launch(
            quant.data_ptr(), c.data_ptr(), out.data_ptr(), c.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"quantiser sweep ({gamma})")
    return out
