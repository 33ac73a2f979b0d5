"""The banded Lanczos-3 resize of packed RGBA words: a batch of (N, H, W)
u32 words to (N, out_h, out_w) words or JPEG YCbCr 4:2:0 planes in one
launch, bit for bit a plain banded version.

``ops/resize.py`` holds each axis's weights as a dense (in, out) f32
matrix (``resize.weight_matrix``); all but a band of each column are
zero (at 4:1 about 25 of thousands). Here:

- ``band_table``: one axis's band, (first, weights): for each output the
  first input with a nonzero weight, and its weights from there, T of
  them, T the widest span (first to last nonzero weight), padded with
  exact zeros; taken from the program's own matrix, cached per size,
  method and device;
- ``resize_words_banded_plain``: the plain version. The passes run in
  the order ``resize.resize_hw`` picks (``resize.rows_first``); each
  output is summed tap by tap in ascending input index, ``acc = acc +
  x[i] * w[t]`` from 0, every product and sum rounded in f32; an axis
  that keeps its size takes no pass. Then rounded half to even, clamped
  and repacked with opaque alpha, as ``resize.resize_rgba_words`` did.
  It differs from the dense products only in the order of the nonzero
  terms (the benchmark's ``web_reference`` sums in the same order);
- ``launch_resize``: one launch of the kernel (CUDA C++ for sm_90a,
  ``csrc/resize.cu``, built by ``ops/_build.py``) over the words and the
  launch's tables (``kernel_plan``), CUDA tensors only: the band march
  ``resize_bands``, or, for a size change it does not take (a downscale
  beyond about 73:1, an upscale beyond about 2.5x), ``resize_taps``, a
  block a 2x2 quad of outputs; both give the plain version's words, so
  every size change runs on the card;
- ``LAUNCHES``: launches per output, ``resize_words`` and
  ``resize_ycbcr420``.

The wrapper, ``resize_words``, takes (H, W) or (N, H, W) words: for CPU
tensors it runs the plain version (and ``ops/jpeg.rgba_words_to_ycbcr420``
for planes), for CUDA tensors it launches the kernel or raises; nothing
falls back to the plain version there.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from raweditor_tpu_torch.ops import jpeg as _jpeg
from raweditor_tpu_torch.ops.develop import pack_rgba, unpack_rgba
from raweditor_tpu_torch.ops.resize import (METHODS, rows_first,
                                            weight_matrix)

_F32 = torch.float32
OUTPUTS = {"rgba": 0, "ycbcr420": 1}
# Launch counts: the wrapper adds one where it launches its kernel.
LAUNCHES = {"resize_words": 0, "resize_ycbcr420": 0}
_LAUNCH_KEY = {"rgba": "resize_words", "ycbcr420": "resize_ycbcr420"}

# The kernel's geometry (csrc/resize.cu): 256 threads a block; the ring
# of live outputs along the march (8 or 16) sets the input columns a
# thread owns (2 or 1), so a block's window is 512 or 256 columns.
THREADS = 256
RINGS = (8, 16)
COLUMNS = {8: 2, 16: 1}
BAND_ROWS = 64     # output rows (along the march) a block computes
STRIP_MAX = 256    # output columns a block computes, at most
SMEM_MAX = 227 * 1024


@functools.lru_cache(maxsize=32)
def _band_cached(in_size: int, out_size: int, method: str, device: str):
    w = weight_matrix(in_size, out_size, method, device).T  # (out, in)
    nz = w != 0
    idx = torch.arange(in_size, device=w.device)
    big = torch.full_like(idx, in_size)
    first = torch.where(nz, idx, big).min(dim=1).values
    last = torch.where(nz, idx, torch.full_like(idx, -1)).max(dim=1).values
    empty = last < 0
    first = torch.where(empty, torch.zeros_like(first), first)
    span = torch.where(empty, torch.zeros_like(last), last - first + 1)
    taps = max(int(span.max()), 1)
    t = torch.arange(taps, device=w.device)
    pos = first[:, None] + t
    inside = t[None, :] < span[:, None]
    weights = torch.where(
        inside, torch.gather(w, 1, pos.clamp(max=in_size - 1)),
        torch.zeros((), dtype=_F32, device=w.device))
    return first, weights.contiguous()


def band_table(in_size: int, out_size: int, method: str = "lanczos3",
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first (out_size,) int64, weights (out_size, T) f32) of one axis on
    ``device``: output ``o`` sums inputs ``first[o] + t`` with weights
    ``weights[o, t]``, t < T; every weight of ``resize.weight_matrix``
    outside the band is 0.0, and the band's padding is 0.0."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}; expected one "
                         f"of {METHODS}")
    return _band_cached(int(in_size), int(out_size), method,
                        str(torch.device(device or "cpu")))


def _along(x: torch.Tensor, first: torch.Tensor, weights: torch.Tensor,
           axis: int) -> torch.Tensor:
    """``x`` (..., H, W) f32 resampled along ``axis`` (-2 rows, -1
    columns) by one band table, tap by tap in ascending input index. The
    padding's zero weights add exact zeros (every value is finite)."""
    in_size = x.shape[axis]
    out_size, taps = weights.shape
    idx = (first[:, None] + torch.arange(taps, device=x.device)).clamp(
        max=in_size - 1)
    shape = [1] * x.dim()
    shape[axis] = out_size
    acc = torch.zeros(x.shape[:axis % x.dim()] + (out_size,)
                      + x.shape[axis % x.dim() + 1:], dtype=_F32,
                      device=x.device)
    for t in range(taps):
        acc = acc + (torch.index_select(x, axis % x.dim(), idx[:, t])
                     * weights[:, t].reshape(shape))
    return acc


def resize_f32_banded(x: torch.Tensor, out_h: int, out_w: int,
                      method: str = "lanczos3") -> torch.Tensor:
    """(..., H, W) f32 to (..., out_h, out_w) f32 through the band tables,
    the passes in ``resize.resize_hw``'s order."""
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device

    def along_h(t):
        return _along(t, *band_table(h, out_h, method, dev), -2)

    def along_w(t):
        return _along(t, *band_table(w, out_w, method, dev), -1)

    do_h, do_w = out_h != h, out_w != w
    if do_h and do_w:
        if rows_first(h, w, out_h, out_w):
            return along_w(along_h(x))
        return along_h(along_w(x))
    if do_h:
        return along_h(x)
    if do_w:
        return along_w(x)
    return x


def resize_words_banded_plain(words: torch.Tensor, out_w: int, out_h: int,
                              method: str = "lanczos3") -> torch.Tensor:
    """Packed RGBA words (..., H, W) u32 to (..., out_h, out_w) u32: the
    R, G, B bytes as f32 planes through ``resize_f32_banded``, rounded
    half to even, clamped and repacked with opaque alpha."""
    planes = torch.stack([c.to(_F32) for c in unpack_rgba(words)], dim=-3)
    y = resize_f32_banded(planes, out_h, out_w, method)
    q = torch.clamp(torch.round(y), 0, 255)
    return pack_rgba(q[..., 0, :, :], q[..., 1, :, :], q[..., 2, :, :])


class KernelPlan(NamedTuple):
    """What one launch needs beyond the words, for one size change:
    ``itab`` int32 and ``ftab`` f32 on the device (the march axis's first
    and last inputs and weights, the cross axis's first inputs, tap
    counts and weights, the blocks' strips) and the launch's scalars."""
    itab: torch.Tensor
    ftab: torch.Tensor
    transposed: int   # 1: the march runs along the columns
    taps_march: int
    taps_cross: int
    strips: int
    strip_max: int
    ring: int         # 0: resize_taps, without strips
    smem_bytes: int


def _identity(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table of an axis that keeps its size: each output its own
    input, weight 1.0 (``0 + x * 1.0`` is ``x`` exactly)."""
    return (torch.arange(n, device=device),
            torch.ones((n, 1), dtype=_F32, device=device))


def _ring(first, last):
    """The smallest ring of ``RINGS`` that holds every output whose band
    a march row feeds (output ``o + ring`` starts after ``o`` ends), or
    None where an upscale beyond about 2.5x needs more."""
    n = len(first)
    for ring in RINGS:
        if n <= ring or all(first[o + ring] > last[o]
                            for o in range(n - ring)):
            return ring
    return None


def _strips(first, last, window: int):
    """Blocks' strips of the cross axis: (first input, first output, end
    output) each, the outputs whose bands lie inside ``window`` inputs
    from the strip's first, at most ``STRIP_MAX``; an even count but at
    the end, so a strip holds whole 4:2:0 quads. None where two bands do
    not fit the window (a downscale beyond about 73:1 at 512 columns)."""
    out, n, p = [], len(first), 0
    while p < n:
        c0, end = first[p], p
        while (end < n and end - p < STRIP_MAX
               and last[end] < c0 + window):
            end += 1
        if end < n:
            end -= (end - p) % 2
        if end == p:
            return None
        out.append((c0, p, end))
        p = end
    return out


def _spans(weights: torch.Tensor) -> torch.Tensor:
    """Each band's taps up to its last nonzero weight (0 for none)."""
    nz = weights != 0
    last = weights.shape[1] - nz.flip(1).int().argmax(1)
    return torch.where(nz.any(1), last, torch.zeros_like(last))


def _march_fit(march, cross, taps_m: int, taps_c: int):
    """(ring, strips, shared memory bytes) of the march over the bands
    ``march`` and ``cross``, each (first inputs, last inputs, spans), or
    None where it does not take them: it needs every band nonempty, the
    first and last inputs in order, the live outputs in its ring, two
    cross bands in a window and its shared memory on an SM."""
    for first, last, span in (march, cross):
        if not bool((span >= 1).all()) or any(
                b < a for a, b in zip(first, first[1:])) or any(
                b < a for a, b in zip(last, last[1:])):
            return None
    ring = _ring(*march[:2])
    if ring is None:
        return None
    window = THREADS * COLUMNS[ring]
    strips = _strips(*cross[:2], window)
    if strips is None:
        return None
    strip_max = max(e - p for _, p, e in strips)
    smem = 4 * (3 * ring * (window + 1) + BAND_ROWS * (taps_m + 2)
                + strip_max * (taps_c + 2))
    return (ring, strips, smem) if smem <= SMEM_MAX else None


@functools.lru_cache(maxsize=16)
def _plan_cached(h: int, w: int, out_h: int, out_w: int, method: str,
                 device: str) -> KernelPlan:
    dev = torch.device(device)
    ys = (band_table(h, out_h, method, dev) if out_h != h
          else _identity(h, dev))
    xs = (band_table(w, out_w, method, dev) if out_w != w
          else _identity(w, dev))
    transposed = out_h != h and out_w != w and not rows_first(
        h, w, out_h, out_w)
    (fm, wm), (fc, wc) = (xs, ys) if transposed else (ys, xs)
    span_m, span_c = _spans(wm), _spans(wc)
    march = (fm.tolist(), (fm + span_m - 1).tolist(), span_m)
    cross = (fc.tolist(), (fc + span_c - 1).tolist(), span_c)
    taps_m, taps_c = wm.shape[1], wc.shape[1]
    ints = march[0] + march[1] + cross[0] + span_c.tolist()
    fit = _march_fit(march, cross, taps_m, taps_c)
    ring, strips, smem = fit or (0, [], 0)
    ints += [v for s in strips for v in s]
    floats = torch.cat([wm.reshape(-1), wc.reshape(-1)]).to(_F32)
    return KernelPlan(torch.tensor(ints, dtype=torch.int32).to(dev),
                      floats.contiguous(), int(transposed), taps_m, taps_c,
                      len(strips), max((e - p for _, p, e in strips),
                                       default=0), ring, smem)


def kernel_plan(h: int, w: int, out_h: int, out_w: int,
                method: str = "lanczos3", device=None) -> KernelPlan:
    """The launch's tables and scalars for (h, w) to (out_h, out_w) on
    ``device``, built from ``band_table`` once and cached. The march runs
    down the rows where ``resize.rows_first`` (or a kept width) says the
    rows' pass comes first, else along the columns (``transposed``).
    Where the march does not take the change (``_march_fit``) the plan
    has ``ring`` 0 and no strips, and the launch runs ``resize_taps``."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}; expected one "
                         f"of {METHODS}")
    return _plan_cached(int(h), int(w), int(out_h), int(out_w), method,
                        str(torch.device(device or "cpu")))


def _check_words(words, out_w, out_h, output):
    if not isinstance(words, torch.Tensor) or words.dtype != torch.uint32:
        raise TypeError("words must be a torch.uint32 tensor")
    if words.dim() not in (2, 3) or 0 in words.shape:
        raise ValueError(f"words must be (H, W) or (N, H, W), got "
                         f"{tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output {output!r}")
    if out_w < 1 or out_h < 1:
        raise ValueError(f"output size {out_w}x{out_h}")
    if output == "ycbcr420" and (out_h % 2 or out_w % 2):
        raise ValueError("ycbcr420 output requires even out_h and out_w")


def resize_words(words: torch.Tensor, out_w: int, out_h: int,
                 method: str = "lanczos3", output: str = "rgba"):
    """The banded resize of (H, W) or (N, H, W) packed RGBA words to
    (out_h, out_w): u32 words of the input's rank, or for
    ``output="ycbcr420"`` (even out_h and out_w) the (Y, Cb, Cr) u8 planes
    of ``ops/jpeg.rgba_words_to_ycbcr420``. CPU tensors run the plain
    version; CUDA tensors launch the kernel (``launch_resize``), or
    raise."""
    _check_words(words, out_w, out_h, output)
    if words.device.type != "cpu":
        return launch_resize(words, out_w, out_h, method, output)
    out = resize_words_banded_plain(words, out_w, out_h, method)
    return out if output == "rgba" else _jpeg.rgba_words_to_ycbcr420(out)


def launch_resize(words: torch.Tensor, out_w: int, out_h: int,
                  method: str = "lanczos3", output: str = "rgba"):
    """One launch of the kernel over (H, W) or (N, H, W) contiguous CUDA
    words. Returns what ``resize_words`` returns; raises for any other
    device."""
    _check_words(words, out_w, out_h, output)
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"the resize kernel runs on CUDA tensors, not {dev}")
    lead = words.shape[:-2]
    batch = words.reshape((-1,) + tuple(words.shape[-2:]))
    n, h, w = batch.shape
    from raweditor_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        plan = kernel_plan(h, w, out_h, out_w, method, dev)
        if output == "rgba":
            outs = [torch.empty((n, out_h, out_w), dtype=torch.uint32,
                                device=dev)]
        else:
            outs = [torch.empty((n, out_h, out_w), dtype=torch.uint8,
                                device=dev)] + [
                torch.empty((n, out_h // 2, out_w // 2), dtype=torch.uint8,
                            device=dev) for _ in range(2)]
        ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
        code = lib.rtt_resize_launch(
            batch.data_ptr(), plan.itab.data_ptr(), plan.ftab.data_ptr(),
            *ptrs, n, h, w, out_h, out_w, plan.transposed, plan.taps_march,
            plan.taps_cross, plan.strips, plan.strip_max, plan.ring,
            OUTPUTS[output], plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"resize kernel ({h}x{w} to {out_h}x{out_w}, "
                            f"{output})")
    LAUNCHES[_LAUNCH_KEY[output]] += 1
    if output == "rgba":
        return outs[0].reshape(lead + (out_h, out_w))
    return tuple(o.reshape(lead + tuple(o.shape[1:])) for o in outs)
