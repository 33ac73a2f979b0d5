"""The finish-extras post-pass kernel: HSL mixer, colour grading, chroma
and luma denoise, tone curve, vignette and sharpen over packed RGBA
words, with RGBA words or JPEG YCbCr 4:2:0 planes as output.

Port of the TPU kernel ``raweditor_tpu/ops/pallas_develop.py``
(``pallas_finish_extras_rgba`` -> ``_extras_kernel_flat`` ->
``_extras_window``, which runs ``ops/extras.extras_core``). It runs after
any develop lane, on the words the develop wrote: the engine's
full-resolution develop, JPEG planes and export, and the batch route
``fused_batch_develop_rgba(..., output="rgba")`` then
``fused_finish_extras_rgba(..., output="ycbcr420")``. The kernel is CUDA
C++ for sm_90a (``csrc/extras.cu``, built by ``ops/_build.py``): with
``stencils`` a warp marches down a strip of 60 output columns in bands of
64 rows with every stage in registers (``csrc/band_march.cuh``), without
them a thread per 2x2 quad runs the pointwise heads. Beside it:

- ``pack_extras``: the (N, 38) f32 per-image table (``EXTRAS_COLUMNS``)
  and the three static flags of a list of edits, as the JAX engine's
  ``_extras_post`` and the exporter's ``_extras_post_batch`` build
  theirs: ``mixer_on`` and ``grading_on`` when any image uses the mixer
  or grading, ``stencils`` when any image has a non-zero sharpen,
  denoise, tone-curve or vignette amount;
- ``finish_extras_plain``: the kernel's function in plain PyTorch ops
  (``ops/extras.py`` with the table's columns as (N, 1, 1) amounts). The
  wrapper runs it for CPU tensors; the card comparisons hold the kernel
  against it;
- ``LAUNCHES``: launches per output, ``extras_rgba`` and
  ``extras_ycbcr420``.

For a CUDA tensor the wrapper launches the kernel or raises; nothing
falls back to the plain version there.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.yardstick.ops import extras as _extras
from bench_torch.yardstick.ops.develop import pack_rgba
from bench_torch.yardstick.ops.fused_develop import emit_ycbcr420
from bench_torch.yardstick.params import GRADE_FIELDS, MIXER_FIELDS

#: The table's columns, one row per image: the JAX kernel's 7 base
#: columns, then always the 24 mixer and the 7 grading amounts (the
#: flags say which of them the kernel reads).
EXTRAS_COLUMNS = (("sharpen", "denoise", "curve_shadows", "curve_darks",
                   "curve_lights", "curve_highlights", "vignette")
                  + MIXER_FIELDS + GRADE_FIELDS)
N_EXTRAS = len(EXTRAS_COLUMNS)
MIXER_COL = 7
GRADING_COL = MIXER_COL + len(MIXER_FIELDS)
OUTPUTS = {"rgba": 0, "ycbcr420": 1}
# Launch counts: the wrapper adds one where it launches its kernel.
LAUNCHES = {"extras_" + o: 0 for o in OUTPUTS}


def pack_extras(params_list):
    """(table, mixer_on, grading_on, stencils) of a list of edits: the
    (N, 38) f32 CPU table in ``EXTRAS_COLUMNS`` order and the static
    flags. A non-zero clarity, dehaze or grain raises
    ``NotImplementedError`` (whole-frame stages, not ported yet)."""
    for p in params_list:
        _extras.require_band_local(p.clarity, p.dehaze,
                                   (p.grain, p.grain_size))
    table = torch.tensor(
        np.array([[float(getattr(p, name)) for name in EXTRAS_COLUMNS]
                  for p in params_list], np.float32).reshape(-1, N_EXTRAS))
    stencils = bool((table[:, :MIXER_COL] != 0).any())
    return (table, any(p.has_mixer() for p in params_list),
            any(p.has_grading() for p in params_list), stencils)


def finish_extras_plain(words: torch.Tensor, table: torch.Tensor,
                        mixer_on: bool, grading_on: bool, stencils: bool,
                        output: str = "rgba"):
    """The kernel's function in plain PyTorch ops, on any device.

    words (N, H, W) u32, table (N, 38) f32. Returns (N, H, W) u32 RGBA
    words, or for ``output="ycbcr420"`` (Y (N, H, W) u8, CbCr
    (N, H/2, W) u8 with Cb at even and Cr at odd columns)."""
    cols = [c[:, None, None] for c in table.to(torch.float32).unbind(1)]
    r, g, b = _extras.apply_finish_extras(
        *_extras.words_to_planes(words), cols[0], cols[1], tuple(cols[2:6]),
        cols[6],
        mixer=tuple(cols[MIXER_COL:GRADING_COL]) if mixer_on else None,
        grading=tuple(cols[GRADING_COL:]) if grading_on else None,
        stencils=stencils)
    rq, gq, bq = (_extras.quantize(c) for c in (r, g, b))
    if output == "rgba":
        return pack_rgba(rq, gq, bq)
    return emit_ycbcr420(rq, gq, bq)


def _check_inputs(words, table, output):
    if not isinstance(words, torch.Tensor) or words.dtype != torch.uint32:
        raise TypeError("words must be a torch.uint32 tensor")
    if words.dim() != 3 or 0 in words.shape:
        raise ValueError(f"words must be (N, H, W), got {tuple(words.shape)}")
    n, h, w = words.shape
    if not isinstance(table, torch.Tensor) or table.dtype != torch.float32:
        raise TypeError("the extras table must be a torch.float32 tensor")
    if tuple(table.shape) != (n, N_EXTRAS):
        raise ValueError(f"the extras table must be ({n}, {N_EXTRAS}), got "
                         f"{tuple(table.shape)}")
    if table.device != words.device:
        raise ValueError("words and the extras table must be on one device")
    if not (words.is_contiguous() and table.is_contiguous()):
        raise ValueError("words and the extras table must be contiguous")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output {output!r}")
    if output == "ycbcr420" and (h % 2 or w % 2):
        raise ValueError("ycbcr420 output requires even H and W")


def fused_finish_extras_rgba(words: torch.Tensor, table: torch.Tensor, *,
                             mixer_on: bool, grading_on: bool,
                             stencils: bool, output: str = "rgba"):
    """The finish-extras post-pass over packed RGBA words.

    words (H, W) or (N, H, W) u32 and the table (N_EXTRAS,) or
    (N, N_EXTRAS) f32 of per-image amounts (``pack_extras``), contiguous,
    on one device. ``mixer_on``, ``grading_on`` and ``stencils`` are the
    static flags. Returns the words' shape in u32 RGBA words, or for
    ``output="ycbcr420"`` (even H and W) the Y (..., H, W) u8 and
    NV12-interleaved CbCr (..., H/2, W) u8 planes. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    single = isinstance(words, torch.Tensor) and words.dim() == 2
    if single:
        words = words[None]
        table = table.reshape(1, -1)
    _check_inputs(words, table, output)
    dev = words.device
    if dev.type == "cpu":
        out = finish_extras_plain(words, table, mixer_on, grading_on,
                                  stencils, output)
    elif dev.type == "cuda":
        out = _launch(words, table, bool(mixer_on), bool(grading_on),
                      bool(stencils), output)
    else:
        raise ValueError(f"unsupported device {dev}")
    if not single:
        return out
    return out[0] if output == "rgba" else (out[0][0], out[1][0])


def _launch(words, table, mixer_on, grading_on, stencils, output):
    from bench_torch.yardstick.ops import _build

    lib = _build.load()
    dev = words.device
    n, h, w = words.shape
    cy, cx, icy, icx = (float(v) for v in _extras.radial_consts(h, w))
    with torch.cuda.device(dev):
        if output == "rgba":
            out0 = torch.empty((n, h, w), dtype=torch.uint32, device=dev)
            out1 = None
        else:
            out0 = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
            out1 = torch.empty((n, h // 2, w), dtype=torch.uint8, device=dev)
        code = lib.rtt_extras_launch(
            words.data_ptr(), table.data_ptr(), out0.data_ptr(),
            None if out1 is None else out1.data_ptr(), n, h, w,
            int(mixer_on), int(grading_on), int(stencils), OUTPUTS[output],
            cy, cx, icy, icx, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"extras kernel ({output})")
    LAUNCHES["extras_" + output] += 1
    return out0 if output == "rgba" else (out0, out1)
