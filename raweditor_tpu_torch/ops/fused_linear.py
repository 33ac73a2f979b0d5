"""The LinearRaw develop kernel: a batch of already demosaiced (N, H, W, 3)
u16 frames (DNG LinearRaw) to packed RGBA words or JPEG YCbCr 4:2:0
planes in one launch, bit for bit the plain lane's output.

The plain lane (``parallel/batch.batch_develop_linear_rgba``: ``ops/
develop.develop_linear`` an image, then ``ops/jpeg.rgba_words_to_ycbcr420``
over the stacked words) is the function; the kernel (CUDA C++ for sm_90a,
``csrc/linear.cu``, built by ``ops/_build.py``) runs it in the lane's own
operation order, not the folded order of the CFA kernels
(``fused_develop.fold_scalars``, up to 1 LSB from the lane). Beside it:

- ``pack_linear_params``: the (N, 25) f32 per-image scalars in
  ``SCALAR_SLOTS`` order, computed by the lane's own torch operations on
  the frames' device, so each is the f32 value the lane multiplies or
  divides by there (on the card ``x / 100.0`` is a multiply by the
  reciprocal, and ``exp2`` rounds as the card's does);
- ``lane_quant_table``: the transfer-and-quantise map of the lane's
  ``finish_to_u8`` (``_lane_quantize``) as the develop kernels' exact
  table (``fused_develop.QuantTable``), derived by that function on the
  kernel's device at first use and cached; ``linear_quantize`` runs the
  table's lookup over any f32 values, the check that it equals
  ``_lane_quantize``;
- ``launch_linear``: one launch of the kernel over the frames and their
  packed scalars, CUDA tensors only;
- ``LAUNCHES``: launches per output, ``linear_rgba`` and
  ``linear_ycbcr420``.

The wrapper, ``fused_batch_develop_linear``, takes the lane's own
inputs: for CPU tensors it runs the lane itself, for CUDA tensors it
launches the kernel or raises; nothing falls back to the lane there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raweditor_tpu_torch.color import KERNEL_GAMMA_BY_TRANSFER, encoder_for
from raweditor_tpu_torch.ops import fused_develop as _fd
from raweditor_tpu_torch.ops.develop import _SLIDERS, f32
from raweditor_tpu_torch.ops.jpeg import rgba_words_to_ycbcr420
from raweditor_tpu_torch.parallel.batch import batch_develop_linear_rgba

#: The kernel's per-image scalars (``enum Slot`` in csrc/linear.cu).
SCALAR_SLOTS = ("black", "range", "wb_r", "wb_g", "wb_b", "temp_r", "tint",
                "temp_b", *(f"m{i}{j}" for i in range(3) for j in range(3)),
                "exposure", "highlights", "shadows", "contrast", "blacks",
                "inv_range", "saturation", "vibrance")
N_LINEAR_SCALARS = len(SCALAR_SLOTS)
OUTPUTS = {"rgba": 0, "ycbcr420": 1}
#: The kernels' gamma lane to the lane's transfer name.
TRANSFER_BY_GAMMA = {g: t for t, g in KERNEL_GAMMA_BY_TRANSFER.items()}
# Launch counts: the wrapper adds one where it launches its kernel.
LAUNCHES = {"linear_" + o: 0 for o in OUTPUTS}


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """``torch.exp2`` of each value as the lane takes it, of a 0-d tensor:
    the CPU's vector loop rounds otherwise than its scalar one; the card's
    kernel is one function for both."""
    if x.device.type == "cpu":
        return torch.stack([torch.exp2(v) for v in x.unbind()])
    return torch.exp2(x)


def pack_linear_params(params_list, wbs, cam_matrices, white_levels,
                       black_levels, matrix_transpose: bool = False,
                       device="cpu") -> torch.Tensor:
    """(N, N_LINEAR_SCALARS) f32 on ``device``: each image's scalars in
    ``SCALAR_SLOTS`` order, by ``ops/develop``'s operations
    (``_normalize``, ``apply_edit_stack``) over the batch's columns.
    ``wbs`` (N, 3), ``cam_matrices`` (N, 3, 3) (transposed with
    ``matrix_transpose``, as the lane does), levels (N,). One upload."""
    n = len(params_list)
    cms = np.asarray(cam_matrices, np.float32).reshape(n, 3, 3)
    if matrix_transpose:
        cms = cms.transpose(0, 2, 1)
    host = np.concatenate([
        np.asarray(white_levels, np.float32).reshape(n, 1),
        np.asarray(black_levels, np.float32).reshape(n, 1),
        np.asarray([[float(getattr(p, s)) for s in _SLIDERS]
                    for p in params_list], np.float32).reshape(n, 10),
        np.asarray(wbs, np.float32).reshape(n, 3),
        cms.reshape(n, 9)], axis=1)
    v = torch.from_numpy(np.ascontiguousarray(host)).to(device)
    white, black = v[:, 0], v[:, 1]
    p = dict(zip(_SLIDERS, v[:, 2:12].unbind(1)))
    cols = {
        "black": black,
        "range": white - black,
        "temp_r": 1.0 + p["temperature"] * f32(0.3),
        "tint": 1.0 + p["tint"] * f32(0.3),
        "temp_b": 1.0 - p["temperature"] * f32(0.3),
        "exposure": _exp2(p["exposure"]),
        "highlights": p["highlights"],
        "shadows": p["shadows"],
        "contrast": 1.0 + p["contrast"] / 100.0,
        "blacks": p["blacks"],
        "inv_range": 1.0 / (p["whites"] - p["blacks"] + f32(0.0001)),
        "saturation": 1.0 + p["saturation"] / 100.0,
        "vibrance": p["vibrance"],
    }
    for i, c in enumerate("rgb"):
        cols["wb_" + c] = v[:, 12 + i]
    for k in range(9):
        cols[f"m{k // 3}{k % 3}"] = v[:, 15 + k]
    return torch.stack([cols[s] for s in SCALAR_SLOTS], dim=1)


def _lane_quantize(c: torch.Tensor, gamma: str) -> torch.Tensor:
    """``finish_to_u8``'s transfer, clamp at 1 and ``floor(c*255 + 0.5)``
    for the kernels' gamma lane ``gamma``, as f32 codes."""
    encode = encoder_for(TRANSFER_BY_GAMMA[gamma])
    return torch.floor(torch.clamp_max(encode(c), 1.0) * 255.0 + 0.5)


@functools.lru_cache(maxsize=None)
def lane_quant_table(gamma: str, device: torch.device):
    """(QuantTable, its packed bytes as a uint8 tensor on ``device``) of
    the lane's quantiser for ``gamma``, derived by ``_lane_quantize`` on
    ``device`` at first use and cached per transfer and device."""
    if gamma not in TRANSFER_BY_GAMMA:
        raise ValueError(f"unknown gamma {gamma!r}")
    thresholds = _fd.quant_thresholds(gamma, device, _lane_quantize)
    table = _fd.QuantTable(thresholds, _fd.quant_exceptions(
        gamma, thresholds, _lane_quantize))
    data = torch.frombuffer(bytearray(table.packed), dtype=torch.uint8)
    return table, data.to(device)


def _check_frames(frames, n, gamma, output):
    if not isinstance(frames, torch.Tensor) or frames.dtype != torch.uint16:
        raise TypeError("frames must be a torch.uint16 tensor")
    if frames.dim() != 4 or frames.shape[-1] != 3 or 0 in frames.shape:
        raise ValueError(
            f"frames must be (N, H, W, 3), got {tuple(frames.shape)}")
    if frames.shape[0] != n:
        raise ValueError(f"{frames.shape[0]} frames for {n} images")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if gamma not in TRANSFER_BY_GAMMA:
        raise ValueError(f"unknown gamma {gamma!r}")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output {output!r}")
    if output == "ycbcr420" and (frames.shape[1] % 2 or frames.shape[2] % 2):
        raise ValueError("ycbcr420 output requires even H and W")


def fused_batch_develop_linear(frames: torch.Tensor, params_list, wbs,
                               cam_matrices, white_levels, black_levels,
                               matrix_transpose: bool = False,
                               gamma: str = "pow", output: str = "rgba"):
    """The LinearRaw develop of a batch: frames (N, H, W, 3) u16,
    contiguous, with the plain lane's per-image inputs
    (``batch_develop_linear_rgba``'s); ``gamma`` the transfer lane ("pow",
    "poly", "srgb", "srgb_poly"). Returns (N, H, W) u32 RGBA words, or for
    ``output="ycbcr420"`` (even H and W) the Y (N, H, W) u8 and
    NV12-interleaved CbCr (N, H/2, W) u8 planes. CPU tensors run the plain
    lane itself; CUDA tensors launch the kernel (``launch_linear``) over
    the scalars ``pack_linear_params`` computes on the card, or raise."""
    _check_frames(frames, len(params_list), gamma, output)
    if frames.device.type != "cpu":
        scal = pack_linear_params(params_list, wbs, cam_matrices,
                                  white_levels, black_levels,
                                  matrix_transpose, device=frames.device)
        return launch_linear(frames, scal, gamma, output)
    words = batch_develop_linear_rgba(
        frames, params_list, wbs, cam_matrices, white_levels, black_levels,
        matrix_transpose=matrix_transpose, transfer=TRANSFER_BY_GAMMA[gamma])
    if output == "rgba":
        return words
    y, cb, cr = rgba_words_to_ycbcr420(words)
    n, h, w = words.shape
    return y, torch.stack([cb, cr], dim=-1).reshape(n, h // 2, w)


def launch_linear(frames: torch.Tensor, scal: torch.Tensor,
                  gamma: str = "pow", output: str = "rgba"):
    """One launch of the kernel: frames (N, H, W, 3) u16 and scal
    (N, N_LINEAR_SCALARS) f32 (``pack_linear_params``), contiguous CUDA
    tensors on one device. Returns what ``fused_batch_develop_linear``
    returns; raises for any other device."""
    if not isinstance(scal, torch.Tensor) or scal.dtype != torch.float32:
        raise TypeError("scalars must be a torch.float32 tensor")
    _check_frames(frames, scal.shape[0], gamma, output)
    n, h, w, _ = frames.shape
    if tuple(scal.shape) != (n, N_LINEAR_SCALARS):
        raise ValueError(f"scalars must be ({n}, {N_LINEAR_SCALARS}), got "
                         f"{tuple(scal.shape)}")
    if scal.device != frames.device:
        raise ValueError("frames and scalars must be on one device")
    if not scal.is_contiguous():
        raise ValueError("scalars must be contiguous")
    dev = frames.device
    if dev.type != "cuda":
        raise ValueError(f"the LinearRaw kernel runs on CUDA tensors, not "
                         f"{dev}")
    from raweditor_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        quant = lane_quant_table(gamma, dev)[1].data_ptr()
        if output == "rgba":
            out0 = torch.empty((n, h, w), dtype=torch.uint32, device=dev)
            out1 = None
        else:
            out0 = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
            out1 = torch.empty((n, h // 2, w), dtype=torch.uint8, device=dev)
        code = lib.rtt_linear_launch(
            frames.data_ptr(), scal.data_ptr(), out0.data_ptr(),
            None if out1 is None else out1.data_ptr(), n, h, w,
            OUTPUTS[output], quant, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"LinearRaw develop kernel ({output}, {gamma})")
    LAUNCHES["linear_" + output] += 1
    return out0 if output == "rgba" else (out0, out1)


def linear_quantize(c: torch.Tensor, gamma: str = "pow") -> torch.Tensor:
    """The u8 codes of f32 ``c`` (any shape, contiguous) under the lane's
    transfer ``gamma``: on the card the table quantiser over every value
    with ``lane_quant_table`` (a check of the table, not a kernel of the
    develop path), on the CPU ``_lane_quantize``. Returns uint8 of ``c``'s
    shape."""
    return _fd.table_quantize(c, gamma, lane_quant_table, _lane_quantize)
