"""The parity develop chain in plain PyTorch: the reference editor's
fragment shader, step for step.

demosaic, white balance, temperature/tint, colour matrix, exposure,
highlights/shadows, contrast, levels, saturation, vibrance, transfer,
quantise. Every step keeps the JAX package's f32 operation order, so
this lane aims to match ``raweditor_tpu.ops.develop`` bit for bit; its
floor is 1 LSB of 8-bit output. The quirks are the reference's:

- /4096 normalisation by default (``white_level``);
- temperature/tint as +-0.3 linear channel gains;
- the WGSL ``mat3x3`` transpose in parity mode (``matrix_transpose``);
- one luminance read drives highlights and shadows;
- the levels epsilon 1e-4;
- quantisation ``floor(c*255 + 0.5)``.

Tensors keep the JAX layouts: (H, W) u16 mosaic in, (H, W) u32 packed
RGBA or (H, W, 3) u8 out, (3, 256) histograms. Everything runs on the
device of the mosaic.
"""

from __future__ import annotations

import numpy as np
import torch

from raweditor_tpu_torch.color import encoder_for
from raweditor_tpu_torch.ops import demosaic as _demosaic
from raweditor_tpu_torch.ops import sampling as _sampling
from raweditor_tpu_torch.params import EditParams

_F32 = torch.float32


def f32(x) -> float:
    """A Python float holding exactly the f32 value of ``x``."""
    return float(np.float32(x))


LUMA = (f32(0.2126), f32(0.7152), f32(0.0722))  # Rec.709
_SLIDERS = ("exposure", "contrast", "highlights", "shadows", "whites",
            "blacks", "vibrance", "saturation", "temperature", "tint")


def u16_to_f32(t: torch.Tensor) -> torch.Tensor:
    """u16 (or its int16 view) to f32 values 0..65535, through int16,
    which every backend supports for indexing and conversion."""
    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    if t.dtype != torch.int16:
        raise TypeError(f"expected a u16 mosaic, got {t.dtype}")
    return torch.bitwise_and(t.to(torch.int32), 0xFFFF).to(_F32)


def require_ported(params: EditParams, extras=False) -> None:
    """Raise ``NotImplementedError`` for edits this port cannot render
    yet (they are never skipped silently)."""
    if extras or params.has_finish_extras():
        raise NotImplementedError("not ported yet: finish extras")
    if params.locals:
        raise NotImplementedError("not ported yet: local adjustments")
    if params.point_curve:
        raise NotImplementedError("not ported yet: point curve")
    if float(params.highlight_recovery):
        raise NotImplementedError("not ported yet: highlight recovery")


def _scalars(params: EditParams, device):
    """The ten sliders as f32 0-d tensors on ``device`` (one copy)."""
    vals = torch.tensor([float(getattr(params, n)) for n in _SLIDERS],
                        dtype=_F32, device=device)
    return dict(zip(_SLIDERS, vals.unbind(0)))


def _normalize(mosaic: torch.Tensor, white_level, black_level=0.0):
    """(raw - black) / (white - black) in f32; parity passes 4096, 0."""
    x = u16_to_f32(mosaic) if mosaic.dtype in (torch.uint16,
                                               torch.int16) else mosaic
    lv = torch.tensor([white_level, black_level], dtype=_F32,
                      device=x.device)
    white, black = lv[0], lv[1]
    return (x - black) / (white - black)


def apply_edit_stack(r, g, b, params: EditParams, wb, cam_matrix,
                     matrix_transpose: bool = True):
    """Steps 2-9 of the shader chain on linear camera-RGB planes;
    returns linear planes before the transfer."""
    dev = r.device
    p = _scalars(params, dev)
    wb = torch.as_tensor(np.asarray(wb, np.float32), device=dev)
    m = torch.as_tensor(np.asarray(cam_matrix, np.float32).reshape(3, 3),
                        device=dev)
    if matrix_transpose:
        m = m.T

    r = r * wb[0]
    g = g * wb[1]
    b = b * wb[2]

    r = r * (1.0 + p["temperature"] * f32(0.3))
    b = b * (1.0 - p["temperature"] * f32(0.3))
    g = g * (1.0 + p["tint"] * f32(0.3))

    r2 = m[0, 0] * r + m[0, 1] * g + m[0, 2] * b
    g2 = m[1, 0] * r + m[1, 1] * g + m[1, 2] * b
    b2 = m[2, 0] * r + m[2, 1] * g + m[2, 2] * b
    r, g, b = r2, g2, b2

    ex = torch.exp2(p["exposure"])
    r, g, b = r * ex, g * ex, b * ex

    lum = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    tone = (1.0 + lum * p["highlights"]) * (1.0 + (1.0 - lum) * p["shadows"])
    r, g, b = r * tone, g * tone, b * tone

    cf = 1.0 + p["contrast"] / 100.0
    r = (r - 0.5) * cf + 0.5
    g = (g - 0.5) * cf + 0.5
    b = (b - 0.5) * cf + 0.5

    inv_range = 1.0 / (p["whites"] - p["blacks"] + f32(0.0001))
    r = (r - p["blacks"]) * inv_range
    g = (g - p["blacks"]) * inv_range
    b = (b - p["blacks"]) * inv_range

    luma = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    sf = 1.0 + p["saturation"] / 100.0
    r = luma + (r - luma) * sf
    g = luma + (g - luma) * sf
    b = luma + (b - luma) * sf

    mx = torch.maximum(r, torch.maximum(g, b))
    mn = torch.minimum(r, torch.minimum(g, b))
    amount = p["vibrance"] * (1.0 - (mx - mn))
    luma = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    vf = 1.0 + amount
    r = luma + (r - luma) * vf
    g = luma + (g - luma) * vf
    b = luma + (b - luma) * vf
    return r, g, b


def finish_to_u8(r, g, b, valid=None, transfer: str = "gamma22",
                 extras=None, point_curve=None):
    """Transfer, clamp at 1, ``floor(c*255 + 0.5)``; ``valid`` masks
    out-of-frame samples to black. Returns three u8 planes."""
    if extras is not None or point_curve:
        raise NotImplementedError(
            "not ported yet: finish extras and point curve")
    encode = encoder_for(transfer)

    def quant(c):
        q = torch.floor(torch.clamp_max(encode(c), 1.0) * 255.0 + 0.5)
        if valid is not None:
            q = torch.where(valid, q, 0.0)
        return q.to(torch.uint8)

    return quant(r), quant(g), quant(b)


def pack_rgba(r8, g8, b8) -> torch.Tensor:
    """Three u8 planes to packed RGBA u32 words (R in the low byte,
    alpha 0xFF). The shifts run in int64 (uint32 has no shift on the
    CPU); every word has its top bit set, so ``word - 2**32`` fits int32
    and is reinterpreted as u32."""
    word = (r8.to(torch.int64) | (g8.to(torch.int64) << 8)
            | (b8.to(torch.int64) << 16) | 0xFF000000)
    return (word - (1 << 32)).to(torch.int32).view(torch.uint32)


def unpack_rgba(words: torch.Tensor):
    """Packed RGBA u32 words to (r, g, b) int64 planes."""
    w = torch.bitwise_and(words.view(torch.int32).to(torch.int64),
                          0xFFFFFFFF)
    return w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF


def finish_to_rgba_u32(r, g, b, valid=None, transfer: str = "gamma22",
                       extras=None, point_curve=None):
    """``finish_to_u8`` packed into one u32 RGBA word per pixel."""
    return pack_rgba(*finish_to_u8(r, g, b, valid=valid, transfer=transfer,
                                   extras=extras, point_curve=point_curve))


def rgba_view(words) -> np.ndarray:
    """Host (..., W, 4) u8 view of (..., W) u32 RGBA words."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    arr = np.ascontiguousarray(words)
    return arr.view(np.uint8).reshape(arr.shape + (4,))


def _linear_planes(mosaic, params, wb, cam_matrix, white_level,
                   black_level, demosaic_method, matrix_transpose,
                   cfa_phase, extras):
    require_ported(params, extras)
    norm = _normalize(mosaic, white_level, black_level)
    r, g, b = _demosaic.demosaic(norm, demosaic_method, cfa_phase)
    return apply_edit_stack(r, g, b, params, wb, cam_matrix,
                            matrix_transpose)


def develop(mosaic, params: EditParams, wb, cam_matrix, white_level=4096.0,
            black_level=0.0, demosaic_method: str = "nearest",
            matrix_transpose: bool = True, transfer: str = "gamma22",
            cfa_phase=(0, 0), extras=False):
    """Full-resolution develop: (H, W) u16 to (H, W, 3) u8."""
    r, g, b = _linear_planes(mosaic, params, wb, cam_matrix, white_level,
                             black_level, demosaic_method,
                             matrix_transpose, cfa_phase, extras)
    return torch.stack(finish_to_u8(r, g, b, transfer=transfer), dim=-1)


def develop_rgba(mosaic, params: EditParams, wb, cam_matrix,
                 white_level=4096.0, black_level=0.0,
                 demosaic_method: str = "nearest",
                 matrix_transpose: bool = True, transfer: str = "gamma22",
                 cfa_phase=(0, 0), extras=False):
    """Full-resolution develop to packed RGBA: (H, W) u16 to (H, W) u32."""
    r, g, b = _linear_planes(mosaic, params, wb, cam_matrix, white_level,
                             black_level, demosaic_method,
                             matrix_transpose, cfa_phase, extras)
    return finish_to_rgba_u32(r, g, b, transfer=transfer)


def develop_u8(mosaic, params, wb, cam_matrix, **kwargs) -> np.ndarray:
    """``develop`` returned as a host numpy (H, W, 3) u8 array."""
    return develop(mosaic, params, wb, cam_matrix, **kwargs).cpu().numpy()


def develop_preview(mosaic, params: EditParams, wb, cam_matrix, out_w: int,
                    out_h: int, zoom=1.0, pan_x=0.0, pan_y=0.0,
                    white_level=4096.0, black_level=0.0,
                    matrix_transpose: bool = True,
                    transfer: str = "gamma22", cfa_phase=(0, 0),
                    extras=False):
    """Preview at (out_h, out_w) with zoom/pan: nearest-sample the
    mosaic at output pixel centres and develop only those sites.
    The taps are gathered first and normalised after (normalisation is
    elementwise, so the values equal a normalise-then-gather).
    Returns (out_h, out_w, 3) u8."""
    require_ported(params, extras)
    h, w = mosaic.shape
    dev = mosaic.device
    xi, xvalid = _sampling.sample_axis(out_w, w, zoom, pan_x, dev)
    yi, yvalid = _sampling.sample_axis(out_h, h, zoom, pan_y, dev)
    valid = yvalid[:, None] & xvalid[None, :]
    src = mosaic.view(torch.int16) if mosaic.dtype == torch.uint16 else mosaic
    taps = _demosaic.demosaic_nearest_sampled(src, yi, xi, cfa_phase)
    r, g, b = (_normalize(t, white_level, black_level) for t in taps)
    r, g, b = apply_edit_stack(r, g, b, params, wb, cam_matrix,
                               matrix_transpose)
    return torch.stack(finish_to_u8(r, g, b, valid=valid, transfer=transfer),
                       dim=-1)


def histogram_256(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 image to (3, 256) int32 per-channel counts, R, G, B."""
    flat = rgb_u8.reshape(-1, 3).to(torch.int64)
    return torch.stack([torch.bincount(flat[:, c], minlength=256)
                        for c in range(3)]).to(torch.int32)


def develop_histogram(mosaic, params: EditParams, wb, cam_matrix,
                      out_w: int, out_h: int, zoom=1.0, pan_x=0.0,
                      pan_y=0.0, white_level=4096.0, black_level=0.0,
                      matrix_transpose: bool = True,
                      transfer: str = "gamma22", cfa_phase=(0, 0),
                      extras=False):
    """The live histogram: a small sampled render, binned."""
    return histogram_256(develop_preview(
        mosaic, params, wb, cam_matrix, out_w, out_h, zoom, pan_x, pan_y,
        white_level, black_level, matrix_transpose, transfer, cfa_phase,
        extras))
