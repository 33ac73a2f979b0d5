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

After the transfer come, when the edit sets them, the point curve per
channel (``ops/curve.py``) and the finish extras (``ops/extras.py``:
HSL mixer, colour grading, denoise, tone curve, vignette, sharpen), in
the chain before quantisation, as the JAX functions run them. The
``extras`` argument of the entry points is the JAX one: pass
``params.finish_extras_mode()``.

``develop_xtrans``, ``develop_xtrans_preview`` and
``develop_xtrans_histogram`` are the same chain over a square repeating
CFA (the 6x6 X-Trans grid by default) with the generic-CFA demosaics of
``ops/cfa_generic.py``: ``"nearest"``, ``"smooth"`` or ``"grad"``.

``develop_linear``, ``develop_linear_preview`` and
``develop_linear_histogram`` are the same chain over an already
demosaiced (H, W, 3) u16 frame (DNG LinearRaw): each channel plane is
normalised on its own and no demosaic runs.

``demosaic_method`` selects the demosaic of ``develop``,
``develop_rgba`` and ``develop_u8``: the parity stencil ``"nearest"``,
or the accurate lane's ``"bilinear"``, ``"malvar"`` and ``"grad"``
(``ops/demosaic.py``, ``ops/cfa_generic.py``), each the JAX package's
XLA lane operation for operation. The preview and histogram always
sample the nearest stencil, as the JAX package's do.

Tensors keep the JAX layouts: (H, W) u16 mosaic in, (H, W) u32 packed
RGBA or (H, W, 3) u8 out, (3, 256) histograms. Everything runs on the
device of the mosaic.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.yardstick.color import encoder_for
from bench_torch.yardstick.ops import demosaic as _demosaic
from bench_torch.yardstick.ops import sampling as _sampling
from bench_torch.yardstick.params import EditParams

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
    """Raise ``NotImplementedError``, naming the field, for edits this
    port cannot render yet (they are never skipped silently): clarity,
    dehaze, grain and local adjustments. Highlight recovery is not a
    stage of these functions: the engine and the exporter reconstruct
    the mosaic before they develop it (``ops/highlights.py``)."""
    for name in ("clarity", "dehaze", "grain"):
        if float(getattr(params, name)):
            raise NotImplementedError(f"not ported yet: {name}")
    if params.locals:
        raise NotImplementedError("not ported yet: local adjustments")
    _extras_of(params, extras)


def _extras_of(params: EditParams, extras):
    """The (sharpen, denoise, curve 4-tuple, vignette, clarity, dehaze,
    mixer, grading, grain, stencils) amounts for the finish stage, or
    None: the positional contract of
    ``apply_finish_extras(r, g, b, *extras)``.

    ``extras`` is the JAX develop functions' static mode: False/None is
    off; otherwise a "+"-joined string of parts from
    ``EditParams.finish_extras_mode()``: "base" (the stencil stages),
    "mixer", "grading". The parts that run clarity or dehaze ("full",
    and the legacy ``True``) or grain raise ``NotImplementedError``."""
    if not extras:
        return None
    if extras is True:
        raise NotImplementedError(
            "not ported yet: clarity (extras=True is the full mode, which "
            "runs the clarity pass)")
    parts = set(extras.split("+"))
    if "full" in parts:
        raise NotImplementedError("not ported yet: "
                                  + ("dehaze" if float(params.dehaze)
                                     else "clarity"))
    if "grain" in parts:
        raise NotImplementedError("not ported yet: grain")
    return (params.sharpen, params.denoise,
            (params.curve_shadows, params.curve_darks,
             params.curve_lights, params.curve_highlights),
            params.vignette, 0.0, 0.0,
            params.mixer_values() if "mixer" in parts else None,
            params.grading_values() if "grading" in parts else None,
            None, "base" in parts)


def _point_curve_of(params: EditParams):
    """``params.point_curve`` as the finish stage's ``point_curve``: the
    (x, y) tuple, or None when empty."""
    return tuple(params.point_curve) or None


def _scalars(params: EditParams, device):
    """The ten sliders as f32 0-d tensors on ``device`` (one copy)."""
    vals = torch.tensor([float(getattr(params, n)) for n in _SLIDERS],
                        dtype=_F32, device=device)
    return dict(zip(_SLIDERS, vals.unbind(0)))


def _square_period(pat: str) -> int:
    """Side length of a square repeating-CFA pattern string; the
    generic-CFA entry points take square periods only."""
    side = int(len(pat) ** 0.5)
    if side * side != len(pat):
        raise ValueError(
            f"repeating-CFA pattern length {len(pat)} is not square; "
            "only NxN patterns are supported")
    return side


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
    """Transfer, clamp at 1, the point curve per channel (``point_curve``:
    the (x, y) tuple or None), the finish extras (``extras``: the
    ``_extras_of`` tuple or None), ``floor(c*255 + 0.5)``; ``valid``
    masks out-of-frame samples to black. Returns three u8 planes."""
    encode = encoder_for(transfer)
    r, g, b = (torch.clamp_max(encode(c), 1.0) for c in (r, g, b))
    if point_curve:
        from bench_torch.yardstick.ops.curve import apply_point_curve

        r, g, b = (apply_point_curve(c, point_curve) for c in (r, g, b))
    if extras is not None:
        from bench_torch.yardstick.ops.extras import apply_finish_extras

        r, g, b = apply_finish_extras(r, g, b, *extras)

    def quant(c):
        q = torch.floor(c * 255.0 + 0.5)
        if valid is not None:
            q = torch.where(valid, q, 0.0)
        return q.to(torch.uint8)

    return quant(r), quant(g), quant(b)


def finish_to_u16(r, g, b, transfer: str = "gamma22", extras=None,
                  point_curve=None):
    """The 16-bit ``finish_to_u8``: the same transfer, point curve and
    extras, quantised ``floor(c*65535 + 0.5)``. The polynomial transfers
    (u8 accuracy only) are demoted to their exact curves
    (``transfer16_for``). Returns three u16 planes."""
    from bench_torch.yardstick.color import transfer16_for

    encode = encoder_for(transfer16_for(transfer))
    r, g, b = (torch.clamp_max(encode(c), 1.0) for c in (r, g, b))
    if point_curve:
        from bench_torch.yardstick.ops.curve import apply_point_curve

        r, g, b = (apply_point_curve(c, point_curve) for c in (r, g, b))
    if extras is not None:
        from bench_torch.yardstick.ops.extras import apply_finish_extras

        r, g, b = apply_finish_extras(r, g, b, *extras)
    return tuple(_to_u16(torch.floor(c * 65535.0 + 0.5)) for c in (r, g, b))


def _to_u16(q: torch.Tensor) -> torch.Tensor:
    """f32 codes 0..65535 to a u16 tensor, through int32 and the int16
    bit pattern (a direct f32-to-u16 cast is not on every backend)."""
    return q.to(torch.int32).to(torch.int16).view(torch.uint16)


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


def _finish_kwargs(params, transfer, extras):
    return dict(transfer=transfer, extras=_extras_of(params, extras),
                point_curve=_point_curve_of(params))


def develop(mosaic, params: EditParams, wb, cam_matrix, white_level=4096.0,
            black_level=0.0, demosaic_method: str = "nearest",
            matrix_transpose: bool = True, transfer: str = "gamma22",
            cfa_phase=(0, 0), extras=False):
    """Full-resolution develop: (H, W) u16 to (H, W, 3) u8."""
    r, g, b = _linear_planes(mosaic, params, wb, cam_matrix, white_level,
                             black_level, demosaic_method,
                             matrix_transpose, cfa_phase, extras)
    return torch.stack(finish_to_u8(
        r, g, b, **_finish_kwargs(params, transfer, extras)), dim=-1)


def develop_rgba(mosaic, params: EditParams, wb, cam_matrix,
                 white_level=4096.0, black_level=0.0,
                 demosaic_method: str = "nearest",
                 matrix_transpose: bool = True, transfer: str = "gamma22",
                 cfa_phase=(0, 0), extras=False):
    """Full-resolution develop to packed RGBA: (H, W) u16 to (H, W) u32."""
    r, g, b = _linear_planes(mosaic, params, wb, cam_matrix, white_level,
                             black_level, demosaic_method,
                             matrix_transpose, cfa_phase, extras)
    return finish_to_rgba_u32(r, g, b,
                              **_finish_kwargs(params, transfer, extras))


def develop_u16(mosaic, params: EditParams, wb, cam_matrix,
                white_level=4096.0, black_level=0.0,
                demosaic_method: str = "nearest",
                matrix_transpose: bool = True, transfer: str = "gamma22",
                cfa_phase=(0, 0), extras=False):
    """Full-resolution develop to 16 bits: (H, W) u16 to (H, W, 3) u16,
    the TIFF export's develop (``finish_to_u16``)."""
    r, g, b = _linear_planes(mosaic, params, wb, cam_matrix, white_level,
                             black_level, demosaic_method,
                             matrix_transpose, cfa_phase, extras)
    return torch.stack(finish_to_u16(
        r, g, b, **_finish_kwargs(params, transfer, extras)), dim=-1)


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
    elementwise, so the values equal a normalise-then-gather). With
    ``extras`` the finish stencils run on the sampled grid, with the
    vignette over the preview's own frame (the live-preview
    approximation the JAX function makes). Returns (out_h, out_w, 3)
    u8."""
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
    return torch.stack(finish_to_u8(
        r, g, b, valid=valid, **_finish_kwargs(params, transfer, extras)),
        dim=-1)


def develop_xtrans(mosaic, params: EditParams, wb, cam_matrix,
                   white_level=4096.0, black_level=0.0, pattern: str = None,
                   matrix_transpose: bool = False,
                   transfer: str = "gamma22", rgba: bool = False,
                   demosaic_method: str = "nearest", bits: int = 8,
                   extras=False):
    """Full develop of an X-Trans (or any square repeating-CFA) mosaic:
    (H, W) u16 to (H, W, 3) u8, with ``rgba`` to (H, W) u32 words, or
    with ``bits=16`` to (H, W, 3) u16 (``finish_to_u16``).
    ``demosaic_method`` is "nearest", "smooth" or "grad"
    (``ops/cfa_generic.py``); ``pattern`` defaults to the X-Trans grid."""
    from bench_torch.yardstick.ops import cfa_generic

    pat = pattern or cfa_generic.XTRANS_PATTERN
    side = _square_period(pat)
    if rgba and bits == 16:
        raise ValueError("rgba and bits=16 are mutually exclusive")
    demosaics = {"nearest": cfa_generic.demosaic_nearest_generic,
                 "smooth": cfa_generic.demosaic_smooth_generic,
                 "grad": cfa_generic.demosaic_grad_generic}
    if demosaic_method not in demosaics:
        raise ValueError(
            f"unknown generic-CFA demosaic method {demosaic_method!r}")
    require_ported(params, extras)
    norm = _normalize(mosaic, white_level, black_level)
    r, g, b = demosaics[demosaic_method](norm, pat, side, side)
    r, g, b = apply_edit_stack(r, g, b, params, wb, cam_matrix,
                               matrix_transpose)
    finish = _finish_kwargs(params, transfer, extras)
    if rgba:
        return finish_to_rgba_u32(r, g, b, **finish)
    finish_to = finish_to_u16 if bits == 16 else finish_to_u8
    return torch.stack(finish_to(r, g, b, **finish), dim=-1)


def develop_xtrans_preview(mosaic, params: EditParams, wb, cam_matrix,
                           out_w: int, out_h: int, zoom=1.0, pan_x=0.0,
                           pan_y=0.0, white_level=4096.0, black_level=0.0,
                           pattern: str = None,
                           matrix_transpose: bool = False,
                           transfer: str = "gamma22", extras=False):
    """X-Trans preview at (out_h, out_w) with zoom/pan: nearest-sample the
    mosaic at output pixel centres, then demosaic (nearest site) and
    develop only the sampled sites, as ``develop_preview`` does for
    Bayer. Returns (out_h, out_w, 3) u8."""
    from bench_torch.yardstick.ops import cfa_generic

    pat = pattern or cfa_generic.XTRANS_PATTERN
    side = _square_period(pat)
    require_ported(params, extras)
    h, w = mosaic.shape
    dev = mosaic.device
    xi, xvalid = _sampling.sample_axis(out_w, w, zoom, pan_x, dev)
    yi, yvalid = _sampling.sample_axis(out_h, h, zoom, pan_y, dev)
    valid = yvalid[:, None] & xvalid[None, :]
    src = mosaic.view(torch.int16) if mosaic.dtype == torch.uint16 else mosaic
    taps = cfa_generic.demosaic_nearest_generic_sampled(src, yi, xi, pat,
                                                        side, side)
    r, g, b = (_normalize(t, white_level, black_level) for t in taps)
    r, g, b = apply_edit_stack(r, g, b, params, wb, cam_matrix,
                               matrix_transpose)
    return torch.stack(finish_to_u8(
        r, g, b, valid=valid, **_finish_kwargs(params, transfer, extras)),
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


def develop_xtrans_histogram(mosaic, params: EditParams, wb, cam_matrix,
                             out_w: int, out_h: int, zoom=1.0, pan_x=0.0,
                             pan_y=0.0, white_level=4096.0, black_level=0.0,
                             pattern: str = None,
                             matrix_transpose: bool = False,
                             transfer: str = "gamma22", extras=False):
    """The X-Trans live histogram: a small sampled render, binned."""
    return histogram_256(develop_xtrans_preview(
        mosaic, params, wb, cam_matrix, out_w, out_h, zoom, pan_x, pan_y,
        white_level, black_level, pattern, matrix_transpose, transfer,
        extras))


def _linear_normalized(rgb_u16, white_level, black_level):
    """The three channel planes of an (..., 3) u16 frame, each
    normalised on its own (the JAX function splits them first)."""
    return tuple(_normalize(rgb_u16[..., c], white_level, black_level)
                 for c in range(3))


def develop_linear(rgb_u16, params: EditParams, wb, cam_matrix,
                   white_level=4096.0, black_level=0.0,
                   matrix_transpose: bool = False,
                   transfer: str = "gamma22", rgba: bool = False,
                   bits: int = 8, extras=False):
    """Develop an already-demosaiced (H, W, 3) u16 frame (DNG LinearRaw,
    photometric 34892): the edit stack with no demosaic. Returns
    (H, W, 3) u8, with ``rgba`` (H, W) u32 words, or with ``bits=16``
    (H, W, 3) u16 (``finish_to_u16``)."""
    if rgba and bits == 16:
        raise ValueError("rgba and bits=16 are mutually exclusive")
    require_ported(params, extras)
    r, g, b = _linear_normalized(rgb_u16, white_level, black_level)
    r, g, b = apply_edit_stack(r, g, b, params, wb, cam_matrix,
                               matrix_transpose)
    finish = _finish_kwargs(params, transfer, extras)
    if rgba:
        return finish_to_rgba_u32(r, g, b, **finish)
    finish_to = finish_to_u16 if bits == 16 else finish_to_u8
    return torch.stack(finish_to(r, g, b, **finish), dim=-1)


def develop_linear_preview(rgb_u16, params: EditParams, wb, cam_matrix,
                           out_w: int, out_h: int, zoom=1.0, pan_x=0.0,
                           pan_y=0.0, white_level=4096.0, black_level=0.0,
                           matrix_transpose: bool = False,
                           transfer: str = "gamma22", extras=False):
    """LinearRaw preview at (out_h, out_w) with zoom/pan: nearest-sample
    the RGB frame at output pixel centres, then run the edit stack on the
    sampled sites. Returns (out_h, out_w, 3) u8."""
    require_ported(params, extras)
    h, w = rgb_u16.shape[:2]
    dev = rgb_u16.device
    xi, xvalid = _sampling.sample_axis(out_w, w, zoom, pan_x, dev)
    yi, yvalid = _sampling.sample_axis(out_h, h, zoom, pan_y, dev)
    valid = yvalid[:, None] & xvalid[None, :]
    src = (rgb_u16.view(torch.int16) if rgb_u16.dtype == torch.uint16
           else rgb_u16)
    sub = src.index_select(0, yi).index_select(1, xi)
    r, g, b = _linear_normalized(sub, white_level, black_level)
    r, g, b = apply_edit_stack(r, g, b, params, wb, cam_matrix,
                               matrix_transpose)
    return torch.stack(finish_to_u8(
        r, g, b, valid=valid, **_finish_kwargs(params, transfer, extras)),
        dim=-1)


def develop_linear_histogram(rgb_u16, params: EditParams, wb, cam_matrix,
                             out_w: int, out_h: int, zoom=1.0, pan_x=0.0,
                             pan_y=0.0, white_level=4096.0, black_level=0.0,
                             matrix_transpose: bool = False,
                             transfer: str = "gamma22", extras=False):
    """The LinearRaw live histogram: a small sampled render, binned."""
    return histogram_256(develop_linear_preview(
        rgb_u16, params, wb, cam_matrix, out_w, out_h, zoom, pan_x, pan_y,
        white_level, black_level, matrix_transpose, transfer, extras))
