"""Finish extras: sharpen, denoise, the 4-region tone curve and vignette.

The band-local part of the JAX package's ``ops/extras.py`` in PyTorch,
operation for operation in f32. The extras run on the transfer-encoded
RGB planes in [0, 1], just before quantisation (radius 2 in all):

1. the pointwise heads, when on: the HSL mixer (``ops/mixer.py``), then
   colour grading (``ops/grading.py``);
2. opponent split: y = 0.2126 r + 0.7152 g + 0.0722 b, cr = r - y,
   cb = b - y;
3. chroma denoise: two 3x3 tents over cr/cb, blended by denoise/100;
4. luma denoise: one bilateral-lite pass (tent weights times
   1 / (1 + (dy/sigma)^2)), blended by the same amount;
5. the tone curve (``tone_curve``), then the vignette
   y * (1 + (v/100) 0.75 r^2) on ``radial_sq``;
6. unsharp mask on luma: y + (y - tent3(y)) * sharpen/100;
7. rebuild r, g, b and clamp to [0, 1].

Every stencil reads its neighbours clamped at the image edge, stage by
stage (``ops/fused_develop._up/_dn/_lf/_rt``, the JAX ``_pad_shift_fns``).
``finish_extras_rgba_words`` runs the chain on packed RGBA words (the u8
values times 1/255, requantised with ``floor(c*255 + 0.5)``): the
behavioural reference of the B8 kernel (``ops/fused_extras.py``).

Not ported yet: clarity, dehaze and film grain. A non-zero amount of any
of them raises ``NotImplementedError`` naming the field; a zero is
skipped, as the JAX function skips a host-side zero.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.yardstick.ops.develop import LUMA, f32, pack_rgba, unpack_rgba
from bench_torch.yardstick.ops.fused_develop import _dn, _lf, _rt, _up
from bench_torch.yardstick.ops.grading import apply_color_grading, as_f32_tensor
from bench_torch.yardstick.ops.mixer import apply_hsl_mixer

_F = np.float32
_ZERO_CURVE = (0.0, 0.0, 0.0, 0.0)


def tone_curve(y, curve):
    """Parametric tone curve on encoded luma: the four region sliders
    (shadows, darks, lights, highlights) lift the interior knots of a
    6-knot piecewise-linear remap by up to +-0.15 each; a forward-max /
    backward-min cascade keeps the knots ascending, inside bounds spaced
    by 1e-3, so out-of-range sliders soft-limit instead of inverting the
    curve. ``curve`` holds four numbers or tensors that broadcast
    against ``y``."""
    amts = [as_f32_tensor(c) * f32(0.15 / 100.0) for c in curve]
    eps = f32(1e-3)
    k = [torch.clamp(f32(0.2 * (i + 1)) + a, f32((i + 1) * 1e-3),
                     f32(1.0 - (4 - i) * 1e-3))
         for i, a in enumerate(amts)]
    for i in range(1, 4):          # forward: ascending floors
        k[i] = torch.maximum(k[i], k[i - 1] + eps)
    for i in range(2, -1, -1):     # backward: ascending ceilings
        k[i] = torch.minimum(k[i], k[i + 1] - eps)
    t = torch.clamp(y, 0.0, 1.0) * 5.0
    out = torch.zeros_like(y)
    prev = 0.0
    for i, kn in enumerate(k + [1.0]):
        out = out + (kn - prev) * torch.clamp(t - float(i), 0.0, 1.0)
        prev = kn
    return out


def radial_consts(h: int, w: int):
    """(cy, cx, 1/max(cy, 1), 1/max(cx, 1)) as np.float32, by the JAX
    function's own numpy expressions (under NumPy 2 a Python float mixed
    with an np.float32 stays f32). The B8 kernel takes these four."""
    cy, cx = _F((h - 1) / 2.0), _F((w - 1) / 2.0)
    return cy, cx, _F(1.0 / max(cy, 1.0)), _F(1.0 / max(cx, 1.0))


def radial_sq(h, w, rows=None, cols=None, device=None):
    """Normalised radial distance squared for the vignette: 0 at the
    frame centre, 1 at the corners. ``rows``/``cols`` override the
    grid's own f32 coordinates."""
    cy, cx, icy, icx = radial_consts(h, w)
    if rows is None:
        rows = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    if cols is None:
        cols = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    ry = (rows - float(cy)) * float(icy)
    rx = (cols - float(cx)) * float(icx)
    return (ry * ry + rx * rx) * 0.5


def words_to_planes(words):
    """Packed-RGBA u32 words to [0, 1] f32 planes (the u8 values times
    f32(1/255))."""
    scale = f32(1.0 / 255.0)
    return tuple(c.to(torch.float32) * scale for c in unpack_rgba(words))


def quantize(c):
    """The finish rounding floor(c * 255 + 0.5), as f32."""
    return torch.floor(c * 255.0 + 0.5)


def planes_to_words(r, g, b):
    """[0, 1] f32 planes to packed-RGBA u32 words with the finish
    rounding and opaque alpha."""
    return pack_rgba(quantize(r), quantize(g), quantize(b))


def extras_core(r, g, b, sharpen, denoise, curve, vignette, r2,
                up, dn, lf, rt, mixer=None, grading=None, stencils=True):
    """The extras chain on encoded [0, 1] planes over the +-1 clamped
    shift functions ``up``/``dn``/``lf``/``rt``; ``r2`` is the
    ``radial_sq`` plane of the caller's grid. ``mixer`` (24 amounts) and
    ``grading`` (7 amounts) are None or on; ``stencils=False`` runs the
    pointwise heads only. Amounts are numbers or tensors that broadcast
    against the planes. Returns (r, g, b) clamped to [0, 1]."""
    if mixer is not None:
        r, g, b = apply_hsl_mixer(r, g, b, mixer)
    if grading is not None:
        r, g, b = apply_color_grading(r, g, b, grading)
    if not stencils:
        # Pointwise-only: the mixer and grading already clamped.
        return r, g, b
    sharpen = as_f32_tensor(sharpen)
    denoise = as_f32_tensor(denoise)
    vignette = as_f32_tensor(vignette)

    def tent3(x):
        xv = (up(x) + x * 2.0) + dn(x)
        return ((lf(xv) + xv * 2.0) + rt(xv)) * 0.0625

    y = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    cr = r - y
    cb = b - y

    s = torch.clamp(denoise * f32(0.01), 0.0, 1.0)
    cr = cr + (tent3(tent3(cr)) - cr) * s
    cb = cb + (tent3(tent3(cb)) - cb) * s

    # Bilateral-lite luma pass: tent spatial times rational range weights.
    sigma = f32(0.02) + f32(0.06) * s
    inv_s2 = 1.0 / (sigma * sigma)
    u, d = up(y), dn(y)
    taps = ((lf(u), 1.0), (u, 2.0), (rt(u), 1.0),
            (lf(y), 2.0), (rt(y), 2.0),
            (lf(d), 1.0), (d, 2.0), (rt(d), 1.0))
    num = y * 4.0
    den = torch.full_like(y, 4.0)
    for t, wgt in taps:
        dlt = t - y
        # wgt is 1 or 2, so wgt / x (computed by torch as 1/x times wgt)
        # rounds as the division does.
        w_ = wgt / (1.0 + dlt * dlt * inv_s2)
        num = num + t * w_
        den = den + w_
    y = y + (num / den - y) * s

    y = tone_curve(y, curve)

    y = y * (1.0 + vignette * f32(0.0075) * r2)

    a = torch.clamp_min(sharpen, 0.0) * f32(0.01)
    y = y + (y - tent3(y)) * a

    r = y + cr
    b = y + cb
    g = (y - LUMA[0] * r - LUMA[2] * b) * f32(1.0 / 0.7152)
    return (torch.clamp(r, 0.0, 1.0), torch.clamp(g, 0.0, 1.0),
            torch.clamp(b, 0.0, 1.0))


def _is_zero(v) -> bool:
    """True when an amount is zero (every element, for a tensor)."""
    return bool((torch.as_tensor(v) == 0).all())


def require_band_local(clarity=0.0, dehaze=0.0, grain=None) -> None:
    """Raise ``NotImplementedError`` for a non-zero clarity, dehaze or
    grain amount (whole-frame stages not ported yet)."""
    for name, v in (("dehaze", dehaze), ("clarity", clarity),
                    ("grain", 0.0 if grain is None else grain[0])):
        if not _is_zero(v):
            raise NotImplementedError(f"not ported yet: {name}")


def apply_finish_extras(r, g, b, sharpen, denoise, curve=_ZERO_CURVE,
                        vignette=0.0, clarity=0.0, dehaze=0.0,
                        mixer=None, grading=None, grain=None,
                        stencils=True):
    """The extras on transfer-encoded [0, 1] planes, in the chain before
    quantisation (the JAX function's positional contract). The vignette
    plane is this grid's own. Returns (r, g, b) clamped to [0, 1]."""
    require_band_local(clarity, dehaze, grain)
    r2 = radial_sq(r.shape[-2], r.shape[-1], device=r.device)
    return extras_core(r, g, b, sharpen, denoise, curve, vignette, r2,
                       _up, _dn, _lf, _rt, mixer=mixer, grading=grading,
                       stencils=stencils)


def finish_extras_rgba_words(words, sharpen, denoise, curve=_ZERO_CURVE,
                             vignette=0.0, clarity=0.0, dehaze=0.0,
                             mixer=None, grading=None, grain=None,
                             stencils=True):
    """The extras on packed-RGBA u32 (..., H, W) words: unpack to
    [0, 1], ``apply_finish_extras``, requantise. The B8 kernel computes
    this function."""
    r, g, b = apply_finish_extras(*words_to_planes(words), sharpen, denoise,
                                  curve, vignette, clarity, dehaze,
                                  mixer=mixer, grading=grading, grain=grain,
                                  stencils=stencils)
    return planes_to_words(r, g, b)
