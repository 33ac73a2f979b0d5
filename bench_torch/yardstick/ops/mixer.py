"""8-band HSL colour mixer (hue / saturation / luminance per band).

The JAX package's ``ops/mixer.py`` in PyTorch, operation for operation
in f32. A pointwise stage at the head of the finish extras
(``ops/extras.extras_core``) on the transfer-encoded RGB planes in
[0, 1]; the B8 kernel (``csrc/extras.cu``) runs the same arithmetic.

Per pixel: hue, chroma and value by the hexagonal HSV projection; the
24 sliders are knots on the hue circle at the band centres, read by a
circular piecewise-linear interpolation (nine hat weights, the ninth
closing the circle at 360 degrees with knot 0); hue shifts by 0.30
degrees per unit, chroma scales by 1 + s/100, value by
2^(0.0075 l); the result is converted back by the branch-free triangle
formula and blended with the input by smoothstep(5c), so neutrals are
untouched.
"""

from __future__ import annotations

import torch

from bench_torch.yardstick.ops.develop import f32

#: Band order shared with params.MIXER_FIELDS.
BAND_NAMES = ("red", "orange", "yellow", "green", "aqua", "blue",
              "purple", "magenta")
#: Band-centre hues in degrees; the circle closes magenta -> red at 360.
BAND_CENTERS = (0.0, 30.0, 60.0, 120.0, 180.0, 240.0, 280.0, 320.0)

#: Slider-unit scales.
HUE_DEG_PER_UNIT = 0.30
SAT_PER_UNIT = 0.01
LUM_EXP2_PER_UNIT = 0.0075


def _hat_weights(h):
    """The nine hat weights of the circular interpolation at hue ``h``:
    w_i = clip(min((h - C_{i-1}) / Lw, (C_{i+1} - h) / Rw), 0, 1), the
    ninth reusing knot 0 at 360 degrees."""
    ext = list(BAND_CENTERS) + [360.0]
    weights = []
    for i, ci in enumerate(ext):
        left = ext[i - 1] if i > 0 else BAND_CENTERS[-1] - 360.0
        right = ext[i + 1] if i + 1 < len(ext) else 360.0 + BAND_CENTERS[1]
        rise = (h - f32(left)) * f32(1.0 / (ci - left))
        fall = (f32(right) - h) * f32(1.0 / (right - ci))
        weights.append(torch.clamp(torch.minimum(rise, fall), 0.0, 1.0))
    return weights


def _interp(weights, knots):
    """Weighted sum of the 8 knot values (floats, or tensors that
    broadcast against the hue plane) under the 9 hat weights, summed
    left to right."""
    n = len(BAND_CENTERS)
    out = None
    for i, w in enumerate(weights):
        term = w * knots[i % n]
        out = term if out is None else out + term
    return out


def _as_f32(v):
    """A slider amount as f32: tensors as they are, numbers rounded to
    their f32 value (the value ``jnp.asarray(v, float32)`` holds)."""
    return v.to(torch.float32) if isinstance(v, torch.Tensor) else f32(v)


def apply_hsl_mixer(r, g, b, mixer):
    """The mixer on [0, 1] encoded RGB planes.

    ``mixer`` is the flat 24-sequence (hue x8, sat x8, lum x8 in
    BAND_NAMES order, ``EditParams.mixer_values()``); each element a
    number or a tensor that broadcasts against the planes (the batch
    paths pass (N, 1, 1) per-image amounts). Returns (r, g, b) clamped
    to [0, 1]."""
    mixer = [_as_f32(v) for v in mixer]
    if len(mixer) != 3 * len(BAND_CENTERS):
        raise ValueError(
            f"mixer needs {3 * len(BAND_CENTERS)} values, got {len(mixer)}")
    hue_k, sat_k, lum_k = mixer[0:8], mixer[8:16], mixer[16:24]

    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    safe = torch.where(c > 0.0, c, 1.0)
    # Hue sextant: only the max==r arm can go negative, hence mod 6 there.
    hr = (g - b) / safe
    hr = hr - 6.0 * torch.floor(hr * f32(1.0 / 6.0))
    hg = (b - r) / safe + 2.0
    hb = (r - g) / safe + 4.0
    is_r = mx == r
    is_g = torch.logical_and(torch.logical_not(is_r), mx == g)
    h = torch.where(is_r, hr, torch.where(is_g, hg, hb)) * 60.0

    weights = _hat_weights(h)
    dh = _interp(weights, hue_k) * f32(HUE_DEG_PER_UNIT)
    fs = torch.clamp_min(1.0 + _interp(weights, sat_k) * f32(SAT_PER_UNIT),
                         0.0)
    fl = torch.exp2(_interp(weights, lum_k) * f32(LUM_EXP2_PER_UNIT))

    h2 = h + dh
    h2 = h2 - 360.0 * torch.floor(h2 * f32(1.0 / 360.0))
    v2 = torch.clamp(mx * fl, 0.0, 1.0)
    c2 = torch.minimum(torch.clamp(c * fs, 0.0, 1.0), v2)

    # Back-convert (h2, c2, v2) with the branch-free triangle formula.
    hp = h2 * f32(1.0 / 60.0)

    def tri(center, rising):
        a = torch.abs(hp - center)
        t = (a - 1.0) if rising else (2.0 - a)
        return c2 * torch.clamp(t, 0.0, 1.0)

    r1 = tri(3.0, True)
    g1 = tri(2.0, False)
    b1 = tri(4.0, False)
    m = v2 - c2

    # Chroma-weighted blend: w = smoothstep over c in [0, 0.2].
    tcw = torch.clamp(c * 5.0, 0.0, 1.0)
    w = tcw * tcw * (3.0 - 2.0 * tcw)

    def out(plane, new):
        return torch.clamp(plane + w * (new + m - plane), 0.0, 1.0)

    return out(r, r1), out(g, g1), out(b, b1)
