"""Colour grading (split toning): shadow / midtone / highlight tints.

The JAX package's ``ops/grading.py`` in PyTorch, operation for operation
in f32. A pointwise stage of the finish extras, right after the HSL
mixer; the B8 kernel (``csrc/extras.cu``) runs the same arithmetic.

Per pixel: the tonal coordinate t = clip(y + balance * 0.0035, 0, 1) on
the Rec.709 luma; region weights (1-t)^2, 2t(1-t), t^2; each wheel adds
w * (sat/100) * 0.25 times the zero-luma chroma direction of its hue;
the offset is pinned to zero at black and white by smoothstep(8 min(y,
1-y)), and the result clamped to [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch

from raweditor_tpu_torch.ops.develop import LUMA, f32

#: Field order shared with params.GRADE_FIELDS.
GRADE_ORDER = ("shadow_hue", "shadow_sat", "mid_hue", "mid_sat",
               "high_hue", "high_sat", "balance")

#: Slider-unit scales.
STRENGTH = 0.25
BALANCE_PER_UNIT = 0.0035


def as_f32_tensor(v) -> torch.Tensor:
    """A slider amount as an f32 tensor: tensors as they are, numbers as
    0-d CPU tensors (a 0-d CPU tensor combines with planes on any
    device as a scalar)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.tensor(np.float32(v))


def _hue_dir(hue):
    """The zero-luma chroma direction of ``hue`` (degrees, wrapped into
    [0, 360)): fully saturated HSV (h, 1, 1) to RGB by the triangle
    formula, minus its own Rec.709 luma. Returns (dr, dg, db)."""
    hue = as_f32_tensor(hue)
    h = hue - 360.0 * torch.floor(hue * f32(1.0 / 360.0))
    hp = h * f32(1.0 / 60.0)

    def tri(center, rising):
        a = torch.abs(hp - center)
        t = (a - 1.0) if rising else (2.0 - a)
        return torch.clamp(t, 0.0, 1.0)

    r = tri(3.0, True)
    g = tri(2.0, False)
    b = tri(4.0, False)
    y = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    return r - y, g - y, b - y


def apply_color_grading(r, g, b, grading):
    """Colour grading on [0, 1] encoded RGB planes.

    ``grading`` is the flat 7-sequence (shadow_hue, shadow_sat, mid_hue,
    mid_sat, high_hue, high_sat, balance, ``EditParams.grading_values()``);
    each element a number or a tensor that broadcasts against the planes
    (the batch paths pass (N, 1, 1) per-image amounts). Returns (r, g, b)
    clamped to [0, 1]."""
    grading = [as_f32_tensor(v) for v in grading]
    if len(grading) != len(GRADE_ORDER):
        raise ValueError(
            f"grading needs {len(GRADE_ORDER)} values, got {len(grading)}")
    s_hue, s_sat, m_hue, m_sat, h_hue, h_sat, balance = grading

    y = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    t = torch.clamp(y + balance * f32(BALANCE_PER_UNIT), 0.0, 1.0)
    w_s = (1.0 - t) * (1.0 - t)
    w_h = t * t
    w_m = 2.0 * t * (1.0 - t)

    off_r = torch.zeros_like(y)
    off_g = torch.zeros_like(y)
    off_b = torch.zeros_like(y)
    for w, hue, sat in ((w_s, s_hue, s_sat), (w_m, m_hue, m_sat),
                        (w_h, h_hue, h_sat)):
        dr, dg, db = _hue_dir(hue)
        amt = w * (sat * f32(STRENGTH / 100.0))
        off_r = off_r + amt * dr
        off_g = off_g + amt * dg
        off_b = off_b + amt * db

    # Endpoint pin: smoothstep over the outer 1/8 at both ends.
    u = torch.clamp(8.0 * torch.minimum(y, 1.0 - y), 0.0, 1.0)
    p = u * u * (3.0 - 2.0 * u)

    def clip(c):
        return torch.clamp(c, 0.0, 1.0)

    return (clip(r + p * off_r), clip(g + p * off_g), clip(b + p * off_b))
