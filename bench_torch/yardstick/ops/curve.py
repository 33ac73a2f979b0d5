"""Free-form point tone curve (monotone cubic spline).

The JAX package's ``ops/curve.py`` in PyTorch. ``EditParams.point_curve``
is a tuple of (x, y) control points in [0, 1], strictly increasing in x
(``validate_points``); the curve is the Fritsch-Carlson (PCHIP) monotone
cubic Hermite through them, flat outside [x_first, x_last]. It runs per
channel on the encoded planes, after the transfer and before the finish
extras (``ops/develop.finish_to_u8``). No kernel computes it: the engine
develops a frame with a point curve on the plain lane.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

#: More points than anyone drags.
MAX_POINTS = 16
#: Minimum x spacing: the Hermite segment divides by the gap.
MIN_GAP = 1e-3


def validate_points(points) -> Tuple[Tuple[float, float], ...]:
    """Normalise and validate a point-curve spec; returns the canonical
    tuple of (x, y) float pairs for ``EditParams.point_curve``.

    Rules: 0 or 2..MAX_POINTS points, each an (x, y) list or tuple of
    finite coordinates in [0, 1], x strictly increasing with at least
    MIN_GAP spacing. Raises ValueError otherwise."""
    pts = []
    for p in points:
        # Entries must be 2-sequences: a digit string like "00" iterates
        # to two characters and must not become the point (0, 0).
        if not isinstance(p, (list, tuple)) or len(p) != 2:
            raise ValueError(
                f"point_curve entries must be (x, y) pairs, got {p!r}")
        try:
            pair = tuple(float(v) for v in p)
        except (TypeError, ValueError):
            raise ValueError(
                f"point_curve entries must be (x, y) pairs, got {p!r}")
        if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in pair):
            raise ValueError(
                f"point_curve coordinates must be finite in [0, 1], "
                f"got {pair}")
        pts.append(pair)
    if not pts:
        return ()
    if len(pts) == 1:
        raise ValueError("point_curve needs at least 2 points (or none)")
    if len(pts) > MAX_POINTS:
        raise ValueError(
            f"point_curve supports at most {MAX_POINTS} points, "
            f"got {len(pts)}")
    for (x0, _), (x1, _) in zip(pts, pts[1:]):
        if x1 - x0 < MIN_GAP:
            raise ValueError(
                "point_curve x coordinates must be strictly increasing "
                f"(gap >= {MIN_GAP}); got {x0} then {x1}")
    return tuple(pts)


def _tangents(xs, ys):
    """PCHIP tangents at the points (f32 tensors): the weighted harmonic
    mean of the neighbouring secants, zero at local extrema, one-sided
    secants at the ends."""
    n = len(xs)
    h = [xs[i + 1] - xs[i] for i in range(n - 1)]
    d = [(ys[i + 1] - ys[i]) / h[i] for i in range(n - 1)]
    if n == 2:
        return [d[0], d[0]]
    m = [d[0]]
    for i in range(1, n - 1):
        w1 = 2.0 * h[i] + h[i - 1]
        w2 = h[i] + 2.0 * h[i - 1]
        keep = d[i - 1] * d[i] > 0.0
        # Guard the divisions where a secant is 0 or the slopes change
        # sign; the select discards the result either way.
        safe0 = torch.where(keep, d[i - 1], 1.0)
        safe1 = torch.where(keep, d[i], 1.0)
        m.append(torch.where(keep, (w1 + w2) / (w1 / safe0 + w2 / safe1),
                             0.0))
    m.append(d[-1])
    return m


def apply_point_curve(c, points: Sequence[Sequence[float]]):
    """The monotone point curve on encoded values ``c`` (an f32 tensor
    in [0, 1], any shape). ``points`` is the validated tuple of (x, y)
    pairs; values outside [x_first, x_last] take the end point's y.

    The coordinates and tangents are f32 scalar arithmetic on the CPU,
    then one copy to ``c``'s device, so every division below is a
    tensor-by-tensor division on one device (correctly rounded, as the
    JAX function's)."""
    n = len(points)
    if n == 0:
        return c
    pts = torch.tensor(np.asarray(points, np.float64), dtype=torch.float32)
    xs, ys = list(pts[:, 0].unbind()), list(pts[:, 1].unbind())
    m = _tangents(xs, ys)
    k = torch.stack(xs + ys + m).to(c.device)
    xs, ys, m = k[:n], k[n:2 * n], k[2 * n:]
    res = torch.zeros_like(c) + ys[0]
    for i in range(n - 1):
        h = xs[i + 1] - xs[i]
        t = torch.clamp((c - xs[i]) / h, 0.0, 1.0)
        t2 = t * t
        t3 = t2 * t
        seg = ((2.0 * t3 - 3.0 * t2 + 1.0) * ys[i]
               + (t3 - 2.0 * t2 + t) * h * m[i]
               + (3.0 * t2 - 2.0 * t3) * ys[i + 1]
               + (t3 - t2) * h * m[i + 1])
        res = torch.where(c >= xs[i], seg, res)
    res = torch.where(c >= xs[-1], ys[-1], res)
    # The monotone Hermite stays inside [min(ys), max(ys)]; the clamp
    # keeps the quantisers safe.
    return torch.clamp(res, 0.0, 1.0)
