"""Render-target sampling math.

Each output pixel of a preview samples the nearest full-resolution texel
at its centre, after zoom and pan, as the reference editor's rasteriser
does. The index math is f32 on purpose: f64 flips samples that land
exactly on integer texel boundaries (zoom 2.0), so only f32 matches the
reference.
"""

from __future__ import annotations

import torch


def preview_shape(full_w: int, full_h: int, max_width: int = 1280) -> tuple:
    """Preview target (width, height): width-capped, aspect kept,
    height truncated."""
    aspect = full_w / full_h
    out_w = min(full_w, max_width)
    return out_w, int(out_w / aspect)


def histogram_shape(full_w: int, full_h: int, width: int = 128) -> tuple:
    """Histogram target (width, height)."""
    aspect = full_w / full_h
    return width, int(width / aspect)


def sample_axis(out_size: int, full_size: int, zoom, pan, device=None):
    """Sampled full-res indices and the in-frame mask along one axis.

    ``t = ((i + 0.5)/out_size - 0.5)/zoom - pan + 0.5`` in f32; the index
    is ``floor(t * full_size)`` clamped into the image, and the sample is
    valid where ``0 <= t <= 1``.

    Returns (idx int64 (out_size,), valid bool (out_size,)).
    """
    f32 = torch.float32
    zoom = torch.as_tensor(zoom, dtype=f32, device=device)
    pan = torch.as_tensor(pan, dtype=f32, device=device)
    u = (torch.arange(out_size, dtype=f32, device=device) + 0.5) / float(
        out_size)
    t = (u - 0.5) / zoom - pan + 0.5
    valid = (t >= 0.0) & (t <= 1.0)
    idx = torch.clamp(torch.floor(t * float(full_size)), 0, full_size - 1)
    return idx.to(torch.int64), valid
