"""Output-stage geometry on the device: straighten (rotate by any angle),
crop, lens correction and keystone, applied to a developed image before
the export's resize.

The port's own module, written from the JAX package's
``ops/geometry.py`` (which is XLA there: no Pallas kernel). The
conventions are that module's:

- rotation is an inverse-mapped bilinear sample: output pixel (y, x)
  reads the source at ``R(-angle) (p_out - c_out) + c_src``, clamping to
  the edge; positive angles turn the picture clockwise on screen;
- with no ``crop`` the output is the largest upright rectangle of the
  source's aspect inside the rotated frame (``largest_upright_rect``); an
  explicit ``crop`` is (left, top, width, height) in the source frame's
  own box;
- ``lens = (k1, k2, ca_r, ca_b)`` composes the radial polynomial
  ``r (1 + k1 r^2 + k2 r^4)`` about the centre (r normalised to the
  half-diagonal) and a per-channel magnification of ``1e-4`` a unit for
  red and blue into the same sample;
- ``perspective = (kv, kh)`` composes a first-order keystone before the
  rotation; with no crop it shrinks the default rectangle by
  ``1 + |k|`` (keeping the parity of the dimensions);
- angle 0 with no crop, lens or keystone returns the image itself; a pure
  crop is a slice.

Every coordinate constant is a Python float rounded once to f32 (``_F``)
and each operation keeps the JAX order, so the sample positions equal
the JAX ones up to XLA's fused multiply-adds. The u8 and u16 forms round
``floor(x + 0.5)``; the words form unpacks through
``ops/extras.words_to_planes`` (values times 255) and repacks through
``planes_to_words``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raweditor_tpu_torch.ops.develop import _to_u16, f32 as _F, u16_to_f32

_F32 = torch.float32


def largest_upright_rect(w: int, h: int, angle_deg: float) -> Tuple[int, int]:
    """(crop_w, crop_h): the largest axis-aligned rectangle with the
    aspect of (w, h) inside the w x h frame rotated by ``angle_deg``;
    (w, h) at angle 0."""
    a = abs(math.radians(angle_deg)) % math.pi
    if a > math.pi / 2:
        a = math.pi - a
    if a < 1e-9:
        return w, h
    sin_a, cos_a = math.sin(a), math.cos(a)
    # An upright (cw, ch) rectangle centred in the rotated frame fits iff
    # cw cos + ch sin <= w and cw sin + ch cos <= h; with cw = (w/h) ch
    # both are linear in ch: take the binding one.
    r = w / h
    ch = min(w / (r * cos_a + sin_a), h / (r * sin_a + cos_a))
    cw = r * ch
    # 1e-6 absorbs the float loss at right angles (cos(pi/2) ~ 6e-17).
    return max(1, int(cw + 1e-6)), max(1, int(ch + 1e-6))


def _bilerp(img, sx, sy, channel=None):
    """Clamp-to-edge bilinear gather of (H, W, C) f32, or of one channel
    of it, at fractional source coordinates (sy, sx)."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.clamp(torch.floor(sx), 0, w - 1)
    y0 = torch.clamp(torch.floor(sy), 0, h - 1)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp_max(x0i + 1, w - 1)
    y1i = torch.clamp_max(y0i + 1, h - 1)
    if channel is None:
        fx, fy = fx[..., None], fy[..., None]
        src = img
    else:
        src = img[..., channel]

    def tap(yi, xi):
        return src[yi, xi]

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x1i) * fx
    bot = tap(y1i, x0i) * (1 - fx) + tap(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def _rotate_sample(img, angle_deg: float, out_w: int, out_h: int,
                   off_x: float, off_y: float, lens=None, perspective=None):
    """Bilinear inverse-map sample of (H, W, C) f32 to (out_h, out_w, C):
    output pixel (y, x) sits at rotated-frame position (off_x + x,
    off_y + y) and reads the source at that vector, taken about the
    shared frame centre, rotated by -angle; ``perspective`` warps it
    before the rotation and ``lens`` after it."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    th = math.radians(angle_deg)
    cos_t, sin_t = math.cos(th), math.sin(th)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0

    vx = ((torch.arange(out_w, dtype=_F32, device=dev)[None, :]
           + _F(off_x - cx)) + torch.zeros((out_h, 1), dtype=_F32,
                                           device=dev))
    vy = ((torch.arange(out_h, dtype=_F32, device=dev)[:, None]
           + _F(off_y - cy)) + torch.zeros((1, out_w), dtype=_F32,
                                           device=dev))
    if perspective is not None:
        # The keystone in frame-normalised coordinates: kv scales the
        # horizontal sampling with height (converging verticals), kh the
        # vertical with width.
        kv, kh = perspective
        u = vx * _F(1.0 / cx)
        v = vy * _F(1.0 / cy)
        vx = u * (_F(1.0) + _F(kv) * v) * _F(cx)
        vy = v * (_F(1.0) + _F(kh) * u) * _F(cy)
    sx = _F(cos_t) * vx + _F(sin_t) * vy + _F(cx)
    sy = _F(-sin_t) * vx + _F(cos_t) * vy + _F(cy)

    if lens is None:
        return _bilerp(img, sx, sy)
    k1, k2, ca_r, ca_b = lens
    dx = sx - _F(cx)
    dy = sy - _F(cy)
    # r^2 normalised to the half-diagonal: the corners sit at 1.
    rn2 = (dx * dx + dy * dy) * _F(1.0 / (cx * cx + cy * cy))
    base = _F(1.0) + _F(k1) * rn2 + _F(k2) * rn2 * rn2
    if ca_r == 0.0 and ca_b == 0.0:
        return _bilerp(img, _F(cx) + dx * base, _F(cy) + dy * base)
    out = []
    for ci, ca in enumerate((ca_r, 0.0, ca_b)):
        f = base * _F(1.0 + ca * 1e-4) if ca else base
        out.append(_bilerp(img, _F(cx) + dx * f, _F(cy) + dy * f,
                           channel=ci))
    return torch.stack(out, dim=-1)


def _resolve_geometry(h: int, w: int, angle_deg: float,
                      crop: Optional[Tuple[int, int, int, int]]):
    """(out_w, out_h, off_x, off_y): the output rectangle in
    rotated-frame pixels: the centred largest upright rectangle of the
    source aspect, or the explicit crop (left, top, width, height)."""
    if crop is not None:
        left, top, cw, ch = (int(v) for v in crop)
        if cw <= 0 or ch <= 0:
            raise ValueError(f"crop needs positive size, got {crop}")
        if not (0 <= left and 0 <= top and left + cw <= w
                and top + ch <= h):
            raise ValueError(f"crop {crop} exceeds the {w}x{h} frame")
        return cw, ch, float(left), float(top)
    cw, ch = largest_upright_rect(w, h, angle_deg)
    return cw, ch, (w - cw) / 2.0, (h - ch) / 2.0


def _resolve_lens(lens):
    """None when ``lens`` is absent or all zero, else the validated
    (k1, k2, ca_r, ca_b) floats."""
    if lens is None:
        return None
    k1, k2, ca_r, ca_b = (float(v) for v in lens)
    for name, v in (("k1", k1), ("k2", k2), ("ca_r", ca_r),
                    ("ca_b", ca_b)):
        if not math.isfinite(v):
            raise ValueError(f"lens {name} must be finite, got {v}")
    if k1 == 0.0 and k2 == 0.0 and ca_r == 0.0 and ca_b == 0.0:
        return None
    return (k1, k2, ca_r, ca_b)


def _resolve_perspective(perspective):
    """None when ``perspective`` is absent or zero, else the validated
    (kv, kh) floats, each within +-0.95 so that the edge scale 1 + k v
    stays positive."""
    if perspective is None:
        return None
    kv, kh = (float(v) for v in perspective)
    for name, v in (("kv", kv), ("kh", kh)):
        if not math.isfinite(v):
            raise ValueError(f"perspective {name} must be finite")
        if abs(v) > 0.95:
            raise ValueError(
                f"perspective {name} must be within ±0.95, got {v}")
    if kv == 0.0 and kh == 0.0:
        return None
    return (kv, kh)


def output_rect(h: int, w: int, angle_deg: float = 0.0, crop=None,
                perspective=None):
    """(out_w, out_h, off_x, off_y) of the geometry stage on an h x w
    image: ``_resolve_geometry``, then the keystone's shrink of the
    default rectangle."""
    perspective = _resolve_perspective(perspective)
    out_w, out_h, off_x, off_y = _resolve_geometry(h, w, angle_deg, crop)
    if perspective is not None and crop is None:
        # The keystone widens one edge's reach by (1 + |k|); shrink the
        # default rectangle by that factor, keeping the parity of the
        # dimensions so the centred offsets stay integral.
        kv, kh = perspective
        new_w = max(1, int(out_w / (1.0 + abs(kv))))
        new_h = max(1, int(out_h / (1.0 + abs(kh))))
        if (out_w - new_w) % 2 and new_w > 1:
            new_w -= 1
        if (out_h - new_h) % 2 and new_h > 1:
            new_h -= 1
        off_x += (out_w - new_w) / 2.0
        off_y += (out_h - new_h) / 2.0
        out_w, out_h = new_w, new_h
    return out_w, out_h, off_x, off_y


def _rotate_crop(img, angle_deg, crop, to_f32, from_f32, lens=None,
                 perspective=None):
    """The skeleton of every form: resolve the rectangle, take the
    identity and pure-crop fast paths, else resample."""
    h, w = img.shape[0], img.shape[1]
    lens = _resolve_lens(lens)
    perspective = _resolve_perspective(perspective)
    out_w, out_h, off_x, off_y = output_rect(h, w, angle_deg, crop,
                                             perspective)
    # The identity threshold of largest_upright_rect (1e-9).
    if lens is None and perspective is None:
        if (out_w, out_h) == (w, h) and abs(angle_deg) < 1e-9:
            return img
        if abs(angle_deg) < 1e-9:
            t, left = int(off_y), int(off_x)
            return img[t: t + out_h, left: left + out_w]
    out = _rotate_sample(to_f32(img), float(angle_deg), out_w, out_h,
                         off_x, off_y, lens=lens, perspective=perspective)
    return from_f32(out)


def rotate_crop_u8(img_u8, angle_deg: float = 0.0,
                   crop: Optional[Tuple[int, int, int, int]] = None,
                   lens=None, perspective=None):
    """(H, W, 3) u8 straightened, cropped and corrected, u8 on its
    device. Positive angles rotate clockwise on screen."""
    return _rotate_crop(
        img_u8, angle_deg, crop, lambda x: x.to(_F32),
        lambda o: torch.clamp(torch.floor(o + 0.5), 0, 255).to(torch.uint8),
        lens=lens, perspective=perspective)


def rotate_crop_u16(img_u16, angle_deg: float = 0.0,
                    crop: Optional[Tuple[int, int, int, int]] = None,
                    lens=None, perspective=None):
    """The 16-bit form (the TIFF exports)."""
    return _rotate_crop(
        img_u16, angle_deg, crop, u16_to_f32,
        lambda o: _to_u16(torch.clamp(torch.floor(o + 0.5), 0, 65535)),
        lens=lens, perspective=perspective)


def rotate_crop_rgba_words(words, angle_deg: float = 0.0,
                           crop: Optional[Tuple[int, int, int, int]] = None,
                           lens=None, perspective=None):
    """The packed-RGBA (H, W) u32 form: unpack, resample, repack."""
    from raweditor_tpu_torch.ops.extras import (planes_to_words,
                                                words_to_planes)

    def unpack(w32):
        # The shared words contract (values x 255 for the sampler).
        return torch.stack(words_to_planes(w32), dim=-1) * _F(255.0)

    def repack(o):
        s = _F(1.0 / 255.0)
        return planes_to_words(*(torch.clamp(o[..., c] * s, 0, 1)
                                 for c in range(3)))

    return _rotate_crop(words, angle_deg, crop, unpack, repack, lens=lens,
                        perspective=perspective)


def rotate_crop_rgba_words_batch(words, angle_deg: float = 0.0, crop=None,
                                 lens=None, perspective=None):
    """(N, H, W) words with the same geometry on every image (the batch
    exporter's uniform ``rotate``/``crop``/``lens``/``perspective``), one
    image at a time, so each equals ``rotate_crop_rgba_words`` of it."""
    if (abs(angle_deg) < 1e-9 and crop is None
            and _resolve_lens(lens) is None
            and _resolve_perspective(perspective) is None):
        return words
    return torch.stack([
        rotate_crop_rgba_words(w, angle_deg, crop, lens=lens,
                               perspective=perspective) for w in words])


def reshapes(shape, long_edge=None, rotate: float = 0.0, crop=None, lens=None,
             perspective=None) -> bool:
    """Whether the output stage changes a developed frame of ``shape``
    (h, w): any geometry argument (the JAX exporter's ``geometry_on``),
    or a ``long_edge`` below its longer side."""
    from raweditor_tpu_torch.ops.resize import long_edge_shape

    h, w = shape
    return bool(rotate or crop is not None or lens is not None
                or perspective is not None
                or (long_edge and long_edge_shape(h, w, long_edge) != (h, w)))


def shape_output(img, kind: str, long_edge=None, rotate: float = 0.0,
                 crop=None, lens=None, perspective=None):
    """The output stage on one developed image on its device: the
    geometry, then the ``long_edge`` resize (``ops/resize.py``), for
    ``kind`` "words" ((H, W) u32) or "u16" ((H, W, 3)). The engine's
    exports and the batch exporter (image by image) both run it, so their
    files are equal."""
    from raweditor_tpu_torch.ops import resize

    if (rotate or crop is not None or lens is not None
            or perspective is not None):
        geo = rotate_crop_rgba_words if kind == "words" else rotate_crop_u16
        img = geo(img, float(rotate), crop, lens=lens,
                  perspective=perspective)
    if long_edge:
        h, w = img.shape[0], img.shape[1]
        oh, ow = resize.long_edge_shape(h, w, long_edge)
        if (oh, ow) != (h, w):
            fn = (resize.resize_rgba_words if kind == "words"
                  else resize.resize_rgb16)
            img = fn(img, ow, oh)
    return img
