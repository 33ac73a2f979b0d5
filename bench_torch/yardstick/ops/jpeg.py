"""Packed RGBA to JFIF YCbCr planes on the device.

JFIF full-range BT.601 forward transform; 4:2:0 chroma is the 2x2 box
mean before quantisation, as libjpeg's default h2v2 downsampler does.
Rounding is half-to-even (``torch.round``), like ``jnp.round``. The
planes feed the native JFIF encoder (``rawkit.encode_jpeg_420``).
"""

from __future__ import annotations

import torch

from bench_torch.yardstick.ops.develop import f32, unpack_rgba


def rgb_to_ycbcr(r, g, b):
    """f32 (y, cb, cr) from f32 r, g, b planes in 0..255."""
    y = f32(0.299) * r + f32(0.587) * g + f32(0.114) * b
    cb = 128.0 - f32(0.168735892) * r - f32(0.331264108) * g + 0.5 * b
    cr = 128.0 + 0.5 * r - f32(0.418687589) * g - f32(0.081312411) * b
    return y, cb, cr


def quantize_u8(p):
    return torch.clamp(torch.round(p), 0.0, 255.0).to(torch.uint8)


def _box2(p):
    s = p.shape
    return (p.reshape(s[:-2] + (s[-2] // 2, 2, s[-1] // 2, 2))
            .sum(dim=(-3, -1)) * 0.25)


def _check_even(h: int, w: int) -> None:
    if h % 2 or w % 2:
        raise ValueError("ycbcr420 requires even dimensions")


def _words_ycbcr(words):
    return rgb_to_ycbcr(*(c.to(torch.float32) for c in unpack_rgba(words)))


def rgba_words_to_ycbcr420(words: torch.Tensor):
    """Packed RGBA u32 (..., H, W) to (Y u8 (..., H, W),
    Cb u8 (..., H/2, W/2), Cr u8 (..., H/2, W/2))."""
    _check_even(words.shape[-2], words.shape[-1])
    y, cb, cr = _words_ycbcr(words)
    return quantize_u8(y), quantize_u8(_box2(cb)), quantize_u8(_box2(cr))


def rgb_u8_to_ycbcr420(img: torch.Tensor):
    """(H, W, 3) u8 RGB to (Y, Cb/2, Cr/2) u8 planes: the same
    transform entered from channel-last u8."""
    _check_even(img.shape[0], img.shape[1])
    r, g, b = (img[..., c].to(torch.float32) for c in range(3))
    y, cb, cr = rgb_to_ycbcr(r, g, b)
    return quantize_u8(y), quantize_u8(_box2(cb)), quantize_u8(_box2(cr))


def rgba_words_to_ycbcr444(words: torch.Tensor):
    """Packed RGBA u32 (..., H, W) to full-resolution (Y, Cb, Cr) u8."""
    y, cb, cr = _words_ycbcr(words)
    return quantize_u8(y), quantize_u8(cb), quantize_u8(cr)
