"""Image resizing on the device: the preview tiers of a developed image
and the exporters' ``long_edge``.

The port's own module, written from the JAX package's ``ops/resize.py``,
which calls ``jax.image.resize``. ``resize_hw`` rebuilds that function
for the ``"linear"`` and ``"lanczos3"`` methods: per spatial axis a dense
(in, out) weight matrix (``weight_matrix``, JAX's ``compute_weight_mat``
with antialiasing: the kernel is widened by ``1/scale`` when it
downsamples, each output's weights are normalised by their sum, and
outputs whose sample falls outside the input are zero), then one
contraction per axis that changes size, in the order JAX's ``einsum``
picks (the one with fewer operations first). Everything is f32; the
contractions are matrix products, which must not run in TF32 on a card
(``torch.backends.cuda.matmul.allow_tf32`` False, the default, and
``torch.get_float32_matmul_precision() == "highest"``).

``resize_rgb`` and ``resize_rgb16`` run ``resize_hw``; packed RGBA words
(``resize_rgba_words``, the exporters' ``long_edge``) go through the
band of each matrix instead (``ops/fused_resize.py``: a kernel on the
card, a plain version on the CPU), which sums the same nonzero terms in
ascending input order. All round half to even (``torch.round``, JAX's
``jnp.round``), unlike the geometry stage's ``floor(x + 0.5)``. The weight
matrices are cached per size, method and device.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from raweditor_tpu_torch.ops.develop import _to_u16, f32, u16_to_f32

_F32 = torch.float32
_EPS = float(np.finfo(np.float32).eps)
METHODS = ("linear", "lanczos3")


def tier_shape(full_w: int, full_h: int, target_w: int) -> Tuple[int, int]:
    """Width-constrained aspect-preserving tier size (w, h)."""
    scale = target_w / full_w
    return target_w, max(1, round(full_h * scale))


def long_edge_shape(h: int, w: int, long_edge: int) -> Tuple[int, int]:
    """Aspect-preserving (out_h, out_w) with the longer side exactly
    ``long_edge``; (h, w) unchanged when the image already fits (never
    upscales)."""
    if long_edge <= 0 or max(h, w) <= long_edge:
        return h, w
    if w >= h:
        return max(1, round(h * long_edge / w)), long_edge
    return long_edge, max(1, round(w * long_edge / h))


def _kernel(method: str, x: torch.Tensor) -> torch.Tensor:
    """The interpolation kernel at distances ``x`` >= 0 (f32)."""
    if method == "linear":
        return torch.clamp_min(1.0 - torch.abs(x), 0.0)
    radius = 3.0
    px = x * f32(math.pi)
    # A tensor divisor: CUDA multiplies by the reciprocal of a host scalar.
    third = torch.tensor(radius, dtype=_F32, device=x.device)
    y = radius * torch.sin(px) * torch.sin(px / third)
    den = torch.where(x != 0, f32(math.pi ** 2) * (x * x),
                      torch.ones_like(x))
    out = torch.where(x > f32(1e-3), y / den, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


@functools.lru_cache(maxsize=16)
def _weight_matrix_cached(in_size: int, out_size: int, method: str,
                          device: str) -> torch.Tensor:
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=_F32, device=device) + 0.5)
              * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=_F32, device=device)
    x = torch.abs(sample[None, :] - src[:, None])
    if kernel_scale != 1.0:
        x = x / torch.tensor(kernel_scale, dtype=_F32, device=device)
    w = _kernel(method, x)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).contiguous()


def weight_matrix(in_size: int, out_size: int, method: str = "lanczos3",
                  device=None) -> torch.Tensor:
    """(in_size, out_size) f32 resampling weights of one axis: column
    ``o`` holds the weights of the input samples for output ``o``."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}; expected one "
                         f"of {METHODS}")
    return _weight_matrix_cached(int(in_size), int(out_size), method,
                                 str(torch.device(device or "cpu")))


def rows_first(h: int, w: int, out_h: int, out_w: int) -> bool:
    """Whether a resize that changes both axes contracts the rows (the
    height) first: the order with fewer operations, as JAX's ``einsum``
    picks it (ties to the rows)."""
    return h * w * out_h + out_h * w * out_w <= (h * w * out_w
                                                  + h * out_w * out_h)


def resize_hw(x: torch.Tensor, out_h: int, out_w: int,
              method: str = "lanczos3") -> torch.Tensor:
    """Resize the last two axes of an f32 tensor (..., H, W) to
    (out_h, out_w): ``jax.image.resize`` with antialiasing over those two
    axes. An axis that keeps its size is not touched; when both change,
    the contraction with fewer operations runs first, as JAX's
    ``einsum`` orders them."""
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device
    do_h, do_w = out_h != h, out_w != w

    def along_h(t):
        return torch.matmul(weight_matrix(h, out_h, method, dev).T, t)

    def along_w(t):
        return torch.matmul(t, weight_matrix(w, out_w, method, dev))

    if do_h and do_w:
        if rows_first(h, w, out_h, out_w):
            return along_w(along_h(x))
        return along_h(along_w(x))
    if do_h:
        return along_h(x)
    if do_w:
        return along_w(x)
    return x


def _resize_channels_last(x: torch.Tensor, out_h: int, out_w: int,
                          method: str) -> torch.Tensor:
    """(..., H, W, C) f32 resized over H and W, channels last."""
    planes = torch.movedim(x, -1, -3).contiguous()
    return torch.movedim(resize_hw(planes, out_h, out_w, method), -3, -1)


def resize_rgb(img_u8: torch.Tensor, out_w: int, out_h: int,
               method: str = "lanczos3") -> torch.Tensor:
    """(H, W, 3) u8 to (out_h, out_w, 3) u8 on the tensor's device."""
    y = _resize_channels_last(img_u8.to(_F32), out_h, out_w, method)
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def develop_tiers(img_u8: torch.Tensor,
                  widths: Sequence[int] = (256, 384, 1280),
                  method: str = "lanczos3"):
    """Every preview tier of a developed (H, W, 3) u8 image, resized on
    its device: a list of (h, w, 3) u8 tensors, one per width."""
    h, w = img_u8.shape[:2]
    out = []
    for tw in widths:
        ow, oh = tier_shape(w, h, tw)
        out.append(resize_rgb(img_u8, ow, oh, method))
    return out


def resize_rgba_words(words: torch.Tensor, out_w: int, out_h: int,
                      method: str = "lanczos3") -> torch.Tensor:
    """Packed RGBA words (H, W) or (N, H, W) u32, strided or not, to
    (..., out_h, out_w) u32: the banded resize of ``ops/fused_resize.py``
    (``resize_words``: its kernel for CUDA words, its plain version for
    CPU words), within 1 LSB of ``resize_hw`` over the R, G, B bytes,
    rounded half to even, clamped and repacked with opaque alpha."""
    from raweditor_tpu_torch.ops import fused_resize

    return fused_resize.resize_words(words.contiguous(), out_w, out_h, method)


def resize_rgb16(img_u16: torch.Tensor, out_w: int, out_h: int,
                 method: str = "lanczos3") -> torch.Tensor:
    """(..., H, W, 3) u16 to (..., out_h, out_w, 3) u16 (the 16-bit
    exports' ``long_edge``)."""
    y = _resize_channels_last(u16_to_f32(img_u16), out_h, out_w, method)
    return _to_u16(torch.clamp(torch.round(y), 0, 65535))
