"""The least time the plain LinearRaw lane needs for one frame on one
H100, at the rates of ``bounds.py`` (3.35 TB/s, 67 TFLOP/s f32): its f32
operations over the one, or its bytes (each read or written once) over
the other, whichever is larger. ``bounds.py`` prices the CFA develop
kernels; this prices the lane a LinearRaw frame takes, which has no
demosaic and no kernel of its own.

The operations are every f32 element the frozen lane's operators write,
counted once by ``count_ops`` (``ops/develop.develop_linear`` to RGBA
words, and for planes ``ops/jpeg.rgba_words_to_ycbcr420`` after it); an
element of a reduction or a quarter-size chroma plane counts once, a
power or a division counts one, so this is a lower bound. The bytes are
the three u16 samples read and the output written: 4:2:0 planes (1.5 a
pixel) for a slot that goes to the JPEG encoder, RGBA words (4) for a
slot the extras kernel reads after the lane."""

from __future__ import annotations

from bench_torch.yardstick.bounds import F32_OPS_PER_S, HBM_BYTES_PER_S

# f32 operations a pixel, from count_ops(): the develop to words, and the
# 4:2:0 conversion of the words.
DEVELOP_OPS = 116.0
YCBCR420_OPS = 24.0
READ_BYTES = 6.0
OUT_BYTES = {"planes": 1.5, "words": 4.0}


def bound(n_px: int, output: str):
    """(ms, "bytes" or "operations"): the least time of the lane over one
    frame of ``n_px`` pixels to ``output`` ("planes" or "words")."""
    ops = DEVELOP_OPS + (YCBCR420_OPS if output == "planes" else 0.0)
    t_bytes = n_px * (READ_BYTES + OUT_BYTES[output]) / HBM_BYTES_PER_S * 1e3
    t_ops = n_px * ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def count_ops(h: int = 64, w: int = 64):
    """(develop, 4:2:0) f32 elements written a pixel by the frozen lane
    over a seeded (h, w, 3) u16 frame on the CPU: each operator's f32
    outputs of at least a quarter of the frame's pixels (the edit's
    scalars and the 3x3 matrix left out; views write nothing)."""
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from bench_torch.yardstick import color
    from bench_torch.yardstick.ops import develop, jpeg
    from bench_torch.yardstick.params import EditParams

    px = h * w

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                self.n += sum(t.numel() for t in tree_flatten(out)[0]
                              if isinstance(t, torch.Tensor)
                              and t.dtype == torch.float32
                              and 4 * t.numel() >= px)
            return out

    rgb = torch.from_numpy(np.random.default_rng(0).integers(
        0, 65536, (h, w, 3), dtype=np.uint16))
    cam = color.cam_to_output_matrix(np.eye(3, dtype=np.float32),
                                     "accurate", "srgb")
    with Count() as dev:
        words = develop.develop_linear(
            rgb, EditParams(exposure=0.3, contrast=10.0), [2.0, 1.0, 1.6],
            cam, 65535.0, 0.0, rgba=True)
    with Count() as conv:
        jpeg.rgba_words_to_ycbcr420(words[None])
    return dev.n / px, conv.n / px
