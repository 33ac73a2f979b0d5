"""The least time the exporter's output stage needs for one image on one
H100, at the rates of ``bounds.py`` (3.35 TB/s, 67 TFLOP/s f32): its f32
operations over the one, or its bytes (each read or written once) over
the other, whichever is larger.

It prices the work a banded resize must do, not what the program's dense
per-axis matrices do, so that any later design is read on the same
yardstick. Each pass of the ``long_edge`` resize (Lanczos-3, antialiased:
``2 x 3 x max(1, in / out)`` taps an output sample) costs a multiply and
an add a tap, for each of three channels, over every sample it writes; an
axis that keeps its size takes no pass; of the two orders, the cheaper.
For JPEG planes the 4:2:0 conversion of the resized words adds
``linear_bounds.YCBCR420_OPS`` an output pixel. The bytes are the RGBA
words read (4 a pixel in) and the output written: 4:2:0 planes (1.5 a
pixel out) or RGBA words (4)."""

from __future__ import annotations

from bench_torch.yardstick.bounds import F32_OPS_PER_S, HBM_BYTES_PER_S
from bench_torch.yardstick.linear_bounds import YCBCR420_OPS

RADIUS = 3  # Lanczos-3
CHANNELS = 3
WORD_BYTES = 4.0
OUT_BYTES = {"planes": 1.5, "words": 4.0}


def taps(in_size: int, out_size: int) -> float:
    """Input samples an output sample of one axis sums."""
    return 2.0 * RADIUS * max(1.0, in_size / out_size)


def _pass(samples: int, in_size: int, out_size: int) -> float:
    """Multiply-adds of one pass writing ``samples`` samples a channel;
    none where the axis keeps its size."""
    return 0.0 if in_size == out_size else samples * taps(in_size, out_size)


def resize_ops(in_h: int, in_w: int, out_h: int, out_w: int) -> float:
    """f32 operations of the banded resize, in the cheaper order."""
    rows_first = (_pass(out_h * in_w, in_h, out_h)
                  + _pass(out_h * out_w, in_w, out_w))
    cols_first = (_pass(in_h * out_w, in_w, out_w)
                  + _pass(out_h * out_w, in_h, out_h))
    return 2.0 * CHANNELS * min(rows_first, cols_first)


def bound(in_h: int, in_w: int, out_h: int, out_w: int, output: str):
    """(ms, "bytes" or "operations"): the least time of the output stage
    over one (in_h, in_w) image resized to (out_h, out_w) and left as
    ``output`` ("planes" or "words")."""
    out_px = out_h * out_w
    ops = resize_ops(in_h, in_w, out_h, out_w) + (
        YCBCR420_OPS * out_px if output == "planes" else 0.0)
    nbytes = in_h * in_w * WORD_BYTES + out_px * OUT_BYTES[output]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
