"""Plain LinearRaw lane (``parallel/batch.py``, ``ops/develop.py``): per
cent of the lane's device time that its slots need at the H100's
published peaks.

The numerator is the sum over the slots the exporter developed on the
lane (``develop.slots.linear``) of one frame's least time
(``yardstick/linear_bounds.bound``: the larger of its bytes over 3.35
TB/s and its f32 operations over 67 TFLOP/s): RGBA words for a slot the
extras kernel then reads (``extras.slots``), 4:2:0 planes for the others,
as an all-JPEG run of even frames leaves them. The frame's pixels come
from the images the window wrote. The denominator is the lane's device
time (``_linear.lane_s``: every kernel of the window that is not a copy
and not one of the port's named CUDA kernels). None where no LinearRaw
slot ran, where the call also ran other routes, where the trace holds no
kernel, or where the window's frames differ in size."""

from bench_torch.metrics._linear import counters, lane_s
from bench_torch.yardstick import linear_bounds


def read(record):
    got = counters(record)
    device_s = lane_s(record)
    pixels = {w["pixels"] for w in record.get("work") or ()}
    if got is None or device_s is None or len(pixels) != 1:
        return None
    px = pixels.pop()
    words = got.get("extras.slots", 0)
    planes = got["develop.slots.linear"] - words
    need_ms = (planes * linear_bounds.bound(px, "planes")[0]
               + words * linear_bounds.bound(px, "words")[0])
    return 100.0 * need_ms / 1e3 / device_s
