"""The exporter's output stage (``ops/geometry.shape_output``, the
``long_edge`` resize ``ops/resize.py``, and the words-to-4:2:0 conversion
``ops/jpeg.py``): milliseconds of device time in the stage's kernels per
image it shaped (``shape.images``). The stage runs plain torch operators,
so its time is that of every kernel of the window that is neither a copy
nor one of the port's named CUDA kernels (``_linear.lane_s``). None where
the call did not shape every slot it developed, or where the trace holds
no such kernel."""

from bench_torch.metrics._linear import lane_s
from bench_torch.metrics._shape import counters


def read(record):
    got = counters(record)
    device_s = lane_s(record)
    if got is None or device_s is None:
        return None
    return 1e3 * device_s / got["shape.images"]
