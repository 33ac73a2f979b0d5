"""The exporter's output stage (``ops/geometry.shape_output``,
``ops/resize.py``, ``ops/jpeg.py``): per cent of the stage's device time
that its images need at the H100's published peaks.

The numerator is the sum over the images the window wrote of one image's
least time (``yardstick/shape_bounds.bound``: the banded Lanczos-3
resize's operations and the conversion's, or the words read and the
output written, from the sizes the driver records in ``shaped``, taken
only where they sum to the program's ``shape.*`` counters). The
denominator is the stage's device time (``_linear.lane_s``: every kernel
of the window that is neither a copy nor one of the port's named CUDA
kernels), as ``kernels.shape_ms_per_image`` reads it. None where that
reader reads nothing, or the record has no sizes or sizes the program
did not count."""

from bench_torch.metrics._linear import lane_s
from bench_torch.metrics._shape import sizes
from bench_torch.yardstick import shape_bounds


def read(record):
    shaped = sizes(record)
    device_s = lane_s(record)
    if shaped is None or device_s is None:
        return None
    need_ms = sum(shape_bounds.bound(*s["in"], *s["out"], s["output"])[0]
                  for s in shaped)
    return 100.0 * need_ms / 1e3 / device_s
