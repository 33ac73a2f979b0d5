"""Plain LinearRaw lane (``parallel/batch.py``, ``ops/develop.py``):
milliseconds of device time in the lane's kernels (every kernel of the
window that is not a copy and not one of the port's named CUDA kernels,
``develop_*``, ``extras_*``, ``unpack_slots``: ``_linear.lane_s``) per
slot the exporter developed on it (``develop.slots.linear``): the
in-window cost of one LinearRaw frame. None where no LinearRaw slot ran,
where a call also ran other routes, or where the trace holds no kernel."""

from bench_torch.metrics._linear import counters, lane_s


def read(record):
    got = counters(record)
    device_s = lane_s(record)
    if got is None or device_s is None:
        return None
    return 1e3 * device_s / got["develop.slots.linear"]
