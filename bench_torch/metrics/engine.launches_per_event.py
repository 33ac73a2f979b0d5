"""Engine and plain lane (``pipeline/engine.py``, ``ops/develop.py``): device
kernels the profiler saw in the traced window per slider event (copies
not counted)."""


def read(record):
    tr = record.get("trace")
    if not tr or tr.get("busy_s") is None or not record.get("events"):
        return None
    return tr["launches"] / record["events"]
