"""Helpers the per-layer readers share (not a metric: no entry in
``BENCHMARK.json`` names it)."""


def per_image_ms(record: dict, field: str):
    """Milliseconds of an ``ExportReport`` field per image written, or
    None when the record has no export report or no image."""
    rep = record.get("report")
    if not rep or not rep.get("succeeded"):
        return None
    return rep[field] * 1e3 / rep["succeeded"]


def idle_share(record: dict):
    """Per cent of the traced window in which no device event ran, or None
    when the profiler saw none."""
    tr = record.get("trace")
    if not tr or tr.get("busy_s") is None or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def median_ms(record: dict, verb: str):
    """Median of the client's round trips of ``verb``, or None."""
    import statistics

    xs = record.get("spans_ms", {}).get(verb)
    return statistics.median(xs) if xs else None
