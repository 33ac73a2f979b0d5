"""Helpers the readers of the exporter's spans and counters share (not a
metric: no entry in ``BENCHMARK.json`` names it).

The program keeps the newest finished ``run_batch_export`` call's report
in ``raweditor_tpu_torch.pipeline.export.LAST_REPORT`` (its ``as_dict()``,
whose ``stages`` holds every span's total and count and every counter).
A reader takes it only when it is the window's call: its ``succeeded``
equals the images the window wrote. A program without that report reads
nothing."""


def stages(record: dict):
    """The window call's ``stages``, or None."""
    import importlib

    images = record.get("images")
    if not images:
        return None
    try:
        export = importlib.import_module(
            "raweditor_tpu_torch.pipeline.export")
    except ImportError:
        return None
    rep = getattr(export, "LAST_REPORT", None)
    if not isinstance(rep, dict) or rep.get("succeeded") != images:
        return None
    return rep.get("stages") or None


def span(record: dict, name: str):
    """``{"total_s", "count"}`` of the window call's span ``name``, or
    None."""
    st = stages(record)
    if st is None:
        return None
    return st.get("spans", {}).get(name)


def per_image_ms(record: dict, name: str):
    """Milliseconds of the span ``name`` over the call, per image
    written, or None."""
    s = span(record, name)
    return None if s is None else s["total_s"] * 1e3 / record["images"]


def mean_ms(record: dict, name: str):
    """The mean of the span ``name`` in milliseconds, or None."""
    s = span(record, name)
    return None if not s or not s["count"] else s["total_s"] * 1e3 / s[
        "count"]


def percent(record: dict, part: str, *whole: str):
    """100 x the counter ``part`` over the sum of the counters ``whole``,
    or None when they sum to 0 or were not counted."""
    st = stages(record)
    if st is None:
        return None
    counters = st.get("counters", {})
    if part not in counters or any(w not in counters for w in whole):
        return None
    total = sum(counters[w] for w in whole)
    return 100.0 * counters[part] / total if total else None
