"""Batch exporter (``pipeline/export.py``): images written over the wall
time of the window's one ``run_batch_export`` call, by the host's clock,
from its start to the last file written (the traced run's call, so under
the profiler)."""


def read(record):
    if not record.get("images") or not record.get("call_s"):
        return None
    return record["images"] / record["call_s"]
