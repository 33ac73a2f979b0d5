"""Batch exporter (``pipeline/export.py``), batcher: the mean time an
image waits between the end of its decode and the start of the flush
that takes it (the ``queue.batch`` spans), in milliseconds."""

from bench_torch.metrics._stages import mean_ms


def read(record):
    return mean_ms(record, "queue.batch")
