"""Batch exporter (``pipeline/export.py``): milliseconds per image the
exporter waited on its JPEG encode pool (``ExportReport.encode_seconds``)."""

from bench_torch.metrics._ratio import per_image_ms


def read(record):
    return per_image_ms(record, "encode_seconds")
