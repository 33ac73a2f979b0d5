"""Batch exporter (``pipeline/export.py``): milliseconds per image of the
device-to-host copy of the developed planes (``ExportReport.fetch_seconds``)."""

from bench_torch.metrics._ratio import per_image_ms


def read(record):
    return per_image_ms(record, "fetch_seconds")
