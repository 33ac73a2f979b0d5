"""Staging (``ops/staging.py``): milliseconds per image the flush waited for
the upload thread plus the unpack and stack (``ExportReport.upload_seconds``)."""

from bench_torch.metrics._ratio import per_image_ms


def read(record):
    return per_image_ms(record, "upload_seconds")
