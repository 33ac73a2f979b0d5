"""Batch exporter (``pipeline/export.py``), calling thread: milliseconds
per image written that the thread which launches every flush spent
waiting on the next decode (the ``export.wait_decode`` spans)."""

from bench_torch.metrics._stages import per_image_ms


def read(record):
    return per_image_ms(record, "export.wait_decode")
