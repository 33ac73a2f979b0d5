"""Encode pool (``pipeline/export.py``, the program's JFIF encoder):
worker-milliseconds of encoding and writing per image written, summed
over the encode threads (the ``encode`` spans)."""

from bench_torch.metrics._stages import per_image_ms


def read(record):
    return per_image_ms(record, "encode")
