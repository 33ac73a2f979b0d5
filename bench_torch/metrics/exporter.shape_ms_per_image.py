"""Batch exporter (``pipeline/export.py``), host dispatch of the output
stage: milliseconds per image written of the shaped flushes' output stage
and words-to-planes conversion on the host (the ``export.shape`` spans,
children of ``export.launch``). None for a program without that span."""

from bench_torch.metrics._stages import per_image_ms


def read(record):
    return per_image_ms(record, "export.shape")
