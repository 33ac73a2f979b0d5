"""Batch exporter (``pipeline/export.py``), host dispatch of the develop
alone: milliseconds per image written of the flushes' develop calls on
the host, on whichever route each flush takes (the develop kernel, the
plain lane or the 16-bit lane), without the reconstruction before them
or the extras post-pass and output stage after them (the
``export.develop`` spans, children of ``export.launch``). None for a
program without that span."""

from bench_torch.metrics._stages import per_image_ms


def read(record):
    return per_image_ms(record, "export.develop")
