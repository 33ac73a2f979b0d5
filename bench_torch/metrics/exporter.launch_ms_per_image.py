"""Batch exporter (``pipeline/export.py``), host dispatch: milliseconds
per image written of the flushes' launches on the host, from the staged
batch to the event recorded after the last kernel (the ``export.launch``
spans)."""

from bench_torch.metrics._stages import per_image_ms


def read(record):
    return per_image_ms(record, "export.launch")
