"""Host decode (``raw/``): worker-milliseconds of decode per image, the
exporter's ``ExportReport.decode_seconds`` (codec and metadata, summed
over the decode threads) over the images written."""

from bench_torch.metrics._ratio import per_image_ms


def read(record):
    return per_image_ms(record, "decode_seconds")
