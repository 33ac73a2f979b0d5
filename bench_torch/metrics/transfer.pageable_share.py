"""Host-device transfers (staging upload and fetch): the per cent of the
bytes the exporter copied between host and card that went through
pageable host memory (``transfer.pageable_bytes``) rather than pinned
(``transfer.pinned_bytes``)."""

from bench_torch.metrics._stages import percent


def read(record):
    return percent(record, "transfer.pageable_bytes",
                   "transfer.pageable_bytes", "transfer.pinned_bytes")
