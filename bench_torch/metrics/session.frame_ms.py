"""Session and server: median milliseconds of the client's round trip of
``frame 80`` (flush, a second render, the 4:2:0 planes, the fetch, the host
encode and base64)."""

from bench_torch.metrics._ratio import median_ms


def read(record):
    return median_ms(record, "frame")
