"""Session and server (``pipeline/session.py``, ``pipeline/serve.py``): median
milliseconds of the client's round trip of ``set <slider> <value>`` (the
pipelined tick's dispatch, the catalog write, the TCP hop)."""

from bench_torch.metrics._ratio import median_ms


def read(record):
    return median_ms(record, "set")
