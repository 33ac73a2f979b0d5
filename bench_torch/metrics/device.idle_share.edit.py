"""Device: per cent of the traced slider window in which no device event ran
(1 - the union of the profiler's device intervals over the window)."""

from bench_torch.metrics._ratio import idle_share


def read(record):
    return idle_share(record)
