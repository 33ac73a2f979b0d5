"""The device's busy time from a ``torch.profiler`` run: the union of
the intervals of its device events (kernels and copies).

The body of ``busy_union`` is copied verbatim from ``chip_smoke.py``
at commit e13d09fb7b94 (the comment names the lines);
``bench_torch/tests/test_copies.py`` holds it equal."""

import torch


def busy_union(prof):
    """(busy microseconds, sorted (start, end) device intervals) of
    the profiler run ``prof``."""
    # chip_smoke.py:676-682
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy_us, spans
