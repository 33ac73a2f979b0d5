"""Develop and extras kernels, the finish-extras route: the per cent of
the batch slots the extras kernel (B8) ran over whose image asked for
finish extras (``extras.asked`` over ``extras.slots``)."""

from bench_torch.metrics._stages import percent


def read(record):
    return percent(record, "extras.asked", "extras.slots")
