"""X-Trans grad kernel (B7, ``csrc/develop_grad_generic.cu`` via
``ops/fused_develop.py``): milliseconds of device time in every kernel
whose name contains ``develop_grad_cfa_bands`` per slot the exporter
developed on that route (the ``develop.slots.cfa_grad.*`` counters,
which count the images' own slots: a flush launches at its length), over
both outputs: the in-window cost of one X-Trans frame. None when either
is missing."""

from bench_torch.metrics._routes import kernel_s, route_slots

KERNEL = "develop_grad_cfa_bands"


def read(record):
    slots = route_slots(record, "cfa_grad")
    device_s = kernel_s(record, KERNEL)
    if slots is None or device_s is None:
        return None
    return 1e3 * device_s / sum(slots.values())
