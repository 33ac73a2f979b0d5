"""X-Trans grad kernel (B7, ``csrc/develop_grad_generic.cu`` via
``ops/fused_develop.py``): per cent of its device time that the slots it
developed need at the H100's published peaks.

The numerator is, for each output, the exporter's ``develop.slots.
cfa_grad.<output>`` counter (the images' own slots, the ones the kernel
develops: a flush launches at its length) times the least time of one
frame (``yardstick/bounds.py``: ``bound`` of the ``cfa_grad`` tier on the
pattern's grid, at ``ycbcr420`` for ``planes`` and ``rgba`` for
``rgba``); the frame's
pixels, 36-letter CFA and transfer lane come from the images the window
wrote, which carry the configuration's. The denominator is the device
time of every kernel whose name contains ``develop_grad_cfa_bands``.
None when either is missing, or when the window's X-Trans frames differ
in size, pattern or transfer."""

import numpy as np

from bench_torch.metrics._routes import kernel_s, route_slots
from bench_torch.yardstick import bounds

KERNEL = "develop_grad_cfa_bands"
OUTPUTS = {"planes": "ycbcr420", "rgba": "rgba"}


def read(record):
    slots = route_slots(record, "cfa_grad")
    device_s = kernel_s(record, KERNEL)
    frames = {(w["pixels"], w["pattern"], w["gamma"])
              for w in record.get("work") or () if w.get("pattern")}
    if slots is None or device_s is None or len(frames) != 1:
        return None
    pixels, pattern, gamma = frames.pop()
    grid = np.array(["RGB".index(c) for c in pattern]).reshape(6, 6)
    bounds.DEMOSAIC_OPS.update(bounds.cfa_demosaic_ops(grid))
    need_ms = sum(n * bounds.bound(pixels, "cfa_grad", gamma,
                                   OUTPUTS[out])[0]
                  for out, n in slots.items())
    return 100.0 * need_ms / 1e3 / device_s
