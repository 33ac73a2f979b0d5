"""Develop and extras kernels (``csrc/`` via ``ops/fused_develop.py`` and
``ops/fused_extras.py``): per cent of the kernels' device time that the
frames' work needs at the H100's published peaks.

The numerator is the sum over the images the traced call wrote of the
least time each image's work needs (``yardstick/bounds.py``: the demosaic
by pattern and tier, the finish, the transfer, the extras by their flags,
the 4:2:0 output), whatever computes it; the denominator is the device
time of every kernel in the window that is not a copy. State it with the
card's power limit beside it (the run prints it on standard error)."""

import numpy as np

from bench_torch.yardstick import bounds


def _image_ms(w: dict) -> float:
    key = w["demosaic"]
    if w["pattern"]:
        grid = np.array(["RGB".index(c) for c in w["pattern"]]).reshape(6, 6)
        bounds.DEMOSAIC_OPS.update(bounds.cfa_demosaic_ops(grid))
        key = "cfa_" + key
    px = w["pixels"]
    if w["extras"]:
        mixer_on, grading_on, stencils = w["extras"]
        return (bounds.bound(px, key, w["gamma"], "rgba")[0]
                + bounds.extras_bound(px, mixer_on, grading_on, stencils,
                                      "ycbcr420")[0])
    return bounds.bound(px, key, w["gamma"], "ycbcr420")[0]


def read(record):
    tr = record.get("trace")
    work = record.get("work")
    if not tr or not work or not tr.get("kernel_s"):
        return None
    need_s = sum(_image_ms(w) for w in work) / 1e3
    return 100.0 * need_s / tr["kernel_s"]
