"""The general generator of web-delivery export traffic: ``catalog_export``'s
closed loop with the exporter's output stage on, read from a traffic mix
whose ``driver`` is ``catalog_export_web``.

The mix has ``catalog_export``'s keys; its ``export`` also gives
``long_edge``, the side every image's longer side is resized to
(``run_batch_export(long_edge=...)``, as a photographer's "Resize to Fit:
Long Edge"). Set-up, window, release and check are ``catalog_export``'s,
with ``long_edge`` passed to the warm pass and to the window's call, and
the check's planes taken from the configuration's reference by
``shaped_planes``. Under a rehearsal the long edge is cut by the factor
its frame's longer side is cut by, so that the tiny frame is resized by
the cell's own ratio. The record also carries, for each image written
whose file reached the JFIF encoder as planes, its frame's size and the
size of the luma plane the encoder got (``shaped``), which the output
stage's roofline reader prices.

The check adds ``planes_off_ppm``: of every sample of the planes it
compares, the parts per million that differ from the reference's at all,
against the mix's limit of that name. A resize whose matrix products run
in TF32 stays within ``tolerance_lsb`` (it moves a sample by one LSB at
most) but moves some hundred times more samples than an f32 one.
"""

from __future__ import annotations

import numpy as np

from bench_torch.drivers import catalog_export as _export
from bench_torch.drivers.files import shape as frame_shape

# What the check calls on the configuration's reference: only a
# reference that computes the output stage makes a cell under this
# driver's mixes.
REFERENCE = ("shaped_planes",)

release = _export.release
# The call's keywords as ``catalog_export`` derives them.
_plain_kwargs = _export._export_kwargs


def long_edge_of(ctx) -> int:
    """The mix's long edge, or under a rehearsal that long edge cut as the
    frame's longer side is."""
    long_edge = int(ctx.mix["export"]["long_edge"])
    full = max(ctx.cfg["height"], ctx.cfg["width"])
    frame = max(frame_shape(ctx.cfg, ctx.rehearsal))
    return long_edge if frame == full else max(
        2, round(long_edge * frame / full))


def _export_kwargs(ctx):
    return dict(_plain_kwargs(ctx), long_edge=long_edge_of(ctx))


class _Shaped:
    """The configuration's reference as ``catalog_export.check`` calls it:
    its ``export_planes`` are the reference's ``shaped_planes`` at the
    call's long edge, kept by the frame they were asked for (``given``)
    for ``planes_off_ppm``."""

    def __init__(self, module, long_edge: int):
        self.module, self.long_edge, self.given = module, long_edge, {}

    def export_planes(self, frame, params, device, flags):
        want = self.module.shaped_planes(frame, params, device, dict(
            flags, long_edge=self.long_edge))
        self.given[id(frame)] = want
        return want


def setup(ctx):
    # ``catalog_export.setup`` takes the call's keywords from its module's
    # ``_export_kwargs`` at call time: its warm pass then resizes too, so
    # that every shape the window uses is warmed in set-up.
    _export._export_kwargs = _export_kwargs
    try:
        st = _export.setup(ctx)
    finally:
        _export._export_kwargs = _plain_kwargs
    st.reference = _Shaped(st.reference, st.kw["long_edge"])
    return st


def window(ctx, st, seconds, trace):
    record = _export.window(ctx, st, seconds, trace)
    failed = {p for p, _ in st.report.failed}
    sizes = {path: {"in": list(frame.mosaic.shape[:2]),
                    "out": list(st.captured[path][1].shape),
                    "output": "planes"}
             for path, (frame, _) in st.frames.items()
             if path in st.captured}
    record["shaped"] = [sizes[j.raw_path] for j in st.jobs
                        if j.raw_path in sizes and j.raw_path not in failed]
    return record


def check(ctx, st, record):
    """``catalog_export``'s check, and ``planes_off_ppm`` over the planes
    it compared: a plane of another size counts as every sample off."""
    st.reference.given = {}
    checks = _export.check(ctx, st, record)
    off = total = 0
    for raw_path, (frame, _) in st.frames.items():
        got, want = st.captured.get(raw_path), st.reference.given.get(
            id(frame))
        if got is None or want is None:
            continue
        for a, b in zip(got[1:], want):
            total += b.size
            off += b.size if a.shape != b.shape else int(
                np.count_nonzero(a != b))
    checks["planes_off_ppm"] = {
        "value": 1e6 * off / total if total else 0.0,
        "limit": ctx.mix["limits"]["planes_off_ppm"]}
    return checks
