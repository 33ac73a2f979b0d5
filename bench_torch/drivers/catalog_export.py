"""The general generator of batch-export traffic: a closed loop over a
catalog, read from a traffic mix whose ``driver`` is ``catalog_export``.

The mix's keys: ``catalog_files`` (files written and imported),
``sliders`` ({slider: [low, high]}: a set of edits drawn once, the same
for every seed, which the seed deals to the files), ``extras_every``
(every n-th edit also carries the extras edit, its amounts scaled by a
draw in ``extras_scale``), ``export`` (keyword arguments of
``run_batch_export`` on top of the configuration's ``flags``, and
``ext``, the output extension), ``window_images_per_s`` and ``limits``.

Set-up writes the catalog, imports it into a ``Library`` with the edits,
loads the kernels and exports the catalog once (the warm pass). The
window is one ``run_batch_export`` call over the catalog repeated R times
to distinct paths: a user exporting a shoot. R is fixed by ``--seconds``
and the mix's ``window_images_per_s`` alone, so that every run of a
length does the same work whatever the host's speed; the call lasts
about ``--seconds`` at that rate.
``export_images_per_s`` is the images written over the call's wall time.
The call's progress (images done against seconds, at most one reading a
second, as the CLI's ``--progress`` reports it) goes to standard error
with the window's line.

The check, after the window, covers every file (``check``): the planes
the exporter handed its JPEG encoder are observed by wrapping
``pipeline.export._encode_one_jpeg420``, for the first copy of each
file; the configuration's reference (``core.reference_of``) develops the
mosaic and metadata that were written.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from bench_torch import core
from bench_torch.drivers.files import write_files
from bench_torch.yardstick.scene import XEDIT


# The fixed stream the catalog's set of edits is drawn from.
EDIT_STREAM = 20261017
# What the check calls on the configuration's reference: a configuration
# whose reference lacks it makes no cell under this driver's mixes.
REFERENCE = ("export_planes",)


class State:
    pass


def _edits(mix: dict, rng, n: int):
    """Edits for the catalog's n files in the export's order: the same set
    for every seed (drawn from a fixed stream). Each draws the sliders
    from their ranges; every ``extras_every``-th carries the extras edit
    too, scaled by one draw. The seed deals the plain edits among the
    plain places and the extras edits among the extras places, so that it
    changes which file carries which edit but not the work: the exporter
    runs its extras kernel over every batch that holds an extras edit, so
    where they stand in the order sets the device's work."""
    fixed = np.random.default_rng(EDIT_STREAM)
    lo, hi = mix["extras_scale"]
    every = mix["extras_every"]
    extras = [bool(every) and i % every == every - 1 for i in range(n)]
    out = []
    for i in range(n):
        e = {k: float(fixed.uniform(a, b)) for k, (a, b) in
             sorted(mix["sliders"].items())}
        scale = float(fixed.uniform(lo, hi))
        if extras[i]:
            e.update({k: v * scale for k, v in XEDIT.items()})
        out.append(e)
    dealt = list(range(n))
    for flag in (False, True):
        places = [i for i in range(n) if extras[i] == flag]
        for dst, k in zip(places, rng.permutation(len(places))):
            dealt[dst] = places[k]
    return [out[i] for i in dealt]


def flags_of(ctx) -> dict:
    """``run_batch_export`` keywords: the configuration's flags, then the
    mix's ``export`` keys."""
    flags = dict(ctx.cfg["flags"])
    flags.update({k: v for k, v in ctx.mix["export"].items() if k != "ext"})
    return flags


def _export_kwargs(ctx):
    f = flags_of(ctx)
    # The keywords the check's reference follows; an output stage it does
    # not compute (resize, geometry, 16-bit, 4:4:4) needs a driver that
    # does.
    keep = ("batch_size", "decode_threads", "encode_threads", "quality",
            "mode", "demosaic_method", "use_kernel", "color_space")
    kw = {k: f[k] for k in keep if k in f}
    # The CLI passes no transfer for its default, gamma22.
    kw["transfer"] = None if f["transfer"] == "gamma22" else f["transfer"]
    kw["device"] = ctx.device
    return kw


def setup(ctx):
    from raweditor_tpu_torch import EditParams, Library
    from raweditor_tpu_torch.pipeline.export import (jobs_from_catalog,
                                                     run_batch_export)

    st = State()
    st.reference = core.reference_of(ctx.cfg)
    mix = ctx.mix
    n = int(ctx.rehearsal.get("catalog_files", mix["catalog_files"]))
    with ctx.setup.phase("write_files"):
        folder = ctx.workdir / "catalog"
        st.files = write_files(ctx.cfg, folder, n, ctx.rng("scene"),
                               ctx.rehearsal, ctx.device)
    st.edits = _edits(mix, ctx.rng("edits"), n)
    with ctx.setup.phase("catalog"):
        st.lib = Library(str(ctx.workdir / "catalog.db"))
        got = st.lib.import_folder(str(folder))
        if got != {"imported": n, "skipped": 0}:
            raise RuntimeError(f"catalog import {got}")
        # The edits go to the files in the order the export takes them.
        images = st.lib.get_all_images()
        order = [img.path for img in images]
        frames = dict(st.files)
        st.frames = {}
        for img, e in zip(images, st.edits):
            st.lib.save_edit_params(img.id, EditParams(**e))
            st.frames[img.path] = (frames[img.path], e)
        st.base_jobs = jobs_from_catalog(st.lib, str(ctx.workdir / "warm"),
                                         ext=mix["export"]["ext"])
        if [j.raw_path for j in st.base_jobs] != order:
            raise RuntimeError("the export's order is not the catalog's")
    if ctx.cuda:
        with ctx.setup.phase("kernel_load"):
            from raweditor_tpu_torch.ops import _build

            _build.load()
    st.kw = _export_kwargs(ctx)
    with ctx.setup.phase("warm_up"):
        rep = run_batch_export(st.base_jobs, **st.kw)
        ctx.sync()
    if rep.succeeded != n or rep.failed:
        raise RuntimeError(f"warm pass: {rep.as_dict()} {rep.failed[:2]}")
    st.warm_rate = rep.succeeded / rep.seconds
    return st


def window(ctx, st, seconds, trace):
    import time

    from raweditor_tpu_torch.pipeline import export as _export

    n = len(st.base_jobs)
    # A fixed amount of work for a window of this length: sized from the
    # mix, never from a rate read in this process, which would carry the
    # host's speed of the moment into the work.
    rate = float(ctx.mix["window_images_per_s"])
    repeats = int(ctx.rehearsal.get(
        "repeats", max(1, math.ceil(seconds * rate / n))))
    out_dir = ctx.workdir / "window"
    jobs = [_export.ExportJob(j.raw_path, os.path.join(
        out_dir, f"{r:03d}_{os.path.basename(j.out_path)}"), j.params,
        j.image_id) for r in range(repeats) for j in st.base_jobs]
    source = {j.out_path: j.raw_path for j in jobs}
    st.captured = {}
    encode = _export._encode_one_jpeg420

    def observed(out_path, y, cb, cr, *args, **kwargs):
        # The planes of the first copy of each file to reach the encoder.
        st.captured.setdefault(source.get(out_path), (out_path, y, cb, cr))
        return encode(out_path, y, cb, cr, *args, **kwargs)

    progress = []

    def on_progress(done, failed, total, call_s):
        progress.append([done, round(call_s, 3)])

    _export._encode_one_jpeg420 = observed
    try:
        t0 = time.perf_counter()
        rep = _export.run_batch_export(jobs, on_progress=on_progress,
                                       **st.kw)
        ctx.sync()
        wall = time.perf_counter() - t0
    finally:
        _export._encode_one_jpeg420 = encode
    st.jobs = jobs
    st.report = rep
    core.log("window " + json.dumps({"repeats": repeats, "images":
                                     rep.succeeded, "call_s": wall,
                                     "warm_rate": st.warm_rate,
                                     "progress": progress}))
    failed_paths = {p for p, _ in rep.failed}
    work = {path: _work_of(frame, edit, flags_of(ctx))
            for path, (frame, edit) in st.frames.items()}
    return {
        "attempted": len(jobs),
        "failed": len(rep.failed) + (rep.total - rep.succeeded
                                     - len(rep.failed) - rep.skipped),
        "e2e": {"export_images_per_s": rep.succeeded / wall},
        "repeats": repeats,
        "images": rep.succeeded,
        "call_s": wall,
        "report": {k: getattr(rep, k) for k in (
            "total", "succeeded", "seconds", "decode_seconds",
            "decode_megapixels", "stage_seconds", "device_seconds",
            "encode_seconds", "fetch_seconds", "fetch_bytes",
            "upload_seconds", "upload_bytes")},
        # What each written image developed: the roofline reader's input.
        "work": [work[j.raw_path] for j in jobs
                 if j.raw_path not in failed_paths],
    }


def _work_of(frame, edit: dict, flags: dict) -> dict:
    """The develop work one image of this file needs, as the yardstick's
    bounds take it: pixels (the frame's rows times columns, whatever
    samples a pixel carries), demosaic (with the X-Trans pattern), the
    kernels' transfer lane, and the extras flags or None."""
    from bench_torch.yardstick.color import kernel_gamma_for
    from bench_torch.yardstick.ops.cfa_generic import generic_cfa_method
    from bench_torch.yardstick.ops.fused_extras import pack_extras
    from bench_torch.yardstick.params import EditParams

    params = EditParams(**edit)
    _, mixer_on, grading_on, stencils = pack_extras([params])
    on = params.has_finish_extras() and (mixer_on or grading_on or stencils)
    demosaic = flags["demosaic_method"]
    h, w = frame.mosaic.shape[:2]
    return {"pixels": int(h) * int(w),
            "demosaic": (generic_cfa_method(demosaic) if frame.pattern
                         else demosaic),
            "pattern": frame.pattern,
            "gamma": kernel_gamma_for(flags["transfer"]),
            "extras": [bool(mixer_on), bool(grading_on), bool(stencils)]
            if on else None}


def release(ctx, st):
    """Free the program's state before the reference runs."""
    st.lib.close()
    st.report = None
    if ctx.cuda:
        import torch

        torch.cuda.empty_cache()


def _exif_of(data: bytes) -> bytes:
    """The payload of a JPEG's EXIF APP1 segment, which the exporter
    splices right after SOI; empty when there is none."""
    if data[:4] != b"\xff\xd8\xff\xe1":
        return b""
    return data[6:4 + int.from_bytes(data[4:6], "big")]


def check(ctx, st, record):
    """Every job written and none failed; every repeat of a file written
    with the same bytes as its first copy; for one copy of every file,
    the planes the exporter handed its encoder against the reference's
    (``tolerance_lsb``), the written JPEG decoded by libjpeg against the
    reference's planes (the mix's ``jpeg_max_lsb``), its quantisation
    tables against libjpeg's at the configuration's quality, and the
    camera's make and model in its EXIF."""
    from bench_torch.yardstick import jfif
    from bench_torch.yardstick.params import EditParams

    limits = ctx.mix["limits"]
    flags = flags_of(ctx)
    missing = sum(not os.path.exists(j.out_path) for j in st.jobs)
    copies = {}
    for job in st.jobs:
        copies.setdefault(job.raw_path, []).append(job.out_path)
    planes_worst, jpeg_worst, differing, no_exif, tables = 0, 0, 0, 0, 0
    make = ctx.cfg["camera"]["make"].encode() + b"\0"
    model = ctx.cfg["camera"]["model"].encode() + b"\0"
    for raw_path, (frame, edit) in st.frames.items():
        got = st.captured.get(raw_path)
        if got is None or not os.path.exists(got[0]):
            missing += got is None  # an unwritten file is counted above
            continue
        first, planes = got[0], got[1:]
        with open(first, "rb") as f:
            body = f.read()
        for path in copies.get(raw_path, ()):
            if path != first and os.path.exists(path):
                with open(path, "rb") as f:
                    differing += f.read() != body
        want = st.reference.export_planes(frame, EditParams(**edit),
                                          ctx.device, flags)
        for a, b in zip(planes, want):
            planes_worst = max(planes_worst, 255 if a.shape != b.shape else
                               int(np.abs(a.astype(np.int16)
                                          - b.astype(np.int16)).max()))
        jpeg_worst = max(jpeg_worst, jfif.max_lsb(first, want))
        tables += jfif.tables_differ(first, flags["quality"])
        exif = _exif_of(body)
        no_exif += not (make in exif and model in exif)
    return {
        "unwritten_or_failed": {"value": missing + record["failed"],
                                "limit": limits["unwritten_or_failed"]},
        "copies_differing": {"value": differing,
                             "limit": limits["copies_differing"]},
        "planes_max_lsb": {"value": planes_worst,
                           "limit": int(ctx.cfg["tolerance_lsb"])},
        "jpeg_max_lsb": {"value": jpeg_worst,
                         "limit": limits["jpeg_max_lsb"]},
        "jpeg_tables_mismatch": {"value": tables,
                                 "limit": limits["jpeg_tables_mismatch"]},
        "exif_missing": {"value": no_exif, "limit": limits["exif_missing"]},
    }
