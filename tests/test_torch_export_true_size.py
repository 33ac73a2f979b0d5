"""The batch exporter launches every flush at its own length
(``pipeline/export._ExportRun.flush``): a bucket that drains short of
``batch_size`` is staged, developed, extras-processed and fetched over
its images alone, and no slot is developed for an image that is never
written.

Each case exports one job list twice on the CPU device (where the kernel
route runs the kernels' plain versions): at ``batch_size`` 4, where
buckets drain short (of one and three images), and at ``batch_size`` 1,
where every bucket is full. Every file must be byte-equal between the
two, and the counters of the first must count the images' slots alone.
Files are tiny seeded 12-bit Bayer DNGs, X-Trans RAFs and LinearRaw DNGs
written by the port's writers."""

import collections
import os

import numpy as np
import pytest
import torch

from raweditor_tpu_torch import EditParams
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.ops import fused_extras as fx
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.raw import raf, synth

D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32) / 10000.0
SHAPE = (24, 36)
SLIDERS = [dict(exposure=0.3, contrast=5.0, saturation=20.0), dict(),
           dict(exposure=-0.6, shadows=0.3, vibrance=0.4, temperature=0.1)]
EXTRAS = dict(sharpen=40.0, vignette=-20.0, hue_red=20.0,
              grade_shadow_hue=200.0, grade_shadow_sat=30.0)
# Per kind of file: how many, and which of them (by index) ask for
# finish extras. Batches of four then drain short: the Bayer plain
# bucket 4 + 1, the Bayer extras bucket 3, the X-Trans plain bucket 4,
# the X-Trans extras bucket 1, the LinearRaw bucket 3.
FILES = {"bayer": (8, {1, 4, 6}), "xtrans": (5, {2}), "linear": (3, set())}
BATCH = 4
# name: (kinds of file exported, run_batch_export keywords, output
# extension, staging budget in bytes or None for the default, every
# other image's highlight recovery)
CASES = {
    "kernel-grad": (("bayer", "xtrans"), dict(use_kernel=True,
                                              mode="accurate",
                                              demosaic_method="grad"),
                    ".jpg", None, 0.0),
    "plain-png": (("bayer", "xtrans"), dict(mode="accurate",
                                            demosaic_method="malvar"),
                  ".png", None, 0.0),
    "nothing-staged": (("bayer", "xtrans"), dict(use_kernel=True,
                                                 mode="accurate",
                                                 demosaic_method="grad"),
                       ".jpg", 0, 0.0),
    # Room for two packed mosaics (1296 bytes each): the one decode
    # thread stages the first two images, and the first flush uploads
    # its other three into their slots.
    "stragglers": (("bayer", "xtrans"), dict(use_kernel=True,
                                             mode="accurate",
                                             demosaic_method="grad",
                                             decode_threads=1),
                   ".jpg", 2600, 0.0),
    "tiff16-recovery": (("bayer", "xtrans", "linear"),
                        dict(use_kernel=True, mode="accurate",
                             demosaic_method="grad", bits=16),
                        ".tif", None, 60.0),
    "linear-recovery": (("bayer", "linear"), dict(use_kernel=True,
                                                  mode="accurate",
                                                  demosaic_method="malvar"),
                        ".jpg", None, 60.0),
    "geometry": (("bayer", "xtrans"), dict(use_kernel=True,
                                           mode="accurate",
                                           demosaic_method="grad",
                                           rotate=2.0, long_edge=30),
                 ".jpg", None, 0.0),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{kind: [path, ...]} of the seeded files, written once."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(20)
    out = collections.defaultdict(list)
    for kind, (n, _) in FILES.items():
        for i in range(n):
            if kind == "bayer":
                p = root / f"b{i}.dng"
                synth.write_synthetic_raw(
                    p, rng.integers(0, 4096, size=SHAPE, dtype=np.uint16),
                    xyz_to_cam=D3300, black_level=150, white_level=4095,
                    wb_neutral=(0.5, 1.0, 0.625), preview_jpeg=b"")
            elif kind == "xtrans":
                p = root / f"x{i}.raf"
                p.write_bytes(raf.write_raf(
                    rng.integers(0, 4096, size=SHAPE, dtype=np.uint16),
                    model="X-T2", wb_grbg=(256, 512, 384, 256)))
            else:
                p = root / f"l{i}.dng"
                synth.write_synthetic_linear_dng(
                    p, rng.integers(64, 4096, size=SHAPE + (3,),
                                    dtype=np.uint16),
                    bpp=12, wb_neutral=(0.55, 1.0, 0.7), black_level=64)
            out[kind].append(str(p))
    return out


def _jobs(files, kinds, out, ext, recovery):
    """(jobs, {bucket: images}) of the case's files: the buckets are the
    exporter's (kind of frame, extras) keys, the frames being of one
    shape."""
    jobs, buckets = [], collections.Counter()
    for kind in kinds:
        n, extras = FILES[kind]
        for i, path in enumerate(files[kind]):
            edit = dict(SLIDERS[i % len(SLIDERS)])
            if i in extras:
                edit.update(EXTRAS)
            if i % 2:
                edit["highlight_recovery"] = recovery
            stem = os.path.splitext(os.path.basename(path))[0]
            jobs.append(pex.ExportJob(path, os.path.join(out, stem + ext),
                                      EditParams(**edit)))
            buckets[kind, i in extras] += 1
    return jobs, buckets


@pytest.fixture
def launches(monkeypatch):
    """{wrapper: [batch length of each call]} of the develop kernel's and
    the extras kernel's wrappers, and the mosaics each flush with nothing
    staged uploaded whole (``_ExportRun.to_device`` of a u16 stack)."""
    seen = collections.defaultdict(list)
    develop, extras = fd.fused_batch_develop_rgba, fx.fused_finish_extras_rgba
    to_device = pex._ExportRun.to_device

    def counted_develop(mosaics, *args, **kw):
        seen["develop"].append(mosaics.shape[0])
        return develop(mosaics, *args, **kw)

    def counted_extras(words, *args, **kw):
        seen["extras"].append(words.shape[0])
        return extras(words, *args, **kw)

    def counted_upload(self, t, out=None):
        if out is None and t.dtype == torch.uint16:
            seen["uploaded"].append((t.shape[0],
                                     t.numel() * t.element_size()))
        return to_device(self, t, out)

    monkeypatch.setattr(fd, "fused_batch_develop_rgba", counted_develop)
    monkeypatch.setattr(fx, "fused_finish_extras_rgba", counted_extras)
    monkeypatch.setattr(pex._ExportRun, "to_device", counted_upload)
    return seen


def _flushes(buckets, batch):
    """The lengths of the flushes that ``buckets`` make at ``batch``."""
    return sorted(m for n in buckets.values()
                  for m in [batch] * (n // batch) + [n % batch] if m)


@pytest.mark.parametrize("case", list(CASES))
def test_short_flushes_write_the_bytes_of_full_ones(case, files, launches,
                                                    tmp_path, monkeypatch):
    kinds, kw, ext, budget, recovery = CASES[case]
    if budget is not None:
        monkeypatch.setattr(pex, "_STAGE_BUDGET", budget)
    written, reports = {}, {}
    for batch in (BATCH, 1):
        out = str(tmp_path / f"b{batch}")
        jobs, buckets = _jobs(files, kinds, out, ext, recovery)
        launches.clear()
        rep = pex.run_batch_export(jobs, batch_size=batch, device="cpu",
                                   **kw)
        assert rep.succeeded == len(jobs) and not rep.failed, rep.failed
        reports[batch] = rep, dict(launches)
        written[batch] = {os.path.basename(j.out_path):
                          open(j.out_path, "rb").read() for j in jobs}
    assert written[BATCH].keys() == written[1].keys()
    for name, data in written[BATCH].items():
        assert data == written[1][name], name

    rep, seen = reports[BATCH]
    c = rep.stages["counters"]
    n = len(jobs)
    flushes = _flushes(buckets, BATCH)
    assert rep.timer.counts["export.flush"] == len(flushes)
    assert 1 in flushes and 3 in flushes  # the short drains
    assert c["slots.developed"] == n == sum(flushes)
    assert c["slots.unfilled"] == sum(BATCH - m for m in flushes) > 0
    assert reports[1][0].stages["counters"]["slots.unfilled"] == 0
    routes = {k: v for k, v in c.items() if k.startswith("develop.slots.")}
    assert sum(routes.values()) == c["slots.developed"]
    extras = sum(m for (_, ex), m in buckets.items() if ex)
    # The 16-bit lane runs its extras in the chain, not through B8.
    b8 = 0 if kw.get("bits") == 16 else extras
    assert c["extras.slots"] == c["extras.asked"] == b8
    xt_grad = buckets["xtrans", False] + buckets["xtrans", True]
    if kw.get("bits") == 16 or not kw.get("use_kernel") or (
            kw.get("demosaic_method") != "grad"):
        xt_grad = 0
    assert c.get("cfa_grad.period6_slots", 0) == xt_grad
    # Every launch takes its flush's images alone.
    kernel_flushes = sorted(
        m for key, k in buckets.items() if key[0] != "linear"
        for m in _flushes({key: k}, BATCH))
    if kw.get("use_kernel") and kw.get("bits") != 16:
        assert sorted(seen.get("develop", [])) == kernel_flushes
    else:
        assert "develop" not in seen
    if kw.get("bits") != 16:
        assert sorted(seen.get("extras", [])) == sorted(
            m for (_, ex), k in buckets.items() if ex
            for m in _flushes({0: k}, BATCH))
    # Staging: one slot an image where every mosaic staged; a flush with
    # nothing staged uploads its own images' mosaics, not a batch's.
    staged = (c["staging.slots_unpacked"] + c["staging.slots_copied"]
              + c["staging.slots_uploaded"])
    uploaded = seen.get("uploaded", [])
    assert staged + sum(m for m, _ in uploaded) == n
    frame = SHAPE[0] * SHAPE[1] * 2
    for m, nbytes in uploaded:
        assert 1 <= m <= BATCH and nbytes in (m * frame, m * frame * 3)
    if budget == 0:
        assert staged == 0 and sorted(m for m, _ in uploaded) == flushes
    elif budget is None:
        assert not uploaded and c["staging.slots_uploaded"] == 0
    else:
        assert c["staging.slots_uploaded"] > 0


def test_a_flush_launches_no_slot_past_its_images(files, launches, tmp_path,
                                                  monkeypatch):
    """One image in a batch of eight: the develop, the extras and the
    staging fill each take one slot, and the fetch copies one image."""
    from raweditor_tpu_torch.ops import staging as st

    fills = []
    real = st.unpack_into_batch

    def counted(out, sources, fmts):
        fills.append((tuple(out.shape), list(fmts)))
        return real(out, sources, fmts)

    monkeypatch.setattr(st, "unpack_into_batch", counted)
    job = pex.ExportJob(files["xtrans"][0], str(tmp_path / "x.jpg"),
                        EditParams(**EXTRAS))
    rep = pex.run_batch_export([job], batch_size=8, device="cpu",
                               use_kernel=True, mode="accurate",
                               demosaic_method="grad")
    assert rep.succeeded == 1 and not rep.failed
    assert launches["develop"] == [1] and launches["extras"] == [1]
    assert fills == [((1,) + SHAPE, ["u12"])]
    c = rep.stages["counters"]
    assert (c["slots.developed"], c["slots.unfilled"], c["extras.slots"],
            c["develop.slots.cfa_grad.rgba"],
            c["cfa_grad.period6_slots"]) == (1, 7, 1, 1, 1)
    # 4:2:0 planes of one 24x36 frame: Y and the interleaved CbCr.
    assert rep.fetch_bytes == SHAPE[0] * SHAPE[1] * 3 // 2
