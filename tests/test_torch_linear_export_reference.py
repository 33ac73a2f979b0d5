"""The LinearRaw export against the benchmark's plain LinearRaw reference,
and the readers of the LinearRaw lane, on the CPU.

Files are seeded random (H, W, 3) u16 frames written by the benchmark's
``linear_dng`` container at small sizes; ``run_batch_export`` runs with
the ``linear_dng`` configuration's flags, and the planes it hands its
JPEG encoder (taken where the benchmark's export driver takes them, by
wrapping ``pipeline.export._encode_one_jpeg420``) must equal the
reference's ``export_planes`` to the LSB, with and without finish
extras. The readers of ``kernels.linear_*`` and
``exporter.develop_ms_per_image`` read a record of such a call, with
device kernels edited into its trace (the CPU has no device trace)."""

import ast
import json
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import test_torch_source_guard as guard

from bench_torch import core
from bench_torch.containers import linear_dng
from bench_torch.drivers import catalog_export
from bench_torch.yardstick import linear_bounds, linear_reference
from bench_torch.yardstick.params import EditParams as RefParams
from bench_torch.yardstick.scene import XEDIT
from raweditor_tpu_torch import EditParams
from raweditor_tpu_torch.pipeline import export as pex

ROOT = Path(__file__).resolve().parent.parent
CFG = core.load_json(ROOT / "bench_torch" / "configs" / "linear_dng.json")
EDIT = dict(exposure=0.35, contrast=18.0, highlights=-40.0, shadows=25.0,
            whites=8.0, blacks=-6.0, vibrance=20.0, saturation=-10.0,
            temperature=0.2, tint=-0.1)
# A 24 MP slot of the lane: its develop to words alone, timed on an H100
# with CUDA events (ms), for an edited trace.
CARD_MS_PER_SLOT = 11.77


def _files(root, shape, n, seed):
    """n files of seeded random (H, W, 3) u16 frames, by the container;
    [(path, frame)]."""
    rng = np.random.default_rng(seed)
    root.mkdir(exist_ok=True)
    out = []
    for i in range(n):
        img = rng.integers(0, 65536, size=shape + (3,), dtype=np.uint16)
        path = root / linear_dng.NAME.format(i + 1)
        linear_dng.write(str(path), img, CFG, None)
        out.append((str(path), linear_dng.frame(img, CFG)))
    return out


def _flags():
    """``run_batch_export``'s keywords as the export driver derives them
    from the configuration and the ``export`` mix, on the CPU."""
    ctx = SimpleNamespace(cfg=CFG, mix=core.load_json(
        ROOT / "bench_torch" / "traffic" / "export.json"), device="cpu")
    return catalog_export._export_kwargs(ctx)


def _export(files, edits, out, batch_size):
    """The call over ``files`` with ``edits``; the report and the planes
    of each file as the encoder got them."""
    jobs = [pex.ExportJob(p, str(out / f"{i}.jpg"), EditParams(**e))
            for i, ((p, _), e) in enumerate(zip(files, edits))]
    source = {j.out_path: j.raw_path for j in jobs}
    got, lock = {}, threading.Lock()
    encode = pex._encode_one_jpeg420

    def observed(out_path, y, cb, cr, *args, **kwargs):
        with lock:
            got[source[out_path]] = (y.copy(), cb.copy(), cr.copy())
        return encode(out_path, y, cb, cr, *args, **kwargs)

    pex._encode_one_jpeg420 = observed
    try:
        rep = pex.run_batch_export(jobs, **dict(_flags(),
                                                batch_size=batch_size))
    finally:
        pex._encode_one_jpeg420 = encode
    return rep, got


@pytest.mark.parametrize("shape", [(24, 32), (38, 54)])
@pytest.mark.parametrize("extras", [False, True],
                         ids=["plain", "extras"])
def test_linear_export_equals_the_reference(tmp_path, shape, extras):
    files = _files(tmp_path / "raw", shape, 3, seed=sum(shape) + extras)
    edits = [dict(EDIT, exposure=0.1 * i, **(XEDIT if extras else {}))
             for i in range(3)]
    rep, got = _export(files, edits, tmp_path, batch_size=2)
    assert rep.succeeded == 3 and not rep.failed
    counters = rep.stages["counters"]
    assert counters["develop.slots.linear"] == counters[
        "slots.developed"] == 3
    assert counters["extras.slots"] == (3 if extras else 0)
    flags = dict(CFG["flags"])
    for (path, frame), e in zip(files, edits):
        want = linear_reference.export_planes(frame, RefParams(**e), "cpu",
                                              flags)
        for a, b in zip(got[path], want):
            assert a.shape == b.shape
            assert int(np.abs(a.astype(np.int16) - b.astype(np.int16))
                       .max()) == 0


def test_the_container_writes_what_the_decoder_reads(tmp_path):
    from raweditor_tpu_torch.raw.decode import decode_raw

    ((path, frame),) = _files(tmp_path, (6, 10), 1, seed=3)
    raw = decode_raw(path)
    assert raw.is_linear and raw.mosaic.shape == (6, 10, 3)
    assert np.array_equal(raw.mosaic, frame.mosaic)
    np.testing.assert_array_equal(raw.wb_rgb(), frame.wb)
    np.testing.assert_array_equal(raw.xyz_to_cam, frame.xyz_to_cam)
    assert (raw.white_level, raw.black_level) == (frame.white, frame.black)
    assert (raw.camera_make, raw.camera_model) == (
        CFG["camera"]["make"], CFG["camera"]["model"])
    assert frame.pattern is None


@pytest.mark.parametrize("rel", [
    "bench_torch/yardstick/linear_reference.py",
    "bench_torch/yardstick/linear_bounds.py",
    "bench_torch/containers/linear_dng.py",
    "bench_torch/metrics/_linear.py",
    "bench_torch/metrics/kernels.linear_ms_per_slot.py",
    "bench_torch/metrics/kernels.linear_roofline_share.py",
    "bench_torch/metrics/exporter.develop_ms_per_image.py"])
def test_the_reference_imports_neither_jax_nor_the_program(rel):
    guard.test_no_jax_or_reference_imports(ROOT / rel)
    if "yardstick" in rel:
        tree = ast.parse((ROOT / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names] + [n.module for n in ast.walk(tree)
                                      if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names
                    if n and n.startswith("raweditor_tpu_torch")], names


def test_the_bound_counts_the_frozen_lane():
    assert linear_bounds.count_ops() == (linear_bounds.DEVELOP_OPS,
                                         linear_bounds.YCBCR420_OPS)
    px = 4016 * 6016
    ms, kind = linear_bounds.bound(px, "planes")
    assert kind == "bytes"
    assert ms == pytest.approx(px * 7.5 / 3.35e12 * 1e3)
    assert linear_bounds.bound(px, "words")[0] == pytest.approx(
        px * 10.0 / 3.35e12 * 1e3)


# A kernel of each kind the window holds on the card: torch's own (the
# lane), the port's named ones and a copy.
LANE = "void at::native::vectorized_elementwise_kernel<4, at::native::"
NAMED = ("void extras_bands<true>(unsigned int const*, float const*",
         "unpack_slots(Slots, long long)",
         "void develop_grad_bands<true>(unsigned short const*")


def _record(rep, work, lane_s):
    """A record as the export driver makes it, with a traced window of
    ``lane_s`` device seconds in torch's kernels beside the port's
    kernels and a copy."""
    kernels = {LANE: [lane_s, 40]}
    kernels.update({k: [0.5, 3] for k in NAMED})
    return {"images": rep.succeeded, "work": work,
            "trace": {"kernels": kernels,
                      "copies": {"Memcpy HtoD (Pageable -> Device)":
                                 [2.0, 9]},
                      "kernel_s": lane_s + 1.5}}


@pytest.fixture(scope="module")
def linear_call(tmp_path_factory):
    """A LinearRaw call of eight files, two with extras (one flush of
    each kind), and its written images' work."""
    tmp = tmp_path_factory.mktemp("linear_call")
    files = _files(tmp / "raw", (24, 32), 8, seed=41)
    edits = [dict(EDIT, **(XEDIT if i % 4 == 3 else {})) for i in range(8)]
    rep, _ = _export(files, edits, tmp, batch_size=8)
    assert rep.succeeded == 8
    work = [{"pixels": 24 * 32, "pattern": None} for _ in range(8)]
    return rep, work, dict(pex.LAST_REPORT)


def _read(name, record, report, monkeypatch):
    monkeypatch.setattr(pex, "LAST_REPORT", report)
    return core.read_metric(name, record)


def test_the_linear_readers_read_the_lane(linear_call, monkeypatch):
    rep, work, report = linear_call
    counters = report["stages"]["counters"]
    assert counters["develop.slots.linear"] == 8
    assert counters["extras.slots"] == 2
    lane_s = 8 * CARD_MS_PER_SLOT / 1e3
    record = _record(rep, work, lane_s)
    per_slot = _read("kernels.linear_ms_per_slot", record, report,
                     monkeypatch)
    assert per_slot == pytest.approx(CARD_MS_PER_SLOT)
    share = _read("kernels.linear_roofline_share", record, report,
                  monkeypatch)
    need_ms = (6 * linear_bounds.bound(24 * 32, "planes")[0]
               + 2 * linear_bounds.bound(24 * 32, "words")[0])
    assert share == pytest.approx(100.0 * need_ms / 1e3 / lane_s)
    # Twice the lane's time, half the share; the port's kernels and the
    # copies do not count.
    slower = _record(rep, work, 2 * lane_s)
    assert _read("kernels.linear_roofline_share", slower, report,
                 monkeypatch) == pytest.approx(share / 2)
    develop = _read("exporter.develop_ms_per_image", record, report,
                    monkeypatch)
    spans = report["stages"]["spans"]["export.develop"]
    assert develop == pytest.approx(spans["total_s"] * 1e3 / 8) and \
        develop > 0


@pytest.mark.parametrize("ms_per_slot", [CARD_MS_PER_SLOT, 0.2])
def test_the_roofline_share_stays_under_100_at_full_size(
        linear_call, monkeypatch, ms_per_slot):
    """A 24 MP window whose lane takes the in-cell time a slot, or one
    faster than any the card has shown (0.2 ms), reads under 100%: the
    least time of a slot is 0.054-0.072 ms."""
    rep, _, report = linear_call
    work = [{"pixels": 4016 * 6016, "pattern": None} for _ in range(8)]
    record = _record(rep, work, 8 * ms_per_slot / 1e3)
    share = _read("kernels.linear_roofline_share", record, report,
                  monkeypatch)
    assert 0 < share < 100


def test_the_readers_read_nothing_without_the_lane_or_the_span(
        linear_call, monkeypatch):
    rep, work, report = linear_call
    record = _record(rep, work, 0.1)
    # A call with no LinearRaw slot (a Bayer call's counters).
    bayer = json.loads(json.dumps(report))
    c = bayer["stages"]["counters"]
    c["develop.slots.grad.planes"] = c.pop("develop.slots.linear")
    for name in ("kernels.linear_ms_per_slot",
                 "kernels.linear_roofline_share"):
        assert _read(name, record, bayer, monkeypatch) is None
    # A call that mixed routes: the plain kernels are not the lane's alone.
    mixed = json.loads(json.dumps(report))
    mixed["stages"]["counters"]["develop.slots.linear"] = 5
    mixed["stages"]["counters"]["develop.slots.plain"] = 3
    for name in ("kernels.linear_ms_per_slot",
                 "kernels.linear_roofline_share"):
        assert _read(name, record, mixed, monkeypatch) is None
    # A trace with the port's kernels alone, or none.
    named = dict(record, trace=dict(record["trace"], kernels={
        k: [0.5, 3] for k in NAMED}))
    for trace in (named, dict(record, trace=None)):
        for name in ("kernels.linear_ms_per_slot",
                     "kernels.linear_roofline_share"):
            assert _read(name, trace, report, monkeypatch) is None
    # A program without the span (the parent's), or with no report.
    old = json.loads(json.dumps(report))
    del old["stages"]["spans"]["export.develop"]
    assert _read("exporter.develop_ms_per_image", record, old,
                 monkeypatch) is None
    assert _read("exporter.develop_ms_per_image", record, None,
                 monkeypatch) is None


def test_the_cell_reads_the_lane_in_bfloat16_as_not_correct():
    """The bfloat16 control of the LinearRaw cell (the lane and the
    extras kernel in the precision below f32), at the rehearsal frame."""
    import argparse

    import torch

    from bench_torch import rehearse
    from bench_torch.run import run_cell
    from bench_torch.tests.linear_control import control_bf16_linear

    args = argparse.Namespace(workload="linear_dng.export", seed=2**31 + 5,
                              seconds=rehearse.SECONDS, trace=0)
    found = core.any_cell("linear_dng.export")
    with control_bf16_linear():
        out = run_cell(args, found, device=torch.device("cpu"),
                       rehearsal=rehearse.rehearsal_of(found[2]))
    assert not out["correct"]
    assert out["checks"]["planes_max_lsb"]["value"] > CFG["tolerance_lsb"]
