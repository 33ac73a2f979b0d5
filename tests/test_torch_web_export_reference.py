"""The web export (``run_batch_export(long_edge=...)``) against the
benchmark's plain web reference, the reference's resize against
``jax.image.resize``, the exporter's ``export.shape`` span and ``shape.*``
counters, the output stage's bound and its readers, on the CPU.

Files are seeded 14-bit RGGB lossless-JPEG DNGs written by the benchmark's
``dng`` container with the ``r5_dng`` configuration's levels at small 3:2
sizes; ``run_batch_export`` runs with the configuration's flags and a long
edge that shrinks them 2 or 4 times, and the planes it hands its JPEG
encoder (taken where the benchmark's export driver takes them, by
wrapping ``pipeline.export._encode_one_jpeg420``) must lie within the
configuration's ``tolerance_lsb`` of the reference's ``shaped_planes``,
with and without finish extras. The readers read a record of such a call,
with device kernels edited into its trace (the CPU has no device
trace)."""

import argparse
import ast
import contextlib
import json
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_export_trace as trace
import test_torch_source_guard as guard
import torch

from bench_torch import core, rehearse
from bench_torch.containers import dng
from bench_torch.drivers import catalog_export_web
from bench_torch.yardstick import shape_bounds, web_reference
from bench_torch.yardstick.params import EditParams as RefParams
from bench_torch.yardstick.scene import XEDIT
from raweditor_tpu_torch import EditParams
from raweditor_tpu_torch.pipeline import export as pex

ROOT = Path(__file__).resolve().parent.parent
CFG = core.load_json(ROOT / "bench_torch" / "configs" / "r5_dng.json")
MIX = core.load_json(ROOT / "bench_torch" / "traffic" / "export_web.json")
EDIT = dict(exposure=0.35, contrast=18.0, highlights=-40.0, shadows=25.0,
            whites=8.0, blacks=-6.0, vibrance=20.0, saturation=-10.0,
            temperature=0.2, tint=-0.1)


def _files(root, shape, n, seed):
    """n files of the container's seeded scene at ``shape``, rolled per
    file, with the configuration's levels; [(path, frame)]."""
    rng = np.random.default_rng(seed)
    root.mkdir(exist_ok=True)
    base = dng.base(rng, *shape, CFG)
    out = []
    for i in range(n):
        mosaic = np.roll(base, (5 * i, 7 * i), axis=(0, 1))
        path = root / dng.NAME.format(i + 1)
        dng.write(str(path), mosaic, CFG, None)
        out.append((str(path), dng.frame(mosaic, CFG)))
    return out


def _kwargs(long_edge, **kw):
    """``run_batch_export``'s keywords as the web driver derives them from
    the configuration and the mix, on the CPU, at ``long_edge``."""
    ctx = SimpleNamespace(cfg=CFG, mix=MIX, device="cpu", rehearsal={})
    return dict(catalog_export_web._export_kwargs(ctx), long_edge=long_edge,
                **kw)


def _export(files, edits, out, long_edge, ext="jpg", **kw):
    """The call over ``files`` with ``edits``; the report and the planes
    of each file as the encoder got them."""
    jobs = [pex.ExportJob(p, str(out / f"{i}.{ext}"), EditParams(**e))
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
        rep = pex.run_batch_export(jobs, **_kwargs(long_edge, **kw))
    finally:
        pex._encode_one_jpeg420 = encode
    return rep, got


@pytest.mark.parametrize("shape", [(32, 48), (48, 72)])
@pytest.mark.parametrize("shrink", [2, 4])
@pytest.mark.parametrize("extras", [False, True], ids=["plain", "extras"])
def test_web_export_is_within_the_tolerance_of_the_reference(
        tmp_path, shape, shrink, extras):
    files = _files(tmp_path / "raw", shape, 3, seed=sum(shape) + shrink)
    edits = [dict(EDIT, exposure=0.1 * i, **(XEDIT if extras else {}))
             for i in range(3)]
    long_edge = shape[1] // shrink
    rep, got = _export(files, edits, tmp_path, long_edge, batch_size=2)
    assert rep.succeeded == 3 and not rep.failed
    counters = rep.stages["counters"]
    assert counters["shape.images"] == counters["slots.developed"] == 3
    assert counters["extras.slots"] == (3 if extras else 0)
    flags = dict(CFG["flags"], long_edge=long_edge)
    for (path, frame), e in zip(files, edits):
        want = web_reference.shaped_planes(frame, RefParams(**e), "cpu",
                                           flags)
        assert want[0].shape == (shape[0] // shrink, shape[1] // shrink)
        for a, b in zip(got[path], want):
            assert a.shape == b.shape
            assert int(np.abs(a.astype(np.int16) - b.astype(np.int16))
                       .max()) <= CFG["tolerance_lsb"]


@pytest.mark.parametrize("size,out", [
    ((32, 48), (16, 24)), ((32, 48), (8, 12)), ((48, 72), (12, 18)),
    ((40, 60), (13, 20)), ((36, 54), (36, 20)), ((20, 30), (20, 30))])
def test_the_reference_resize_is_jax_image_resize(size, out):
    """The reference's resize, written from the published semantics,
    against ``jax.image.resize(..., "lanczos3", antialias=True)``: within
    a thousandth before rounding, a LSB after it."""
    rgb = np.random.default_rng(sum(size) + sum(out)).uniform(
        0, 255, (3,) + size).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(rgb), (3,) + out,
                                       "lanczos3", antialias=True))
    got = web_reference.resize_f32(torch.from_numpy(rgb), *out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    u8 = web_reference.resize_rgb(torch.from_numpy(rgb), *out).numpy()
    ref = np.clip(np.round(want), 0, 255).astype(np.int16)
    assert np.abs(u8.astype(np.int16) - ref).max() <= 1


def test_the_reference_long_edge_is_the_exporters():
    from raweditor_tpu_torch.ops.resize import long_edge_shape

    for args in [(5464, 8192, 2048), (8192, 5464, 2048), (4016, 6016, 2048),
                 (31, 47, 20), (40, 30, 40), (40, 30, 0)]:
        assert web_reference.long_edge_shape(*args) == long_edge_shape(*args)
    assert web_reference.long_edge_shape(5464, 8192, 2048) == (1366, 2048)


@pytest.mark.parametrize("ext,kw,kind", [
    ("jpg", dict(), "planes"), ("png", dict(), "words"),
    ("tif", dict(bits=16), "u16")])
def test_the_shape_span_nests_in_the_launch_and_counts_the_pixels(
        tmp_path, ext, kw, kind):
    """``export.shape`` times each shaped flush's output stage inside its
    ``export.launch``, never as a profiler range (it encloses launches);
    the ``shape.*`` counters sum to the images and their pixels before and
    after the stage, on the words, planes and 16-bit routes."""
    from torch.profiler import ProfilerActivity, profile

    files = _files(tmp_path / "raw", (32, 48), 5, seed=9)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep, _ = _export(files, [EDIT] * 5, tmp_path, 24, ext=ext,
                         batch_size=2, trace_spans=True, **kw)
    assert rep.succeeded == 5 and not rep.failed
    ranges = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "export.shape" not in ranges
    flushes = rep.timer.counts["export.flush"]
    assert rep.timer.counts["export.shape"] == flushes == 3
    trace._assert_nested(rep, "export.launch", ("export.shape",))
    counters = rep.stages["counters"]
    assert counters["shape.images"] == counters["slots.developed"] == 5
    assert counters["shape.in_pixels"] == 5 * 32 * 48
    assert counters["shape.out_pixels"] == 5 * 16 * 24


def test_an_unshaped_call_has_no_shape_span_or_counter(tmp_path):
    files = _files(tmp_path / "raw", (32, 48), 2, seed=4)
    rep, _ = _export(files, [EDIT] * 2, tmp_path, 48, batch_size=2)
    assert rep.succeeded == 2
    assert "export.shape" not in rep.stages["spans"]
    assert not [k for k in rep.stages["counters"] if k.startswith("shape.")]


def test_the_bound_matches_a_hand_count():
    # A 45 MP R5 frame to 2048x1366 planes: 24 taps a sample each way,
    # rows first (1366 x 8192 x 24 + 1366 x 2048 x 24 multiply-adds a
    # channel), 24 operations an output pixel for the 4:2:0 conversion;
    # 4 bytes a pixel read, 1.5 written. Bound by the bytes.
    ops = 2 * 3 * (1366 * 8192 * 24 + 1366 * 2048 * 24) + 24 * 1366 * 2048
    assert ops == 2_081_390_592
    assert shape_bounds.resize_ops(5464, 8192, 1366, 2048) == \
        ops - 24 * 1366 * 2048
    nbytes = 5464 * 8192 * 4 + 1366 * 2048 * 1.5
    ms, kind = shape_bounds.bound(5464, 8192, 1366, 2048, "planes")
    assert kind == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert ops / 67e12 * 1e3 < ms
    ms, kind = shape_bounds.bound(5464, 8192, 1366, 2048, "words")
    assert (ms, kind) == (pytest.approx(
        (5464 * 8192 + 1366 * 2048) * 4 / 3.35e12 * 1e3), "bytes")
    # A 2x shrink sums 12 taps; an axis that keeps its size takes no
    # pass; a tall frame takes its cheaper order, columns first.
    assert shape_bounds.taps(100, 50) == 12.0
    assert shape_bounds.resize_ops(64, 100, 64, 50) == 2 * 3 * 64 * 50 * 12
    assert shape_bounds.resize_ops(8192, 5464, 2048, 1366) == \
        2 * 3 * (8192 * 1366 * 24 + 1366 * 2048 * 24)


@pytest.mark.parametrize("rel", [
    "bench_torch/yardstick/web_reference.py",
    "bench_torch/yardstick/shape_bounds.py",
    "bench_torch/drivers/catalog_export_web.py",
    "bench_torch/metrics/_shape.py",
    "bench_torch/metrics/kernels.shape_ms_per_image.py",
    "bench_torch/metrics/kernels.shape_roofline_share.py",
    "bench_torch/metrics/exporter.shape_ms_per_image.py"])
def test_the_reference_imports_neither_jax_nor_the_program(rel):
    guard.test_no_jax_or_reference_imports(ROOT / rel)
    tree = ast.parse((ROOT / rel).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names
                if n and n.startswith("raweditor_tpu_torch")], names


def test_the_reference_keeps_tf32_off():
    seen = []
    words = web_reference._words

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return words(*args)

    frame = dng.frame(dng.base(np.random.default_rng(1), 16, 24, CFG), CFG)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        web_reference._words = spy
        web_reference.shaped_planes(frame, RefParams(), "cpu",
                                    dict(CFG["flags"], long_edge=12))
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        web_reference._words = words
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_the_container_writes_what_the_decoder_reads(tmp_path):
    from raweditor_tpu_torch.raw.decode import decode_raw

    ((path, frame),) = _files(tmp_path, (32, 48), 1, seed=3)
    raw = decode_raw(path)
    assert raw.mosaic.shape == (32, 48) and raw.mosaic.max() > 4095
    assert np.array_equal(raw.mosaic, frame.mosaic)
    np.testing.assert_array_equal(raw.wb_rgb(), frame.wb)
    np.testing.assert_allclose(raw.xyz_to_cam, frame.xyz_to_cam, rtol=1e-6)
    assert (raw.white_level, raw.black_level) == (16383, 2048)
    assert (raw.camera_make, raw.camera_model) == ("Canon", "Canon EOS R5")
    assert (frame.phase, frame.pattern) == ((0, 0), None)


def test_the_driver_cuts_the_long_edge_with_the_rehearsal_frame():
    ctx = SimpleNamespace(cfg=CFG, mix=MIX, rehearsal={})
    assert catalog_export_web.long_edge_of(ctx) == 2048
    ctx.rehearsal = rehearse.rehearsal_of(CFG)
    assert catalog_export_web.long_edge_of(ctx) == 24
    assert web_reference.long_edge_shape(64, 96, 24) == (16, 24)


# Kernels of each kind the window holds on the card: the output stage's
# (torch's matrix products and elementwise kernels), the port's named ones
# and a copy.
STAGE = ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nt_align1>",
         "void at::native::vectorized_elementwise_kernel<2, at::native::")
NAMED = ("void extras_bands<false>(unsigned int const*, float const*",
         "unpack_slots(Slots, long long)",
         "void (anonymous namespace)::develop_grad_bands<false>(unsigned")
# The output stage's time an R5 image, measured on one H100 (12.79 ms),
# for an edited trace.
CARD_MS = 12.79


def _record(n, shaped, stage_s):
    kernels = {STAGE[0]: [0.75 * stage_s, n], STAGE[1]: [0.25 * stage_s,
                                                         9 * n]}
    kernels.update({k: [0.5, 3] for k in NAMED})
    return {"images": n, "shaped": shaped,
            "trace": {"kernels": kernels,
                      "copies": {"Memcpy HtoD (Pageable -> Device)":
                                 [2.0, 9]},
                      "kernel_s": stage_s + 1.5}}


@pytest.fixture(scope="module")
def web_call(tmp_path_factory):
    """A shaped call of eight files, two with extras, and the sizes the
    driver records for it."""
    tmp = tmp_path_factory.mktemp("web_call")
    files = _files(tmp / "raw", (32, 48), 8, seed=41)
    edits = [dict(EDIT, **(XEDIT if i % 4 == 3 else {})) for i in range(8)]
    rep, _ = _export(files, edits, tmp, 24, batch_size=8)
    assert rep.succeeded == 8
    shaped = [{"in": [32, 48], "out": [16, 24], "output": "planes"}] * 8
    return rep, shaped, dict(pex.LAST_REPORT)


def _read(name, record, report, monkeypatch):
    monkeypatch.setattr(pex, "LAST_REPORT", report)
    return core.read_metric(name, record)


def test_the_shape_readers_read_the_stage(web_call, monkeypatch):
    rep, shaped, report = web_call
    stage_s = 8 * CARD_MS / 1e3
    record = _record(8, shaped, stage_s)
    assert _read("kernels.shape_ms_per_image", record, report,
                 monkeypatch) == pytest.approx(CARD_MS)
    share = _read("kernels.shape_roofline_share", record, report,
                  monkeypatch)
    need_ms = 8 * shape_bounds.bound(32, 48, 16, 24, "planes")[0]
    assert share == pytest.approx(100.0 * need_ms / 1e3 / stage_s)
    # Twice the stage's time, half the share; the port's kernels and the
    # copies do not count.
    assert _read("kernels.shape_roofline_share", _record(8, shaped,
                                                         2 * stage_s),
                 report, monkeypatch) == pytest.approx(share / 2)
    spans = report["stages"]["spans"]["export.shape"]
    host = _read("exporter.shape_ms_per_image", record, report, monkeypatch)
    assert host == pytest.approx(spans["total_s"] * 1e3 / 8) and host > 0


@pytest.mark.parametrize("ms", [CARD_MS, 0.1])
def test_the_roofline_share_stays_under_100_at_full_size(
        web_call, monkeypatch, ms):
    """A 45 MP window whose stage takes the in-cell time an image, or
    0.1 ms an image (within reach of a banded kernel that reads each word
    once), reads under 100%: the least time of an image is 0.055 ms."""
    _, _, report = web_call
    shaped = [{"in": [5464, 8192], "out": [1366, 2048],
               "output": "planes"}] * 8
    report = json.loads(json.dumps(report))
    report["stages"]["counters"].update({"shape.in_pixels": 8 * 5464 * 8192,
                                         "shape.out_pixels": 8 * 1366 * 2048})
    share = _read("kernels.shape_roofline_share",
                  _record(8, shaped, 8 * ms / 1e3), report, monkeypatch)
    assert 0 < share < 100


def test_the_readers_read_nothing_without_the_stage_or_its_counters(
        web_call, monkeypatch):
    _, shaped, report = web_call
    record = _record(8, shaped, 0.1)
    readers = ("kernels.shape_ms_per_image", "kernels.shape_roofline_share")
    # A program without the counters and the span (the parent's).
    old = json.loads(json.dumps(report))
    for k in [k for k in old["stages"]["counters"] if k.startswith("shape.")]:
        del old["stages"]["counters"][k]
    del old["stages"]["spans"]["export.shape"]
    for name in readers + ("exporter.shape_ms_per_image",):
        assert _read(name, record, old, monkeypatch) is None
    # A call that shaped only some of its slots.
    part = json.loads(json.dumps(report))
    part["stages"]["counters"]["shape.images"] = 5
    for name in readers:
        assert _read(name, record, part, monkeypatch) is None
    # A trace with the port's kernels alone, or none; a record without
    # the sizes.
    named = dict(record, trace=dict(record["trace"], kernels={
        k: [0.5, 3] for k in NAMED}))
    for rec in (named, dict(record, trace=None)):
        for name in readers:
            assert _read(name, rec, report, monkeypatch) is None
    assert _read("kernels.shape_roofline_share", dict(record, shaped=None),
                 report, monkeypatch) is None
    # Sizes the program did not count: one image more, or other sizes.
    for other in (shaped + shaped[:1],
                  [{"in": [48, 32], "out": [24, 12], "output": "planes"}] * 8,
                  [{"in": [32, 48], "out": [18, 24], "output": "planes"}] * 8):
        assert _read("kernels.shape_roofline_share", dict(
            record, shaped=other), report, monkeypatch) is None
    assert _read("kernels.shape_ms_per_image", dict(
        record, shaped=shaped[:1]), report, monkeypatch) is not None


def _rehearse(seed=2**31 + 5, trace=0):
    """The web cell run through the harness at the rehearsal frame."""
    from bench_torch.run import run_cell

    args = argparse.Namespace(workload="r5_dng.export_web", seed=seed,
                              seconds=rehearse.SECONDS, trace=trace)
    found = core.any_cell("r5_dng.export_web")
    return run_cell(args, found, device=torch.device("cpu"),
                    rehearsal=rehearse.rehearsal_of(found[2]))


def test_the_cell_reads_the_chain_in_bfloat16_as_not_correct():
    """The bfloat16 control of the web cell (the develop, the extras and
    the resize in the precision below f32), at the rehearsal frame."""
    from bench_torch.tests.web_control import control_bf16_web

    with control_bf16_web():
        out = _rehearse()
    assert not out["correct"]
    assert out["checks"]["planes_max_lsb"]["value"] > CFG["tolerance_lsb"]


@contextlib.contextmanager
def _tf32_banded():
    """``web_control.control_tf32_rounded`` for the banded resize of
    words, which multiplies tap by tap and calls no ``torch.matmul``: the
    operands of each pass's products, the values and the band's weights,
    rounded to TF32's 10-bit mantissa as a card's TF32 takes them."""
    from bench_torch.tests import faults, web_control
    from raweditor_tpu_torch.ops import fused_resize

    along = fused_resize._along

    def rounded(x, first, weights, axis):
        return along(web_control._tf32(x), first, web_control._tf32(weights),
                     axis)

    with faults._patched([(fused_resize, "_along", rounded)]):
        yield


@pytest.mark.parametrize("fault", [
    None, "altered_answer_web", "control_tf32_rounded", "half_batch_dropped",
    "quality_lowered"])
@pytest.mark.parametrize("seed", [2**31 + 5, 2**33 + 17])
def test_the_cell_reads_each_planted_fault(fault, seed):
    """A sound rehearsal reads correct, with no plane sample off the
    reference; the shaped route's altered answer, a resize in TF32 (its
    operands rounded as a card's TF32 takes them), a dropped half of the
    encodes and a lowered quality read not correct. The TF32 resize moves
    no sample by more than ``tolerance_lsb``: only ``planes_off_ppm``
    reads it. The resize of words is banded, so its TF32 fault rounds the
    band's operands (``_tf32_banded``)."""
    from bench_torch.tests import faults, web_control

    if fault is None:
        out = _rehearse(seed)
        assert out["correct"], out["checks"]
        assert out["checks"]["planes_off_ppm"]["value"] == 0
        return
    known = dict(faults.FAULTS, **web_control.FAULTS)
    known["control_tf32_rounded"] = _tf32_banded
    with known[fault]():
        out = _rehearse(seed)
    assert not out["correct"], (fault, out["checks"])
    if fault == "control_tf32_rounded":
        checks = out["checks"]
        assert [k for k, c in checks.items() if c["value"] > c["limit"]] \
            == ["planes_off_ppm"]


def test_the_driver_records_the_sizes_the_program_counted(monkeypatch):
    """The window's ``shaped`` list holds each written image's frame and
    the luma plane its encoder got, and sums to the program's ``shape.*``
    counters, so the roofline reader prices it."""
    from bench_torch.metrics import _shape

    records = []
    window = catalog_export_web.window

    def kept(*args):
        records.append(window(*args))
        return records[-1]

    monkeypatch.setattr(catalog_export_web, "window", kept)
    out = _rehearse(trace=1)
    assert out["correct"], out["checks"]
    (record,) = records
    shaped = record["shaped"]
    assert len(shaped) == record["images"] > 0
    assert {json.dumps(s) for s in shaped} == {json.dumps(
        {"in": [64, 96], "out": [16, 24], "output": "planes"})}
    assert _shape.sizes(record) is shaped
