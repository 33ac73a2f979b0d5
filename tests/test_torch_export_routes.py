"""The batch exporter's develop-route counters (``develop.slots.<route>``
in ``pipeline/export.run_batch_export``) and the benchmark's readers of
the X-Trans grad kernel (``bench_torch/metrics/kernels.cfa_grad_*``), on
the CPU device, where the kernel route runs the kernels' plain versions.

Files are tiny seeded X-Trans III RAFs and Bayer DNGs written by the
benchmark's own writers (``bench_torch/drivers/files.py``) from its
``xt2_raf`` and ``d3300_dng`` configurations, so the X-Trans export is
also held against the benchmark's frozen plain reference."""

import json

import numpy as np
import pytest

from bench_torch import core
from bench_torch.drivers.files import write_files
from bench_torch.yardstick import bounds, reference
from bench_torch.yardstick.params import EditParams as RefParams
from bench_torch.yardstick.scene import XEDIT
from raweditor_tpu_torch import EditParams
from raweditor_tpu_torch.pipeline import export as pex

FRAMES = {"xt2_raf": (60, 96), "d3300_dng": (64, 96)}
B7 = "develop_grad_cfa_bands"


def _cfg(name):
    return core.load_json(core.PKG / "configs" / f"{name}.json")


def _write(name, folder, n, seed):
    return write_files(_cfg(name), folder, n, np.random.default_rng(seed),
                       {"frame": FRAMES}, "cpu", threads=2)


def _edit(i, extras):
    e = dict(exposure=0.2 * (i % 3) - 0.2, contrast=10.0 * i,
             shadows=15.0, vibrance=20.0)
    if extras:
        e.update(XEDIT)
    return e


def _kwargs(cfg, **over):
    """``run_batch_export`` keywords of a configuration's flags, as the
    benchmark's catalog export passes them."""
    f = cfg["flags"]
    kw = {k: f[k] for k in ("batch_size", "decode_threads",
                            "encode_threads", "quality", "mode",
                            "demosaic_method", "use_kernel", "color_space")}
    kw["transfer"] = None
    kw.update(over, device="cpu")
    return kw


@pytest.fixture
def captured(monkeypatch):
    """{out_path: (y, cb, cr)} of every image handed to the JPEG
    encoder."""
    got = {}
    encode = pex._encode_one_jpeg420

    def observed(out_path, y, cb, cr, *args, **kwargs):
        got[out_path] = (y, cb, cr)
        return encode(out_path, y, cb, cr, *args, **kwargs)

    monkeypatch.setattr(pex, "_encode_one_jpeg420", observed)
    return got


def _routes(rep):
    c = rep.stages["counters"]
    return {k[len("develop.slots."):]: n for k, n in c.items()
            if k.startswith("develop.slots.")}


def test_xtrans_export_agrees_with_the_plain_reference(tmp_path, captured):
    """Five X-Trans RAFs, one with finish extras, in batches of four: the
    plain bucket fills a batch, the extras bucket flushes its one image
    three slots short; every 4:2:0 plane within the configuration's
    tolerance of the reference."""
    cfg = _cfg("xt2_raf")
    files = _write("xt2_raf", tmp_path / "raw", 5, 2**31 + 41)
    edits = [_edit(i, i == 2) for i in range(5)]
    jobs = [pex.ExportJob(p, str(tmp_path / f"x{i}.jpg"), EditParams(**e))
            for i, ((p, _), e) in enumerate(zip(files, edits))]
    rep = pex.run_batch_export(jobs, **_kwargs(cfg, batch_size=4))
    assert rep.succeeded == 5 and not rep.failed
    c = rep.stages["counters"]
    assert (c["slots.developed"], c["slots.unfilled"]) == (5, 3)
    assert _routes(rep) == {"cfa_grad.planes": 4, "cfa_grad.rgba": 1}
    assert c["cfa_grad.period6_slots"] == 5
    flags = dict(cfg["flags"])
    worst = 0
    for job, (_, frame), e in zip(jobs, files, edits):
        want = reference.export_planes(frame, RefParams(**e), "cpu", flags)
        for a, b in zip(captured[job.out_path], want):
            assert a.shape == b.shape
            worst = max(worst, int(np.abs(a.astype(np.int16)
                                          - b.astype(np.int16)).max()))
    assert worst <= cfg["tolerance_lsb"]


# (case, run_batch_export keywords over the configuration's, output
# extension, the route counters a call over three DNGs and three RAFs,
# one of each with finish extras, in batches of two must read)
MIXED = [
    ("kernel-jpeg", {}, "jpg",
     {"grad.planes": 2, "grad.rgba": 1, "cfa_grad.planes": 2,
      "cfa_grad.rgba": 1}),
    ("kernel-png", {}, "png", {"grad.rgba": 3, "cfa_grad.rgba": 3}),
    ("plain-jpeg", {"use_kernel": False}, "jpg", {"plain": 6}),
    ("kernel-nearest", {"demosaic_method": "nearest"}, "jpg",
     {"nearest.planes": 2, "nearest.rgba": 1, "cfa_nearest.planes": 2,
      "cfa_nearest.rgba": 1}),
]


@pytest.fixture(scope="module")
def mixed_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed")
    return (_write("d3300_dng", root / "dng", 3, 2**31 + 43)
            + _write("xt2_raf", root / "raf", 3, 2**31 + 47))


@pytest.mark.parametrize("case,over,ext,want", MIXED,
                         ids=[m[0] for m in MIXED])
def test_route_counters_split_bayer_from_xtrans(case, over, ext, want,
                                                mixed_files, tmp_path):
    jobs = [pex.ExportJob(p, str(tmp_path / f"m{i}.{ext}"),
                          EditParams(**_edit(i, i % 3 == 2)))
            for i, (p, _) in enumerate(mixed_files)]
    rep = pex.run_batch_export(jobs, **_kwargs(_cfg("xt2_raf"),
                                               batch_size=2, **over))
    assert rep.succeeded == 6 and not rep.failed
    c = rep.stages["counters"]
    assert _routes(rep) == want
    assert sum(want.values()) == c["slots.developed"]
    assert c["slots.unfilled"] == 2
    cfa_grad = sum(n for k, n in want.items() if k.startswith("cfa_grad."))
    assert c.get("cfa_grad.period6_slots", 0) == cfa_grad
    assert pex.LAST_REPORT["stages"]["counters"] == json.loads(
        json.dumps(c))


@pytest.mark.parametrize("config", ["xt2_raf", "d3300_dng"])
def test_period6_slots_count_the_xtrans_grad_slots(config, tmp_path):
    """``cfa_grad.period6_slots``: on an X-Trans export every slot of the
    grad kernel (the X-Trans grid takes the kernel's period-6 march), the
    sum of ``develop.slots.cfa_grad.*``, one an image; absent on a Bayer
    export, which never runs that kernel."""
    files = _write(config, tmp_path / "raw", 3, 2**31 + 53)
    jobs = [pex.ExportJob(p, str(tmp_path / f"p{i}.jpg"),
                          EditParams(**_edit(i, i == 1)))
            for i, (p, _) in enumerate(files)]
    rep = pex.run_batch_export(jobs, **_kwargs(_cfg(config), batch_size=2))
    assert rep.succeeded == 3 and not rep.failed
    c = rep.stages["counters"]
    cfa_grad = {k: n for k, n in _routes(rep).items()
                if k.startswith("cfa_grad.")}
    if config == "xt2_raf":
        assert cfa_grad and c["cfa_grad.period6_slots"] == sum(
            cfa_grad.values()) == c["slots.developed"] == 3
    else:
        assert not cfa_grad and "cfa_grad.period6_slots" not in c


def _read(name, record):
    return core.read_metric(f"kernels.cfa_grad_{name}", record)


def _work(pixels, pattern, gamma="pow"):
    return {"pixels": pixels, "demosaic": "grad", "pattern": pattern,
            "gamma": gamma, "extras": None}


def _record(monkeypatch, counters, kernels, work, images=108):
    """A window's record as the harness hands it to a reader, with the
    program's newest export report set to ``counters``."""
    monkeypatch.setattr(pex, "LAST_REPORT", None if counters is None else
                        {"succeeded": images,
                         "stages": {"spans": {}, "counters": counters}})
    return {"images": images, "work": work,
            "trace": {"kernels": kernels, "kernel_s": sum(
                t for t, _ in kernels.values())}}


PATTERN = _cfg("xt2_raf")["cfa"]
PIXELS = 4000 * 6000
KERNELS = {
    f"void (anonymous namespace)::{B7}<true>(unsigned short const*": [
        0.04224, 88],
    f"void (anonymous namespace)::{B7}<false>(unsigned short const*": [
        0.01753, 32],
    "void (anonymous namespace)::develop_grad_bands<true>(unsigned": [
        9.0, 1],
    "void (anonymous namespace)::extras_bands<true, true, true>": [
        0.016, 4],
}
COUNTED = {"slots.developed": 108, "slots.padded": 12,
           "develop.slots.cfa_grad.planes": 88,
           "develop.slots.cfa_grad.rgba": 32}


def test_readers_read_the_kernel_over_its_slots(monkeypatch):
    record = _record(monkeypatch, COUNTED, KERNELS,
                     [_work(PIXELS, PATTERN)] * 108)
    device_s = 0.04224 + 0.01753
    grid = np.array(["RGB".index(ch) for ch in PATTERN]).reshape(6, 6)
    bounds.DEMOSAIC_OPS.update(bounds.cfa_demosaic_ops(grid))
    need_ms = (88 * bounds.bound(PIXELS, "cfa_grad", "pow", "ycbcr420")[0]
               + 32 * bounds.bound(PIXELS, "cfa_grad", "pow", "rgba")[0])
    assert _read("roofline_share", record) == pytest.approx(
        100.0 * need_ms / 1e3 / device_s, rel=1e-12)
    # About a tenth: a plausible share, not 100 times off.
    assert 5.0 < _read("roofline_share", record) < 20.0
    assert _read("ms_per_slot", record) == pytest.approx(
        1e3 * device_s / 120, rel=1e-12)


NOTHING = [
    ("no export report", None, KERNELS),
    ("no route counters", {"slots.developed": 108, "slots.padded": 12},
     KERNELS),
    ("bayer routes only", {"slots.developed": 108, "slots.padded": 12,
                           "develop.slots.grad.planes": 88,
                           "develop.slots.grad.rgba": 32}, KERNELS),
    ("no kernel in the trace", COUNTED,
     {k: v for k, v in KERNELS.items() if B7 not in k}),
]


@pytest.mark.parametrize("reader", ["roofline_share", "ms_per_slot"])
@pytest.mark.parametrize("case,counters,kernels", NOTHING,
                         ids=[n[0] for n in NOTHING])
def test_readers_read_nothing_without_counters_or_kernel(
        monkeypatch, reader, case, counters, kernels):
    record = _record(monkeypatch, counters, kernels,
                     [_work(PIXELS, PATTERN)] * 108)
    assert _read(reader, record) is None
    # Another call's report is not the window's.
    record = _record(monkeypatch, COUNTED, KERNELS,
                     [_work(PIXELS, PATTERN)] * 108)
    record["images"] = 107
    assert _read(reader, record) is None


def test_roofline_share_reads_nothing_over_mixed_frames(monkeypatch):
    work = [_work(PIXELS, PATTERN)] * 100 + [_work(60 * 96, PATTERN)] * 8
    record = _record(monkeypatch, COUNTED, KERNELS, work)
    assert _read("roofline_share", record) is None
    assert _read("ms_per_slot", record) is not None


def test_readers_take_the_counters_a_real_call_leaves(mixed_files,
                                                      tmp_path):
    """The counter names the exporter writes are the ones the readers
    look for: a CPU call over the mixed files, with a device trace made
    up for its window."""
    jobs = [pex.ExportJob(p, str(tmp_path / f"r{i}.jpg"),
                          EditParams(**_edit(i, i % 3 == 2)))
            for i, (p, _) in enumerate(mixed_files)]
    rep = pex.run_batch_export(jobs, **_kwargs(_cfg("xt2_raf"),
                                               batch_size=2))
    assert rep.succeeded == 6
    kernels = {f"{B7}<true>": [0.002, 1], f"{B7}<false>": [0.002, 1]}
    record = {"images": 6, "work": [_work(60 * 96, PATTERN)] * 3,
              "trace": {"kernels": kernels, "kernel_s": 0.004}}
    # Three X-Trans slots, one an image: two planes, one RGBA.
    assert _read("ms_per_slot", record) == pytest.approx(4.0 / 3.0)
    assert _read("roofline_share", record) > 0
