"""Spans and counters of the port's batch exporter
(``pipeline/export.run_batch_export`` and ``utils/timing.StageTimer``) on
the CPU device, with the exporter's default thread counts.

Files are tiny seeded 12-bit DNGs written by the port's writer; one job
in three carries finish extras, so extras batches form beside plain ones.
Nothing here is a timing: the tests hold the names, the counts, the image
ids, the nesting and the clock of what the recorder keeps."""

import json
import sys
import threading
import time

import numpy as np
import pytest

from raweditor_tpu_torch import EditParams
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.raw import synth
from raweditor_tpu_torch.utils.timing import StageTimer

D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32) / 10000.0
SHAPE = (24, 32)
EXTRAS = dict(sharpen=40.0, hue_red=20.0, grade_shadow_sat=30.0)
# The calling thread's waits, which also enter profiler ranges.
WAITS = ("export.wait_decode", "export.wait_upload", "export.wait_fetch",
         "export.wait_encode")
# The calling thread's work that launches device work: log only.
LAUNCHING = ("export.flush", "export.stage", "export.launch",
             "export.develop")
SPANS = WAITS + LAUNCHING + (
    "export.hand_off", "decode", "stage.pack", "upload", "fetch.wait",
    "fetch.copy", "encode", "queue.batch", "queue.encode")
COUNTERS = ("transfer.pinned_bytes", "transfer.pageable_bytes",
            "slots.developed", "slots.unfilled", "extras.slots", "extras.asked",
            "staging.slots_unpacked", "staging.slots_copied",
            "staging.slots_uploaded")
# (name, output extension, run_batch_export keywords, files already
# written before the call)
CASES = [
    ("jpeg-kernel", "jpg", dict(use_kernel=True, mode="accurate",
                                demosaic_method="grad", batch_size=2), 0),
    ("png-plain", "png", dict(mode="parity", batch_size=3), 0),
    ("jpeg-resume", "jpg", dict(use_kernel=True, mode="accurate",
                                batch_size=2), 2),
]


def _files(root, n=7, seed=5):
    rng = np.random.default_rng(seed)
    root.mkdir(exist_ok=True)
    paths = []
    for i in range(n):
        p = root / f"f{i}.dng"
        synth.write_synthetic_raw(
            p, rng.integers(0, 4096, size=SHAPE, dtype=np.uint16),
            xyz_to_cam=D3300, black_level=150, white_level=4095,
            wb_neutral=(0.5, 1.0, 0.625), cfa="RGGB",
            make="NIKON CORPORATION", model="NIKON D3300", preview_jpeg=b"")
        paths.append(str(p))
    return paths


def _jobs(paths, out, ext, ids=True):
    """One job a file, catalog ids 101, 102, ... (or none), every third
    with finish extras."""
    return [pex.ExportJob(p, str(out / f"f{i}.{ext}"),
                          EditParams(exposure=0.1 * i,
                                     **(EXTRAS if i % 3 == 1 else {})),
                          100 + i + 1 if ids else None)
            for i, p in enumerate(paths)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("raw"))


def _run(jobs, **kw):
    t0 = time.time_ns()
    rep = pex.run_batch_export(jobs, device="cpu", **kw)
    return rep, t0, time.time_ns()


def _entries(rep, name):
    return [e for e in rep.timer.log if e["name"] == name]


def _images_of(rep, name):
    """The image ids the log's ``name`` spans carry (a flush's spans
    carry the list of its images)."""
    got = set()
    for e in _entries(rep, name):
        got.update(e["image"] if isinstance(e["image"], list)
                   else [e["image"]])
    return got


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0])
def traced(request, paths, tmp_path_factory):
    """(case, jobs, report, call start, call end) of one traced call."""
    name, ext, kw, done = request.param
    out = tmp_path_factory.mktemp(name)
    jobs = _jobs(paths, out, ext, ids=name != "jpeg-resume")
    for job in jobs[:done]:
        open(job.out_path, "wb").close()
    rep, t0, t1 = _run(jobs, trace_spans=True, skip_existing=bool(done),
                       **kw)
    assert rep.succeeded == len(jobs) - done and not rep.failed
    return request.param, jobs, rep, t0, t1


def test_report_names_every_span_and_counter(traced):
    (_, _, kw, _), _, rep, _, _ = traced
    spans, counters = rep.stages["spans"], rep.stages["counters"]
    assert set(SPANS) <= set(spans), sorted(set(SPANS) - set(spans))
    # Beside the fixed counters, one counter a develop route that ran.
    routes = {k for k in counters if k.startswith("develop.slots.")}
    assert set(COUNTERS) == set(counters) - routes and routes
    assert sum(counters[k] for k in routes) == counters["slots.developed"]
    assert rep.as_dict()["stages"] == rep.stages
    assert json.loads(json.dumps(rep.as_dict()))["stages"] == rep.stages
    # Nothing crosses between host and device on the CPU.
    assert counters["transfer.pinned_bytes"] == 0
    assert counters["transfer.pageable_bytes"] == 0
    # The arena trim runs (and is timed) unless it is switched off.
    from raweditor_tpu_torch.utils.memory import arena_cap_from_env

    assert ("export.trim" in spans) == bool(arena_cap_from_env())


def test_report_fields_are_reads_of_the_spans(traced):
    _, _, rep, _, _ = traced
    t = rep.timer.totals
    assert rep.decode_seconds == t["decode"] > 0
    assert rep.stage_seconds == t["stage.pack"]
    assert rep.device_seconds == t["fetch.wait"]
    assert rep.fetch_seconds == t["fetch.copy"] > 0
    assert rep.upload_seconds == t["export.wait_upload"] + t["export.stage"]
    assert rep.encode_seconds == t["export.wait_encode"]
    for name, s in rep.stages["spans"].items():
        assert s["total_s"] == round(t[name], 6)
        assert s["count"] == rep.timer.counts[name] == len(
            _entries(rep, name))


def test_counts_are_exact_across_threads(traced):
    (_, _, kw, done), jobs, rep, _, _ = traced
    n = len(jobs) - done
    c = rep.timer.counts
    for name in ("decode", "stage.pack", "upload", "export.wait_decode",
                 "queue.batch", "encode", "queue.encode"):
        assert c[name] == n, name
    flushes = c["export.flush"]
    for name in ("export.stage", "export.launch", "export.develop",
                 "export.wait_upload", "export.wait_fetch", "fetch.wait",
                 "fetch.copy", "export.hand_off"):
        assert c[name] == flushes, name
    counters = rep.stages["counters"]
    batch = kw["batch_size"]
    assert counters["slots.developed"] == n
    # A flush short of its batch leaves the rest unfilled: no slot is
    # developed for an image that is not written.
    assert counters["slots.developed"] + counters["slots.unfilled"] == (
        flushes * batch)
    extras = [j for j in jobs[done:] if j.params.has_finish_extras()]
    assert counters["extras.asked"] == len(extras) > 0
    # Extras images batch apart from plain ones: B8 runs over the extras
    # images' slots only.
    assert counters["extras.slots"] == len(extras)
    # Every mosaic stages packed (12-bit, even width, within the budget):
    # the staging kernel's plain version unpacks one slot an image.
    assert counters["staging.slots_unpacked"] == n
    assert counters["staging.slots_copied"] == 0
    assert counters["staging.slots_uploaded"] == 0


def test_every_written_image_carries_its_id(traced):
    (name, _, _, done), jobs, rep, _, _ = traced
    ids = {(j.image_id if j.image_id is not None else i)
           for i, j in enumerate(jobs)}
    written = ({j.image_id for j in jobs[done:]} if name != "jpeg-resume"
               else set(range(done, len(jobs))))
    assert written <= ids
    for span in ("decode", "queue.batch", "fetch.copy", "encode",
                 "queue.encode", "upload", "export.wait_decode"):
        assert _images_of(rep, span) == written, span
    # A flush's images, its queue waits and its fetch share its number.
    for e in _entries(rep, "queue.batch"):
        flush = [f for f in _entries(rep, "export.flush")
                 if f["batch"] == e["batch"]]
        assert len(flush) == 1 and e["image"] in flush[0]["image"]


def test_log_lies_inside_the_call_on_one_clock(traced):
    _, _, rep, t0, t1 = traced
    log = rep.timer.log
    assert log and all(t0 <= e["start_ns"] <= e["end_ns"] <= t1 for e in log)
    main = threading.get_native_id()
    for e in log:
        on_caller = (e["name"].startswith("export.")
                     or e["name"] == "queue.batch")
        assert (e["tid"] == main) == on_caller, e
    # Children lie inside their flush, the develop inside its launch.
    _assert_nested(rep, "export.flush",
                   ("export.wait_upload", "export.stage", "export.launch"))
    _assert_nested(rep, "export.launch", ("export.develop",))


def _assert_nested(rep, parent, children):
    """Each ``children`` span names ``parent`` and lies inside the
    ``parent`` span of its flush."""
    outer = {e["batch"]: e for e in _entries(rep, parent)}
    for name in children:
        for e in _entries(rep, name):
            f = outer[e["batch"]]
            assert e["parent"] == parent
            assert f["start_ns"] <= e["start_ns"] <= e["end_ns"] \
                <= f["end_ns"]


def test_no_log_without_a_profiler_or_trace_spans(paths, tmp_path):
    jobs = _jobs(paths[:3], tmp_path, "jpg")
    rep, _, _ = _run(jobs, use_kernel=True, batch_size=2)
    assert rep.succeeded == 3 and rep.timer.log is None
    assert rep.stages["spans"]["decode"]["count"] == 3
    assert pex.LAST_REPORT == rep.as_dict()


def test_profiler_records_the_waits_and_no_launching_range(paths, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    jobs = _jobs(paths[:5], tmp_path, "jpg")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep, _, _ = _run(jobs, use_kernel=True, batch_size=2)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name in WAITS:
        assert name in ranges, name
    for name in LAUNCHING:
        assert name not in ranges, name
    # A profiler open keeps the log, and its waits and the ranges share
    # one clock (a single pair can be parted by other threads holding
    # the interpreter lock between the two stamps: the median is held).
    log = _entries(rep, "export.wait_decode")
    assert len(log) == len(ranges["export.wait_decode"]) == 5
    pairs = list(zip(log, sorted(ranges["export.wait_decode"])))
    assert np.median([abs(e["start_ns"] - a) for e, (a, _) in pairs]) < 1e6
    assert np.median([abs(e["end_ns"] - b) for e, (_, b) in pairs]) < 1e6


def test_stage_timer_loses_nothing_across_threads():
    rec = StageTimer(keep_log=True)
    threads, per = 24, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                with rec.span("s", image=(k, i)):
                    pass
                rec.count("c", 3)

        pool = [threading.Thread(target=work, args=(k,))
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert rec.counts["s"] == len(rec.log) == threads * per
    assert rec.counters["c"] == 3 * threads * per
    assert len({e["image"] for e in rec.log}) == threads * per
    assert rec.report() == {
        "spans": {"s": {"total_s": round(rec.totals["s"], 6),
                        "count": threads * per}},
        "counters": {"c": 3 * threads * per}}


def test_cli_trace_out_writes_a_chrome_trace(paths, tmp_path, monkeypatch,
                                             capsys):
    from raweditor_tpu_torch.cli import main

    monkeypatch.setenv("RAWEDITOR_TPU_PLATFORM", "cpu")
    trace = tmp_path / "trace.json"
    code = main(["export", "-o", str(tmp_path / "out"), "--files",
                 *paths[:4], "--fast", "--trace-out", str(trace)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and line["succeeded"] == 4
    assert line["stages"]["spans"]["decode"]["count"] == 4
    events = json.loads(trace.read_text())["traceEvents"]
    decode = [e for e in events if e["name"] == "decode"]
    assert sorted(e["args"]["image"] for e in decode) == [0, 1, 2, 3]
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert threading.current_thread().name in names
    flush = [e for e in events if e["name"] == "export.flush"]
    assert flush and all(e["dur"] >= 0 and "batch" in e["args"]
                         for e in flush)


def _linear_files(root, n=5, seed=9):
    """LinearRaw DNGs (photometric 34892, (H, W, 3) u16) by the port's
    writer."""
    rng = np.random.default_rng(seed)
    root.mkdir(exist_ok=True)
    paths = []
    for i in range(n):
        p = root / f"l{i}.dng"
        synth.write_synthetic_linear_dng(
            p, rng.integers(0, 65536, size=SHAPE + (3,), dtype=np.uint16),
            wb_neutral=(0.5, 1.0, 0.625), uncorrelated_preview=True)
        paths.append(str(p))
    return paths


# (route, files, output extension, run_batch_export keywords, the route
# counters the call must count)
DEVELOP_ROUTES = [
    ("kernel", "mosaic", "jpg", dict(use_kernel=True, mode="accurate",
                                     demosaic_method="grad"),
     {"develop.slots.grad.planes", "develop.slots.grad.rgba"}),
    ("plain", "mosaic", "png", dict(mode="parity"), {"develop.slots.plain"}),
    ("linear", "linear", "jpg", dict(use_kernel=True, mode="accurate"),
     {"develop.slots.linear"}),
    ("16-bit", "linear", "tif", dict(mode="accurate", bits=16),
     {"develop.slots.linear"}),
]


@pytest.mark.parametrize("route,files,ext,kw,counted", DEVELOP_ROUTES,
                         ids=[r[0] for r in DEVELOP_ROUTES])
def test_the_develop_span_nests_in_the_launch_on_every_route(
        paths, tmp_path, route, files, ext, kw, counted):
    """``export.develop`` times each flush's develop call inside its
    ``export.launch`` on the kernel route, the plain lane, the LinearRaw
    lane and the 16-bit lane, never as a profiler range (it encloses
    launches), and the route counters still sum to the slots
    developed."""
    from torch.profiler import ProfilerActivity, profile

    src = paths if files == "mosaic" else _linear_files(tmp_path / "raw")
    jobs = _jobs(src[:5], tmp_path, ext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep, _, _ = _run(jobs, batch_size=2, **kw)
    assert rep.succeeded == 5 and not rep.failed
    ranges = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "export.develop" not in ranges and "export.wait_decode" in ranges
    flushes = rep.timer.counts["export.flush"]
    assert rep.timer.counts["export.develop"] == flushes == 3
    _assert_nested(rep, "export.launch", ("export.develop",))
    counters = rep.stages["counters"]
    routes = {k for k in counters if k.startswith("develop.slots.")}
    assert routes == counted
    assert sum(counters[k] for k in routes) == counters["slots.developed"]
