"""What every cell's run shares: the benchmark file and the lookups by
name (a cell's configuration and traffic mix, the mix's driver, the
configuration's container writer and reference, the per-layer readers);
the set-up clock and its split; the cache directories; the traced window;
the device's description; the result line.

Nothing here imports the program; the drivers do, inside their
functions."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
BENCHMARK = REPO / "BENCHMARK.json"
# Where configurations and traffic mixes are found by name.
CONFIGS = PKG / "configs"
TRAFFIC = PKG / "traffic"
# Fixed cache directories inside the checkout, so that only a cell's first
# run there builds or compiles. The program builds its own kernels into
# build/raweditor_tpu_torch/ (a fixed path under the checkout as well).
CACHE = REPO / "build" / "bench_torch"
CACHE_ENV = {"TRITON_CACHE_DIR": CACHE / "triton",
             "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
             "CUDA_CACHE_PATH": CACHE / "cuda_cache"}
# Device events that move bytes rather than compute (excluded from the
# kernels' device time, kept in the busy union).
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
# Kernel names are C++ signatures of some hundreds of characters; the
# first 120 tell them apart.
NAME_CHARS = 120


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), so that set-up
    counts the interpreter's own start; falls back to 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def set_cache_dirs() -> None:
    """Point every compiler cache at its fixed directory in the
    checkout (before torch is imported)."""
    for key, path in CACHE_ENV.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def find_cell(name: str):
    """(benchmark, cell, configuration, traffic mix) of the cell
    ``name`` of ``BENCHMARK.json``; raises KeyError naming it when the
    file has no such cell, and LookupError (``serves``) when its
    configuration's reference lacks what its mix's driver checks with."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {BENCHMARK.name}; cells: "
                       f"{sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(REPO / config["file"])
    mix = _mix(cell)
    serves(cfg, cell["traffic"], mix)
    return bench, cell, cfg, mix


def folder_cells() -> list:
    """``<config>.<mix>`` for every configuration under ``CONFIGS`` and
    every mix under ``TRAFFIC`` whose driver its reference serves
    (``serves``): the cells the rehearsal and the tests run, those
    ``BENCHMARK.json`` names and those it does not yet. A new
    configuration or a new mix is found as a new file alone."""
    mixes = {m.stem: load_json(m) for m in sorted(TRAFFIC.glob("*.json"))}
    cells = []
    for path in sorted(CONFIGS.glob("*.json")):
        cfg = load_json(path)
        for traffic, mix in mixes.items():
            try:
                serves(cfg, traffic, mix)
            except _Unserved:
                continue
            cells.append(f"{path.stem}.{traffic}")
    return cells


def any_cell(name: str):
    """As ``find_cell``, and for a name not in ``BENCHMARK.json`` the
    cell ``<config>.<mix>`` read from ``CONFIGS`` and ``TRAFFIC``
    directly, on one chip, with the end-to-end metrics that name no
    cells."""
    try:
        return find_cell(name)
    except KeyError:
        config, _, traffic = name.partition(".")
        path = CONFIGS / f"{config}.json"
        if not path.is_file():
            raise
    cfg = load_json(path)
    bench = benchmark()
    cell = {"name": name, "config": config, "traffic": traffic, "chips": 1}
    mix = _mix(cell)
    serves(cfg, traffic, mix)
    return bench, cell, cfg, mix


class _Unserved(LookupError):
    """A configuration's reference lacks entry points a driver needs."""


def serves(cfg: dict, traffic: str, mix: dict) -> None:
    """Refuses, by a LookupError naming what is missing, a cell of the
    configuration ``cfg`` under the mix ``traffic`` unless its reference
    module (``reference_of``) gives every entry point that the mix's
    driver lists in ``REFERENCE``, the ones its check calls."""
    need = driver_of(mix).REFERENCE
    reference = reference_of(cfg)
    missing = [n for n in need if not hasattr(reference, n)]
    if missing:
        raise _Unserved(f"configuration {cfg['name']!r}: its reference "
                        f"{cfg['reference']} gives no {missing}, which mix "
                        f"{traffic!r} (driver {mix['driver']!r}) checks "
                        f"with")


def _mix(cell: dict) -> dict:
    return load_json(TRAFFIC / f"{cell['traffic']}.json")


def driver_of(mix: dict):
    """The general generator that reads a traffic mix: the module
    ``bench_torch.drivers.<mix["driver"]>``."""
    return importlib.import_module(f"bench_torch.drivers.{mix['driver']}")


def container_of(cfg: dict):
    """The writer of a configuration's files: the module
    ``bench_torch.containers.<cfg["container"]>`` (its interface is in
    that package's docstring); raises LookupError naming the module when
    there is none."""
    return _module(cfg, "container", f"bench_torch.containers."
                                     f"{cfg['container']}")


def reference_of(cfg: dict):
    """The plain reference that checks a configuration: the module whose
    file its ``reference`` key names, relative to the checkout
    (``bench_torch/yardstick/reference.py`` is
    ``bench_torch.yardstick.reference``), imported by that name; raises
    LookupError naming it when there is none.

    A reference module gives what the drivers' checks call, for the
    frames its configuration's container returns; each driver lists the
    ones it calls in its ``REFERENCE``, and a configuration makes a cell
    under a mix only where its reference gives them all (``serves``):
    ``export_planes(frame, params, device, flags)``, the (Y, Cb, Cr) u8
    4:2:0 planes the exporter hands its JPEG encoder for one file
    (``catalog_export``); ``preview(frame, mosaic_dev, params, flags)``,
    the session's (h, w, 3) u8 preview; ``preview_planes(rgb)``, an even
    preview's 4:2:0 planes; ``histogram(frame, mosaic_dev, params,
    flags)``, the (3, 256) counts of the ``histogram`` reply;
    ``bin_shift(got, want)``, how many bins one histogram's counts lie
    from another's (these four, ``slider_session``)."""
    path = cfg["reference"]
    if not path.endswith(".py") or path.startswith("/") or ".." in path:
        raise LookupError(f"configuration {cfg['name']!r}: reference "
                          f"{path!r} is not a .py file inside the checkout")
    return _module(cfg, "reference", path[:-3].replace("/", "."))


def _module(cfg: dict, key: str, name: str):
    """The module ``name`` that the configuration's ``key`` names;
    LookupError naming both when there is no such module."""
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name is None or not (name == e.name
                                  or name.startswith(e.name + ".")):
            raise
        raise LookupError(f"configuration {cfg['name']!r}: {key} "
                          f"{cfg[key]!r} has no module {name}") from None


def _load(path: Path, name: str):
    """The module at ``path``, executed anew under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: dict, traced: bool):
    """The metric entries this cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    def applies(m):
        return cell["name"] in m.get("workloads", [cell["name"]])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if applies(m)
            and ("workloads" in m or m["moves"] in names)]


def read_metric(name: str, record: dict):
    """The metric ``name`` read from the run's record by its own reader,
    ``bench_torch/metrics/<name>.py`` (every per-layer metric, and an
    end-to-end metric whose source is the device trace); None when the
    reader finds nothing to read."""
    return _load(PKG / "metrics" / f"{name}.py",
                 f"bench_torch_metric_{name.replace('.', '_')}").read(record)


class Setup:
    """The set-up clock: from process start to the window's start, split
    into named phases (whatever falls between phases is ``other``)."""

    def __init__(self):
        self.t0 = time.perf_counter() - process_age_s()
        self.split = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.split[name] = (self.split.get(name, 0.0)
                                + time.perf_counter() - t)

    def total(self) -> float:
        return time.perf_counter() - self.t0

    def report(self) -> dict:
        total = self.total()
        out = dict(self.split)
        out["other"] = total - sum(self.split.values())
        out["setup_s"] = total
        return out


class Ctx:
    """One run: the cell, its configuration and mix, the seed, the device
    and a scratch directory. ``rehearsal`` is set by ``bench_torch.
    rehearse`` (the CPU, a tiny frame), never by the real command."""

    def __init__(self, cell, cfg, mix, seed, device, workdir,
                 rehearsal=None, setup=None):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed = int(seed)
        self.device = device
        self.cuda = device is not None and device.type == "cuda"
        self.workdir = Path(workdir)
        self.rehearsal = rehearsal or {}
        self.setup = setup or Setup()

    def rng(self, stream: str):
        """A NumPy generator of this seed for one named purpose, so that
        adding a draw in one place moves no other draw."""
        import zlib

        import numpy as np

        return np.random.default_rng([self.seed & (2**63 - 1),
                                      zlib.crc32(stream.encode())])

    def sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)


class Trace:
    """The traced window: ``torch.profiler`` over CPU and CUDA activity
    while on, and after it the device's busy time, the kernels' device
    time by name and the longest idle gaps; a no-op when off. ``light``
    records the device's activity alone (no host operations), for an
    untraced run whose end-to-end metrics come from the device trace."""

    def __init__(self, on: bool, cuda: bool, light: bool = False):
        self.on, self.cuda, self.light = on, cuda, light
        self.prof = None
        self.window_s = 0.0
        self.summary = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [] if self.light and self.cuda else [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        if self.prof is not None:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(self.prof, self.window_s)
        return False


class _Range:
    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    """A profiler event as ``busy_union`` reads it (microseconds)."""
    __slots__ = ("name", "device_type", "time_range")

    def __init__(self, raw):
        self.name = raw.name()
        self.device_type = raw.device_type()
        self.time_range = _Range(raw.start_ns() / 1e3, raw.end_ns() / 1e3)


class _Events:
    """The profiler's raw events without its slow tree building, behind
    the ``events()`` the busy union calls."""

    def __init__(self, prof):
        self._events = [_Event(e) for e in
                        prof.profiler.kineto_results.events()]

    def events(self):
        return self._events


def summarize(prof, window_s: float) -> dict:
    """The traced window's device numbers: busy seconds (the union of
    device intervals), kernels by name (device seconds, count; copies
    apart), the count of kernel launches, and the ten longest idle gaps
    labelled by the innermost host operation running at their midpoint.
    ``busy_s`` is None when the profiler saw no device event."""
    import bisect

    import torch

    from bench_torch.yardstick.busy import busy_union

    raw = _Events(prof)
    busy_us, spans = busy_union(raw)
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in raw.events():
        if e.device_type == cuda:
            s = (e.time_range.end - e.time_range.start) / 1e6
            name = e.name[:NAME_CHARS]
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + s, n + 1)
    kernels = {k: v for k, v in by_name.items()
               if not k.startswith(COPY_PREFIXES)}
    copies = {k: v for k, v in by_name.items() if k.startswith(COPY_PREFIXES)}
    gaps = []
    end = None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    mids = sorted(((a + b) / 2, i) for i, (a, b) in enumerate(gaps))
    keys = [m for m, _ in mids]
    inner = {}
    for e in raw.events():
        if e.device_type == cuda:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        for j in range(bisect.bisect_left(keys, lo),
                       bisect.bisect_right(keys, hi)):
            i = mids[j][1]
            if i not in inner or hi - lo < inner[i][0]:
                inner[i] = (hi - lo, e.name[:NAME_CHARS])
    labelled = [[inner[i][1] if i in inner else "no torch op on the host",
                 (b - a) / 1e6] for i, (a, b) in enumerate(gaps)]
    return {
        "busy_s": busy_us / 1e6 if spans else None,
        "window_s": window_s,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "copies": {k: list(v) for k, v in copies.items()},
        "launches": sum(n for _, n in kernels.values()),
        "kernel_s": sum(t for t, _ in kernels.values()),
        "device_ops": sorted(([k, v[0]] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": labelled,
    }


def device_info(device) -> dict:
    """The contract's ``device`` object for the card the run used."""
    import torch

    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    "not read"."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def log(*a):
    print(*a, file=sys.stderr, flush=True)
