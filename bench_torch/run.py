"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m bench_torch.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (``bench_torch/configs/<config>.json``) and
a traffic mix (``bench_torch/traffic/<mix>.json``); the mix names the
general generator that reads it (``bench_torch/drivers/<driver>.py``),
which makes the cell's files from the seed, sets the program up, runs the
window and checks what the window produced against the configuration's
plain reference (the module its ``reference`` key names). With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, each read by ``bench_torch/metrics/<name>.py`` from the traced
window's record.

Standard error gets the set-up split, then as its last lines each number
the check compared beside its limit; the last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``. An
end-to-end metric whose source is ``device_trace`` is read by its reader
from the device's activity, which ``--trace 0`` records without the host's
operations. Exits
with 2, printing no result, when torch sees no CUDA device or fewer than
the cell asks for; with 3, printing no result, when once the window has
closed the process holds a module of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from bench_torch import core

# Top-level module names the process may not hold: the port and the
# benchmark run without JAX and without the JAX package.
BARRED = frozenset({"jax", "jaxlib", "flax", "raweditor_tpu"})


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m bench_torch.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, found, device=None, rehearsal=None, setup=None) -> dict:
    """Set up, run the window, check; returns the result object.
    ``found`` is the cell as ``core.find_cell`` gives it. The real
    command passes no ``device`` (the card) and the set-up clock it
    started; the rehearsal passes the CPU and a ``rehearsal`` dict of
    shrunk sizes."""
    bench, cell, cfg, mix = found
    driver = core.driver_of(mix)
    with tempfile.TemporaryDirectory(prefix="bench_torch_") as work:
        ctx = core.Ctx(cell, cfg, mix, args.seed, device, work, rehearsal,
                       setup)
        with ctx.setup.phase("import"):
            import torch

            import raweditor_tpu_torch  # noqa: F401 - timed as set-up
        if device is None:
            with ctx.setup.phase("cuda_init"):
                torch.cuda.init()
                ctx.device = torch.device("cuda", 0)
                ctx.cuda = True
                torch.zeros(1, device=ctx.device)
                torch.cuda.synchronize()
        state = driver.setup(ctx)
        split = ctx.setup.report()
        core.log("setup_split " + json.dumps(split))
        if ctx.cuda:
            torch.cuda.reset_peak_memory_stats(ctx.device)
        e2e = core.metrics_of(bench, cell, False)
        device_e2e = any(m["source"] == "device_trace" for m in e2e)
        with core.Trace(bool(args.trace) or device_e2e, ctx.cuda,
                        light=not args.trace) as trace:
            record = driver.window(ctx, state, args.seconds, trace)
        record["trace"] = trace.summary
        record["window_s"] = trace.window_s
        device_obj = (core.device_info(ctx.device) if ctx.cuda else
                      {"platform": "cpu", "kind": "cpu rehearsal",
                       "count": 0, "memory_peak_bytes": 0})
        driver.release(ctx, state)
        checks = driver.check(ctx, state, record)
    metrics = {}
    for m in core.metrics_of(bench, cell, bool(args.trace)):
        if args.trace or m["source"] == "device_trace":
            value = core.read_metric(m["name"], record)
        elif m["name"] == "setup_s":
            value = split["setup_s"]
        else:
            value = record["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics,
           "device": device_obj}
    summary = record["trace"]
    if args.trace:
        if summary is not None and summary["busy_s"] is not None:
            device_obj["busy_s"] = summary["busy_s"]
            device_obj["window_s"] = summary["window_s"]
            out["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    setup = core.Setup()
    args = parse(argv)
    core.set_cache_dirs()  # before the lookups import torch
    with setup.phase("import"):
        found = core.find_cell(args.workload)
        import torch
    cell = found[1]

    want = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        core.log(f"{args.workload} needs {want} CUDA device(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}:"
                 " no result")
        return 2
    out = run_cell(args, found, setup=setup)
    loaded = sorted(BARRED & {m.partition(".")[0] for m in sys.modules})
    if loaded:
        core.log(f"the run loaded {loaded}: no result")
        return 3
    core.log(f"card: {core.power_limit()}")
    for name, c in out["checks"].items():
        core.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
