"""Rehearse every cell on the CPU at a tiny frame.

    python -m bench_torch.rehearse [--cells a,b] [--seed N]

Every configuration under ``configs/`` under every mix of ``traffic/``
whose driver its reference serves (``core.folder_cells``: the cells of
``BENCHMARK.json`` and those it does not name yet) runs its set-up,
window and check through ``run.run_cell`` with the CPU as the device (the kernels' plain versions, the server's engines
on the CPU), at the frame its own ``rehearsal`` key gives
(``rehearsal_of``), a catalog of four files written once, and a window of
``SECONDS``, untraced and traced; the result object must have the
contract's keys, the cell's metrics by name and ``correct`` true.
Then the real command must refuse to run here (no card) without printing
a result. It prints what it checked, never a metric's value: no number
taken on the CPU stands for the card's."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_torch import core

SECONDS = 1.5
KEYS = ("correct", "attempted", "failed", "metrics", "device", "checks")


def rehearsal_of(cfg: dict) -> dict:
    """The sizes a rehearsal runs the configuration ``cfg`` at, in the
    shape ``Ctx.rehearsal`` carries: its ``rehearsal.frame`` under
    ``frame`` (``files.shape``), its ``rehearsal.session`` (a preview
    width cut with the frame) under ``session`` (``slider_session.
    session_of``), four catalog files and two repeats of them. Refuses,
    by name, a configuration with no ``rehearsal.frame``: it is never
    rehearsed at its full size."""
    own = cfg.get("rehearsal", {})
    if "frame" not in own:
        raise KeyError(f"configuration {cfg['name']!r} has no "
                       f"rehearsal.frame; it is not rehearsed at full size")
    return {"frame": {cfg["name"]: tuple(own["frame"])},
            "session": {cfg["name"]: own.get("session", {})},
            "catalog_files": 4, "repeats": 2}


def rehearse_cell(name: str, seed: int, traced: bool) -> dict:
    import torch

    from bench_torch.run import run_cell

    args = argparse.Namespace(workload=name, seed=seed, seconds=SECONDS,
                              trace=int(traced))
    found = core.any_cell(name)
    out = run_cell(args, found, device=torch.device("cpu"),
                   rehearsal=rehearsal_of(found[2]))
    want = {m["name"] for m in core.metrics_of(found[0], found[1], traced)}
    if tuple(out) != KEYS:
        raise AssertionError(f"{name}: result keys {list(out)}")
    if not set(out["metrics"]) <= want:
        raise AssertionError(f"{name}: metrics {sorted(out['metrics'])} "
                             f"outside {sorted(want)}")
    # The CPU has no device trace: a metric read from it reads nothing.
    host = {m["name"] for m in core.metrics_of(found[0], found[1], traced)
            if m["source"] != "device_trace"}
    if not traced and not host <= set(out["metrics"]):
        raise AssertionError(f"{name}: end-to-end metrics "
                             f"{sorted(out['metrics'])}, want {sorted(host)}")
    for m in out["metrics"].values():
        if set(m) != {"value", "unit"} or not isinstance(
                m["value"], (int, float)):
            raise AssertionError(f"{name}: metric entry {m}")
    if not out["correct"]:
        raise AssertionError(f"{name}: not correct: {out['checks']}")
    json.dumps(out)  # the line must serialise
    return out


def refuses_without_card(name: str) -> None:
    """The real command exits non-zero and prints no result line here."""
    proc = subprocess.run(
        [sys.executable, "-m", "bench_torch.run", "--workload", name,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=core.REPO, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    if proc.returncode == 0 or proc.stdout.strip():
        raise AssertionError(f"the real command ran without a card: "
                             f"rc {proc.returncode}, {proc.stdout[-200:]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m bench_torch.rehearse")
    p.add_argument("--cells", default="")
    p.add_argument("--seed", type=int, default=2**31 + 17)
    args = p.parse_args(argv)
    cells = [c for c in args.cells.split(",") if c] or core.folder_cells()
    for name in cells:
        for traced in (False, True):
            out = rehearse_cell(name, args.seed, traced)
            print(f"rehearsal {name} trace={int(traced)}: keys ok, metrics "
                  f"{sorted(out['metrics'])}, correct, checks "
                  f"{ {k: v['value'] for k, v in out['checks'].items()} }",
                  flush=True)
    refuses_without_card(core.benchmark()["workloads"][0]["name"])
    print("rehearsal: the real command refuses to run without a card",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
