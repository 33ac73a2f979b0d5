"""The readings the check's limits are set from, on the card at the cells'
own size, in one process (set-up is long, and every run of a cell writes
its own files from its seed):

    python -m bench_torch.tests.chip_readings --cells <a,b> --seeds 12 \
        --seconds 4 --faults control_bf16 --out chiprun_out/readings.jsonl

For each cell and seed, a sound run (a short window at the cell's own
load, comparing as many outputs as a full run), then the same seed under
each named fault (``faults.py``); one JSON line each with every number the
check compared. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from bench_torch import core
from bench_torch.run import run_cell
from bench_torch.tests import faults


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cells", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2**31 + 101)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--faults", default="control_bf16")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    core.set_cache_dirs()
    names = [f for f in args.faults.split(",") if f]
    with open(args.out, "a") as out:
        for cell in args.cells.split(","):
            for k in range(args.seeds):
                seed = args.first_seed + 7919 * k
                runs = [None] + (names if k < args.fault_seeds else [])
                for fault in runs:
                    ctx = (faults.FAULTS[fault]() if fault
                           else contextlib.nullcontext())
                    t = time.perf_counter()
                    try:
                        with ctx:
                            res = run_cell(argparse.Namespace(
                                workload=cell, seed=seed,
                                seconds=args.seconds, trace=0),
                                core.any_cell(cell))
                        line = {"checks": {n: c["value"] for n, c in
                                           res["checks"].items()},
                                "correct": res["correct"],
                                "attempted": res["attempted"],
                                "metrics": {n: m["value"] for n, m in
                                            res["metrics"].items()}}
                    except Exception as e:  # a control that crashes has
                        line = {"error": repr(e)[:500]}  # failed
                    line.update(cell=cell, seed=seed, fault=fault,
                                seconds=time.perf_counter() - t)
                    out.write(json.dumps(line) + "\n")
                    out.flush()
                    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
