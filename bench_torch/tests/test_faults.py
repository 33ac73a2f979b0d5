"""The check reads the control and every planted fault as not correct,
and a sound run as correct: each cell run through the harness on the CPU
at the rehearsal's tiny frame (the step that looks for a card skipped),
with the timed path broken underneath (``faults.py``)."""

import argparse

import pytest
import torch

from bench_torch import core, rehearse
from bench_torch.run import run_cell
from bench_torch.tests import faults

CASES = [(name, fault) for name in core.folder_cells()
         for fault in (None,) + faults.BY_DRIVER[
             core.any_cell(name)[3]["driver"]]]


def _run(cell: str, seed: int):
    args = argparse.Namespace(workload=cell, seed=seed,
                              seconds=rehearse.SECONDS, trace=0)
    found = core.any_cell(cell)
    return run_cell(args, found, device=torch.device("cpu"),
                    rehearsal=rehearse.rehearsal_of(found[2]))


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_the_check_reads_the_fault(cell, fault):
    if fault is None:
        out = _run(cell, 2**31 + 5)
        assert out["correct"], out["checks"]
        return
    with faults.FAULTS[fault]():
        out = _run(cell, 2**31 + 5)
    assert not out["correct"], (fault, out["checks"])
