"""On the card, at each training cell's own size, one seed: the program
passes its limits, and the control (the reference with TF32 on in the
program's place) fails at least one of them.  The readings the limits
were set from, over a dozen seeds and three control seeds, are in
PERF.md; ``python3 -m benchmark.control`` makes them."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import run as bench_run
from benchmark.tests.tiny import REPO


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at full size")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["waymo_default.train",
                                      "waymo_perf.train"])
def test_control_fails_and_program_passes(card, workload):
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.control", "--workload", workload,
         "--seeds", "6100000001", "--control", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    limits = bench_run.Bench(REPO).limits(workload)
    lines = [json.loads(x) for x in res.stdout.splitlines()]
    by_side = {x["side"]: x for x in lines}
    prog = by_side["program"]
    assert prog["failed"] == 0
    assert all(prog[k] <= v for k, v in limits.items())
    for side, x in by_side.items():
        if side != "program":
            assert any(x[k] > v for k, v in limits.items()), (side, x)
