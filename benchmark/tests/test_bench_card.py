"""On the card: one short run of each cell through the command, correct
and with every end-to-end metric.  Skips where there is no card."""
import json
import subprocess
import sys

import pytest

import harness
from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.load_benchmark()["workloads"]])
def test_cell_runs_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "4242424242", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    names = {m["name"] for m in harness.resolve(workload).end_to_end}
    assert set(line["metrics"]) == names
