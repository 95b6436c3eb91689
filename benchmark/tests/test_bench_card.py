"""On a CUDA card: one short run of each cell gives a correct result line
with the contract's keys. Skipped where there is no card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.inputs.load_json(
    harness.ROOT + "/BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           "2147483777", "--seconds", "2", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] and line["device"]["platform"] == "gpu"
