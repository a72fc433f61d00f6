"""On a card: a short traced run of each cell through the one command,
correct, with its per-layer metrics and the device's busy time."""

import json
import subprocess
import sys

import pytest

from perfbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 3), "--seconds", "5", "--trace", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert result["metrics"]
