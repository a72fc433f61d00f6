"""The control of each cell (the plain reference in the program's place at
the precision below the configuration's) and its faults come out as not
correct under the cell's limits: ``control.py`` at a size a test can hold.
A control in TF32 exists only on the card: its cells' test is marked
``cuda`` and skips without one."""

import pytest
import torch

from perfbench import control, harness


def _cells():
    for w in harness.benchmark()["workloads"]:
        tf32 = harness.cell(w["name"])[1]["control"]["nets"] == "tf32"
        yield pytest.param(w["name"], marks=[pytest.mark.cuda] if tf32 else [])


CELLS = list(_cells())


def failed(numbers, limits):
    return [k for k, lim in limits.items() if k in numbers and not numbers[k] <= lim]


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail(cell):
    device = "cpu"
    if harness.cell(cell)[1]["control"]["nets"] == "tf32":
        if not torch.cuda.is_available():
            pytest.skip("TF32 products exist only on a CUDA card")
        device = "cuda"
    out = control.main(["--workload", cell, "--seeds", str(2 ** 31 + 5), "--rehearse",
                        "--device", device])
    limits = harness.cell(cell)[0]["limits"]
    (readings,) = out["seeds"].values()
    # the rest are unsound; ``noise_gap`` counts standard errors, which the
    # rehearsal's few hundred draws cannot pile up to the cell's limit
    # (``test_perfbench_check.py`` holds it at a cell's size)
    kinds = [k for k in readings if not k.startswith("program") and k != "noise_zeroed"]
    assert any(k.startswith("control") for k in kinds)
    for kind in kinds:
        assert failed(readings[kind], limits), (kind, readings[kind])
