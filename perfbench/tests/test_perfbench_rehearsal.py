"""Each cell rehearsed on the CPU at small widths, through the harness's
own entry: the last line of standard output is the result, with exactly
the keys the contract reads, and it names no device metric; a run without a
card asks for none."""

import json

import pytest
import torch

from perfbench import harness
from perfbench import run as bench_run

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def rehearse(capsys, cell, trace, seed=2 ** 31 + 11):
    rc = bench_run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                         "--trace", str(trace), "--rehearse"])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_last_line(capsys, cell, trace):
    rc, result = rehearse(capsys, cell, trace)
    assert rc == 0
    assert set(result) == KEYS | ({"breakdown"} if trace else set())
    assert list(result)[-1] == "checks"
    assert result["metrics"] == {}  # no device metric from the CPU
    assert result["device"]["platform"] == "cpu"
    assert result["attempted"] >= 1 and result["failed"] == 0
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
