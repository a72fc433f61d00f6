"""The comparison that decides ``correct`` sees each fault a cell can have:
the rest of a run (a rehearsal on the CPU) is driven with the timed path
broken underneath, and ``correct`` comes out false. The sound rehearsal
beside them comes out true. The limits are the cells' own, set at their
sizes on the card; here the program's products run in float32, so that
what the tiny widths make of bf16 does not blur what the faults do."""

import json

import pytest
import torch

from perfbench import harness
from perfbench import run as bench_run

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SEED = 2 ** 31 + 101


@pytest.fixture(autouse=True)
def float32_products(monkeypatch):
    monkeypatch.setitem(harness.REHEARSAL["agent_config"], "compute_dtype", "float32")


def correct(capsys, cell):
    assert bench_run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                           "--rehearse"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound(capsys, cell):
    assert correct(capsys, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(capsys, monkeypatch, cell):
    from controllable_agent_torch import optim
    monkeypatch.setattr(optim.Adam, "step", lambda self, grads: None)
    assert not correct(capsys, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch(capsys, monkeypatch, cell):
    import dataclasses

    from controllable_agent_torch.data import replay
    sample = replay.sample

    def half(*args, **kwargs):
        batch = sample(*args, **kwargs)
        rows = batch.obs.shape[0] // 2
        cut = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
        cut = {k: (v[:rows] if isinstance(v, torch.Tensor) else
                   {m: x[:rows] for m, x in v.items()} if isinstance(v, dict) else v)
               for k, v in cut.items()}
        return dataclasses.replace(batch, **cut)

    monkeypatch.setattr(replay, "sample", half)
    assert not correct(capsys, cell)


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".online")])
def test_transition_altered(capsys, monkeypatch, cell):
    from controllable_agent_torch.train import loops
    write = loops.EpisodeCollector._write

    def altered(self, name, value):
        write(self, name, value + 0.01 if name == "physics" else value)

    monkeypatch.setattr(loops.EpisodeCollector, "_write", altered)
    assert not correct(capsys, cell)
