"""The check's reading of the program's draws: each sampled row found among
the data's transitions, a row that is none counted, and the noise held to
its distributions."""

import math

import pytest
import torch

from perfbench import check, data
from perfbench.reference import train, walker

WIDTHS = {"observation": 5, "action": 3, "physics": 18, "goal": 2}
DISCOUNT = 0.98


def _data():
    return data.replay(7, 20, WIDTHS, 2 ** 31 + 21, torch.device("cpu"), walker.replay_physics)


def _batch(storage, n=64):
    gen = torch.Generator().manual_seed(3)
    ep = torch.randint(0, 7, (n,), generator=gen)
    step = torch.randint(1, 21, (n,), generator=gen)
    return ep, step, train.batch_of(storage, ep, step, DISCOUNT)


def test_rows_are_found():
    storage = _data()
    ep, step, batch = _batch(storage)
    found_ep, found_step, miss = check.rows(batch, storage, DISCOUNT, 64)
    assert miss == 0.0
    assert torch.equal(found_ep, ep) and torch.equal(found_step, step)


@pytest.mark.parametrize("fault", ["next_obs", "discount", "half", "goal"])
def test_rows_that_are_no_transition(fault):
    storage = _data()
    _, _, batch = _batch(storage)
    if fault == "half":
        batch = {k: v[:32] for k, v in batch.items()}
        expected = 0.5
    else:
        batch = dict(batch)
        batch[fault] = batch[fault].clone()
        batch[fault][:16] += 0.5
        expected = 16 / 64
    assert check.rows(batch, storage, DISCOUNT, 64)[2] == expected


def test_noise_held_to_its_distributions():
    gen = torch.Generator().manual_seed(5)
    sound = {"z_normal": torch.randn((1024, 50), generator=gen),
             "mix_uniform": torch.rand((1024, 1), generator=gen),
             "perm": torch.randperm(1024, generator=gen)}
    assert check.noise([sound]) < 5.0
    halved = {**sound, "z_normal": sound["z_normal"] * 0.5}
    assert check.noise([halved]) > 100.0
    assert math.isinf(check.noise([{**sound, "perm": torch.zeros(1024, dtype=torch.int64)}]))
    with pytest.raises(ValueError):
        check.noise([{"unknown": sound["z_normal"]}])
