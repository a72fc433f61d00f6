"""Each reference module's FLOP count (``update_flops``, from ``flops.py``'s
pieces) against ``torch.utils.flop_counter`` on one eager update of the
program with the plain loss, at small widths on the CPU."""

import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import data, flops, program
from perfbench.harness import cell
from perfbench.reference import walker

N = 16


def _update_flops(name, overrides):
    _, config = cell(name, rehearse=True)
    config = {**config, "agent_config": {**config["agent_config"], **overrides,
                                         "batch_size": N}}
    agent = program.agent(config, torch.device("cpu"))
    env = config["env"]
    gen = torch.Generator().manual_seed(0)
    batch = program_batch(env, gen)
    with FlopCounterMode(display=False) as counter:
        agent.update(batch, gen)
    return counter.get_total_flops(), program.shapes(config), importlib.import_module(
        f"perfbench.reference.{config['reference']}")


def program_batch(env, gen):
    from controllable_agent_torch.data.episode_batch import EpisodeBatch

    def rows(width):
        return torch.randn((N, width), generator=gen) if width else None

    return EpisodeBatch(obs=rows(env["observation"]), action=rows(env["action"]).tanh(),
                        reward=rows(1), discount=torch.full((N, 1), 0.98),
                        next_obs=rows(env["observation"]), goal=rows(env.get("goal")),
                        next_goal=rows(env.get("goal")), future_obs=rows(env["observation"]),
                        future_goal=rows(env.get("goal")), physics=None, meta={})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fb_update(dtype):
    counted, s, ref = _update_flops("fb_walker.offline",
                                    {"use_pallas_loss": False, "compute_dtype": dtype})
    # the plain loss's diagnostics add BᵀB (orth_linf, orth_l2), no part of the model
    assert counted == ref.update_flops(s, N) + 2 * N * s.z * s.z


def test_sf_update():
    counted, s, ref = _update_flops("sf_lap_walker.offline", {})
    assert s.goal == s.obs  # no goal space: φ reads the observation
    assert counted == ref.update_flops(s, N)


def test_fused_loss_counts_least_work():
    work, moved = flops.fused_fb_loss(1024, 50)
    assert work == 16 * 1024 * 1024 * 50 + 2 * 1024 * 50 * 50
    assert moved == 2 * (6 * 1024 * 50 + 1024) * 4 + 3 * 1024 * 50 * 4 + 16


def test_replay_is_the_seeds():
    widths = {"observation": 3, "action": 2, "physics": 6, "goal": 2}
    a = data.replay(2, 5, widths, 2 ** 31 + 7, torch.device("cpu"), walker.replay_physics)
    b = data.replay(2, 5, widths, 2 ** 31 + 7, torch.device("cpu"), walker.replay_physics)
    c = data.replay(2, 5, widths, 2 ** 31 + 8, torch.device("cpu"), walker.replay_physics)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["observation"], c["observation"])
