"""The data-parallel updates of SF (four φ learners and the z mix), SF-SVD,
discrete FB and discrete SF at two gloo processes against JAX's
``make_dp_trainer`` on a 2-device mesh, and one ``OnlineTrainer(group=)``
cycle of discrete FB on the gridworld.

As ``tests/test_torch_parallel_agents.py`` (one spawn of
``tests/torch_dp_worker.py`` for the file, the cases of
``tests/torch_dp_agents.py``). The coupled terms here: ``lap``'s
orthonormality, the contrastive logits over the global batch, the n x n
factorizations of ``svd_sr``, ``svd_p`` and SF-SVD, the z mix over the
global batch's permuted goals whitened by the pseudo-inverse of their
covariance (``mix_ratio=0.5``), discrete FB's measure matrices and
orthonormality sums, its z mix and the pseudo-inverse of the global
batch's Cov(B) (``q_loss``). At one process, the data-parallel update
equals the plain one to the bit.
"""

import numpy as np
import pytest
import torch

from controllable_agent_torch.agents import AGENTS
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.train.loops import OfflineTrainer, OnlineTrainer
from controllable_agent_torch.train.workspace import make_env
from test_torch_parallel import _spawn, one_process_group  # noqa: F401
from torch_dp_agents import (CASES, DISCRETE_TOL, SF_SMALL, check_one_process,
                             check_two_processes, close_metrics, close_states, two_process_refs)

NAMES = ["sf_lap", "sf_contrastive", "sf_svd_sr", "sf_svd_p", "sf_mix", "sf_svd", "discrete_fb",
         "discrete_fb_q_loss", "discrete_sf"]
ONLINE = {"agent": "discrete_fb", "cfg": SF_SMALL, "task": "grid_simple", "episode_length": 10,
          "num_envs": 2, "updates_per_step": 0.2, "generator_seed": 4}


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    folder = tmp_path_factory.mktemp("dp2_sf")
    refs = two_process_refs(folder, NAMES)
    torch.save(ONLINE, folder / "online.pt")
    return _spawn(folder), refs


@pytest.mark.parametrize("name", NAMES)
def test_dp_update_at_two_processes(two_processes, name) -> None:
    outs, refs = two_processes
    check_two_processes(outs, refs, name)


def _grid_agent():
    env = make_env(ONLINE["task"], ONLINE["episode_length"])
    cfg_cls, cls = AGENTS[ONLINE["agent"]]
    return env, cls(cfg_cls(**ONLINE["cfg"]), env.spec.obs_dim, env.spec.n_actions,
                    device="cpu")


def test_online_cycle_with_a_group_at_two_processes(two_processes) -> None:
    """Each process steps its share of the grid's environments from its own
    collect generator, both commit every episode in rank order, and the
    data-parallel updates on that replay end where the single-process
    trainer's do on the same replay and generator."""
    outs, _ = two_processes
    got = [out["online"] for out in outs]
    for key in got[0]["state"]:
        assert torch.equal(got[0]["state"][key], got[1]["state"][key]), key
    for key in got[0]["storage"]:
        assert torch.equal(got[0]["storage"][key], got[1]["storage"][key]), key
    num_envs, length = ONLINE["num_envs"], ONLINE["episode_length"]
    assert got[0]["episodes"] == num_envs
    assert got[0]["updates"] == int(length * num_envs * ONLINE["updates_per_step"]) > 0
    assert np.isfinite(got[0]["metrics"]["fb_loss"])
    # rank r's episode is the one a single process collects from the generator of rank r
    for rank in range(2):
        env, agent = _grid_agent()
        buffer = ReplayBuffer(1, discount=0.98, future=0.99, max_episode_length=length,
                              device="cpu")
        collect = torch.Generator().manual_seed(ONLINE["generator_seed"] + 1 + rank)
        OnlineTrainer(env, agent, buffer, num_envs=1, updates_per_step=0.0).run_cycle(
            torch.Generator(), collect)
        for key, value in buffer.state.storage.items():
            assert torch.equal(got[0]["storage"][key][rank], value[0]), (rank, key)
    _, agent = _grid_agent()
    buffer = ReplayBuffer(num_envs, discount=0.98, future=0.99, max_episode_length=length,
                          device="cpu")
    buffer.add_trajectory({k: v.transpose(0, 1) for k, v in got[0]["storage"].items()}, length)
    metrics = OfflineTrainer(agent, buffer.cfg, agent.cfg.batch_size, got[0]["updates"])(
        buffer.state, torch.Generator().manual_seed(ONLINE["generator_seed"]))
    close_metrics({k: got[0]["metrics"][k] for k in metrics}, metrics, DISCRETE_TOL, "online")
    close_states(got[0]["state"], agent.train_state(), SF_SMALL.get("lr", 1e-4), DISCRETE_TOL,
                 "online")


@pytest.mark.parametrize("name", NAMES)
def test_dp_update_at_one_process_is_the_plain_update(
        one_process_group, name) -> None:  # noqa: F811
    check_one_process(one_process_group, name)
