"""The data-parallel updates of DDPG and the explorers (RND, DIAYN, ICM,
ICM-APT, Disagreement, MaxEnt, SMM) at two gloo processes against JAX's
``make_dp_trainer`` on a 2-device mesh, and ``MultiHostTrainer`` with RND.

Two processes (``tests/torch_dp_worker.py``, one spawn for the file) take
the same weights, global batch and noise as the JAX update
(``tests/torch_dp_agents.py``); both must end with the same parameters to
the bit, and within each agent's parity tolerances of JAX's update and of
the port's single-process update on the whole batch. The coupled terms
here: RND's batch statistics and the running statistics of its error, and
``pbe``'s nearest neighbours over the global batch (ICM-APT and MaxEnt,
``knn_avg`` true and false). At one process, the data-parallel update
equals the plain one to the bit.
"""

import pytest
import torch

from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data import replay as replay_lib
from controllable_agent_torch.data.exorl import synthetic_episodes
from controllable_agent_torch.parallel import multihost
from test_torch_parallel import _spawn, one_process_group  # noqa: F401
from torch_dp_agents import (ACT, CASES, DDPG_TOL, N, OBS, check_one_process,
                             check_two_processes, close_metrics, close_states, port_agent,
                             two_process_refs)

NAMES = ["ddpg", "rnd", "diayn", "icm", "icm_apt_avg", "icm_apt_kth", "disagreement",
         "max_ent_avg", "max_ent_kth", "smm"]
RND_SMALL = dict(hidden_dim=32, batch_size=N, rnd_rep_dim=8)


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _episodes():
    return synthetic_episodes(6, 30, OBS, ACT, seed=3)


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    folder = tmp_path_factory.mktemp("dp2_explorers")
    refs = two_process_refs(folder, NAMES)
    torch.save({"agent": "rnd", "cfg": RND_SMALL, "obs_dim": OBS, "action_dim": ACT,
                "episodes": _episodes(), "steps": 2, "trainer_seed": 5},
               folder / "multihost.pt")
    return _spawn(folder), refs


@pytest.mark.parametrize("name", NAMES)
def test_dp_update_at_two_processes(two_processes, name) -> None:
    outs, refs = two_processes
    check_two_processes(outs, refs, name)


def test_rnd_target_stays_frozen_at_two_processes(two_processes) -> None:
    """RND's target gets a zero gradient on every process; summed over the
    group it stays zero, and Adam leaves the target where it was."""
    outs, refs = two_processes
    before = refs["rnd"]["initial_state"]
    for out in outs:
        state = out["agent_updates"]["rnd"]["state"]
        target = [k for k in state if k.startswith("module.mlps.1.")]
        assert target and all(torch.equal(state[k], before[k]) for k in target)


def test_multihost_trainer_with_rnd_at_two_processes(two_processes) -> None:
    """``MultiHostTrainer`` with RND: each process samples its half of every
    batch from its own shard; two updates equal the single-process updates
    on the two halves put together."""
    outs, _ = two_processes
    got = [out["multihost"] for out in outs]
    for key in got[0]["state"]:
        assert torch.equal(got[0]["state"][key], got[1]["state"][key]), key
    agent = port_agent(CASES["rnd"])
    shards = []
    for rank in range(2):
        part = _episodes()[rank::2]
        buffer = ReplayBuffer(max_episodes=len(part), discount=0.98, future=0.99, device="cpu")
        buffer.load_episodes(part)
        shards.append((buffer, torch.Generator().manual_seed(
            5 + multihost.SAMPLE_SEED_STRIDE * (rank + 1))))
    update_generator = torch.Generator().manual_seed(5)
    sums: dict = {}
    for _ in range(2):
        halves = [replay_lib.sample(b.state, g, N // 2, b.cfg) for b, g in shards]
        batch = type(halves[0])(**{
            k: (torch.cat([getattr(h, k) for h in halves]) if torch.is_tensor(getattr(
                halves[0], k)) else getattr(halves[0], k))
            for k in ("obs", "action", "reward", "next_obs", "discount", "meta", "goal",
                      "next_goal", "future_obs", "future_goal", "physics")})
        for k, v in agent.update(batch, update_generator).items():
            sums[k] = sums.get(k, 0.0) + v
    close_metrics(got[0]["metrics"], {k: (v / 2).numpy() for k, v in sums.items()}, DDPG_TOL,
                  "multihost")
    close_states(got[0]["state"], agent.train_state(), 1e-4, DDPG_TOL, "multihost")


@pytest.mark.parametrize("name", NAMES)
def test_dp_update_at_one_process_is_the_plain_update(
        one_process_group, name) -> None:  # noqa: F811
    check_one_process(one_process_group, name)
