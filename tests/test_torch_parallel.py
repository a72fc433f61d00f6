"""The port's data-parallel FB update against the single-process update and
against the JAX package's ``make_dp_trainer``.

Two processes on gloo (``tests/torch_dp_worker.py``, rendezvous through a
file) take the same weights, global batch and noise as the JAX update on a
2-device mesh; the JAX noise is replayed from its key
(``test_torch_fb_ddpg.jax_update_noise``). Held to the tolerances of the
single-process parity tests (``tests/test_torch_fb_ddpg.py``: metrics and
losses rtol 1e-4, atol 1e-5; parameters after Adam within 2 lr, with at
most one entry per tensor or 1e-3 of it past 1e-3 lr). Every process must
end with the same parameters to the bit, and at world size 1 the
data-parallel update must equal the single-process one to the bit. The
trainers take every agent of ``AGENTS`` (the other agents' updates against
JAX's are in ``tests/test_torch_parallel_agents*.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from controllable_agent_tpu.parallel import make_dp_trainer as jax_make_dp_trainer
from controllable_agent_tpu.parallel import make_mesh
from controllable_agent_tpu.parallel import shard_batch as jax_shard_batch
from controllable_agent_torch.agents import AGENTS, FBDDPGAgent, FBDDPGConfig
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data import replay as replay_lib
from controllable_agent_torch.data.exorl import synthetic_episodes
from controllable_agent_torch.parallel import (make_dp_offline_trainer, make_dp_trainer,
                                               make_group, multihost)
from controllable_agent_torch.tools import dryrun_multichip
from controllable_agent_torch.train.loops import OfflineTrainer
from test_torch_fb_ddpg import (ACT, N, OBS, SMALL, _agents, _batch, _close, _close_params,
                                jax_update_noise)
import torch_dp_agents as dp_agents

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
SPAWN_TIMEOUT = 240  # seconds for the two processes together
CASES = {
    "default": dict(adam_mu_dtype="float32"),
    "mix_rand_weight": dict(adam_mu_dtype="float32", rand_weight=True, future_ratio=0.5),
    "q_loss": dict(adam_mu_dtype="float32", q_loss=True),
}
OFFLINE = dict(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8, batch_size=16,
               adam_mu_dtype="float32")
OFFLINE_LR = FBDDPGConfig().lr


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spawn(folder: Path, world: int = 2) -> list:
    """Run the worker in ``world`` gloo processes on ``folder``'s jobs; their
    outputs by rank. The processes are killed if they outlast the timeout."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    init = f"file://{folder}/rendezvous"
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(rank), str(world), init,
                               str(folder)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {world} processes did not finish in {SPAWN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-4000:]}"
    return [torch.load(folder / f"out_{rank}.pt", weights_only=False) for rank in range(world)]


def _episodes():
    return synthetic_episodes(6, 30, OBS, ACT, seed=3)


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """One spawn of two processes for every world-size-2 job; the JAX side
    and the single-process port side of each update case."""
    folder = tmp_path_factory.mktemp("dp2")
    jbatch, tbatch = _batch()
    cases, refs = {}, {}
    for name, overrides in CASES.items():
        jcfg, jagent, state, tagent = _agents(**overrides)
        key = jax.random.key(11)
        noise = jax_update_noise(jcfg, key)
        cases[name] = {"cfg": {**SMALL, **overrides}, "obs_dim": OBS, "action_dim": ACT,
                       "state": {k: v.clone() for k, v in tagent.train_state().items()},
                       "batch": {k: getattr(tbatch, k) for k in
                                 ("obs", "action", "reward", "next_obs", "discount",
                                  "future_obs")},
                       "noise": {k: v for k, v in vars(noise).items()}}
        mesh = make_mesh(2)
        with mesh:
            new_state, metrics_j = jax_make_dp_trainer(jagent, mesh)(
                state, jax_shard_batch(jbatch, mesh), key)
        metrics_t = tagent._update(tbatch, noise)
        refs[name] = dict(jcfg=jcfg, jax_state=new_state, jax_metrics=metrics_j,
                          single=tagent, single_metrics=metrics_t)
    torch.save(cases, folder / "updates.pt")
    job = {"cfg": OFFLINE, "obs_dim": OBS, "action_dim": ACT, "seed": 0,
           "episodes": _episodes(), "steps": 3}
    torch.save(job, folder / "offline.pt")
    torch.save({**job, "steps": 2, "trainer_seed": 5}, folder / "multihost.pt")
    return _spawn(folder), refs, job


def _close_states(got: dict, want: dict, lr: float, what: str) -> None:
    """Parameters after Adam from two orders of float32 sums: within 2 lr,
    at most one entry per tensor (or 1e-3 of it) past 1e-3 lr; Adam's
    moments at the parity tests' tolerances (mu rtol 1e-4, nu rtol 1e-3);
    the counters equal."""
    for name, w in want.items():
        g = got[name]
        if g.dtype in (torch.int64, torch.int32) or name.endswith("count"):
            assert torch.equal(g, w), f"{what}.{name}"
            continue
        diff = (g.float() - w.float()).abs()
        if ".mu." in name or ".nu." in name:
            mu = ".mu." in name
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=1e-4 if mu else 1e-3, atol=1e-6 if mu else 1e-12,
                                       err_msg=f"{what}.{name}")
            continue
        assert float(diff.max()) <= 2 * lr + 1e-6, f"{what}.{name}"
        flipped = int((diff > 1e-3 * lr).sum())
        assert flipped <= max(1, 1e-3 * diff.numel()), f"{what}.{name}: {flipped}"


@pytest.mark.parametrize("case", list(CASES))
def test_dp_update_at_two_processes(two_processes, case) -> None:
    """The world-size-2 update equals the single-process update on the whole
    batch and JAX's ``make_dp_trainer`` on a 2-device mesh, from the same
    weights, batch and noise; both processes hold the same parameters."""
    outs, refs, _ = two_processes
    ref = refs[case]
    got = [out["updates"][case] for out in outs]
    for name in got[0]["state"]:
        assert torch.equal(got[0]["state"][name], got[1]["state"][name]), name
    metrics = got[0]["metrics"]
    assert set(metrics) == set(ref["jax_metrics"]) == set(ref["single_metrics"])
    for k in metrics:
        _close(metrics[k], ref["jax_metrics"][k], atol=1e-5, msg=f"{k} vs JAX")
        _close(metrics[k], ref["single_metrics"][k].numpy(), atol=1e-5, msg=f"{k} vs port")
    lr = ref["jcfg"].lr
    agent = FBDDPGAgent(FBDDPGConfig(**SMALL, **CASES[case]), OBS, ACT, device="cpu")
    agent.load_train_state(got[0]["state"])
    for module, tree, what in (
            (agent.actor, ref["jax_state"].actor_params, "actor"),
            (agent.forward_net, ref["jax_state"].forward_params, "forward"),
            (agent.backward_net, ref["jax_state"].backward_params, "backward"),
            (agent.target_forward_net, ref["jax_state"].target_forward_params,
             "target_forward"),
            (agent.target_backward_net, ref["jax_state"].target_backward_params,
             "target_backward")):
        _close_params(module, tree, lr, what)
    _close_states(got[0]["state"], dict(ref["single"].train_state()), lr, "vs port")
    assert agent.step == 1


def test_dp_offline_trainer_at_two_processes(two_processes) -> None:
    """``make_dp_offline_trainer``: each process draws the global batch,
    keeps its rows and updates; three updates equal the single-process
    trainer's from the same generator."""
    outs, _, job = two_processes
    got = [out["offline"] for out in outs]
    for name in got[0]["state"]:
        assert torch.equal(got[0]["state"][name], got[1]["state"][name]), name
    agent = FBDDPGAgent(FBDDPGConfig(**OFFLINE), OBS, ACT, device="cpu", seed=0)
    buffer = ReplayBuffer(max_episodes=6, discount=0.98, future=0.99, device="cpu")
    buffer.load_episodes(job["episodes"])
    metrics = OfflineTrainer(agent, buffer.cfg, 16, 3)(buffer.state,
                                                      torch.Generator().manual_seed(0))
    for k, v in metrics.items():
        _close(got[0]["metrics"][k], v.numpy(), atol=1e-5, msg=k)
    _close_states(got[0]["state"], dict(agent.train_state()), OFFLINE_LR, "offline")


def test_multihost_trainer_at_two_processes(two_processes) -> None:
    """``MultiHostTrainer``: each process samples its half of every batch
    from its own shard of the episodes (a generator seeded by rank) and the
    noise of the global batch from a generator seeded alike. Two updates
    equal the single-process update on the two halves put together."""
    outs, _, job = two_processes
    job = {**job, "trainer_seed": 5, "steps": 2}
    got = [out["multihost"] for out in outs]
    for name in got[0]["state"]:
        assert torch.equal(got[0]["state"][name], got[1]["state"][name]), name
    agent = FBDDPGAgent(FBDDPGConfig(**OFFLINE), OBS, ACT, device="cpu", seed=0)
    shards = []
    for rank in range(2):
        part = job["episodes"][rank::2]
        buffer = ReplayBuffer(max_episodes=len(part), discount=0.98, future=0.99, device="cpu")
        buffer.load_episodes(part)
        shards.append((buffer, torch.Generator().manual_seed(
            job["trainer_seed"] + multihost.SAMPLE_SEED_STRIDE * (rank + 1))))
    update_generator = torch.Generator().manual_seed(job["trainer_seed"])
    sums: dict = {}
    for _ in range(job["steps"]):
        halves = [replay_lib.sample(b.state, g, 8, b.cfg) for b, g in shards]
        batch = type(halves[0])(**{
            k: (torch.cat([getattr(h, k) for h in halves]) if torch.is_tensor(getattr(
                halves[0], k)) else getattr(halves[0], k))
            for k in ("obs", "action", "reward", "next_obs", "discount", "meta", "goal",
                      "next_goal", "future_obs", "future_goal", "physics")})
        for k, v in agent.update(batch, update_generator).items():
            sums[k] = sums.get(k, 0.0) + v
    for k, v in sums.items():
        _close(got[0]["metrics"][k], (v / job["steps"]).numpy(), atol=1e-5, msg=k)
    _close_states(got[0]["state"], dict(agent.train_state()), OFFLINE_LR, "multihost")


@pytest.fixture
def one_process_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        yield make_group()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_dp_update_at_one_process_is_the_plain_update(one_process_group, case) -> None:
    """At world size 1 gather and the sums are identities: the data-parallel
    update (through gloo) equals the single-process update to the bit."""
    _, _, _, plain = _agents(**CASES[case])
    _, _, _, dp = _agents(**CASES[case])
    _, tbatch = _batch()
    noise = jax_update_noise(plain.cfg, jax.random.key(3))
    want = plain._update(tbatch, noise)
    got = make_dp_trainer(dp, one_process_group)(tbatch, noise)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for name, value in plain.train_state().items():
        assert torch.equal(dp.train_state()[name], value), name


def test_dp_offline_trainer_at_one_process_is_the_plain_trainer(one_process_group) -> None:
    buffers = []
    for _ in range(2):
        buffer = ReplayBuffer(max_episodes=6, discount=0.98, future=0.99, device="cpu")
        buffer.load_episodes(_episodes())
        buffers.append(buffer)
    plain = FBDDPGAgent(FBDDPGConfig(**OFFLINE), OBS, ACT, device="cpu", seed=0)
    dp = FBDDPGAgent(FBDDPGConfig(**OFFLINE), OBS, ACT, device="cpu", seed=0)
    want = OfflineTrainer(plain, buffers[0].cfg, 16, 3)(buffers[0].state,
                                                       torch.Generator().manual_seed(2))
    got = make_dp_offline_trainer(dp, buffers[1].cfg, 16, 3, one_process_group)(
        buffers[1].state, torch.Generator().manual_seed(2))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for name, value in plain.train_state().items():
        assert torch.equal(dp.train_state()[name], value), name


@pytest.mark.parametrize("name", sorted(AGENTS))
def test_every_agent_has_a_data_parallel_update(one_process_group, name) -> None:
    """``make_dp_trainer`` and ``MultiHostTrainer`` take every agent of
    ``AGENTS``, and one data-parallel update at one process runs, with
    finite metrics."""
    case = dp_agents.CASES[dp_agents.AGENT_CASES[name]]
    agent = dp_agents.port_agent(case)
    buffer = ReplayBuffer(max_episodes=6, discount=0.98, future=0.99, device="cpu")
    buffer.load_episodes(_episodes())
    assert multihost.MultiHostTrainer(agent, buffer, N, 1).shard.world == 1
    metrics = make_dp_trainer(agent, one_process_group)(
        dp_agents.torch_batch(dp_agents.batch_arrays(case)), torch.Generator().manual_seed(0))
    assert metrics and all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert agent.step == 1


def test_initialize_is_a_no_op_for_one_process() -> None:
    assert multihost.initialize(None, 1, 0, device="cpu") is False
    assert not dist.is_initialized()
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.host_local_batch_size(1024) == 1024
    state = {"w": torch.ones(2)}
    assert multihost.host_local_state(state) is state
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(None, 2, 0, device="cpu")


def test_dryrun_multichip_at_two_processes() -> None:
    """The analogue of ``__graft_entry__.dryrun_multichip`` at N = 2 on gloo:
    a data-parallel update and an online cycle with the group."""
    lines = dryrun_multichip.run(2, device="cpu", timeout=SPAWN_TIMEOUT)
    assert len(lines) == 2 and all(line.endswith("ok") for line in lines)
    assert lines[0].split(":")[1] == lines[1].split(":")[1]  # the same metrics


def test_dryrun_multichip_with_rnd_at_two_processes() -> None:
    """``agent=rnd``: RND's data-parallel update and an online cycle with the
    group, the same parameters on both processes."""
    lines = dryrun_multichip.run(2, device="cpu", timeout=SPAWN_TIMEOUT, agent="rnd")
    assert len(lines) == 2 and all(line.endswith("ok") for line in lines)
    assert all(": rnd " in line for line in lines)
    assert lines[0].split(":")[1] == lines[1].split(":")[1]
