"""The online slice's loops on the CPU: the port's ``EpisodeCollector``
against the JAX ``make_episode_collector``, the collector's semantics, one
``OnlineTrainer`` cycle, and the sampler after commits on the device.

Collector parity: the port's agent carries the JAX agent's weights
(``convert.py``); the episodes start from the states of the JAX resets
(``reset_from_uniform`` fed the uniforms of the JAX reset keys); the
policy's noise and the z-resampling draws are the JAX collector's own,
replayed from its key chain (``loops.py:117-119``, ``base.py:89-95``) and
handed to the collector as one ``StepNoise`` per step. The walker starts
airborne with its joints near the middle of their range, so that no contact
or joint limit closes inside the episode on one side alone. Tolerance: rtol
1e-4 with an atol of 1e-5 of each column's largest entry (float32 sums in
another order, compounded over a few control steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents.ddpg import DDPGAgent as JaxDDPG
from controllable_agent_tpu.agents.ddpg import DDPGConfig as JaxDDPGConfig
from controllable_agent_tpu.agents.fb_ddpg import FBDDPGAgent as JaxFB
from controllable_agent_tpu.agents.fb_ddpg import FBDDPGConfig as JaxFBConfig
from controllable_agent_tpu.envs import locomotion as jloco
from controllable_agent_tpu.envs import pointmass as jpm
from controllable_agent_tpu.train.loops import make_episode_collector
from controllable_agent_torch.agents import DDPGAgent, DDPGConfig, FBDDPGAgent, FBDDPGConfig
from controllable_agent_torch.agents.base import StepNoise
from controllable_agent_torch.convert import load_train_state
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data import replay as replay_lib
from controllable_agent_torch.envs import locomotion as tloco
from controllable_agent_torch.envs import pointmass as tpm
from controllable_agent_torch.train.loops import (EpisodeCollector, OnlineTrainer,
                                                  init_meta_batched)
from torch_threads import one_thread  # noqa: F401

E = 3
FB_SMALL = dict(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8, batch_size=16)
RTOL, ATOL_OF_MAX = 1e-4, 1e-5
LIFT = 2.0  # metres added to the walker's root height: airborne for the episode


class _Airborne:
    """A JAX locomotion environment whose resets start ``LIFT`` higher with
    the joints at a fifth of their drawn angle."""

    def __init__(self, env) -> None:
        self.env, self.spec = env, env.spec

    def reset(self, key):
        state, ts = self.env.reset(key)
        state = state.replace(q=state.q.at[1].add(LIFT).at[3:].multiply(0.2))
        return state, ts.replace(observation=self.env._obs(state),
                                 physics=self.env._physics(state))

    def step(self, state, action):
        return self.env.step(state, action)


def _airborne(env, state, ts):
    """The port's counterpart of ``_Airborne.reset``."""
    q = state.q.clone()
    q[:, 1] += LIFT
    q[:, 3:] *= 0.2
    state = dataclasses.replace(state, q=q)
    return state, ts.replace(observation=env._obs(q, state.qd, state.touch),
                             physics=torch.cat([q, state.qd], -1))


def _envs(task: str, horizon: int):
    if task == "point_mass":
        return (jpm.PointMassMaze("reach_top_left", horizon),
                tpm.PointMassMaze("reach_top_left", horizon))
    return _Airborne(jloco.make(task, horizon)), tloco.make(task, horizon)


def _reset(task: str, tenv, keys):
    """The port's reset from the uniforms behind the JAX resets of ``keys``."""
    if task == "point_mass":  # x from the first half of the key, y from the second
        u = [[float(jax.random.uniform(k, ())) for k in jax.random.split(key)] for key in keys]
        return tenv.reset_from_uniform(torch.tensor(u, dtype=torch.float32))
    nj = tenv.spec.action_dim
    u = np.stack([np.asarray(jax.random.uniform(jax.random.split(k)[0], (nj,))) for k in keys])
    return _airborne(tenv, *tenv.reset_from_uniform(torch.from_numpy(u)))


def jax_collector_noise(key, horizon: int, action_dim: int, z_dim: int = 0):
    """The draws of the JAX collector's scan from its ``act_key``: per step
    ``key, k_act, k_meta = split(key, 3)``; ``act`` splits k_act into the
    normal's key and the exploration uniform's; ``rollout_update_meta``
    splits k_meta into the resampling uniform's key and ``sample_z``'s."""
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    out = []
    for _ in range(horizon):
        key, k_act, k_meta = jax.random.split(key, 3)
        k_sample, k_expl = jax.random.split(k_act)
        noise = StepNoise(act_normal=t(jax.random.normal(k_sample, (E, action_dim))),
                          act_uniform=t(jax.random.uniform(k_expl, (E, action_dim))))
        if z_dim:
            k_p, k_z = jax.random.split(k_meta)
            noise.meta_uniform = t(jax.random.uniform(k_p, (E, 1)))
            noise.z_normal = t(jax.random.normal(jax.random.split(k_z)[0], (E, z_dim)))
        out.append(noise)
    return out


def _agents(kind: str, obs_dim: int, action_dim: int, **overrides):
    if kind == "fb":
        jagent = JaxFB(JaxFBConfig(**FB_SMALL, **overrides), obs_dim, action_dim)
        tagent = FBDDPGAgent(FBDDPGConfig(**FB_SMALL, **overrides), obs_dim, action_dim,
                             device="cpu")
    else:
        jagent = JaxDDPG(JaxDDPGConfig(hidden_dim=32, **overrides), obs_dim, action_dim)
        tagent = DDPGAgent(DDPGConfig(hidden_dim=32, **overrides), obs_dim, action_dim,
                           device="cpu")
    state = jagent.init(jax.random.key(0))
    load_train_state(tagent, jax.tree.map(np.asarray, state))
    return jagent, state, tagent


def _close(got: torch.Tensor, want, msg: str) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, msg
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, err_msg=msg,
                               atol=ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-6))


CASES = {  # task, agent, horizon, global step, agent overrides
    "point_mass_fb": ("point_mass", "fb", 12, 0, dict(update_z_every_step=5)),
    "walker_fb": ("walker_walk", "fb", 6, 100, dict(update_z_every_step=4,
                                                     stddev_schedule="linear(1.0,0.1,200)")),
    "point_mass_ddpg_exploring": ("point_mass", "ddpg", 8, 3, dict(num_expl_steps=5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_collector_matches_jax(case) -> None:
    """The whole [T+1, E, .] trajectory, the meta columns and the goal."""
    task, kind, horizon, step, overrides = CASES[case]
    jenv, tenv = _envs(task, horizon)
    spec = tenv.spec
    jagent, state, tagent = _agents(kind, spec.obs_dim, spec.action_dim, **overrides)
    z_dim = tagent.cfg.z_dim if kind == "fb" else 0
    rng = np.random.RandomState(1)
    meta_np = {}
    if z_dim:
        z = rng.randn(E, z_dim)
        z *= np.sqrt(z_dim) / np.linalg.norm(z, axis=1, keepdims=True)
        meta_np["z"] = z.astype(np.float32)
    keys = jax.random.split(jax.random.key(2), E)
    act_key = jax.random.key(3)
    goal_fn = lambda p: p[..., :2]  # noqa: E731
    want = make_episode_collector(jenv, jagent, E, goal_fn=goal_fn)(
        state, {k: jnp.asarray(v) for k, v in meta_np.items()}, keys, jnp.asarray(step), act_key)
    collector = EpisodeCollector(tenv, tagent, E, torch.Generator(), goal_fn=goal_fn)
    got = collector({k: torch.from_numpy(v) for k, v in meta_np.items()},
                    *_reset(task, tenv, keys), step,
                    noise=jax_collector_noise(act_key, horizon, spec.action_dim, z_dim))
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], name)
    if kind == "ddpg":  # the first steps explore uniformly, the rest follow the policy
        assert step < tagent.cfg.num_expl_steps
    if z_dim:  # resampled at t = 0 and again inside the episode
        assert not torch.equal(got["z"][1], got["z"][-1])


def test_hold_meta_keeps_z_for_the_whole_episode() -> None:
    """With ``hold_meta`` the caller's z drives every step; without it the
    default FB rollout resamples at t = 0, so the given z does not survive."""
    env = tpm.PointMassMaze("reach_top_left", 10)
    agent = FBDDPGAgent(FBDDPGConfig(**FB_SMALL), 4, 2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    z = torch.arange(8, dtype=torch.float32).expand(3, 8)
    held = EpisodeCollector(env, agent, 3, gen, hold_meta=True)
    traj = held({"z": z}, *env.reset(gen, 3), 0)
    assert torch.equal(traj["z"], z.expand(11, 3, 8))
    free = EpisodeCollector(env, agent, 3, gen)
    traj = free({"z": z}, *env.reset(gen, 3), 0)
    assert not torch.equal(traj["z"][1:], z.expand(10, 3, 8))


def test_collector_layout() -> None:
    """[T+1, E, .] columns with the first dummy transition (zero action and
    reward, the reset's observation) and the initial meta at index 0; the
    batched init_meta draws one z per environment; a mismatch raises."""
    env = tpm.PointMassMaze("reach_top_left", 10)
    agent = FBDDPGAgent(FBDDPGConfig(**FB_SMALL), 4, 2, device="cpu")
    gen = torch.Generator().manual_seed(1)
    meta = init_meta_batched(agent, gen, 3)
    assert meta["z"].shape == (3, 8) and not torch.equal(meta["z"][0], meta["z"][1])
    collector = EpisodeCollector(env, agent, 3, gen, goal_fn=lambda p: p[..., :2])
    state, ts = env.reset(gen, 3)
    traj = collector(meta, state, ts, 0)
    shapes = {"observation": 4, "action": 2, "reward": 1, "discount": 1, "physics": 4,
              "z": 8, "goal": 2}
    assert {k: v.shape for k, v in traj.items()} == {k: (11, 3, d) for k, d in shapes.items()}
    assert float(traj["action"][0].abs().max()) == 0.0 and float(traj["reward"][0].abs().max()) == 0.0
    assert torch.equal(traj["observation"][0], ts.observation)
    assert torch.equal(traj["z"][0], meta["z"])
    assert float(traj["action"][1:].abs().max()) > 0.0
    with pytest.raises(ValueError, match="built for observations"):
        collector(meta, *env.reset(gen, 2), 0)
    with pytest.raises(ValueError, match="CUDA"):
        EpisodeCollector(env, agent, 3, gen, capture=True)


def test_online_trainer_cycle() -> None:
    """One cycle commits E episodes, advances the step by T*E and runs
    T*E*updates_per_step updates; the second commits E more."""
    env = tpm.PointMassMaze("reach_top_left", 10)
    agent = FBDDPGAgent(FBDDPGConfig(**FB_SMALL), 4, 2, device="cpu")
    buf = ReplayBuffer(8, discount=0.98, future=0.99, max_episode_length=10, device="cpu")
    trainer = OnlineTrainer(env, agent, buf, num_envs=2, updates_per_step=0.2,
                            max_steps_per_call=3)
    gen, collect_gen = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    metrics = trainer.run_cycle(gen, collect_gen)
    assert len(buf) == 2 and trainer.global_step == 20 and trainer.global_episode == 2
    assert agent.step == 4 and np.isfinite(metrics["fb_loss"])
    assert metrics["episode_reward"] == pytest.approx(
        float(buf.state.storage["reward"][:2, 1:].sum(1).mean()))
    assert torch.equal(buf.state.ep_lengths, torch.tensor([10, 10, 0, 0, 0, 0, 0, 0]))
    trainer.run_cycle(gen, collect_gen)
    assert len(buf) == 4 and agent.step == 8 and trainer.timings["updates"] == 4


def test_sampler_draws_by_length_after_commits() -> None:
    """Episodes of three lengths committed into a ring of eight slots, three
    of them left empty: episodes are drawn in proportion to their length
    (to 0.01 over 200,000 draws) and an empty slot never."""
    buf = ReplayBuffer(8, discount=0.98, future=0.99, max_episode_length=30, device="cpu")
    gen = torch.Generator().manual_seed(0)

    def traj(steps: int, num: int):
        return {"observation": torch.randn(steps + 1, num, 4, generator=gen),
                "reward": torch.rand(steps + 1, num, 1, generator=gen)}

    buf.add_trajectory(traj(30, 2), 30)
    buf.add_trajectory(traj(10, 2), 10)
    buf.add_episode({k: v[:, 0].numpy() for k, v in traj(5, 1).items()})
    lengths = buf.state.ep_lengths
    assert lengths.tolist() == [30, 30, 10, 10, 5, 0, 0, 0] and len(buf) == 5
    assert float(buf.state.storage["observation"][2, 11:].abs().max()) == 0.0  # zero-padded
    ep_idx, step_idx, _ = replay_lib._sample_indices(buf.state, gen, 200_000, 0.99)
    freq = torch.bincount(ep_idx, minlength=8).float() / 200_000
    np.testing.assert_allclose(freq.numpy(), (lengths / lengths.sum()).numpy(), atol=0.01)
    assert int(freq[5:].sum()) == 0
    assert bool((step_idx >= 1).all() & (step_idx <= lengths[ep_idx]).all())


def test_update_meta_resamples_on_its_period() -> None:
    """FB's host-side ``update_meta``: at a multiple of update_z_every_step,
    a new z drawn as ``sample_z`` draws it, taken with probability
    update_z_proba; between multiples the meta is returned as it is."""
    z = torch.zeros(8)
    agent = FBDDPGAgent(FBDDPGConfig(**FB_SMALL, update_z_every_step=10), 4, 2, device="cpu")
    meta = {"z": z}
    assert agent.update_meta(meta, 15, torch.Generator()) is meta
    new = agent.update_meta(meta, 20, torch.Generator().manual_seed(3))["z"]
    assert torch.equal(new, agent.sample_z(1, torch.Generator().manual_seed(3))[0])
    assert float(new.norm()) == pytest.approx(8 ** 0.5, rel=1e-5)
    never = FBDDPGAgent(FBDDPGConfig(**FB_SMALL, update_z_every_step=10, update_z_proba=0.0),
                        4, 2, device="cpu")
    assert torch.equal(never.update_meta(meta, 20, torch.Generator())["z"], z)
