"""DDPG and RND of the port against the JAX agents: one update each, the
reward model's regression, the running statistics, n-step sampling, and a
JAX ``rnd`` checkpoint folder read by the port.

As in ``test_torch_fb_ddpg.py``, the port's agent loads the JAX train state
through ``convert.py`` and the update's noise is the JAX update's own draws,
replayed from its ``jax.random.split`` calls (``ddpg.py:305`` and
``exploration.py:150``). Tolerances are that file's: losses, metrics and
gradients at rtol 1e-4 / atol 1e-6 (float32 sums in another order);
parameters after Adam within 2*lr, with at most one entry per tensor or 1e-3
of it beyond 1e-3*lr (Adam's first step is ~lr*sign(g)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents.ddpg import DDPGAgent as JaxDDPG
from controllable_agent_tpu.agents.ddpg import DDPGConfig as JaxDDPGConfig
from controllable_agent_tpu.agents.exploration import RNDAgent as JaxRND
from controllable_agent_tpu.agents.exploration import RNDConfig as JaxRNDConfig
from controllable_agent_tpu.data import replay as jreplay
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_tpu.ops.pbe import RMSState as JaxRMS
from controllable_agent_tpu.ops.pbe import rms_update as jax_rms_update
from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch.agents import (DDPGAgent, DDPGConfig, DDPGNoise, RNDAgent,
                                             RNDConfig)
from controllable_agent_torch.convert import (flax_to_state_dict, load_ddpg_train_state,
                                              load_intrinsic_train_state)
from controllable_agent_torch.data import replay as treplay
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.ops.pbe import RMSState, rms_update
from controllable_agent_torch.pretrain import build_workspace
from torch_threads import one_thread  # noqa: F401

N, OBS, ACT = 16, 6, 3
SMALL = dict(hidden_dim=32, batch_size=N)
RTOL, ATOL = 1e-4, 1e-6
STEP_SHARE = 1e-3


def _batch(seed: int = 0):
    rng = np.random.RandomState(seed)
    arrays = dict(obs=rng.randn(N, OBS), action=rng.uniform(-1, 1, (N, ACT)),
                  reward=rng.rand(N, 1), next_obs=rng.randn(N, OBS),
                  discount=np.full((N, 1), 0.98))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def jax_ddpg_noise(key: jax.Array) -> DDPGNoise:
    """The draws of the JAX DDPG ``_update(state, batch, key)``: the target
    policy's noise from the first of its four keys, the actor's from the
    second."""
    k_critic, k_actor, _, _ = jax.random.split(key, 4)
    t = lambda k: torch.from_numpy(np.array(jax.random.normal(k, (N, ACT))))  # noqa: E731
    return DDPGNoise(critic_normal=t(k_critic), actor_normal=t(k_actor))


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL, msg="") -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def _close_params(module: torch.nn.Module, flax_params, lr: float, what: str) -> None:
    want = flax_to_state_dict(flax_params)
    got = module.state_dict()
    assert set(got) == set(want), what
    for name in want:
        diff = (got[name].float() - want[name]).abs()
        assert float(diff.max()) <= 2 * lr + 1e-6, f"{what}.{name}"
        flipped = int((diff > 1e-3 * lr).sum())
        assert flipped <= max(1, STEP_SHARE * diff.numel()), f"{what}.{name}: {flipped}"


def _close_ddpg_state(agent: DDPGAgent, state, lr: float) -> None:
    for module, tree, what in ((agent.actor, state.actor_params, "actor"),
                               (agent.critic, state.critic_params, "critic"),
                               (agent.target_critic, state.target_critic_params, "target")):
        _close_params(module, tree, lr, what)
    adam = state.critic_opt_state[0]
    assert agent.step == int(state.step) and agent.critic_opt.count == int(adam.count)
    for name, nu in flax_to_state_dict(adam.nu).items():
        _close(agent.critic_opt.nu[name], nu, rtol=1e-3, atol=1e-12, msg=f"nu {name}")
    for name, mu in flax_to_state_dict(adam.mu).items():
        _close(agent.critic_opt.mu[name], mu, atol=1e-6, msg=f"mu {name}")


@pytest.mark.parametrize("reward_free", [False, True], ids=["batch_reward", "reward_model"])
def test_ddpg_update_matches_jax(reward_free) -> None:
    """Metrics, parameters, target critic, Adam moments and the step after
    one update; with ``reward_free`` the reward model's prediction at the
    next observation takes the batch reward's place."""
    jcfg = JaxDDPGConfig(**SMALL, reward_free=reward_free)
    jagent = JaxDDPG(jcfg, OBS, ACT)
    state = jagent.init(jax.random.key(0))
    agent = DDPGAgent(DDPGConfig(**SMALL, reward_free=reward_free), OBS, ACT, device="cpu")
    load_ddpg_train_state(agent, jax.tree.map(np.asarray, state))
    jbatch, tbatch = _batch()
    key = jax.random.key(1)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    got = agent._update(tbatch, jax_ddpg_noise(key))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], atol=1e-5, msg=k)
    if reward_free:
        assert abs(float(got["batch_reward"]) - float(tbatch.reward.mean())) > 1e-3
    _close_ddpg_state(agent, new_state, jcfg.lr)


def test_ddpg_reward_regression_matches_jax() -> None:
    """``train_reward``: two Adam steps of reward_model(obs) toward the
    rewards, against the JAX regression (lr 1e-3)."""
    jagent = JaxDDPG(JaxDDPGConfig(**SMALL, reward_free=True), OBS, ACT)
    state = jagent.init(jax.random.key(2))
    agent = DDPGAgent(DDPGConfig(**SMALL, reward_free=True), OBS, ACT, device="cpu")
    load_ddpg_train_state(agent, jax.tree.map(np.asarray, state))
    jbatch, tbatch = _batch(3)
    new_state = jagent.train_reward(state, jbatch.obs, jbatch.reward, num_iters=2)
    agent.train_reward(tbatch.obs, tbatch.reward, num_iters=2)
    assert agent.reward_opt is not None and agent.reward_opt.count == 2
    _close_params(agent.reward_model.mlps[0], new_state.reward_params, 2 * 1e-3, "reward")


def _rnd_pair(**overrides):
    jcfg = JaxRNDConfig(**SMALL, rnd_rep_dim=8, **overrides)
    jagent = JaxRND(jcfg, OBS, ACT)
    state = jagent.init(jax.random.key(0))
    agent = RNDAgent(RNDConfig(**SMALL, rnd_rep_dim=8, **overrides), OBS, ACT, device="cpu")
    load_intrinsic_train_state(agent, jax.tree.map(np.asarray, state))
    return jcfg, jagent, state, agent


def test_rnd_update_matches_jax() -> None:
    """One RND update: the predictor's loss and Adam step (the frozen target
    gets a zero gradient and stays), the intrinsic reward and the running
    statistics it advances, then the DDPG update on that reward."""
    jcfg, jagent, state, agent = _rnd_pair()
    jbatch, tbatch = _batch(4)
    key = jax.random.key(5)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    got = agent._update(tbatch, jax_ddpg_noise(jax.random.split(key, 3)[2]))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], atol=1e-5, msg=k)
    _close_params(agent.module, new_state.module_params, jcfg.lr, "module")
    target = {k: v for k, v in agent.module.state_dict().items() if k.startswith("mlps.1.")}
    before = flax_to_state_dict(state.module_params)
    assert all(torch.equal(v, before[k]) for k, v in target.items())  # frozen
    for name in ("mean", "var", "n"):
        _close(getattr(agent, f"rms_{name}"), getattr(new_state.rms, name), msg=name)
    _close_ddpg_state(agent.ddpg, new_state.ddpg, jcfg.lr)


def test_intrinsic_agents_train_the_critic_on_their_reward() -> None:
    """The round-4 fault: the intrinsic agents' DDPG takes their reward as
    it is (use_reward_model=False) rather than a reward model's prediction.
    The critic's batch reward is the intrinsic one, on both sides, and the
    port's DDPG holds no reward model."""
    _, jagent, state, agent = _rnd_pair()
    jbatch, tbatch = _batch(6)
    key = jax.random.key(7)
    _, want = jax.jit(jagent._update)(state, jbatch, key)
    got = agent._update(tbatch, jax_ddpg_noise(jax.random.split(key, 3)[2]))
    assert agent.ddpg.reward_model is None
    for metrics in (got, want):
        assert float(metrics["batch_reward"]) == pytest.approx(float(metrics["intr_reward"]))
        assert abs(float(metrics["batch_reward"]) - float(tbatch.reward.mean())) > 1e-3


def test_rms_update_matches_jax() -> None:
    """Three folds of batches of different sizes into the running mean and
    variance (population variance, as jnp.var)."""
    rng = np.random.RandomState(8)
    jstate, tstate = JaxRMS.create(), RMSState.create()
    for n in (5, 16, 3):
        x = rng.randn(n, 1).astype(np.float32) * 3 + 1
        jstate, jmean, jstd = jax_rms_update(jstate, jnp.asarray(x))
        tstate, tmean, tstd = rms_update(tstate, torch.from_numpy(x))
        _close(tmean, jmean)
        _close(tstd, jstd)
    _close(tstate.n, jstate.n)


def _episodes(n: int = 3, steps: int = 12):
    rng = np.random.RandomState(9)
    return [{"observation": rng.randn(steps + 1, OBS).astype(np.float32),
             "action": rng.uniform(-1, 1, (steps + 1, ACT)).astype(np.float32),
             "reward": rng.rand(steps + 1, 1).astype(np.float32),
             "discount": (rng.rand(steps + 1, 1) > 0.2).astype(np.float32)}
            for _ in range(n)]


def test_nstep_sampling_matches_jax(monkeypatch) -> None:
    """``nstep=3`` returns and discounts on a fixed buffer (discounts of 0
    inside the window included), against the JAX sampler at the same
    indices: each side's index draw is replaced by the same fixed indices."""
    episodes = _episodes()
    jbuf = jreplay.ReplayBuffer(4, discount=0.9, future=0.99, max_episode_length=12)
    for ep in episodes:
        jbuf.add_episode(ep)
    tstate = treplay.init_replay_state(
        {k: (v.shape[1:], torch.float32) for k, v in episodes[0].items()}, 4, 12, "cpu")
    for ep in episodes:
        treplay.add_episode(tstate, {k: torch.from_numpy(v) for k, v in ep.items()}, 12)
    rng = np.random.RandomState(10)
    ep_idx = rng.randint(0, 3, 32)
    step_idx = rng.randint(1, 11, 32)  # the whole window of 3 fits: step + 2 <= 12
    monkeypatch.setattr(jreplay, "_sample_indices", lambda *a, **k: (
        jnp.asarray(ep_idx), jnp.asarray(step_idx), jnp.asarray(step_idx)))
    monkeypatch.setattr(treplay, "_sample_indices", lambda *a, **k: (
        torch.from_numpy(ep_idx), torch.from_numpy(step_idx), torch.from_numpy(step_idx)))
    jcfg = jreplay.SampleConfig(discount=0.9, future=0.99, nstep=3)
    tcfg = treplay.SampleConfig(discount=0.9, future=0.99, nstep=3)
    want = jreplay.sample(jbuf.state, jax.random.key(0), 32, jcfg)
    got = treplay.sample(tstate, torch.Generator(), 32, tcfg)
    for name in ("obs", "action", "reward", "discount", "next_obs"):
        _close(getattr(got, name), getattr(want, name), msg=name)
    assert float(got.discount.min()) == 0.0 < float(got.discount.max()) <= 0.9 ** 3 + 1e-6


def test_sampler_windows_fit_inside_episodes() -> None:
    """The port's own draw with nstep=3: start steps leave room for the
    window, so next_obs is never read past an episode's end."""
    buf = treplay.ReplayBuffer(4, discount=0.9, future=0.99, device="cpu")
    buf.load_episodes(_episodes())
    buf.cfg = dataclasses.replace(buf.cfg, nstep=3)
    _, steps, _ = treplay._sample_indices(buf.state, torch.Generator().manual_seed(0), 4096,
                                          0.99, nstep=3)
    assert int(steps.min()) == 1 and int(steps.max()) == 10


def test_a_jax_rnd_folder_loads_into_the_port(tmp_path) -> None:
    """``load_model=`` of a checkpoint folder that the JAX package wrote for
    ``agent=rnd``: the whole train state (DDPG, module, Adam, statistics)
    and the counters come across."""
    args = ["agent=rnd", "task=walker_walk", "episode_length=20", "use_console=false",
            "agent.hidden_dim=32", "agent.rnd_rep_dim=8", "agent.batch_size=16"]
    jws = jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    jws.agent_state = jws.agent_state.replace(rms=JaxRMS(
        mean=jnp.full((1,), 0.5), var=jnp.full((1,), 2.0), n=jnp.asarray(7.0)))
    jws.global_step = 40
    jws.save_checkpoint(tmp_path / "jax_ckpt")
    tws = build_workspace(args + ["device=cpu", f"load_model={tmp_path}/jax_ckpt",
                                  f"folder={tmp_path}/torch"])
    assert tws.global_step == 40
    state = jws.agent_state
    for module, tree in ((tws.agent.ddpg.actor, state.ddpg.actor_params),
                         (tws.agent.ddpg.target_critic, state.ddpg.target_critic_params),
                         (tws.agent.module, state.module_params)):
        want = flax_to_state_dict(tree)
        assert all(torch.equal(v, want[k]) for k, v in module.state_dict().items())
    assert float(tws.agent.rms_var) == 2.0 and float(tws.agent.rms_n) == 7.0
