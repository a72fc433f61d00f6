"""APS and NEWAPS of the port against the JAX agents.

As in ``tests/test_torch_explorers.py``: the port's agent loads the JAX
train state through ``convert.py``, and the update's noise is the JAX
update's own draws, re-derived from the key that its ``_update`` splits
(APS: ``aps.py:184`` into the target policy's and the actor's; NEWAPS:
``aps.py:397`` into z's, the target policy's, the actor's and the future
mask's). Tolerances are that file's: metrics at rtol 1e-4 / atol 1e-5,
parameters after Adam within 2*lr, the critics' gradients (read back from
Adam's moments after one step) at rtol 1e-3 with an atol of 1e-4 of the
tensor's largest |g|, since both rewards carry ``pbe``'s float32 noise.
The least-squares task and z at rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents import aps as japs
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_torch.agents import (APSAgent, APSConfig, DDPGNoise, NEWAPSAgent,
                                             NEWAPSConfig, NEWAPSNoise)
from controllable_agent_torch.agents.base import StepNoise
from controllable_agent_torch.convert import flax_to_state_dict, load_train_state
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from test_torch_ddpg import _close_params

N, OBS, ACT, SF = 16, 6, 3, 5
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _unit_rows(rng: np.random.RandomState, n: int, d: int) -> np.ndarray:
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _batch(seed: int, meta: dict):
    rng = np.random.RandomState(seed)
    arrays = dict(obs=rng.randn(N, OBS), action=rng.uniform(-1, 1, (N, ACT)),
                  reward=rng.rand(N, 1), next_obs=rng.randn(N, OBS),
                  discount=np.full((N, 1), 0.98), future_obs=rng.randn(N, OBS))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()},
                     meta={k: jnp.asarray(v) for k, v in meta.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                         meta={k: torch.from_numpy(v) for k, v in meta.items()}))


def _close_grads(opt, adam_state, what: str) -> None:
    """The gradients of one Adam step, read back from the moments
    (g = mu / (1 - b1), |g| = sqrt(nu / (1 - b2)))."""
    adam = adam_state[0]
    assert opt.count == int(adam.count) == 1
    scale = 1.0 / (1.0 - opt.b2)
    for name, nu in flax_to_state_dict(adam.nu).items():
        want = (nu * scale).sqrt().numpy()
        np.testing.assert_allclose((opt.nu[name] * scale).sqrt().numpy(), want, rtol=1e-3,
                                   atol=1e-4 * float(want.max()), err_msg=f"{what} |g| {name}")
    for name, mu in flax_to_state_dict(adam.mu).items():
        want = mu.numpy() / (1.0 - opt.b1)
        np.testing.assert_allclose(opt.mu[name].numpy() / (1.0 - opt.b1), want, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"{what} g {name}")


def _close_metrics(got, want) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _close_rms(agent, rms) -> None:
    for k in ("mean", "var", "n"):
        np.testing.assert_allclose(getattr(agent, f"rms_{k}").numpy(),
                                   np.asarray(getattr(rms, k)), rtol=RTOL, err_msg=k)


def _aps_pair(**overrides):
    cfg = dict(hidden_dim=32, batch_size=N, sf_dim=SF, **overrides)
    jagent = japs.APSAgent(japs.APSConfig(**cfg), OBS, ACT)
    state = jagent.init(jax.random.key(0))
    agent = APSAgent(APSConfig(**cfg), OBS, ACT, device="cpu")
    load_train_state(agent, jax.tree.map(np.asarray, state))
    return jagent, state, agent


def _new_aps_pair(**overrides):
    cfg = dict(hidden_dim=32, backward_hidden_dim=16, feature_dim=16, z_dim=SF,
               batch_size=N, **overrides)
    jagent = japs.NEWAPSAgent(japs.NEWAPSConfig(**cfg), OBS, ACT)
    state = jagent.init(jax.random.key(0))
    agent = NEWAPSAgent(NEWAPSConfig(**cfg), OBS, ACT, device="cpu")
    load_train_state(agent, jax.tree.map(np.asarray, state))
    return jagent, state, agent


@pytest.mark.parametrize("reward_free", [True, False], ids=["intrinsic", "extrinsic"])
def test_aps_update_matches_jax(reward_free) -> None:
    """φ's MLE step, the reward pbe(φ(s')) + task·φ̂(s') from the updated φ
    (and the running statistics it advances), the task-projected twin
    critic's TD step and the actor's step on the updated critic."""
    jagent, state, agent = _aps_pair(reward_free=reward_free)
    task = _unit_rows(np.random.RandomState(1), N, SF)
    jbatch, tbatch = _batch(2, {"task": task})
    key = jax.random.key(3)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    k_c, k_a = jax.random.split(key)
    got = agent._update(tbatch, DDPGNoise(_t(jax.random.normal(k_c, (N, ACT))),
                                          _t(jax.random.normal(k_a, (N, ACT)))))
    _close_metrics(got, want)
    assert ("intr_reward" in got) == reward_free
    lr = agent.cfg.lr
    for module, tree, what in ((agent.actor, new_state.actor_params, "actor"),
                               (agent.critic, new_state.critic_params, "critic"),
                               (agent.target_critic, new_state.target_critic_params, "target"),
                               (agent.aps_net, new_state.aps_params, "aps")):
        _close_params(module, tree, lr, what)
    assert agent.step == int(new_state.step) == 1
    _close_grads(agent.critic_opt, new_state.critic_opt_state, "critic")
    _close_rms(agent, new_state.rms)


@pytest.mark.parametrize("case", ["meta_z", "drawn_z", "future"])
def test_new_aps_update_matches_jax(case) -> None:
    """NEWAPS: z from the batch's meta or drawn (``meta_z``, ``drawn_z``);
    with ``future_ratio=0.5`` half of it replaced by φ̂(future)·Cov(φ̂)⁺."""
    jagent, state, agent = _new_aps_pair(future_ratio=0.5 if case == "future" else 0.0)
    meta = {"z": _unit_rows(np.random.RandomState(1), N, SF)} if case != "drawn_z" else {}
    jbatch, tbatch = _batch(2, meta)
    key = jax.random.key(4)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    k_z, k_c, k_a, k_f = jax.random.split(key, 4)
    noise = NEWAPSNoise(_t(jax.random.normal(k_z, (N, SF))), _t(jax.random.normal(k_c, (N, ACT))),
                        _t(jax.random.normal(k_a, (N, ACT))),
                        _t(jax.random.uniform(k_f, (N, 1))) if case == "future" else None)
    got = agent._update(tbatch, noise)
    _close_metrics(got, want)
    lr = agent.cfg.lr
    for module, tree, what in (
            (agent.actor, new_state.actor_params, "actor"),
            (agent.successor_net, new_state.sf_params, "sf"),
            (agent.target_successor_net, new_state.target_sf_params, "target"),
            (agent.phi_net, new_state.phi_params, "phi")):
        _close_params(module, tree, lr, what)
    assert agent.step == int(new_state.step) == 1
    _close_grads(agent.sf_opt, new_state.sf_opt_state, "sf")
    _close_rms(agent, new_state.rms)


def test_the_least_squares_task_and_z_match_jax() -> None:
    """APS's ``regress_meta`` and NEWAPS's ``infer_meta_from_obs_and_rewards``
    on the same samples: lstsq(φ̂(s), r), unit-normalised."""
    rng = np.random.RandomState(5)
    obs = rng.randn(64, OBS).astype(np.float32)
    reward = rng.rand(64, 1).astype(np.float32)
    jagent, state, agent = _aps_pair()
    want = jagent.regress_meta(state, jnp.asarray(obs), jnp.asarray(reward))
    got = agent.regress_meta(torch.from_numpy(obs), torch.from_numpy(reward))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    jagent, state, agent = _new_aps_pair()
    want = jagent.infer_meta_from_obs_and_rewards(state, jnp.asarray(obs), jnp.asarray(reward))
    got = agent.infer_meta_from_obs_and_rewards(torch.from_numpy(obs), torch.from_numpy(reward))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got.norm()), 1.0, rtol=1e-6)


@pytest.mark.parametrize("t", [0, 3, 5, 100, 101])
def test_rollout_update_meta_matches_jax(t) -> None:
    """The collector's in-episode resampling fed the same normals: APS's
    task on the sphere at multiples of update_task_every_step (5), NEWAPS's
    unit z at multiples of update_z_every_step (100)."""
    key = jax.random.key(t)
    n = 4
    jagent, state, agent = _aps_pair()
    task = _unit_rows(np.random.RandomState(t), n, SF)
    want = jagent.rollout_update_meta(state, {"task": jnp.asarray(task)}, jnp.asarray(t),
                                      key)["task"]
    noise = StepNoise(z_normal=_t(jax.random.normal(key, (n, SF))))
    got = agent.rollout_update_meta({"task": torch.from_numpy(task)}, torch.tensor(t),
                                    noise)["task"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.array_equal(got.numpy(), task) == (t % 5 != 0)

    jagent, state, agent = _new_aps_pair()
    want = jagent.rollout_update_meta(state, {"z": jnp.asarray(task)}, jnp.asarray(t), key)["z"]
    k_p, k_z = jax.random.split(key)
    noise = StepNoise(meta_uniform=_t(jax.random.uniform(k_p, (n, 1))),
                      z_normal=_t(jax.random.normal(k_z, (n, SF))))
    got = agent.rollout_update_meta({"z": torch.from_numpy(task)}, torch.tensor(t), noise)["z"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.array_equal(got.numpy(), task) == (t % 100 != 0)


def test_the_collector_draws_what_each_meta_reads() -> None:
    """APS's step noise carries a normal [n, sf_dim] task draw, NEWAPS's the
    uniform and normal of a z resample; their metas have those widths."""
    _, _, aps = _aps_pair()
    gen = torch.Generator().manual_seed(0)
    noise = aps.step_noise(7, gen)
    assert noise.z_normal.shape == (7, SF) and noise.act_normal.shape == (7, ACT)
    assert aps.meta_dims == {"task": SF} and aps.init_meta(gen)["task"].shape == (SF,)
    _, _, new_aps = _new_aps_pair()
    noise = new_aps.step_noise(7, gen)
    assert noise.z_normal.shape == (7, SF) and noise.meta_uniform.shape == (7, 1)
    z = new_aps.init_meta(gen)["z"]
    assert new_aps.meta_dims == {"z": SF} and float(z.norm()) == pytest.approx(1.0, rel=1e-6)
