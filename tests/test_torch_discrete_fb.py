"""The port's discrete FB agent against the JAX package's: the discrete
forward map, one whole update (z, the loss and its gradients, metrics,
every network after Adam, Adam's moments, the step) over the loss's
variants, acting (greedy and ε-greedy with JAX's draws), the goal z and z
inference, a second update from a converted Adam state, and the config.

Same weights (``convert.py``) and the same noise: the JAX update's own
draws, replayed from its ``jax.random.split`` chain (``discrete_fb.py:270``
and ``:174``), as ``test_torch_fb_ddpg.py`` does. Tolerances: losses,
metrics and outputs rtol 2e-4 (float32 products of width <= 32 summed in
another order; atol 1e-5 for entries near 0); gradients rtol 1e-3;
parameters after Adam within 2*lr with at most one entry per tensor or
1e-3 of it beyond 1e-3*lr (Adam's first step is ~lr*sign(g), which flips
where a gradient is ~0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents.discrete_fb import DiscreteFBAgent as JaxAgent
from controllable_agent_tpu.agents.discrete_fb import DiscreteFBConfig as JaxConfig
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_tpu.models.networks import DiscreteForwardMap as JaxForwardMap
from controllable_agent_torch.agents import DiscreteFBAgent, DiscreteFBConfig, UpdateNoise
from controllable_agent_torch.agents.base import StepNoise
from controllable_agent_torch.agents.fb_ddpg import build_train_z
from controllable_agent_torch.convert import flax_to_state_dict, load_discrete_fb_train_state
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.models.networks import DiscreteForwardMap
from torch_threads import one_thread  # noqa: F401

N, OBS, GOAL, ACTIONS = 16, 4, 3, 5
SMALL = dict(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8, batch_size=N)
RTOL, ATOL, GRAD_RTOL = 2e-4, 1e-5, 1e-3
STEP_SHARE = 1e-3


def _batch(seed: int = 0, goal_space: bool = False):
    rng = np.random.RandomState(seed)
    arrays = dict(
        obs=rng.randn(N, OBS), action=rng.randint(0, ACTIONS, (N, 1)),
        reward=rng.rand(N, 1), next_obs=rng.randn(N, OBS),
        discount=np.full((N, 1), 0.98), future_obs=rng.randn(N, OBS))
    if goal_space:
        arrays.update(goal=rng.randn(N, GOAL), next_goal=rng.randn(N, GOAL),
                      future_goal=rng.randn(N, GOAL))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def jax_update_noise(cfg: JaxConfig, key: jax.Array) -> UpdateNoise:
    """The draws of the JAX ``_update(state, batch, key)``, in its order."""
    k_z, _ = jax.random.split(key)
    kz, k_perm, k_mix, k_w, k_u, k_fut = jax.random.split(k_z, 6)
    k1, k2 = jax.random.split(kz)
    d = cfg.z_dim
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    rand_weight = cfg.rand_weight and cfg.mix_ratio > 0
    return UpdateNoise(
        z_normal=t(jax.random.normal(k1, (N, d))),
        perm=t(jax.random.permutation(k_perm, N)).long(),
        mix_uniform=t(jax.random.uniform(k_mix, (N, 1))),
        z_uniform=None if cfg.norm_z else t(jax.random.uniform(k2, (N, d))),
        w_uniform=t(jax.random.uniform(k_w, (N, N))) if rand_weight else None,
        w_scale=t(jax.random.uniform(k_u, (N, 1))) if rand_weight else None,
        future_uniform=(t(jax.random.uniform(k_fut, (N, 1)))
                        if cfg.future_ratio > 0 else None))


def _agents(**overrides):
    goal_dim = GOAL if overrides.get("goal_space") else None
    jcfg = JaxConfig(**SMALL, **overrides)
    jagent = JaxAgent(jcfg, obs_dim=OBS, n_actions=ACTIONS, goal_dim=goal_dim)
    state = jagent.init(jax.random.key(0))
    tagent = DiscreteFBAgent(DiscreteFBConfig(**SMALL, **overrides), OBS, ACTIONS,
                             goal_dim=goal_dim, device="cpu")
    load_discrete_fb_train_state(tagent, jax.tree.map(np.asarray, state))
    return jcfg, jagent, state, tagent


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


@pytest.mark.parametrize("preprocess,add_trunk", [(False, False), (True, False), (True, True)])
def test_discrete_forward_map_matches_jax(preprocess, add_trunk) -> None:
    """Twin heads of z_dim * n_actions reshaped to [B, z_dim, n_actions]."""
    net = JaxForwardMap(z_dim=8, n_actions=ACTIONS, feature_dim=16, hidden_dim=32,
                        preprocess=preprocess, add_trunk=add_trunk)
    rng = np.random.RandomState(1)
    obs, z = rng.randn(N, OBS).astype(np.float32), rng.randn(N, 8).astype(np.float32)
    params = net.init(jax.random.key(2), jnp.asarray(obs), jnp.asarray(z))
    ours = DiscreteForwardMap(OBS, 8, ACTIONS, 16, 32, preprocess=preprocess,
                              add_trunk=add_trunk)
    ours.load_state_dict(flax_to_state_dict(params))
    got = ours(torch.from_numpy(obs), torch.from_numpy(z))
    want = net.apply(params, jnp.asarray(obs), jnp.asarray(z))
    for g, w in zip(got, want):
        assert g.shape == (N, 8, ACTIONS)
        _close(g, w)


CASES = {
    "default_boltzmann": dict(),
    "argmax_target": dict(boltzmann=False),
    "q_loss": dict(q_loss=True),
    "argmax_q_loss_no_mix": dict(boltzmann=False, q_loss=True, mix_ratio=0.0),
    "rand_weight_future": dict(rand_weight=True, future_ratio=0.5),
    "goal_space_no_norm_z": dict(goal_space="grid_simple", norm_z=False, future_ratio=0.3),
    "preprocess_trunk": dict(preprocess=True, add_trunk=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_update_parity(case) -> None:
    jcfg, jagent, state, tagent = _agents(**CASES[case])
    goal_space = jcfg.goal_space is not None
    jbatch, tbatch = _batch(goal_space=goal_space)
    key = jax.random.key(1)
    noise = jax_update_noise(jcfg, key)

    k_z, _ = jax.random.split(key)
    z_j = jagent._build_train_z(state, jbatch, k_z)
    z_t = build_train_z(tagent.cfg, tagent.backward_net, tbatch, noise)
    _close(z_t, z_j, msg="z")

    next_goal_j = jbatch.next_goal if goal_space else jbatch.next_obs
    next_goal_t = tbatch.next_goal if goal_space else tbatch.next_obs
    (loss_j, aux_j), (fw_g, bw_g) = jax.value_and_grad(
        jagent._fb_loss, argnums=(0, 1), has_aux=True)(
        state.forward_params, state.backward_params, state, jbatch, z_j, next_goal_j)
    loss_t, aux_t = tagent._fb_loss(tbatch, z_t, next_goal_t)
    _close(loss_t, loss_j, msg="fb_loss")
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        _close(aux_t[k], aux_j[k], msg=k)
    fw = dict(tagent.forward_net.named_parameters())
    bw = dict(tagent.backward_net.named_parameters())
    grads = torch.autograd.grad(loss_t, list(fw.values()) + list(bw.values()))
    got = dict(zip(list(fw) + [f"b.{k}" for k in bw], grads))
    want = {**flax_to_state_dict(fw_g),
            **{f"b.{k}": v for k, v in flax_to_state_dict(bw_g).items()}}
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], rtol=GRAD_RTOL, atol=1e-6, msg=f"grad {name}")

    new_state, metrics_j = jax.jit(jagent._update)(state, jbatch, key)
    metrics_t = tagent._update(tbatch, noise)
    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        _close(metrics_t[k], metrics_j[k], msg=k)
    for module, tree, what in (
            (tagent.forward_net, new_state.forward_params, "forward"),
            (tagent.backward_net, new_state.backward_params, "backward"),
            (tagent.target_forward_net, new_state.target_forward_params, "target_forward"),
            (tagent.target_backward_net, new_state.target_backward_params, "target_backward")):
        _close_params(module, tree, jcfg.lr, what)
    assert tagent.step == int(new_state.step) == 1
    for opt, opt_state in ((tagent.fw_opt, new_state.fw_opt_state),
                           (tagent.bw_opt, new_state.bw_opt_state)):
        adam = opt_state[0]
        assert opt.count == int(adam.count) == 1
        for name, nu in flax_to_state_dict(adam.nu).items():
            _close(opt.nu[name], nu, rtol=2 * GRAD_RTOL, atol=1e-12, msg=f"nu {name}")
        for name, mu in flax_to_state_dict(adam.mu).items():
            _close(opt.mu[name], mu, rtol=GRAD_RTOL, atol=1e-7, msg=f"mu {name}")


def test_second_update_from_converted_adam_state() -> None:
    """A JAX state one update in, converted: its Adam moments and counts
    carry over, and the next update agrees (bias correction at count 2)."""
    jcfg, jagent, state, _ = _agents(q_loss=True)
    jbatch, tbatch = _batch(1)
    state, _ = jax.jit(jagent._update)(state, jbatch, jax.random.key(7))
    tagent = DiscreteFBAgent(DiscreteFBConfig(**SMALL, q_loss=True), OBS, ACTIONS,
                             device="cpu")
    load_discrete_fb_train_state(tagent, jax.tree.map(np.asarray, state))
    assert tagent.step == 1 and tagent.fw_opt.count == 1 and tagent.bw_opt.count == 1
    key = jax.random.key(2)
    new_state, metrics_j = jax.jit(jagent._update)(state, jbatch, key)
    metrics_t = tagent._update(tbatch, jax_update_noise(jcfg, key))
    for k in ("fb_loss", "q_loss", "orth_loss"):
        _close(metrics_t[k], metrics_j[k], msg=k)
    _close_params(tagent.forward_net, new_state.forward_params, jcfg.lr, "forward")
    _close_params(tagent.backward_net, new_state.backward_params, jcfg.lr, "backward")
    assert tagent.fw_opt.count == 2


@pytest.mark.parametrize("num_expl_steps", [0, 10])
def test_act_greedy_and_epsilon_greedy_with_jax_draws(num_expl_steps) -> None:
    """Greedy in eval mode is the first argmax of min(F1·z, F2·z); out of
    it the JAX draws' uniform < expl_eps (or step < num_expl_steps) takes
    the JAX draws' random action."""
    jcfg, jagent, state, tagent = _agents(num_expl_steps=num_expl_steps)
    rng = np.random.RandomState(3)
    n = 64
    obs = rng.randn(n, OBS).astype(np.float32)
    z = np.array(jagent.sample_z(jax.random.key(4), n))
    tobs, tz = torch.from_numpy(obs), torch.from_numpy(z)
    key = jax.random.key(5)
    greedy_j = jagent.act(state, jnp.asarray(obs), jnp.asarray(z), jnp.asarray(3), key,
                          eval_mode=True)
    greedy_t = tagent.act(tobs, tz, 3, eval_mode=True)
    assert greedy_t.dtype == torch.int64
    np.testing.assert_array_equal(greedy_t.numpy(), np.asarray(greedy_j))
    assert len(set(greedy_t.tolist())) > 1
    k_eps, k_rand = jax.random.split(key)
    noise = StepNoise(
        explore_uniform=torch.from_numpy(np.array(jax.random.uniform(k_eps, (n,)))),
        random_action=torch.from_numpy(np.array(
            jax.random.randint(k_rand, (n,), 0, ACTIONS))).long())
    for step in (3, torch.tensor(3), torch.tensor(30)):
        want = jagent.act(state, jnp.asarray(obs), jnp.asarray(z), jnp.asarray(int(step)), key)
        got = tagent.act(tobs, tz, step, noise=noise)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    explored = (noise.explore_uniform < jcfg.expl_eps).numpy()
    assert 0 < explored.sum() < n


def test_goal_meta_and_inference_match_jax() -> None:
    """z = B(goal) and z = rᵀB/N, sqrt(z_dim)-normalized."""
    _, jagent, state, tagent = _agents()
    rng = np.random.RandomState(6)
    goal = rng.randn(OBS).astype(np.float32)
    _close(tagent.get_goal_meta(torch.from_numpy(goal)),
           jagent.get_goal_meta(state, jnp.asarray(goal)))
    obs, reward = rng.randn(64, OBS).astype(np.float32), rng.rand(64, 1).astype(np.float32)
    z = tagent.infer_meta_from_obs_and_rewards(torch.from_numpy(obs), torch.from_numpy(reward))
    _close(z, jagent.infer_meta_from_obs_and_rewards(state, jnp.asarray(obs),
                                                     jnp.asarray(reward)))
    assert abs(float(z.norm()) - np.sqrt(SMALL["z_dim"])) < 1e-5


def test_config_fields_equal_jax() -> None:
    ours = [(f.name, f.default) for f in dataclasses.fields(DiscreteFBConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == theirs


def test_the_agent_needs_a_card_unless_asked_for_the_cpu(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiscreteFBAgent(DiscreteFBConfig(**SMALL), OBS, ACTIONS)
    agent = DiscreteFBAgent(DiscreteFBConfig(**SMALL), OBS, ACTIONS, device="cpu")
    assert agent.device.type == "cpu" and agent.step_t.device.type == "cpu"
