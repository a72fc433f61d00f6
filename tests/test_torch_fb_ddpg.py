"""One full FBDDPG update of the port against the JAX agent.

Randomness is moved out of both sides: the port agent loads the JAX
``FBTrainState`` through ``convert.py``, and the update's noise is the JAX
update's own draws, replayed here from its ``jax.random.split`` calls
(``fb_ddpg.py:454`` and ``:283``) and handed to the port's ``_update``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from controllable_agent_tpu.agents.fb_ddpg import FBDDPGAgent as JaxAgent
from controllable_agent_tpu.agents.fb_ddpg import FBDDPGConfig as JaxConfig
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig, UpdateNoise
from controllable_agent_torch.convert import flax_to_state_dict, load_fb_train_state
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.data.exorl import synthetic_episodes
from controllable_agent_torch.optim import Adam
from controllable_agent_torch.utils.schedules import schedule
from torch_threads import one_thread  # noqa: F401

N, OBS, ACT = 16, 6, 3
SMALL = dict(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8,
             batch_size=N)
# Tolerances. Losses, metrics and gradients: float32 products of width <= 32
# summed in another order (rtol 1e-4; atol 1e-6 for entries near zero).
# Parameters after Adam: Adam's first step is ~lr*sign(g), so an entry whose
# gradient is within float32 noise of zero may move by up to 2*lr more on
# one side; atol = 2*lr covers that, and the entries outside 1e-3*lr are
# held separately to at most one per tensor or 1e-3 of it.
RTOL, ATOL = 1e-4, 1e-6
STEP_SHARE = 1e-3


def _batch(seed: int = 0):
    rng = np.random.RandomState(seed)
    arrays = dict(
        obs=rng.randn(N, OBS), action=rng.uniform(-1, 1, (N, ACT)),
        reward=rng.rand(N, 1), next_obs=rng.randn(N, OBS),
        discount=np.full((N, 1), 0.98), future_obs=rng.randn(N, OBS))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def jax_update_noise(cfg: JaxConfig, key: jax.Array) -> UpdateNoise:
    """The draws of the JAX ``_update(state, batch, key)``, in its order."""
    k_z, k_fb, k_actor = jax.random.split(key, 3)
    kz, k_perm, k_mix, k_w, k_u, k_fut = jax.random.split(k_z, 6)
    k1, k2 = jax.random.split(kz)
    d = cfg.z_dim
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    rand_weight = cfg.rand_weight and cfg.mix_ratio > 0
    return UpdateNoise(
        z_normal=t(jax.random.normal(k1, (N, d))),
        perm=t(jax.random.permutation(k_perm, N)).long(),
        mix_uniform=t(jax.random.uniform(k_mix, (N, 1))),
        next_action_normal=t(jax.random.normal(k_fb, (N, ACT))),
        actor_normal=t(jax.random.normal(k_actor, (N, ACT))),
        z_uniform=None if cfg.norm_z else t(jax.random.uniform(k2, (N, d))),
        w_uniform=t(jax.random.uniform(k_w, (N, N))) if rand_weight else None,
        w_scale=t(jax.random.uniform(k_u, (N, 1))) if rand_weight else None,
        future_uniform=(t(jax.random.uniform(k_fut, (N, 1)))
                        if cfg.future_ratio > 0 else None))


def _agents(**overrides):
    jcfg = JaxConfig(**SMALL, **overrides)
    jagent = JaxAgent(jcfg, obs_dim=OBS, action_dim=ACT)
    state = jagent.init(jax.random.key(0))
    tagent = FBDDPGAgent(FBDDPGConfig(**SMALL, **overrides), OBS, ACT, device="cpu")
    load_fb_train_state(tagent, jax.tree.map(np.asarray, state))
    return jcfg, jagent, state, tagent


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL, msg="") -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def _close_params(module: torch.nn.Module, flax_params, lr: float, what: str) -> None:
    want = flax_to_state_dict(flax_params)
    got = module.state_dict()
    assert set(got) == set(want), what
    for name in want:
        diff = (got[name].float() - want[name]).abs()
        assert float(diff.max()) <= 2 * lr + 1e-6, f"{what}.{name}"
        flipped = int((diff > 1e-3 * lr).sum())
        assert flipped <= max(1, STEP_SHARE * diff.numel()), f"{what}.{name}: {flipped}"


CASES = {
    "default_mu_f32": dict(adam_mu_dtype="float32"),
    "default_mu_bf16": dict(adam_mu_dtype="bfloat16"),
    "fused_loss": dict(adam_mu_dtype="float32", use_pallas_loss=True),
    "rand_weight_future": dict(rand_weight=True, future_ratio=0.5),
    "no_norm_z_q_loss": dict(norm_z=False, q_loss=True),
    "boltzmann": dict(boltzmann=True),
    "no_preprocess_trunk": dict(preprocess=False, add_trunk=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_update_parity(case) -> None:
    jcfg, jagent, state, tagent = _agents(**CASES[case])
    jbatch, tbatch = _batch()
    key = jax.random.key(1)
    noise = jax_update_noise(jcfg, key)

    # z construction
    k_z, k_fb, _ = jax.random.split(key, 3)
    z_j = jagent._build_train_z(state, jbatch, k_z)
    z_t = tagent._build_train_z(tbatch, noise)
    _close(z_t, z_j, msg="z")

    # FB loss and its gradients
    (loss_j, _), (fw_g, bw_g) = jax.value_and_grad(
        jagent._fb_loss, argnums=(0, 1), has_aux=True)(
        state.forward_params, state.backward_params, state, jbatch, z_j,
        jbatch.next_obs, k_fb)
    loss_t, _ = tagent._fb_loss(tbatch, z_t, tbatch.next_obs, noise.next_action_normal)
    _close(loss_t, loss_j, msg="fb_loss")
    params = dict(tagent.forward_net.named_parameters())
    bw_params = dict(tagent.backward_net.named_parameters())
    grads = torch.autograd.grad(loss_t, list(params.values()) + list(bw_params.values()))
    got = dict(zip(list(params) + [f"b.{k}" for k in bw_params], grads))
    want = {**flax_to_state_dict(fw_g),
            **{f"b.{k}": v for k, v in flax_to_state_dict(bw_g).items()}}
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], atol=1e-5, msg=f"grad {name}")

    # the whole update: metrics, parameters, targets, optimizer state
    new_state, metrics_j = jax.jit(jagent._update)(state, jbatch, key)
    metrics_t = tagent._update(tbatch, noise)
    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        _close(metrics_t[k], metrics_j[k], atol=1e-5, msg=k)
    lr = jcfg.lr
    for module, tree, what in (
            (tagent.actor, new_state.actor_params, "actor"),
            (tagent.forward_net, new_state.forward_params, "forward"),
            (tagent.backward_net, new_state.backward_params, "backward"),
            (tagent.target_forward_net, new_state.target_forward_params, "target_forward"),
            (tagent.target_backward_net, new_state.target_backward_params, "target_backward")):
        _close_params(module, tree, lr, what)
    assert tagent.step == int(new_state.step) == 1
    adam_j = new_state.fw_opt_state[0]
    assert tagent.fw_opt.count == int(adam_j.count) == 1
    mu_dtype = torch.bfloat16 if jcfg.adam_mu_dtype == "bfloat16" else torch.float32
    for name, nu in flax_to_state_dict(adam_j.nu).items():
        _close(tagent.fw_opt.nu[name], nu, rtol=1e-3, atol=1e-12, msg=f"nu {name}")
    for name, mu in flax_to_state_dict(adam_j.mu).items():
        assert tagent.fw_opt.mu[name].dtype == mu_dtype
        # mu = 0.1 * grad, so the gradients' tolerance scaled by 0.1; bf16
        # storage also rounds to 8 bits of mantissa (rtol 1e-2)
        _close(tagent.fw_opt.mu[name], mu, rtol=1e-2 if mu_dtype == torch.bfloat16 else RTOL,
               atol=1e-6, msg=f"mu {name}")


def test_second_update_uses_loaded_adam_state() -> None:
    """A state one update in: its Adam moments and step counter carry over,
    and the next update still agrees (bias correction at count 2)."""
    jcfg, jagent, state, _ = _agents(adam_mu_dtype="float32")
    jbatch, tbatch = _batch(1)
    state, _ = jax.jit(jagent._update)(state, jbatch, jax.random.key(7))
    tagent = FBDDPGAgent(FBDDPGConfig(**SMALL, adam_mu_dtype="float32"), OBS, ACT,
                         device="cpu")
    load_fb_train_state(tagent, jax.tree.map(np.asarray, state))
    assert tagent.step == 1 and tagent.actor_opt.count == 1
    key = jax.random.key(2)
    new_state, metrics_j = jax.jit(jagent._update)(state, jbatch, key)
    metrics_t = tagent._update(tbatch, jax_update_noise(jcfg, key))
    _close(metrics_t["fb_loss"], metrics_j["fb_loss"])
    _close_params(tagent.forward_net, new_state.forward_params, jcfg.lr, "forward")
    _close_params(tagent.actor, new_state.actor_params, jcfg.lr, "actor")


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adam_with_device_counters_against_optax(mu_dtype) -> None:
    """Five steps of the port's Adam (counts and moments in fixed tensors,
    foreach arithmetic) against ``optax.adam(lr, mu_dtype=...)`` on the same
    gradients. float32 moments: each step's move agrees to 1e-4 of lr. A
    bfloat16 first moment may round the other way where the float32 values
    differ in the last bit: 1/128 of a move of at most lr, per step."""
    rng = np.random.RandomState(0)
    lr, steps = 1e-2, 5
    module = torch.nn.Linear(7, 5)
    params = {"weight": rng.randn(5, 7).astype(np.float32),
              "bias": rng.randn(5).astype(np.float32)}
    module.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    opt = Adam(module, lr, torch.bfloat16 if mu_dtype == "bfloat16" else torch.float32)
    mu_before = {k: v.data_ptr() for k, v in opt.mu.items()}
    tx = optax.adam(lr, mu_dtype=jnp.dtype(mu_dtype))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tol = (steps * lr / 128 if mu_dtype == "bfloat16" else 1e-4 * lr)
    for step in range(1, steps + 1):
        grads = {k: (rng.randn(*v.shape) * 10.0 ** rng.randint(-3, 2)).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in opt.params])
        assert opt.count == int(jstate[0].count) == step
        for k, p in opt.params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=tol, err_msg=f"{k} at step {step}")
            np.testing.assert_allclose(opt.nu[k].numpy(), np.asarray(jstate[0].nu[k]),
                                       rtol=1e-6, atol=1e-12)
            # a bf16 moment: one rounding (2^-8) of the decayed moment, which
            # the new gradient may mostly cancel, so of the largest entry
            want_mu = np.asarray(jstate[0].mu[k].astype(jnp.float32))
            np.testing.assert_allclose(
                opt.mu[k].float().numpy(), want_mu, rtol=1e-6,
                atol=np.abs(want_mu).max() / 128 if mu_dtype == "bfloat16" else 1e-9)
    # the moments were updated in place: a captured step keeps its buffers
    assert {k: v.data_ptr() for k, v in opt.mu.items()} == mu_before
    assert sorted(opt.state()) == ["count", "mu.bias", "mu.weight", "nu.bias", "nu.weight"]


def test_stddev_schedule_follows_the_device_step() -> None:
    """``stddev_schedule=linear(...)``: the port reads the schedule at its
    device step counter, as the JAX update reads it at ``state.step``. Three
    updates in a row; before each the port loads the JAX state, so both take
    the step from the same place, and the metrics (which feel the stddev
    through both policy noises) agree at the update test's tolerance."""
    spec = "linear(1.0,0.1,2)"
    jcfg, jagent, state, tagent = _agents(stddev_schedule=spec, stddev_clip=5.0)
    jbatch, tbatch = _batch(2)
    update = jax.jit(jagent._update)
    seen = []
    for step in range(3):
        load_fb_train_state(tagent, jax.tree.map(np.asarray, state))
        assert tagent.step == step
        stddev = tagent._stddev(tagent.step_t)
        assert torch.is_tensor(stddev) and stddev.dtype == torch.float32
        seen.append(float(stddev))
        key = jax.random.key(10 + step)
        state, metrics_j = update(state, jbatch, key)
        metrics_t = tagent._update(tbatch, jax_update_noise(jcfg, key))
        for k in metrics_j:
            _close(metrics_t[k], metrics_j[k], atol=1e-5, msg=f"{k} at step {step}")
        assert tagent.step == int(state.step) == step + 1
    np.testing.assert_allclose(seen, [1.0, 0.55, 0.1], rtol=1e-6)
    # without the schedule the same noise gives another actor loss
    _, _, state0, plain = _agents(stddev_clip=5.0)
    key = jax.random.key(10)
    metrics_0 = plain._update(tbatch, jax_update_noise(jcfg, key))
    load_fb_train_state(tagent, jax.tree.map(np.asarray, state0))
    metrics_1 = tagent._update(tbatch, jax_update_noise(jcfg, key))
    assert float(metrics_0["actor_logprob"]) != float(metrics_1["actor_logprob"])
    assert schedule("0.2")(tagent.step_t) == 0.2  # a constant stays a host float


def test_inference_and_diagnostics() -> None:
    _, jagent, state, tagent = _agents()
    rng = np.random.RandomState(3)
    obs = rng.randn(40, OBS).astype(np.float32)
    reward = rng.rand(40, 1).astype(np.float32)
    z = rng.randn(SMALL["z_dim"]).astype(np.float32)
    t = torch.from_numpy
    _close(tagent.infer_meta_from_obs_and_rewards(t(obs), t(reward)),
           jagent.infer_meta_from_obs_and_rewards(state, jnp.asarray(obs), jnp.asarray(reward)))
    _close(tagent.get_goal_meta(t(obs[0])), jagent.get_goal_meta(state, jnp.asarray(obs[0])))
    _close(tagent.compute_z_correl(t(obs), t(z)),
           jagent.compute_z_correl(state, jnp.asarray(obs), jnp.asarray(z)))
    zb = np.broadcast_to(z, (40, z.size)).copy()
    _close(tagent.act(t(obs), t(zb), 0, eval_mode=True),
           jagent.act(state, jnp.asarray(obs), jnp.asarray(zb), 0, jax.random.key(0),
                      eval_mode=True))
    gen = torch.Generator().manual_seed(0)
    action = tagent.act(t(obs), t(zb), 0, gen)
    assert action.shape == (40, ACT) and bool((action.abs() < 1).all())
    success = float(tagent.compute_actor_success(t(obs), t(z), gen))
    assert 0.0 <= success <= 1.0
    assert tagent.init_meta(gen)["z"].shape == (SMALL["z_dim"],)
    torch.testing.assert_close(tagent.policy_act(t(obs), {"z": t(zb)}, 0, eval_mode=True),
                               tagent.act(t(obs), t(zb), 0, eval_mode=True))
    # infer_meta regresses z on the replay's stored rewards (num_inference_steps samples)
    buf = ReplayBuffer(2, discount=0.98, future=0.99, device="cpu")
    buf.load_episodes(synthetic_episodes(2, 20, OBS, ACT))
    z_inf = tagent.infer_meta(buf, gen)["z"]
    assert z_inf.shape == (SMALL["z_dim"],)
    np.testing.assert_allclose(float(z_inf.norm()), np.sqrt(SMALL["z_dim"]), rtol=1e-5)


def test_public_update_is_seeded() -> None:
    """``update`` draws its noise from the generator: same seed, same run."""
    _, tbatch = _batch()
    runs = []
    for _ in range(2):
        agent = FBDDPGAgent(FBDDPGConfig(**SMALL), OBS, ACT, device="cpu", seed=3)
        gen = torch.Generator().manual_seed(5)
        metrics = [agent.update(tbatch, gen) for _ in range(2)]
        runs.append((metrics, [p.detach().clone() for p in agent.parameters()]))
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    assert float(runs[0][0][1]["fb_loss"]) == float(runs[1][0][1]["fb_loss"])


def test_config_matches_the_jax_config() -> None:
    assert dataclasses.asdict(FBDDPGConfig()) == dataclasses.asdict(JaxConfig())


def test_agent_needs_a_card_unless_asked_for_cpu(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FBDDPGAgent(FBDDPGConfig(**SMALL), OBS, ACT)
