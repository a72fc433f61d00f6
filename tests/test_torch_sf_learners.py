"""The thirteen φ learners of the port's SF agent against the JAX package's:
for each, φ, the learner's loss and its gradients, then one whole update
(its metrics, every network after Adam, the learner's targets after their
soft update, Adam's moments and the step).

As in ``test_torch_fb_ddpg.py``, the port's agent loads the JAX train state
through ``convert.py`` and the update's noise is the JAX update's own draws,
replayed from its ``jax.random.split(key, 5)`` (``sf.py:562``). Tolerances
are that file's: losses, metrics and gradients at rtol 1e-4 / atol 1e-6
(float32 sums in another order); parameters after Adam within 2*lr, with at
most one entry per tensor or 1e-3 of it beyond 1e-3*lr (Adam's first step is
~lr*sign(g), which flips where a gradient is ~0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents.sf import SFAgent as JaxSF
from controllable_agent_tpu.agents.sf import SFConfig as JaxSFConfig
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_torch.agents import FEATURE_LEARNERS, SFAgent, SFConfig, SFNoise
from controllable_agent_torch.agents.sf import FROZEN_LEARNERS
from controllable_agent_torch.convert import flax_to_state_dict, load_sf_train_state
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from torch_threads import one_thread  # noqa: F401

N, OBS, ACT = 16, 6, 3
SMALL = dict(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8, batch_size=N)
RTOL, ATOL = 1e-4, 1e-6
STEP_SHARE = 1e-3


def batch_pair(seed: int = 0, n: int = N):
    """The same random batch for both packages, future observations included."""
    rng = np.random.RandomState(seed)
    arrays = dict(obs=rng.randn(n, OBS), action=rng.uniform(-1, 1, (n, ACT)),
                  reward=rng.rand(n, 1), next_obs=rng.randn(n, OBS),
                  discount=np.full((n, 1), 0.98), future_obs=rng.randn(n, OBS))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def jax_sf_noise(cfg, key: jax.Array, n: int = N) -> SFNoise:
    """The draws of the JAX SF ``_update(state, batch, key)``, in its order."""
    k_z, k_perm, k_mix, k_sf, k_actor = jax.random.split(key, 5)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    mix = cfg.mix_ratio > 0
    return SFNoise(z_normal=t(jax.random.normal(k_z, (n, cfg.z_dim))),
                   next_action_normal=t(jax.random.normal(k_sf, (n, ACT))),
                   actor_normal=t(jax.random.normal(k_actor, (n, ACT))),
                   perm=t(jax.random.permutation(k_perm, n)).long() if mix else None,
                   mix_uniform=t(jax.random.uniform(k_mix, (n, 1))) if mix else None)


def sf_pair(**overrides):
    """A JAX SF agent and state, and the port's agent loaded from it."""
    jagent = JaxSF(JaxSFConfig(**{**SMALL, **overrides}), obs_dim=OBS, action_dim=ACT)
    state = jagent.init(jax.random.key(0))
    tagent = SFAgent(SFConfig(**{**SMALL, **overrides}), OBS, ACT, device="cpu")
    load_sf_train_state(tagent, jax.tree.map(np.asarray, state))
    return jagent.cfg, jagent, state, tagent


def close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL, msg="") -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def close_params(module: torch.nn.Module, flax_params, lr: float, what: str) -> None:
    want = flax_to_state_dict(flax_params)
    got = module.state_dict()
    assert set(got) == set(want), what
    for name in want:
        diff = (got[name].float() - want[name]).abs()
        assert float(diff.max()) <= 2 * lr + 1e-6, f"{what}.{name}"
        flipped = int((diff > 1e-3 * lr).sum())
        assert flipped <= max(1, STEP_SHARE * diff.numel()), f"{what}.{name}: {flipped}"


def close_grads(got: dict, want: dict, msg: str) -> None:
    assert set(got) <= set(want), msg
    for name, grad in got.items():
        close(grad, want[name], msg=f"{msg} {name}")


def close_update(tagent, new_state, metrics_t, metrics_j, lr: float) -> None:
    """Metrics, every network, the Adam states and the step after one update."""
    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        close(metrics_t[k], metrics_j[k], msg=k)
    for module, tree, what in (
            (tagent.actor, new_state.actor_params, "actor"),
            (tagent.successor_net, new_state.sf_params, "sf"),
            (tagent.target_successor_net, new_state.target_sf_params, "target_sf"),
            (tagent.feature_learner, new_state.feature_params, "learner")):
        close_params(module, tree, lr, what)
    assert tagent.step == int(new_state.step) == 1
    for opt, opt_state in ((tagent.sf_opt, new_state.sf_opt_state),
                           (tagent.phi_opt, new_state.phi_opt_state)):
        if opt is None:
            continue
        adam = opt_state[0]
        assert opt.count == int(adam.count)
        for name, nu in flax_to_state_dict(adam.nu).items():
            if name in opt.nu:
                close(opt.nu[name], nu, rtol=1e-3, atol=1e-12, msg=f"nu {name}")
        for name, mu in flax_to_state_dict(adam.mu).items():
            if name in opt.mu:
                close(opt.mu[name], mu, msg=f"mu {name}")


@pytest.mark.parametrize("learner", sorted(FEATURE_LEARNERS))
def test_learner_matches_jax(learner) -> None:
    jcfg, jagent, state, tagent = sf_pair(feature_learner=learner)
    jbatch, tbatch = batch_pair()
    if learner == "identity":
        assert tagent.cfg.z_dim == jcfg.z_dim == OBS and tagent.phi_opt is None

    # φ
    close(tagent.features(tbatch.obs), jagent.features(state.feature_params, jbatch.obs),
          msg="phi")

    # the learner's loss and its gradients (the target subtrees get none in
    # JAX, and the port's Adam leaves them out)
    loss_j, grads_j = jax.value_and_grad(jagent._phi_loss)(
        state.feature_params, jbatch.obs, jbatch.action, jbatch.next_obs, jbatch.future_obs)
    args = (tbatch.obs, tbatch.action, tbatch.next_obs, tbatch.future_obs)
    if learner in FROZEN_LEARNERS:
        assert tagent.feature_learner.loss(*args) is None and float(loss_j) == 0.0
        assert not tagent.learner_trainable
    else:
        loss_t = tagent._phi_loss(*args)
        close(loss_t, loss_j, msg="phi_loss")
        params = tagent.phi_opt.params
        grads = torch.autograd.grad(loss_t, list(params.values()))
        want = flax_to_state_dict(grads_j)
        close_grads(dict(zip(params, grads)), want, "grad")
        for name in set(want) - set(params):
            assert name.startswith("target_") and not bool(want[name].any()), name

    # one whole update: the SF step, the φ step and its targets, the actor
    key = jax.random.key(1)
    new_state, metrics_j = jagent._update(state, jbatch, key)  # eager: no compile per learner
    metrics_t = tagent._update(tbatch, jax_sf_noise(jcfg, key))
    assert ("phi_loss" in metrics_t) == (learner not in FROZEN_LEARNERS)
    close_update(tagent, new_state, metrics_t, metrics_j, jcfg.lr)
