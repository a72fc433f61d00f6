"""The port's discrete SF agent against the JAX package's: one whole update
for five φ learners with the loss in Q space and in feature space (the
successor nets after Adam and their target, the learner after its step,
Adam's moments, the step), the enumeration of the actions against JAX's
``vmap``, acting with JAX's draws, and the conversion of a JAX state.

Same weights (``convert.py``) and the same noise: the JAX update draws one
normal for z from ``jax.random.split(key)[0]`` (``discrete_sf.py:120``).
Tolerances: losses, metrics and outputs rtol 2e-4 (atol 1e-5 for entries
near 0); Adam's first moment, 0.1 of the gradient, rtol 1e-3; parameters
after Adam within 2*lr (``test_torch_discrete_fb.py``'s rule).
"""

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents.discrete_sf import DiscreteSFAgent as JaxAgent
from controllable_agent_tpu.agents.discrete_sf import DiscreteSFConfig as JaxConfig
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_torch.agents import DiscreteSFAgent, DiscreteSFConfig, SFNoise
from controllable_agent_torch.agents.base import StepNoise
from controllable_agent_torch.convert import flax_to_state_dict, load_discrete_sf_train_state
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.train import jax_checkpoint
from test_torch_discrete_fb import ACTIONS, GRAD_RTOL, N, OBS, _close, _close_params
from torch_threads import one_thread  # noqa: F401

SMALL = dict(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8, batch_size=N)
LEARNERS = ["icm", "identity", "random", "lap", "contrastive"]


def _batch(seed: int = 0):
    rng = np.random.RandomState(seed)
    arrays = dict(obs=rng.randn(N, OBS), action=rng.randint(0, ACTIONS, (N, 1)),
                  reward=rng.rand(N, 1), next_obs=rng.randn(N, OBS),
                  discount=np.full((N, 1), 0.98), future_obs=rng.randn(N, OBS))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _agents(**overrides):
    jagent = JaxAgent(JaxConfig(**{**SMALL, **overrides}), obs_dim=OBS, n_actions=ACTIONS)
    state = jagent.init(jax.random.key(0))
    tagent = DiscreteSFAgent(DiscreteSFConfig(**{**SMALL, **overrides}), OBS, ACTIONS,
                             device="cpu")
    load_discrete_sf_train_state(tagent, jax.tree.map(np.asarray, state))
    return jagent, state, tagent


def _noise(cfg, key: jax.Array) -> SFNoise:
    k_z, _ = jax.random.split(key)
    return SFNoise(z_normal=torch.from_numpy(np.array(jax.random.normal(k_z, (N, cfg.z_dim)))))


@pytest.mark.parametrize("q_loss", [True, False], ids=["q_loss", "feature_loss"])
@pytest.mark.parametrize("learner", LEARNERS)
def test_update_parity(learner, q_loss) -> None:
    jagent, state, tagent = _agents(feature_learner=learner, q_loss=q_loss)
    jcfg = jagent.cfg
    if learner == "identity":
        assert tagent.cfg.z_dim == jcfg.z_dim == OBS and tagent.phi_opt is None
    jbatch, tbatch = _batch()
    key = jax.random.key(1)
    new_state, metrics_j = jagent._update(state, jbatch, key)  # eager: no compile per case
    metrics_t = tagent._update(tbatch, _noise(jcfg, key))
    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        _close(metrics_t[k], metrics_j[k], msg=k)
    for module, tree, what in (
            (tagent.successor_net, new_state.sf_params, "sf"),
            (tagent.target_successor_net, new_state.target_sf_params, "target_sf"),
            (tagent.feature_learner, new_state.feature_params, "learner")):
        _close_params(module, tree, jcfg.lr, what)
    assert tagent.step == int(new_state.step) == 1
    for opt, opt_state in ((tagent.sf_opt, new_state.sf_opt_state),
                           (tagent.phi_opt, new_state.phi_opt_state)):
        if opt is None:
            continue
        adam = opt_state[0]
        assert opt.count == int(adam.count)
        for name, mu in flax_to_state_dict(adam.mu).items():
            if name in opt.mu:  # the learner's targets have moments in JAX only
                _close(opt.mu[name], mu, rtol=GRAD_RTOL, atol=1e-7, msg=f"mu {name}")
                _close(opt.nu[name], flax_to_state_dict(adam.nu)[name], rtol=2 * GRAD_RTOL,
                       atol=1e-12, msg=f"nu {name}")
            else:
                assert name.startswith("target_") and not bool(mu.any()), name


def test_action_enumeration_matches_jax_vmap() -> None:
    """Q of every action in one batched pass against JAX's pass per action."""
    jagent, state, tagent = _agents()
    rng = np.random.RandomState(2)
    obs, z = rng.randn(N, OBS).astype(np.float32), rng.randn(N, 8).astype(np.float32)
    got = tagent.all_action_q(tagent.successor_net, torch.from_numpy(obs), torch.from_numpy(z))
    assert got.shape == (N, ACTIONS)
    _close(got, jagent._all_action_q(state.sf_params, jnp.asarray(obs), jnp.asarray(z)))


def test_act_with_jax_draws() -> None:
    jagent, state, tagent = _agents()
    rng = np.random.RandomState(3)
    n = 64
    obs = rng.randn(n, OBS).astype(np.float32)
    z = np.array(jagent.sample_z(jax.random.key(4), n))
    key = jax.random.key(5)
    greedy = tagent.act(torch.from_numpy(obs), torch.from_numpy(z), 0, eval_mode=True)
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jagent.act(state, obs, z, 0, key, eval_mode=True)))
    assert len(set(greedy.tolist())) > 1
    k_eps, k_rand = jax.random.split(key)
    noise = StepNoise(
        explore_uniform=torch.from_numpy(np.array(jax.random.uniform(k_eps, (n,)))),
        random_action=torch.from_numpy(np.array(
            jax.random.randint(k_rand, (n,), 0, ACTIONS))).long())
    got = tagent.act(torch.from_numpy(obs), torch.from_numpy(z), torch.tensor(0), noise=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jagent.act(state, obs, z, 0, key)))
    assert 0 < int((noise.explore_uniform < 0.2).sum()) < n


@pytest.mark.parametrize("learner", ["latent", "identity"])
def test_conversion_of_a_jax_state(learner) -> None:
    """A JAX state one update in, from its decoded checkpoint bytes: every
    network equal to the bit, the Adam counts and moments, the step; the φ
    targets' zero moments dropped, and no φ Adam for identity."""
    jagent = JaxAgent(JaxConfig(**SMALL, feature_learner=learner), obs_dim=OBS,
                      n_actions=ACTIONS)
    state = jagent.init(jax.random.key(0))
    jbatch, _ = _batch()
    state, _ = jagent._update(state, jbatch, jax.random.key(1))
    decoded = jax_checkpoint.restore(flax.serialization.to_bytes(state))
    tagent = DiscreteSFAgent(DiscreteSFConfig(**SMALL, feature_learner=learner), OBS, ACTIONS,
                             device="cpu")
    load_discrete_sf_train_state(tagent, decoded)
    for module, tree in ((tagent.successor_net, state.sf_params),
                         (tagent.target_successor_net, state.target_sf_params),
                         (tagent.feature_learner, state.feature_params)):
        want = flax_to_state_dict(tree)
        for name, value in module.state_dict().items():
            assert torch.equal(value, want[name]), name
    assert tagent.step == 1 and tagent.sf_opt.count == 1
    assert (tagent.phi_opt is None) == (learner == "identity")
    if tagent.phi_opt is not None:
        assert tagent.phi_opt.count == 1
        assert not any(k.startswith("target_") for k in tagent.phi_opt.params)
        mu = flax_to_state_dict(state.phi_opt_state[0].mu)
        for name, value in tagent.phi_opt.mu.items():
            assert torch.equal(value, mu[name]), name


def test_config_fields_equal_jax() -> None:
    ours = [(f.name, f.default) for f in dataclasses.fields(DiscreteSFConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == theirs
