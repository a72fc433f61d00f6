"""The port's SF and SF-SVD agents against the JAX package's, beyond the
learners (``test_torch_sf_learners.py``): the SF loss in Q space and in
feature space, the actor with the truncated normal and the squashed
Gaussian (boltzmann), the update that mixes whitened φ into z
(``mix_ratio`` > 0), least squares and the pseudo-inverse with JAX's
cutoffs (full rank and rank-deficient), z inference and goal inference with
and without ``precompute_cov``, grafting FB's backward net in as φ, SF-SVD's
update and its action-conditioned inference, and the draws of an update and
of a collector step.

Same weights (``convert.py``) and the same noise (the JAX keys' own draws);
tolerances are ``test_torch_fb_ddpg.py``'s: rtol 1e-4 / atol 1e-6 for
losses, metrics, gradients and z, 2*lr for parameters after Adam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents.base import ZMetaMixin as JaxZMeta
from controllable_agent_tpu.agents.fb_ddpg import FBDDPGAgent as JaxFB
from controllable_agent_tpu.agents.fb_ddpg import FBDDPGConfig as JaxFBConfig
from controllable_agent_tpu.agents.sf_svd import SFSVDAgent as JaxSFSVD
from controllable_agent_tpu.agents.sf_svd import SFSVDConfig as JaxSFSVDConfig
from controllable_agent_torch.agents import (FBDDPGAgent, FBDDPGConfig, SFAgent, SFConfig,
                                             SFNoise, SFSVDAgent, SFSVDConfig)
from controllable_agent_torch.agents.base import StepNoise
from controllable_agent_torch.convert import (flax_to_state_dict, load_fb_train_state,
                                              load_sf_svd_train_state)
from controllable_agent_torch.ops.linalg import lstsq, pinv
from test_torch_sf_learners import (ACT, OBS, SMALL, batch_pair, close, close_grads,
                                    close_params, close_update, jax_sf_noise, sf_pair)
from torch_threads import one_thread  # noqa: F401

N = SMALL["batch_size"]

CASES = {
    "q_loss": dict(feature_learner="lap"),
    "feature_space_loss": dict(feature_learner="lap", q_loss=False),
    "boltzmann": dict(feature_learner="icm", boltzmann=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sf_and_actor_losses_match_jax(case) -> None:
    """The SF loss and its gradients, the actor loss and its gradients, and
    the whole update, from the same z and noise."""
    jcfg, jagent, state, tagent = sf_pair(**CASES[case])
    jbatch, tbatch = batch_pair()
    key = jax.random.key(1)
    noise = jax_sf_noise(jcfg, key)
    k_z, _, _, k_sf, k_actor = jax.random.split(key, 5)
    z_j = jagent.sample_z(k_z, N)
    z_t = tagent.z_from_noise(noise.z_normal)
    close(z_t, z_j, msg="z")

    (loss_j, metrics_j), grads_j = jax.value_and_grad(jagent._sf_loss, has_aux=True)(
        state.sf_params, state, jbatch, jbatch.obs, jbatch.next_obs, z_j, k_sf)
    loss_t, metrics_t = tagent._sf_loss(tbatch, tbatch.next_obs, z_t, noise.next_action_normal)
    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        close(metrics_t[k], metrics_j[k], msg=k)
    params = tagent.sf_opt.params
    grads = torch.autograd.grad(loss_t, list(params.values()))
    close_grads(dict(zip(params, grads)), flax_to_state_dict(grads_j), "sf grad")

    (loss_j, metrics_j), grads_j = jax.value_and_grad(jagent._actor_loss, has_aux=True)(
        state.actor_params, state.sf_params, state, jbatch.obs, z_j, k_actor)
    loss_t, metrics_t = tagent._actor_loss(tbatch.obs, z_t, noise.actor_normal)
    for k in metrics_j:
        close(metrics_t[k], metrics_j[k], msg=k)
    params = tagent.actor_opt.params
    grads = torch.autograd.grad(loss_t, list(params.values()))
    close_grads(dict(zip(params, grads)), flax_to_state_dict(grads_j), "actor grad")

    new_state, metrics_j = jagent._update(state, jbatch, key)
    close_update(tagent, new_state, tagent._update(tbatch, noise), metrics_j, jcfg.lr)


def test_mix_update_matches_jax() -> None:
    """``mix_ratio`` > 0: z of permuted next goals whitened by the pinv of
    their φ covariance replaces the sampled z where the mask draws it."""
    jcfg, jagent, state, tagent = sf_pair(feature_learner="svd_sr", mix_ratio=0.5)
    jbatch, tbatch = batch_pair()
    key = jax.random.key(2)
    noise = jax_sf_noise(jcfg, key)
    assert 0 < int((noise.mix_uniform < 0.5).sum()) < N  # both kinds of z occur
    # the mixed z: what the JAX update computes before its SF loss
    k_z, k_perm, k_mix, _, _ = jax.random.split(key, 5)
    perm = jax.random.permutation(k_perm, N)
    phi = jagent.features(state.feature_params, jbatch.next_obs[perm])
    new_z = jagent.features(state.feature_params, jbatch.next_obs[perm]) @ jnp.linalg.pinv(
        phi.T @ phi / N)
    new_z = np.sqrt(jcfg.z_dim) * new_z / jnp.linalg.norm(new_z, axis=-1, keepdims=True)
    z_j = jnp.where(jax.random.uniform(k_mix, (N, 1)) < 0.5, new_z, jagent.sample_z(k_z, N))
    z_t = tagent._mix_z(tagent.z_from_noise(noise.z_normal), tbatch.next_obs, noise)
    close(z_t, z_j, rtol=1e-4, atol=1e-5, msg="mixed z")
    new_state, metrics_j = jagent._update(state, jbatch, key)
    close_update(tagent, new_state, tagent._update(tbatch, noise), metrics_j, jcfg.lr)


def _rank_deficient(rows: int, cols: int, seed: int) -> np.ndarray:
    """[rows, cols] of rank cols - 2: a zero column (a dead unit) and a
    duplicated one."""
    a = np.random.RandomState(seed).randn(rows, cols).astype(np.float32)
    a[:, 1] = 0.0
    a[:, 2] = a[:, 3]
    return a


@pytest.mark.parametrize("kind", ["full_rank", "rank_deficient", "fewer_rows_than_columns"])
def test_lstsq_and_pinv_match_jax(kind) -> None:
    """``ops/linalg.py`` against ``jnp.linalg.lstsq`` and ``jnp.linalg.pinv``."""
    rng = np.random.RandomState(3)
    a = {"full_rank": rng.randn(64, 8).astype(np.float32),
         "rank_deficient": _rank_deficient(64, 8, 4),
         "fewer_rows_than_columns": rng.randn(5, 8).astype(np.float32)}[kind]
    b = rng.rand(a.shape[0], 1).astype(np.float32)
    want = jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(b))[0]
    close(lstsq(torch.from_numpy(a), torch.from_numpy(b)), want, atol=1e-5, msg="lstsq")
    cov = a.T @ a / a.shape[0]
    close(pinv(torch.from_numpy(cov)), jnp.linalg.pinv(jnp.asarray(cov)), atol=1e-5,
          msg="pinv")


@pytest.mark.parametrize("kind", ["full_rank", "rank_deficient", "fewer_samples_than_z"])
def test_reward_inference_matches_jax(kind) -> None:
    """z = lstsq(φ(s), r), norm sqrt(z_dim): on 64 samples, on observations
    with a zero and a duplicated column under the identity learner, and
    on fewer samples than z has entries (the minimum-norm solution)."""
    learner = "identity" if kind == "rank_deficient" else "lap"
    _, jagent, state, tagent = sf_pair(feature_learner=learner)
    rows = 5 if kind == "fewer_samples_than_z" else 64
    obs = (_rank_deficient(rows, OBS, 5) if kind == "rank_deficient"
           else np.random.RandomState(5).randn(rows, OBS).astype(np.float32))
    reward = np.random.RandomState(6).rand(rows, 1).astype(np.float32)
    want = jagent.infer_meta_from_obs_and_rewards(state, jnp.asarray(obs), jnp.asarray(reward))
    got = tagent.infer_meta_from_obs_and_rewards(torch.from_numpy(obs), torch.from_numpy(reward))
    close(got, want, atol=1e-5, msg="z")
    np.testing.assert_allclose(float(got.norm()), np.sqrt(tagent.cfg.z_dim), rtol=1e-5)


@pytest.mark.parametrize("precompute", [False, True], ids=["identity_inv_cov", "precomputed"])
def test_goal_meta_matches_jax(precompute) -> None:
    """z = φ(g)·Σ⁺, with Σ⁺ the identity (as the JAX workspace leaves it) or
    the pinv of the φ covariance over replay goals."""
    _, jagent, state, tagent = sf_pair(feature_learner="contrastive")
    goals = np.random.RandomState(7).randn(64, OBS).astype(np.float32)
    if precompute:
        state = jagent.precompute_cov(state, jnp.asarray(goals))
        tagent.precompute_cov(torch.from_numpy(goals))
        close(tagent.inv_cov, state.inv_cov, atol=1e-5, msg="inv_cov")
    else:
        assert torch.equal(tagent.inv_cov, torch.eye(tagent.cfg.z_dim))
    goal = goals[3]
    close(tagent.get_goal_meta(torch.from_numpy(goal)),
          jagent.get_goal_meta(state, jnp.asarray(goal)), atol=1e-5, msg="goal z")


def test_load_fb_features_grafts_the_backward_net() -> None:
    """φ = B of an FB agent: from the port's FB agent (loaded from the JAX
    one) and from the JAX ``backward_params`` tree, as the JAX
    ``load_fb_features`` grafts it; other learners refuse."""
    jfb = JaxFB(JaxFBConfig(**SMALL), obs_dim=OBS, action_dim=ACT)
    fb_state = jfb.init(jax.random.key(9))
    tfb = FBDDPGAgent(FBDDPGConfig(**SMALL), OBS, ACT, device="cpu")
    load_fb_train_state(tfb, jax.tree.map(np.asarray, fb_state))
    _, jagent, state, tagent = sf_pair(feature_learner="fb")
    state = jagent.load_fb_features(state, fb_state.backward_params)
    goals = np.random.RandomState(8).randn(10, OBS).astype(np.float32)
    want = jagent.features(state.feature_params, jnp.asarray(goals))
    tagent.load_fb_features(tfb.backward_net.state_dict())
    close(tagent.features(torch.from_numpy(goals)), want, msg="phi from the port's FB")
    close(tagent.features(torch.from_numpy(goals)), jfb.backward_net.apply(
        fb_state.backward_params, jnp.asarray(goals)), msg="phi = B")
    _, _, _, other = sf_pair(feature_learner="fb")
    other.load_fb_features(jax.tree.map(np.asarray, fb_state.backward_params))
    close(other.features(torch.from_numpy(goals)), want, msg="phi from the JAX tree")
    _, _, _, lap = sf_pair(feature_learner="lap")
    with pytest.raises(ValueError, match="feature_learner='fb'"):
        lap.load_fb_features(tfb.backward_net.state_dict())


def _svd_pair(**overrides):
    jagent = JaxSFSVD(JaxSFSVDConfig(**{**SMALL, **overrides}), obs_dim=OBS, action_dim=ACT)
    state = jagent.init(jax.random.key(0))
    tagent = SFSVDAgent(SFSVDConfig(**{**SMALL, **overrides}), OBS, ACT, device="cpu")
    load_sf_svd_train_state(tagent, jax.tree.map(np.asarray, state))
    return jagent.cfg, jagent, state, tagent


@pytest.mark.parametrize("q_loss", [True, False], ids=["q_loss", "feature_space_loss"])
def test_sf_svd_update_matches_jax(q_loss) -> None:
    """One SF-SVD update with the draws of its three-way key split
    (``sf_svd.py:187``): the SVD step first, then SF on the updated φ(s, a),
    then the actor."""
    jcfg, jagent, state, tagent = _svd_pair(q_loss=q_loss)
    jbatch, tbatch = batch_pair(1)
    key = jax.random.key(3)
    k_z, k_sf, k_actor = jax.random.split(key, 3)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    noise = SFNoise(z_normal=t(jax.random.normal(k_z, (N, jcfg.z_dim))),
                    next_action_normal=t(jax.random.normal(k_sf, (N, ACT))),
                    actor_normal=t(jax.random.normal(k_actor, (N, ACT))))
    new_state, metrics_j = jagent._update(state, jbatch, key)
    metrics_t = tagent._update(tbatch, noise)
    assert set(metrics_t) == set(metrics_j) == {"phi_loss", "sf_loss", "actor_loss"}
    for k in metrics_j:
        close(metrics_t[k], metrics_j[k], msg=k)
    lr = jcfg.lr
    for module, tree, what in ((tagent.actor, new_state.actor_params, "actor"),
                               (tagent.successor_net, new_state.sf_params, "sf"),
                               (tagent.target_successor_net, new_state.target_sf_params,
                                "target_sf"),
                               (tagent.svd, new_state.svd_params, "svd")):
        close_params(module, tree, lr, what)
    assert tagent.step == 1 and tagent.svd_opt.count == int(new_state.svd_opt_state[0].count)


@pytest.mark.parametrize("rows", [64, 5], ids=["full_rank", "fewer_samples_than_z"])
def test_sf_svd_inference_matches_jax(rows) -> None:
    """z = lstsq(φ(s, a), r); SF-SVD has no state-only regression and no
    goal inference, as in JAX."""
    _, jagent, state, tagent = _svd_pair()
    rng = np.random.RandomState(rows)
    obs = rng.randn(rows, OBS).astype(np.float32)
    action = rng.uniform(-1, 1, (rows, ACT)).astype(np.float32)
    reward = rng.rand(rows, 1).astype(np.float32)
    want = jagent.infer_meta_from_obs_action_and_rewards(
        state, jnp.asarray(obs), jnp.asarray(action), jnp.asarray(reward))
    got = tagent.infer_meta_from_obs_action_and_rewards(
        torch.from_numpy(obs), torch.from_numpy(action), torch.from_numpy(reward))
    close(got, want, atol=1e-5, msg="z")
    assert not hasattr(tagent, "infer_meta_from_obs_and_rewards")
    assert not hasattr(tagent, "get_goal_meta")


def test_update_draws() -> None:
    """SF's update draws a permutation only when it mixes (``torch.randperm``
    where JAX draws ``jax.random.permutation``: checked on its
    distribution), SF-SVD's never; every draw comes from the generator."""
    gen = torch.Generator().manual_seed(0)
    draws = [SFNoise.draw(N, 8, ACT, True, gen, torch.device("cpu")) for _ in range(2000)]
    perms = torch.stack([d.perm for d in draws])
    assert all(torch.equal(p.sort().values, torch.arange(N)) for p in perms[:50])
    # where index 0 lands: uniform over the N positions (chi-square, 15 dof,
    # far below the 0.1% critical value of 37.7)
    counts = torch.bincount((perms == 0).float().argmax(1), minlength=N).float()
    expected = len(draws) / N
    assert float(((counts - expected) ** 2 / expected).sum()) < 37.7
    assert all(0 <= float(d.mix_uniform.min()) and float(d.mix_uniform.max()) < 1
               for d in draws[:50])
    _, _, _, tagent = sf_pair(feature_learner="lap")
    _, _, _, svd = _svd_pair(mix_ratio=0.5)  # a field the JAX SF-SVD never reads
    assert not tagent.mixes and not svd.mixes
    a, b = (torch.Generator().manual_seed(1) for _ in range(2))
    _, tbatch = batch_pair()
    tagent.update(tbatch, a)
    assert not torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize("make", [sf_pair, _svd_pair], ids=["sf", "sf_svd"])
def test_collector_z_resample_matches_jax(make) -> None:
    """The collector's in-episode z resample (``rollout_update_meta``) takes
    SF's plain sqrt(z)-scaled normalized normal: the JAX mixin's draws
    replayed into the port's ``StepNoise``."""
    _, jagent, state, tagent = make()
    n, key = 4, jax.random.key(4)
    z = np.random.RandomState(1).randn(n, tagent.cfg.z_dim).astype(np.float32)
    t = jnp.asarray(100)  # a multiple of update_z_every_step: every z is resampled
    want = JaxZMeta.rollout_update_meta(jagent, state, {"z": jnp.asarray(z)}, t, key)["z"]
    k_p, k_z = jax.random.split(key)
    noise = StepNoise(act_normal=torch.zeros(n, ACT), act_uniform=torch.zeros(n, ACT),
                      meta_uniform=torch.from_numpy(np.array(jax.random.uniform(k_p, (n, 1)))),
                      z_normal=torch.from_numpy(np.array(
                          jax.random.normal(k_z, (n, tagent.cfg.z_dim)))))
    got = tagent.rollout_update_meta({"z": torch.from_numpy(z)}, torch.tensor(100), noise)["z"]
    close(got, want, msg="resampled z")
    drawn = tagent.step_noise(n, torch.Generator().manual_seed(0))
    assert drawn.z_normal.shape == (n, tagent.cfg.z_dim) and drawn.z_uniform is None


@pytest.mark.parametrize("agent_cls,cfg_cls", [(SFAgent, SFConfig), (SFSVDAgent, SFSVDConfig)],
                         ids=["sf", "sf_svd"])
def test_compute_dtype_changes_nothing(agent_cls, cfg_cls) -> None:
    """``compute_dtype`` is read by nothing, as in JAX: an agent built with
    bfloat16 updates to the same bits as one built with float32."""
    _, tbatch = batch_pair()
    agents = [agent_cls(cfg_cls(**SMALL, compute_dtype=dtype), OBS, ACT, device="cpu")
              for dtype in ("float32", "bfloat16")]
    metrics = [a.update(tbatch, torch.Generator().manual_seed(3)) for a in agents]
    assert all(torch.equal(metrics[0][k], metrics[1][k]) for k in metrics[0])
    got, want = agents[1].train_state(), agents[0].train_state()
    assert all(torch.equal(got[k], v) and v.dtype != torch.bfloat16 for k, v in want.items())
