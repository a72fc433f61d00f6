"""The five explorers of the port (DIAYN, ICM, ICM-APT, Disagreement,
MaxEnt) and the particle-based entropy against the JAX package.

As in ``tests/test_torch_ddpg.py``: the port's agent loads the JAX train
state through ``convert.py``; the DDPG update's noise is the JAX update's
own draws (``exploration.py:150`` splits the key in three, the third goes
to DDPG); metrics at rtol 1e-4 / atol 1e-5, parameters after Adam within
2*lr, the critic's gradients (read back from Adam's moments after one
step: g = mu / (1 - b1), |g| = sqrt(nu / (1 - b2))) at rtol 1e-3 and an atol of 1e-4
of the tensor's largest |g|: the particle-based rewards carry float32 noise
into every entry, 1e-5 of the largest one (measured on MaxEnt and ICM-APT
on states), which is 2% of an entry 1e-3 of it. ``pbe``'s rewards at rtol 1e-4 / atol 1e-5 beside JAX's, its running
statistics at rtol 1e-4 (the k nearest distances come from one float32
product in either package; a row's distance to itself is the square root of
a rounding residue, equal in both here, since both products are exact on
these integer-valued rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents import exploration as jex
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_tpu.ops.pbe import RMSState as JaxRMS
from controllable_agent_tpu.ops.pbe import pbe as jax_pbe
from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch.agents import (DIAYNAgent, DIAYNConfig, DisagreementAgent,
                                             DisagreementConfig, ICMAgent, ICMAPTAgent,
                                             ICMAPTConfig, ICMConfig, MaxEntAgent, MaxEntConfig)
from controllable_agent_torch.agents.base import StepNoise
from controllable_agent_torch.convert import flax_to_state_dict, load_intrinsic_train_state
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.ops.pbe import RMSState, pbe
from controllable_agent_torch.pretrain import build_workspace
from controllable_agent_torch.train.loops import init_meta_batched
from test_torch_ddpg import _close_params, jax_ddpg_noise
from torch_threads import one_thread  # noqa: F401

N, OBS, ACT, SKILLS = 16, 6, 3, 5
SMALL = dict(hidden_dim=32, batch_size=N)
RTOL, ATOL = 1e-4, 1e-5

AGENTS = {  # name: (JAX config, JAX agent, port config, port agent, overrides)
    "diayn": (jex.DIAYNConfig, jex.DIAYNAgent, DIAYNConfig, DIAYNAgent,
              dict(skill_dim=SKILLS)),
    "icm": (jex.ICMConfig, jex.ICMAgent, ICMConfig, ICMAgent, {}),
    "icm_apt": (jex.ICMAPTConfig, jex.ICMAPTAgent, ICMAPTConfig, ICMAPTAgent,
                dict(icm_rep_dim=8)),
    "icm_apt_identity": (jex.ICMAPTConfig, jex.ICMAPTAgent, ICMAPTConfig, ICMAPTAgent,
                         dict(rep="identity")),
    "disagreement": (jex.DisagreementConfig, jex.DisagreementAgent, DisagreementConfig,
                     DisagreementAgent, dict(n_models=3)),
    "max_ent": (jex.MaxEntConfig, jex.MaxEntAgent, MaxEntConfig, MaxEntAgent, {}),
}
METRICS = {"diayn": {"diayn_loss", "diayn_acc"}, "icm": {"icm_loss"},
           "icm_apt": {"icm_loss"}, "icm_apt_identity": set(),
           "disagreement": {"disagreement_loss"}, "max_ent": set()}


def _reps(seed: int, n: int = N, dim: int = 4) -> np.ndarray:
    """Rows with duplicates and integer values (exact products)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-3, 4, (n, dim)).astype(np.float32)
    x[1] = x[0]
    return x


@pytest.mark.parametrize("knn_avg", [True, False], ids=["avg", "kth"])
@pytest.mark.parametrize("knn_rms", [True, False], ids=["rms", "raw"])
@pytest.mark.parametrize("knn_clip", [0.0, 0.5])
def test_pbe_matches_jax(knn_avg, knn_rms, knn_clip) -> None:
    """Both branches of ``knn_avg`` and of ``knn_rms``, with and without a
    clip that bites, over two batches (the running statistics carry)."""
    jrms, trms = JaxRMS.create(), RMSState.create()
    for seed in (0, 1):
        x = _reps(seed)
        kwargs = dict(knn_k=5, knn_avg=knn_avg, knn_clip=knn_clip, knn_rms=knn_rms)
        want, jrms = jax_pbe(jnp.asarray(x), jrms, **kwargs)
        got, trms = pbe(torch.from_numpy(x), trms, **kwargs)
        assert got.shape == want.shape == (N, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        for name in ("mean", "var", "n"):
            np.testing.assert_allclose(getattr(trms, name).numpy(),
                                       np.asarray(getattr(jrms, name)), rtol=RTOL)


def _close_ddpg_state(agent, state, lr: float) -> None:
    for module, tree, what in ((agent.actor, state.actor_params, "actor"),
                               (agent.critic, state.critic_params, "critic"),
                               (agent.target_critic, state.target_critic_params, "target")):
        _close_params(module, tree, lr, what)
    adam = state.critic_opt_state[0]
    assert agent.step == int(state.step) == agent.critic_opt.count == int(adam.count) == 1
    scale = 1.0 / (1.0 - agent.critic_opt.b2)
    for name, nu in flax_to_state_dict(adam.nu).items():
        want = (nu * scale).sqrt().numpy()
        np.testing.assert_allclose((agent.critic_opt.nu[name] * scale).sqrt().numpy(), want,
                                   rtol=1e-3, atol=1e-4 * float(want.max()),
                                   err_msg=f"|g| {name}")
    for name, mu in flax_to_state_dict(adam.mu).items():
        want = mu.numpy() / (1.0 - agent.critic_opt.b1)
        np.testing.assert_allclose(agent.critic_opt.mu[name].numpy() / (1.0 - agent.critic_opt.b1),
                                   want, rtol=1e-3, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"g {name}")


def _pair(name: str):
    jcfg_cls, jcls, tcfg_cls, tcls, overrides = AGENTS[name]
    jcfg = jcfg_cls(**SMALL, **overrides)
    jagent = jcls(jcfg, OBS, ACT)
    state = jagent.init(jax.random.key(0))
    agent = tcls(tcfg_cls(**SMALL, **overrides), OBS, ACT, device="cpu")
    load_intrinsic_train_state(agent, jax.tree.map(np.asarray, state))
    return jcfg, jagent, state, agent


def _batch(seed: int, skills: bool):
    rng = np.random.RandomState(seed)
    arrays = dict(obs=rng.randn(N, OBS), action=rng.uniform(-1, 1, (N, ACT)),
                  reward=rng.rand(N, 1), next_obs=rng.randn(N, OBS),
                  discount=np.full((N, 1), 0.98))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    meta = ({"skill": np.eye(SKILLS, dtype=np.float32)[rng.randint(0, SKILLS, N)]}
            if skills else {})
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()},
                     meta={k: jnp.asarray(v) for k, v in meta.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                         meta={k: torch.from_numpy(v) for k, v in meta.items()}))


@pytest.mark.parametrize("name", sorted(AGENTS))
def test_explorer_update_matches_jax(name) -> None:
    """One update: the module's loss and Adam step, the intrinsic reward from
    the updated module (and the running statistics it advances), then the
    DDPG update on that reward with the skill in the input (DIAYN)."""
    jcfg, jagent, state, agent = _pair(name)
    jbatch, tbatch = _batch(2, skills=name == "diayn")
    key = jax.random.key(3)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    got = agent._update(tbatch, jax_ddpg_noise(jax.random.split(key, 3)[2]))
    assert set(got) == set(want) and METRICS[name] | {"intr_reward"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert float(got["batch_reward"]) == pytest.approx(float(got["intr_reward"]))
    if agent.module is not None:
        _close_params(agent.module, new_state.module_params, jcfg.lr, "module")
        assert agent.module_opt.count == 1
    else:
        assert new_state.module_params is None
    for k in ("mean", "var", "n"):
        np.testing.assert_allclose(getattr(agent, f"rms_{k}").numpy(),
                                   np.asarray(getattr(new_state.rms, k)), rtol=RTOL, err_msg=k)
    _close_ddpg_state(agent.ddpg, new_state.ddpg, jcfg.lr)


def test_disagreement_is_one_batched_product_per_layer() -> None:
    """The ensemble's parameters are stacked [n_models, ...], as JAX's
    vmapped parameter stack, and each model is its own MLP: model i alone
    gives slice i of the batched forward."""
    _, _, _, agent = _pair("disagreement")
    stack = agent.module.VmapMLPWrap_0.mlps[0]
    assert stack.Dense_0.weight.shape == (3, 32, OBS + ACT)
    x = torch.randn(5, OBS + ACT)
    preds = stack(x)
    for i in range(3):
        h = torch.relu(x @ stack.Dense_0.weight[i].T + stack.Dense_0.bias[i])
        torch.testing.assert_close(preds[i], h @ stack.Dense_1.weight[i].T + stack.Dense_1.bias[i])


def test_diayn_meta_matches_jax_and_its_distribution() -> None:
    """``init_meta`` draws a uniform one-hot skill; ``update_meta`` draws a
    new one at multiples of update_skill_every_step and keeps it elsewhere;
    the collector's ``rollout_update_meta`` puts the drawn index in at the
    steps t that are multiples of it, as the JAX agent does with its own
    draw of the same indices."""
    jcfg, jagent, state, agent = _pair("diayn")
    gen = torch.Generator().manual_seed(4)
    metas = init_meta_batched(agent, gen, 4096)["skill"]
    assert metas.shape == (4096, SKILLS) and bool((metas.sum(1) == 1).all())
    counts = metas.sum(0)
    assert float((counts - 4096 / SKILLS).abs().max()) < 5 * (4096 * 0.2 * 0.8) ** 0.5
    meta = agent.init_meta(gen)
    every = jcfg.update_skill_every_step
    assert agent.update_meta(meta, every + 1, gen) is meta
    draws = torch.stack([agent.update_meta(meta, 2 * every, gen)["skill"] for _ in range(200)])
    assert len(torch.unique(draws.argmax(1))) == SKILLS
    noise = agent.step_noise(4096, gen)
    assert noise.skill_index.shape == (4096,) and int(noise.skill_index.max()) == SKILLS - 1
    skills = torch.from_numpy(np.eye(SKILLS, dtype=np.float32)[[0, 1, 2, 3]])
    for t in (0, 3, every, 2 * every + 1):
        key = jax.random.key(t)
        want = jagent.rollout_update_meta(state, {"skill": jnp.asarray(skills.numpy())},
                                          jnp.asarray(t), key)["skill"]
        idx = torch.from_numpy(np.array(jax.random.randint(key, (4,), 0, SKILLS))).long()
        got = agent.rollout_update_meta({"skill": skills}, torch.tensor(t),
                                        StepNoise(skill_index=idx))["skill"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, skills) == (t % every != 0)


def test_a_jax_diayn_folder_loads_into_the_port(tmp_path) -> None:
    """``load_model=`` of a checkpoint folder that the JAX package wrote for
    ``agent=diayn``: the DDPG state with the skill in its input width, the
    discriminator and its Adam state, and the counters."""
    args = ["agent=diayn", "task=walker_walk", "episode_length=20", "use_console=false",
            "agent.hidden_dim=32", f"agent.skill_dim={SKILLS}", "agent.batch_size=16"]
    jws = jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    jws.global_step = 60
    jws.save_checkpoint(tmp_path / "jax_ckpt")
    tws = build_workspace(args + ["device=cpu", f"load_model={tmp_path}/jax_ckpt",
                                  f"folder={tmp_path}/torch"])
    assert tws.global_step == 60
    state = jws.agent_state
    for module, tree in ((tws.agent.ddpg.actor, state.ddpg.actor_params),
                         (tws.agent.ddpg.critic, state.ddpg.critic_params),
                         (tws.agent.module, state.module_params)):
        want = flax_to_state_dict(tree)
        assert all(torch.equal(v, want[k]) for k, v in module.state_dict().items())
    assert tws.agent.ddpg.actor.mlps[0].Dense_0.weight.shape[1] == 24 + SKILLS
    assert tws.agent.module_opt.count == int(state.module_opt_state[0].count)
