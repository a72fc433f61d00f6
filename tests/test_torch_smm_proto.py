"""SMM and Proto of the port against the JAX agents.

As in ``tests/test_torch_explorers.py``: the port's agent loads the JAX
train state through ``convert.py``; the update's draws are the JAX update's
own, re-derived from the key it splits: SMM's VAE ε of the loss and of the
reward from the first two of ``exploration.py:150``'s three keys, DDPG's
from the third; Proto's candidates' Gumbel noise from the first of
``proto.py:141``'s two keys (``jax.random.categorical`` is the Gumbel-max
of it), DDPG's from the second. Metrics at rtol 1e-4 / atol 1e-5,
parameters after Adam within 2*lr, the critic's gradients from Adam's
moments at rtol 1e-3 with an atol of 1e-4 of the tensor's largest |g|.

Proto's distances are differences taken directly in both packages, so a
queue row equal to the embedding is at 0 in both; the rest, its queue after
several updates and its intrinsic reward agree at rtol 1e-4 / atol 1e-5
(the embeddings come from parameters that agree within 2*lr; float32 sums
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents import proto as jproto
from controllable_agent_tpu.agents import smm as jsmm
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_torch.agents import (ProtoAgent, ProtoConfig, ProtoNoise, SMMAgent,
                                             SMMConfig, SMMNoise)
from controllable_agent_torch.agents.base import StepNoise
from controllable_agent_torch.agents.proto import sinkhorn_knopp
from controllable_agent_torch.convert import load_train_state
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.train.loops import init_meta_batched
from test_torch_ddpg import _close_params, jax_ddpg_noise
from test_torch_explorers import _close_ddpg_state

N, OBS, ACT, Z = 16, 6, 3, 4
RTOL, ATOL = 1e-4, 1e-5
PROTO = dict(hidden_dim=32, batch_size=N, pred_dim=8, proj_dim=16, num_protos=8,
             queue_size=20)


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _batch(seed: int, skills: bool):
    rng = np.random.RandomState(seed)
    arrays = dict(obs=rng.randn(N, OBS), action=rng.uniform(-1, 1, (N, ACT)),
                  reward=rng.rand(N, 1), next_obs=rng.randn(N, OBS),
                  discount=np.full((N, 1), 0.98))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    meta = {"z": np.eye(Z, dtype=np.float32)[rng.randint(0, Z, N)]} if skills else {}
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()},
                     meta={k: jnp.asarray(v) for k, v in meta.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                         meta={k: torch.from_numpy(v) for k, v in meta.items()}))


def _close_metrics(got, want) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _pair(jcls, jcfg_cls, tcls, tcfg_cls, **cfg):
    jagent = jcls(jcfg_cls(**cfg), OBS, ACT)
    state = jagent.init(jax.random.key(0))
    agent = tcls(tcfg_cls(**cfg), OBS, ACT, device="cpu")
    load_train_state(agent, jax.tree.map(np.asarray, state))
    return jagent, state, agent


def test_sinkhorn_knopp_matches_jax() -> None:
    scores = np.random.RandomState(0).randn(N, 8).astype(np.float32) / 0.1
    want = np.asarray(jproto.sinkhorn_knopp(jnp.asarray(scores)))
    got = sinkhorn_knopp(torch.from_numpy(scores)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


def test_smm_update_matches_jax() -> None:
    """The VAE and skill predictor's loss and Adam step, the reward
    state_ent·h(s|z) + latent_ent·log K + latent_cond_ent·h(z|s) from the
    updated module with a fresh ε, then DDPG on [obs, z]."""
    jagent, state, agent = _pair(jsmm.SMMAgent, jsmm.SMMConfig, SMMAgent, SMMConfig,
                                 hidden_dim=32, batch_size=N, code_dim=8)
    jbatch, tbatch = _batch(2, skills=True)
    key = jax.random.key(3)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    k_mod, k_intr, k_ddpg = jax.random.split(key, 3)
    ddpg = jax_ddpg_noise(k_ddpg)
    noise = SMMNoise(ddpg.critic_normal, ddpg.actor_normal,
                     loss_eps=_t(jax.random.normal(k_mod, (N, 8))),
                     reward_eps=_t(jax.random.normal(k_intr, (N, 8))))
    got = agent._update(tbatch, noise)
    _close_metrics(got, want)
    assert {"loss_vae", "loss_pred", "intr_reward"} <= set(got)
    _close_params(agent.module, new_state.module_params, agent.cfg.lr, "module")
    assert agent.ddpg.actor.mlps[0].Dense_0.weight.shape[1] == OBS + Z
    _close_ddpg_state(agent.ddpg, new_state.ddpg, agent.cfg.lr)


def test_smm_skill_meta_matches_jax() -> None:
    """A uniform one-hot z of width z_dim, resampled by the collector to the
    drawn index at multiples of update_skill_every_step (50), as the JAX
    agent does with its own draw of the same indices."""
    jagent, state, agent = _pair(jsmm.SMMAgent, jsmm.SMMConfig, SMMAgent, SMMConfig,
                                 hidden_dim=32, batch_size=N)
    gen = torch.Generator().manual_seed(4)
    metas = init_meta_batched(agent, gen, 2048)["z"]
    assert metas.shape == (2048, Z) and bool((metas.sum(1) == 1).all())
    assert len(torch.unique(metas.argmax(1))) == Z and agent.meta_dims == {"z": Z}
    noise = agent.step_noise(64, gen)
    assert noise.skill_index.shape == (64,) and int(noise.skill_index.max()) < Z
    skills = torch.eye(Z)[[0, 1, 2, 3]]
    for t in (0, 3, 50, 101):
        key = jax.random.key(t)
        want = jagent.rollout_update_meta(state, {"z": jnp.asarray(skills.numpy())},
                                          jnp.asarray(t), key)["z"]
        idx = _t(jax.random.randint(key, (4,), 0, Z)).long()
        got = agent.rollout_update_meta({"z": skills}, torch.tensor(t),
                                        StepNoise(skill_index=idx))["z"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _proto_noise(key, n: int = N):
    k_cand, k_ddpg = jax.random.split(key)
    ddpg = jax_ddpg_noise(k_ddpg)
    return ProtoNoise(ddpg.critic_normal, ddpg.actor_normal,
                      candidate_gumbel=_t(jax.random.gumbel(k_cand, (PROTO["num_protos"], n))))


@pytest.mark.parametrize("reward_free", [True, False], ids=["intrinsic", "extrinsic"])
def test_proto_update_matches_jax(reward_free) -> None:
    """The swap loss's Adam step (the target predictor's zero gradient
    included), the EMA of the predictor after it, the candidates pushed into
    the queue and the kNN reward, then DDPG on that reward."""
    jagent, state, agent = _pair(jproto.ProtoAgent, jproto.ProtoConfig, ProtoAgent,
                                 ProtoConfig, reward_free=reward_free, **PROTO)
    jbatch, tbatch = _batch(2, skills=False)
    key = jax.random.key(5)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    got = agent._update(tbatch, _proto_noise(key))
    _close_metrics(got, want)
    assert ("intr_reward" in got) == reward_free
    net = new_state.module_params["net"]
    _close_params(agent.module, net, agent.cfg.lr, "module")
    assert agent.module_opt.count == 1
    np.testing.assert_allclose(agent.queue.numpy(), np.asarray(new_state.module_params["queue"]),
                               rtol=RTOL, atol=ATOL)
    assert int(agent.queue_ptr) == int(new_state.module_params["queue_ptr"]) \
        == (PROTO["num_protos"] if reward_free else 0)
    _close_ddpg_state(agent.ddpg, new_state.ddpg, agent.cfg.lr)


def test_proto_queue_wraps_as_in_jax() -> None:
    """Five updates: 8 rows a time into a queue of 20, at ptr % 13 (JAX's
    start, which ``dynamic_update_slice`` would clamp: 16 % 13 = 3), the
    pointer wrapping at 20; the queue and the pointer follow JAX's after
    every update, and the rewards too."""
    jagent, state, agent = _pair(jproto.ProtoAgent, jproto.ProtoConfig, ProtoAgent,
                                 ProtoConfig, **PROTO)
    update = jax.jit(jagent._update)
    pointers = []
    for i in range(5):
        jbatch, tbatch = _batch(10 + i, skills=False)
        key = jax.random.key(20 + i)
        state, want = update(state, jbatch, key)
        got = agent._update(tbatch, _proto_noise(key))
        np.testing.assert_allclose(float(got["intr_reward"]), float(want["intr_reward"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(agent.queue.numpy(), np.asarray(state.module_params["queue"]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"update {i}")
        pointers.append(int(agent.queue_ptr))
        assert pointers[-1] == int(state.module_params["queue_ptr"])
    assert pointers == [8, 16, 4, 12, 0]


def test_proto_state_holds_the_queue() -> None:
    """The queue and its pointer are train state: a checkpoint's dict
    carries them and loads them back."""
    _, _, agent = _pair(jproto.ProtoAgent, jproto.ProtoConfig, ProtoAgent, ProtoConfig,
                        **PROTO)
    agent._update(_batch(1, skills=False)[1], _proto_noise(jax.random.key(0)))
    state = {k: v.clone() for k, v in agent.train_state().items()}
    assert state["queue"].shape == (20, 8) and int(state["queue_ptr"]) == 8
    twin = ProtoAgent(ProtoConfig(**PROTO), OBS, ACT, device="cpu", seed=3)
    twin.load_train_state(state)
    assert torch.equal(twin.queue, agent.queue) and int(twin.queue_ptr) == 8
