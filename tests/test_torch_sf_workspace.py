"""SF and SF-SVD through the port's entry points on the CPU, at small
widths: ``train_offline`` from relabeled walker episodes through evaluation
and ``finalize()``, a resumed folder that continues to the bit, a short
``pretrain agent=sf``, a JAX ``sf`` / ``sf_svd`` checkpoint folder read with
``load_model=``, the workspace's task inference on either regression API,
and the CLI's feature learners."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch import pretrain, train_offline
from controllable_agent_torch.agents import (FEATURE_LEARNERS, SFAgent, SFSVDAgent,
                                             agent_classes)
from controllable_agent_torch.convert import flax_to_state_dict
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import save_exorl_episodes
from controllable_agent_torch.envs import locomotion
from torch_threads import one_thread  # noqa: F401

SMALL = ["agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
         "agent.z_dim=8", "agent.batch_size=16", "agent.num_inference_steps=64"]
COMMON = ["task=walker_walk", "device=cpu", "use_console=false", "save_eval_video=false",
          "replay_buffer_episodes=4", "z_inference_draws=2", "steps_per_call=2",
          "log_every_steps=2", "episode_length=10", *SMALL]
WALKER_TASKS = [f"walker_{t}" for t in ("stand", "walk", "run", "flip")]
AGENTS = {"sf": ["agent=sf", "agent.feature_learner=lap"], "sf_svd": ["agent=sf_svd"]}


@pytest.fixture(scope="module")
def walker_dir(tmp_path_factory):
    """4 walker-shaped episodes of 20 steps with native physics; stored
    rewards of -1, so that a relabeled run is told from one that is not."""
    rng = np.random.RandomState(1)
    env = locomotion.make("walker_walk")
    store = ReplayBuffer(4, discount=0.98, future=0.99, device="cpu")
    episodes = []
    for _ in range(4):
        q = rng.uniform(-1.0, 1.0, (21, 9))
        q[:, 1] = rng.uniform(0.6, 1.5, 21)
        physics = np.concatenate([q, rng.randn(21, 9) * 2], -1).astype(np.float32)
        episodes.append({
            "observation": env.obs_from_physics(torch.from_numpy(physics)).numpy(),
            "action": rng.uniform(-1, 1, (21, 6)).astype(np.float32),
            "reward": -np.ones((21, 1), np.float32),
            "discount": np.ones((21, 1), np.float32), "physics": physics})
    store.load_episodes(episodes)
    folder = tmp_path_factory.mktemp("episodes") / "walker"
    save_exorl_episodes(store.state, folder)
    return folder


@pytest.mark.parametrize("agent", list(AGENTS))
def test_offline_entry_point_evaluates_and_finalizes(walker_dir, tmp_path, agent) -> None:
    """8 relabeled updates, an evaluation every 4, the final battery of the
    walker's four tasks, and the inferred z of norm sqrt(z_dim)."""
    ws = train_offline.main([f"replay_dir={walker_dir}", *COMMON, *AGENTS[agent],
                             "num_grad_steps=8", "eval_every_steps=4", "num_eval_episodes=2",
                             "final_tests=2", f"folder={tmp_path}/run"])
    assert ws.global_step == 8 and ws.agent.step == 8
    assert float(ws.buffer.state.storage["reward"].min()) > -1  # relabeled for walker_walk
    row = ws.last_row
    assert {"sf_loss", "phi_loss", "actor_loss"} <= set(row)
    assert all(np.isfinite(v) for v in row.values())
    evals = (tmp_path / "run" / "eval.csv").read_text().splitlines()
    assert len(evals) == 3  # the header and the evaluations at steps 4 and 8
    rewards = json.loads((tmp_path / "run" / "test_rewards.json").read_text())
    assert list(rewards) == WALKER_TASKS
    assert all(len(v) == 2 and all(np.isfinite(r) and 0 <= r <= 10 for r in v)
               for v in rewards.values())
    assert ws.inferred_z.shape == (8,)
    np.testing.assert_allclose(float(ws.inferred_z.norm()), np.sqrt(8), rtol=1e-5)


@pytest.mark.parametrize("agent", ["sf_contrastive", "sf_svd"])
def test_a_resumed_folder_continues_to_the_bit(walker_dir, tmp_path, agent) -> None:
    """4 updates, then the same command to 8 from ``models/latest``, equals
    8 updates in one run: every tensor of the agent's state and the
    generator (the contrastive learner reads the sampled future states)."""
    args = [f"replay_dir={walker_dir}", *COMMON, "eval_every_steps=0", "final_tests=0",
            *(["agent=sf", "agent.feature_learner=contrastive"] if agent != "sf_svd"
              else AGENTS["sf_svd"])]
    train_offline.main(args + ["num_grad_steps=4", f"folder={tmp_path}/a"])
    resumed = train_offline.main(args + ["num_grad_steps=8", f"folder={tmp_path}/a"])
    straight = train_offline.main(args + ["num_grad_steps=8", f"folder={tmp_path}/b"])
    assert resumed.agent.step == straight.agent.step == 8
    got, want = resumed.agent.train_state(), straight.agent.train_state()
    assert set(got) == set(want)
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    assert not unequal
    assert torch.equal(resumed.generator.get_state(), straight.generator.get_state())


def test_pretrain_sf_online(tmp_path) -> None:
    """``pretrain agent=sf`` for 200 frames: a seed cycle, then cycles of
    collection and updates, an evaluation and the final battery."""
    ws = pretrain.main(["agent=sf", "agent.feature_learner=latent", *COMMON[:-6], *SMALL,
                        "episode_length=20", "num_envs=2", "num_seed_frames=40",
                        "num_train_frames=200", "eval_every_steps=120", "num_eval_episodes=2",
                        "final_tests=2", "checkpoint_every=80", f"folder={tmp_path}/run"])
    assert ws.global_step == 200 and ws.agent.step == 160 // 2
    assert "phi_loss" in ws.last_row and all(np.isfinite(v) for v in ws.last_row.values())
    assert len((tmp_path / "run" / "eval.csv").read_text().splitlines()) == 2
    rewards = json.loads((tmp_path / "run" / "test_rewards.json").read_text())
    assert list(rewards) == WALKER_TASKS
    assert (tmp_path / "run" / "models" / "latest" / "agent.pt").exists()


@pytest.mark.parametrize("agent", ["sf_svd_sr", "sf_svd"])
def test_load_model_takes_a_jax_sf_folder(tmp_path, agent) -> None:
    """A JAX workspace after one update, saved by the JAX ``save_checkpoint``
    and read with ``load_model=``: every network (the learner's targets
    included), Adam's moments, ``inv_cov``, the counters and the policy."""
    picked = (["agent=sf", "agent.feature_learner=svd_sr"] if agent == "sf_svd_sr"
              else ["agent=sf_svd"])
    args = [*picked, "task=walker_walk", "episode_length=10", "save_eval_video=false",
            "use_console=false", "final_tests=0", *SMALL]
    jws = jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    rng = np.random.RandomState(0)
    jws.buffer.load_episodes([{
        "observation": rng.randn(11, 24).astype(np.float32),
        "action": rng.uniform(-1, 1, (11, 6)).astype(np.float32),
        "reward": rng.rand(11, 1).astype(np.float32),
        "discount": np.ones((11, 1), np.float32)} for _ in range(3)])
    batch = jws.buffer.sample(jax.random.key(0), 16)
    jws.agent_state, _ = jws.agent.update(jws.agent_state, batch, jax.random.key(1))
    jws.global_step, jws.global_episode = 7, 3
    jws.save_checkpoint()
    tws = pretrain.build_workspace(args + ["device=cpu", f"folder={tmp_path}/torch",
                                          f"load_model={tmp_path}/jax/models/latest"])
    assert tws.global_step == 7 and tws.global_episode == 3 and tws.agent.step == 1
    state = jax.tree.map(np.asarray, jws.agent_state)
    learner = ((tws.agent.feature_learner, state.feature_params) if agent == "sf_svd_sr"
               else (tws.agent.svd, state.svd_params))
    for module, tree in ((tws.agent.actor, state.actor_params),
                         (tws.agent.successor_net, state.sf_params),
                         (tws.agent.target_successor_net, state.target_sf_params), learner):
        want = flax_to_state_dict(tree)
        got = module.state_dict()
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert tws.agent.sf_opt.count == 1
    mu = flax_to_state_dict(state.sf_opt_state[0].mu)
    assert all(torch.equal(tws.agent.sf_opt.mu[k], mu[k]) for k in mu)
    if agent == "sf_svd_sr":
        assert torch.equal(tws.agent.inv_cov, torch.from_numpy(np.array(state.inv_cov)))
    obs = rng.randn(5, 24).astype(np.float32)
    z = rng.randn(5, 8).astype(np.float32)
    want = jws.agent.act(jws.agent_state, jnp.asarray(obs), jnp.asarray(z), jnp.asarray(0),
                         jax.random.key(0), eval_mode=True)
    got = tws.agent.act(torch.from_numpy(obs), torch.from_numpy(z), 0, eval_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("agent", list(AGENTS))
def test_task_inference_takes_the_agents_regression(walker_dir, tmp_path, agent) -> None:
    """The workspace regresses z on the next state (SF) or on the next state
    and the action (SF-SVD), as does the agent mixin's ``infer_meta``."""
    ws = train_offline.main([f"replay_dir={walker_dir}", *COMMON, *AGENTS[agent],
                             "num_grad_steps=2", "eval_every_steps=0", "final_tests=0",
                             f"folder={tmp_path}/run"])
    before = ws.generator.get_state()
    got = ws._infer_meta_from_replay(None, draws=1)
    ws.generator.set_state(before)
    batch = ws.buffer.sample(ws.generator, ws.agent.cfg.num_inference_steps)
    if agent == "sf_svd":
        want = ws.agent.infer_meta_from_obs_action_and_rewards(batch.next_obs, batch.action,
                                                               batch.reward)
    else:
        want = ws.agent.infer_meta_from_obs_and_rewards(batch.next_obs, batch.reward)
    assert torch.equal(got, want)
    ws.generator.set_state(before)
    assert torch.equal(ws.agent.infer_meta(ws.buffer, ws.generator)["z"], want)


@pytest.mark.parametrize("learner", sorted(FEATURE_LEARNERS))
def test_every_feature_learner_builds_from_the_cli(tmp_path, learner) -> None:
    ws = pretrain.build_workspace(["agent=sf", f"agent.feature_learner={learner}", *COMMON,
                                   f"folder={tmp_path}/run"])
    assert isinstance(ws.agent, SFAgent)
    assert ws.agent.cfg.z_dim == (24 if learner == "identity" else 8)


def test_the_registry_and_an_unknown_learner(tmp_path) -> None:
    assert agent_classes("sf")[1] is SFAgent and agent_classes("sf_svd")[1] is SFSVDAgent
    with pytest.raises(ValueError, match="known: \\['autoencoder', 'contrastive'"):
        pretrain.build_workspace(["agent=sf", "agent.feature_learner=nope", *COMMON,
                                  f"folder={tmp_path}/run"])
