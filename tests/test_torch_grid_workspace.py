"""The gridworld and the discrete agents through the port's entry points on
the CPU at small widths: ``pretrain``, ``anytrain``, ``train_online`` and
``train_offline``, a resumed folder, ``load_model=`` of a folder written by
the JAX package (same greedy actions), the goal-observation z of
``_init_eval_meta`` against JAX's on the same weights (rtol 2e-4),
``finalize`` on the grid, ``--help``, and the port's analogue of
``tests/test_e2e_gridworld.py``."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch import anytrain, pretrain, train_offline, train_online
from controllable_agent_torch.agents import DiscreteFBAgent, DiscreteFBConfig
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import save_exorl_episodes
from controllable_agent_torch.envs import build_gridworld_task
from controllable_agent_torch.ops import fused_fb
from controllable_agent_torch.train.loops import make_offline_trainer
from torch_threads import one_thread  # noqa: F401

HORIZON = 20
SMALL = ["agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
         "agent.z_dim=8", "agent.batch_size=16"]
COMMON = ["device=cpu", f"episode_length={HORIZON}", "num_envs=2", "num_eval_episodes=2",
          "use_console=false", "replay_buffer_episodes=16", *SMALL]


def _rows(path) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_pretrain_discrete_fb_on_grid_simple_and_resume(tmp_path) -> None:
    """A seed cycle and two training cycles, two evaluations with their
    videos, a checkpoint; no final battery on the grid; the same command
    with a larger budget resumes."""
    folder = tmp_path / "run"
    args = ["agent=discrete_fb", "task=grid_simple", *COMMON, "num_seed_frames=40",
            "eval_every_steps=40", "final_tests=2", f"folder={folder}"]
    launches = dict(fused_fb.launches)
    ws = pretrain.main([*args, "num_train_frames=120"])
    assert [int(float(r["step"])) for r in _rows(folder / "train.csv")] == [40, 80, 120]
    assert "fb_loss" in _rows(folder / "train.csv")[-1]
    evals = _rows(folder / "eval.csv")
    assert [int(float(r["step"])) for r in evals] == [40, 80, 120]
    assert all(0 <= float(r["episode_reward"]) <= HORIZON for r in evals)
    assert abs(float(evals[-1]["z_norm"]) - np.sqrt(8)) < 1e-4
    assert (folder / "eval_video" / "120.png").exists()
    assert not (folder / "test_rewards.json").exists() and ws.finalize() == {}
    assert ws.agent.step == 40 and ws.buffer.state.storage["action"].shape[-1] == 1
    actions = ws.buffer.state.storage["action"][:6, 1:HORIZON + 1]
    assert bool((actions == actions.round()).all()) and set(actions.unique().tolist()) <= set(
        range(5))
    assert dict(fused_fb.launches) == launches  # the fused FB kernels are not on this path
    again = pretrain.main([*args, "num_train_frames=160"])
    assert again.global_step == 160 and again.agent.step == 60 and len(again.buffer) == 8


def _jax_folder(tmp_path, task: str):
    """A small JAX discrete FB workspace after one update, saved by the JAX
    ``save_checkpoint``, and the port's workspace that loads it."""
    args = ["agent=discrete_fb", f"task={task}", f"episode_length={HORIZON}",
            "use_console=false", "final_tests=0", "save_eval_video=false", *SMALL]
    jws = jax_build_workspace([*args, f"folder={tmp_path}/jax"])
    rng = np.random.RandomState(0)
    jws.buffer.load_episodes([{
        "observation": rng.rand(HORIZON + 1, 2).astype(np.float32),
        "action": rng.randint(0, 5, (HORIZON + 1, 1)).astype(np.float32),
        "reward": rng.rand(HORIZON + 1, 1).astype(np.float32),
        "discount": np.ones((HORIZON + 1, 1), np.float32)} for _ in range(3)])
    batch = jws.buffer.sample(jax.random.key(0), 16)
    jws.agent_state, _ = jws.agent.update(jws.agent_state, batch, jax.random.key(1))
    jws.global_step, jws.global_episode = 40, 2
    jws.save_checkpoint()
    ws = pretrain.build_workspace([*args, "device=cpu", f"folder={tmp_path}/port",
                                   f"load_model={tmp_path}/jax/models/latest"])
    assert ws.agent.step == 1 and ws.global_step == 40
    return jws, ws


def test_goal_observation_z_matches_jax_on_the_same_weights(tmp_path) -> None:
    """``load_model=`` of a JAX discrete FB folder: the same greedy actions
    as the JAX agent on the same observations, and the goal-observation z of
    ``_init_eval_meta`` equal to JAX's on ``grid_obstacle``, whose goal is
    fixed."""
    jws, ws = _jax_folder(tmp_path, "grid_obstacle")
    np.testing.assert_allclose(ws._init_eval_meta()["z"].numpy(),
                               np.asarray(jws._init_eval_meta()["z"]), rtol=2e-4, atol=1e-5)
    rng = np.random.RandomState(1)
    obs = rng.rand(64, 2).astype(np.float32)
    zs = np.array(jws.agent.sample_z(jax.random.key(2), 64))
    want = jws.agent.act(jws.agent_state, jnp.asarray(obs), jnp.asarray(zs), jnp.asarray(0),
                         jax.random.key(3), eval_mode=True)
    got = ws.agent.act(torch.from_numpy(obs), torch.from_numpy(zs), 0, eval_mode=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grid_simple_evaluates_with_the_goal_of_its_own_reset(tmp_path) -> None:
    """On ``grid_simple`` the z is B of the goal observation of one reset
    drawn from the workspace's generator (not the evaluation episodes'
    goals, as in JAX): held against JAX's ``get_goal_meta`` of that
    observation on the same weights."""
    jws, ws = _jax_folder(tmp_path, "grid_simple")
    replay = torch.Generator().manual_seed(0)
    replay.set_state(ws.generator.get_state())
    z = ws._init_eval_meta()["z"]
    state, _ = ws.env.reset(replay, 1)
    assert torch.equal(replay.get_state(), ws.generator.get_state())
    goal_obs = ws.env.get_goal_obs(state)[0].numpy()
    want = jws.agent.get_goal_meta(jws.agent_state, jnp.asarray(goal_obs))
    np.testing.assert_allclose(z.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("entry", ["pretrain", "anytrain"])
def test_discrete_sf_evaluates_with_a_random_z(tmp_path, entry) -> None:
    """Discrete SF has no goal or inference API: the evaluation takes
    ``init_meta``'s random z, as in JAX."""
    main = {"pretrain": pretrain.main, "anytrain": anytrain.main}[entry]
    ws = main(["agent=discrete_sf", "agent.feature_learner=lap", "task=grid_simple", *COMMON,
               "num_train_frames=80", "num_seed_frames=40", "eval_every_steps=80",
               "final_tests=2", f"folder={tmp_path}"])
    row = _rows(tmp_path / "train.csv")[-1]
    assert np.isfinite(float(row["sf_loss"])) and np.isfinite(float(row["phi_loss"]))
    assert ws.agent.step == 20 and len(_rows(tmp_path / "eval.csv")) == 1
    z1, z2 = ws._init_eval_meta()["z"], ws._init_eval_meta()["z"]
    assert not torch.equal(z1, z2) and abs(float(z1.norm()) - np.sqrt(8)) < 1e-5
    assert ws.finalize() == {}


def test_train_online_and_train_offline_on_grid_episodes(tmp_path) -> None:
    """``train_online`` collects and trains on ``grid_obstacle``; its
    episodes, written as ExORL files, train ``train_offline`` with the
    stored rewards (no grid reward functions exist, so ``relabel=true``
    raises), which prints the goal-observation z."""
    ws = train_online.main(["agent=discrete_fb", "task=grid_obstacle", *COMMON,
                            "num_train_frames=120", "num_rollout_episodes=2",
                            "num_agent_updates=4", "num_seed_frames=40", "eval_every_steps=0",
                            "final_tests=0", f"folder={tmp_path}/online"])
    assert ws.agent.step == 12 and len(ws.buffer) == 6
    episodes = tmp_path / "episodes"
    assert save_exorl_episodes(ws.buffer.state, episodes) == 6
    args = ["agent=discrete_fb", "task=grid_obstacle", f"replay_dir={episodes}", *COMMON,
            "num_grad_steps=10", "steps_per_call=5", "log_every_steps=5",
            "eval_every_steps=5", "final_tests=2", "save_eval_video=false"]
    with pytest.raises(ValueError, match="Unknown reward function 'grid_obstacle'"):
        train_offline.main([*args, f"folder={tmp_path}/relabel"])
    off = train_offline.main([*args, "relabel=false", f"folder={tmp_path}/offline"])
    assert off.global_step == 10 and len(_rows(tmp_path / "offline" / "eval.csv")) == 2
    state, _ = off.env.reset(torch.Generator(), 1)
    want = off.agent.get_goal_meta(off.env.get_goal_obs(state)[0])
    assert torch.allclose(off.inferred_z, want)


def test_help_lists_the_discrete_agents(capsys) -> None:
    assert pretrain.main(["--help"]) is None
    out = capsys.readouterr().out
    assert "discrete_fb: " in out and "discrete_sf: " in out and "expl_eps" in out
    assert "task=grid_simple" in out
    with pytest.raises(ValueError, match="has a discrete one"):
        pretrain.build_workspace(["agent=fb_ddpg", "task=grid_simple", "device=cpu"])
    with pytest.raises(ValueError, match="has a continuous one"):
        pretrain.build_workspace(["agent=discrete_fb", "task=walker_walk", "device=cpu"])


def _random_episodes(env, n: int, seed: int) -> dict:
    """``n`` random-policy episodes of ``env``, [T+1, n, ...] as the
    collector lays them out."""
    gen = torch.Generator().manual_seed(seed)
    state, ts = env.reset(gen, n)
    steps = [ts]
    for _ in range(env.spec.episode_length):
        state, ts = env.step(state, torch.randint(0, 5, (n,), generator=gen).float())
        steps.append(ts)
    return {"observation": torch.stack([s.observation for s in steps]),
            "action": torch.stack([s.action for s in steps]),
            "reward": torch.stack([s.reward for s in steps])[..., None],
            "discount": torch.stack([s.discount for s in steps])[..., None],
            "physics": torch.stack([s.physics for s in steps])}


def test_discrete_fb_learns_gridworld() -> None:
    """``tests/test_e2e_gridworld.py`` on the port: random episodes on
    ``grid_obstacle``, 600 updates, then the greedy policy under z = B(goal
    observation) comes at least as close to the goal as the start was."""
    torch.manual_seed(0)
    env = build_gridworld_task("obstacle", max_episode_length=30)
    buf = ReplayBuffer(max_episodes=40, discount=0.98, future=0.99, device="cpu")
    buf.add_trajectory(_random_episodes(env, 40, 0), env.spec.episode_length)
    cfg = DiscreteFBConfig(hidden_dim=64, backward_hidden_dim=64, feature_dim=32, z_dim=16,
                           batch_size=256, fb_target_tau=0.05)
    agent = DiscreteFBAgent(cfg, env.spec.obs_dim, env.spec.n_actions, device="cpu", seed=1)
    trainer = make_offline_trainer(agent, buf.cfg, cfg.batch_size, steps_per_call=100)
    gen = torch.Generator().manual_seed(2)
    for _ in range(6):
        metrics = trainer(buf.state, gen)
    assert np.isfinite(float(metrics["fb_loss"]))
    state, ts = env.reset(torch.Generator().manual_seed(3), 1)
    z = agent.get_goal_meta(env.get_goal_obs(state)[0])
    start = int((state.pos - state.goal).abs().sum())
    dists = []
    for _ in range(30):
        action = agent.act(ts.observation, z[None], 10 ** 6, eval_mode=True)
        state, ts = env.step(state, action.float())
        dists.append(int((state.pos - state.goal).abs().sum()))
    assert min(dists) <= start
