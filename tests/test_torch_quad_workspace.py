"""The quadruped and jaco slice as a whole on the CPU, at small widths: a
small FB with the JAX agent's weights rolled out on ``quadruped_walk`` from
the same initial states as the JAX ``_eval_fn``; the online entry points on
the quadruped with the ``quad_pos_speed`` goal space (the recipe of
``results/quad_one``), its final battery and videos; ``train_offline``
relabeling that replay; jaco, escape and fetch through ``pretrain`` and
``anytrain``; ``load_model=`` of a JAX quadruped checkpoint; and FB, SF and
DDPG states of the JAX package on the 3-D domains through ``convert.py``
(the same modules at observation widths 37, 60, 49 and 24, actions 8 and 6).

Rollout tolerance: the policy's actions on the same observations rtol 1e-4;
the physics of three control steps of the robot landing on its feet rtol
1e-3 with an atol of 1e-3 of the largest entry (float32 over 24 substeps of
stiff contacts).
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch import anytrain, pretrain, train_offline, train_online
from controllable_agent_torch.convert import load_train_state
from controllable_agent_torch.pretrain import build_workspace
from controllable_agent_torch.train.loops import Rollout

HORIZON, EPISODES = 3, 3
FB_SMALL = ["agent.hidden_dim=64", "agent.backward_hidden_dim=64", "agent.feature_dim=16",
            "agent.z_dim=8", "agent.batch_size=16", "agent.num_inference_steps=64"]
COMMON = ["use_console=false", "z_inference_draws=2", "replay_buffer_episodes=16"]
BATTERY = [f"quadruped_{t}" for t in ("stand", "walk", "run", "jump")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The engine's products are small (14 x 78 per environment): with the
    test workers sharing the cores, MKL's threads spend their time waiting
    for each other, so this module runs them on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(path) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _close(got: torch.Tensor, want, rtol: float, atol_of_max: float) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol_of_max * max(float(np.abs(want).max()), 1e-6))


def _pair(tmp_path, task: str, *extra: str):
    """A JAX workspace and a port workspace of one configuration, the port's
    agent loaded with the JAX agent's state."""
    args = [f"task={task}", *COMMON, "save_eval_video=false", *extra]
    jws = jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    tws = build_workspace(args + [f"folder={tmp_path}/torch", "device=cpu"])
    load_train_state(tws.agent, jax.tree.map(np.asarray, jws.agent_state))
    return jws, tws


def test_rollout_matches_jax_on_quadruped_walk(tmp_path) -> None:
    """``Rollout`` against the JAX ``_eval_fn``: the same initial states (the
    joint draw behind each episode key) under the same z, the policy's
    actions on JAX's observations, then the totals, physics and
    observations."""
    jws, tws = _pair(tmp_path, "quadruped_walk", "agent=fb_ddpg", *FB_SMALL,
                     f"episode_length={HORIZON}", f"num_eval_episodes={EPISODES}")
    keys = jax.random.split(jax.random.key(7), EPISODES)
    z = np.random.RandomState(0).randn(8).astype(np.float32)
    z *= np.sqrt(8) / np.linalg.norm(z)
    totals, physics, obs = jws._make_eval_fn()(jws.agent_state, {"z": jnp.asarray(z)}, keys)
    u = np.stack([np.asarray(jax.random.uniform(jax.random.split(k)[0], (8,))) for k in keys])
    state, ts = tws.env.reset_from_uniform(torch.from_numpy(u))
    # the policy on the same observations
    flat_obs = np.asarray(obs).reshape(-1, 37)
    zs = np.broadcast_to(z, (len(flat_obs), 8))
    want_action = jws.agent.act(jws.agent_state, jnp.asarray(flat_obs), jnp.asarray(zs),
                                jnp.asarray(0), jax.random.key(0), eval_mode=True)
    got_action = tws.agent.act(torch.from_numpy(flat_obs), torch.from_numpy(zs.copy()), 0,
                               eval_mode=True)
    _close(got_action, want_action, 1e-4, 1e-5)
    got = Rollout(tws.env, tws.agent, EPISODES)(torch.from_numpy(z), state, ts)
    assert got[1].shape == (EPISODES, HORIZON, 28)
    for g, w in zip(got, (totals, physics, obs)):
        _close(g, w, 1e-3, 1e-3)


@pytest.mark.parametrize("entry", ["train_online", "pretrain", "anytrain"])
def test_online_entry_points_on_the_quadruped(tmp_path, entry) -> None:
    """``results/quad_one``'s recipe at a small size (FB, ``quadruped_stand``,
    ``goal_space=quad_pos_speed``): three cycles of two 10-step episodes, an
    evaluation with its video, a checkpoint, and the final battery of the
    quadruped's four tasks (F2)."""
    main = {"train_online": train_online.main, "pretrain": pretrain.main,
            "anytrain": anytrain.main}[entry]
    folder = tmp_path / "run"
    ws = main(["agent=fb_ddpg", "task=quadruped_stand", "goal_space=quad_pos_speed", *FB_SMALL,
               *COMMON, "device=cpu", "episode_length=10", "num_envs=2",
               "num_eval_episodes=2", "num_train_frames=60", "num_seed_frames=20",
               "eval_every_steps=40", "checkpoint_every=20", "final_tests=2",
               "num_rollout_episodes=2", "num_agent_updates=4", f"folder={folder}"])
    assert [int(float(r["step"])) for r in _rows(folder / "train.csv")] == [20, 40, 60]
    assert all(np.isfinite(float(v)) for v in _rows(folder / "train.csv")[-1].values() if v)
    assert [int(float(r["step"])) for r in _rows(folder / "eval.csv")] == [40]
    assert (folder / "eval_video" / "40.png").stat().st_size > 0
    assert "phys_up_mean" in _rows(folder / "eval.csv")[0]
    rewards = json.loads((folder / "test_rewards.json").read_text())
    assert list(rewards) == BATTERY
    assert all(len(v) == 2 and all(0 <= r <= 10 for r in v) for v in rewards.values())
    assert ws.agent.goal_dim == 7 and ws.spec.obs_dim == 37 and len(ws.buffer) == 6
    assert ws.agent.step == {"train_online": 12, "pretrain": 20, "anytrain": 20}[entry]


def test_train_offline_relabels_a_quadruped_replay(tmp_path) -> None:
    """A pretrain run's replay, relabeled for ``quadruped_walk`` from the
    stored physics and trained offline with an evaluation."""
    args = ["agent=fb_ddpg", *FB_SMALL, *COMMON, "device=cpu", "episode_length=10",
            "num_envs=2", "num_eval_episodes=2", "final_tests=0", "save_eval_video=false"]
    pretrain.main([*args, "task=quadruped_stand", "num_train_frames=40", "num_seed_frames=20",
                   "eval_every_steps=0", f"folder={tmp_path}/online"])
    ws = train_offline.main([*args, "task=quadruped_walk", "relabel=true",
                             f"load_replay={tmp_path}/online/models/latest",
                             "num_grad_steps=10", "steps_per_call=5", "log_every_steps=5",
                             "eval_every_steps=5", f"folder={tmp_path}/offline"])
    assert ws.global_step == 10 and len(_rows(tmp_path / "offline" / "eval.csv")) == 2
    stored = ws.buffer.state.storage
    want = ws.env.reward_from_physics(stored["physics"])
    lengths = ws.buffer.state.ep_lengths
    for i in range(len(ws.buffer)):
        n = int(lengths[i])
        torch.testing.assert_close(stored["reward"][i, 1:n + 1, 0], want[i, 1:n + 1])
    assert ws.inferred_z is not None and bool(torch.isfinite(ws.inferred_z).all())


@pytest.mark.parametrize("entry,task", [("pretrain", "jaco_reach_top_left"),
                                        ("anytrain", "quadruped_escape"),
                                        ("anytrain", "quadruped_fetch")])
def test_jaco_escape_and_fetch_train_online(tmp_path, entry, task) -> None:
    """Jaco through ``pretrain`` (its final battery is empty, as in JAX: no
    jaco row), escape and fetch through ``anytrain``, a seed cycle and a
    training cycle each, with an evaluation and its video."""
    main = {"pretrain": pretrain.main, "anytrain": anytrain.main}[entry]
    extra = ["goal_space=quadruped_positions"] if task == "quadruped_fetch" else []
    ws = main(["agent=fb_ddpg", f"task={task}", *FB_SMALL, *COMMON, *extra, "device=cpu",
               "episode_length=8", "num_envs=2", "num_eval_episodes=2", "num_train_frames=32",
               "num_seed_frames=16", "eval_every_steps=32", "final_tests=2",
               f"folder={tmp_path}"])
    assert ws.agent.step == 8 and len(ws.buffer) == 4
    assert ws.spec.obs_dim == {"jaco_reach_top_left": 24, "quadruped_escape": 60,
                               "quadruped_fetch": 49}[task]
    assert (tmp_path / "eval_video" / "32.png").exists()
    if task.startswith("jaco"):
        assert ws.finalize() == {} and not (tmp_path / "test_rewards.json").exists()
    else:  # the quadruped's battery, rolled out on the task's own terrain or arena
        assert list(json.loads((tmp_path / "test_rewards.json").read_text())) == BATTERY


def test_load_model_takes_a_jax_quadruped_checkpoint(tmp_path) -> None:
    """``load_model=`` of a JAX FB folder trained one update on the
    quadruped: the counters and the same policy output."""
    args = ["agent=fb_ddpg", "task=quadruped_walk", "episode_length=10",
            "save_eval_video=false", "use_console=false", "final_tests=0", *FB_SMALL]
    jws = jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    rng = np.random.RandomState(0)
    jws.buffer.load_episodes([{
        "observation": rng.randn(11, 37).astype(np.float32),
        "action": rng.uniform(-1, 1, (11, 8)).astype(np.float32),
        "reward": rng.rand(11, 1).astype(np.float32),
        "discount": np.ones((11, 1), np.float32)} for _ in range(3)])
    batch = jws.buffer.sample(jax.random.key(0), 16)
    jws.agent_state, _ = jws.agent.update(jws.agent_state, batch, jax.random.key(1))
    jws.global_step, jws.global_episode = 7, 3
    jws.save_checkpoint()
    tws = build_workspace(args + ["device=cpu", f"load_model={tmp_path}/jax/models/latest",
                                  f"folder={tmp_path}/torch"])
    assert tws.global_step == 7 and tws.global_episode == 3 and tws.agent.step == 1
    obs = rng.randn(5, 37).astype(np.float32)
    z = rng.randn(5, 8).astype(np.float32)
    want = jws.agent.act(jws.agent_state, jnp.asarray(obs), jnp.asarray(z), jnp.asarray(0),
                         jax.random.key(0), eval_mode=True)
    got = tws.agent.act(torch.from_numpy(obs), torch.from_numpy(z), 0, eval_mode=True)
    _close(got, want, 1e-5, 1e-6)


@pytest.mark.parametrize("agent,task", [("fb_ddpg", "quadruped_escape"),
                                        ("sf", "quadruped_fetch"),
                                        ("ddpg", "jaco_reach_top_right")])
def test_jax_states_convert_on_the_3d_domains(tmp_path, agent, task) -> None:
    """The JAX agent's train state on a 3-D domain loads into the port's
    agent of the same configuration through ``convert.py``, with no new
    state type: the same deterministic actions on the same observations."""
    extra = ["agent.feature_learner=lap"] if agent == "sf" else []
    small = ["agent.hidden_dim=64", "agent.batch_size=16"] + (
        ["agent.feature_dim=16", "agent.z_dim=8"] if agent != "ddpg" else [])
    jws, tws = _pair(tmp_path, task, f"agent={agent}", *small, *extra, "final_tests=0")
    obs_dim, action_dim = tws.spec.obs_dim, tws.spec.action_dim
    assert (obs_dim, action_dim) == {"quadruped_escape": (60, 8), "quadruped_fetch": (49, 8),
                                     "jaco_reach_top_right": (24, 6)}[task]
    rng = np.random.RandomState(2)
    obs = rng.randn(4, obs_dim).astype(np.float32)
    z = rng.randn(4, 8).astype(np.float32)
    meta = {} if agent == "ddpg" else {"z": z}
    want = jws.agent.policy_act(jws.agent_state, jnp.asarray(obs),
                                {k: jnp.asarray(v) for k, v in meta.items()}, jnp.asarray(0),
                                jax.random.key(0), eval_mode=True)
    got = tws.agent.policy_act(torch.from_numpy(obs),
                               {k: torch.from_numpy(v) for k, v in meta.items()}, 0,
                               eval_mode=True)
    assert got.shape == (4, action_dim)
    _close(got, want, 1e-5, 1e-6)
