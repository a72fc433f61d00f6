"""The evaluation half of the port's offline slice as a whole, on the CPU: a
small FB agent with the JAX agent's weights, the same initial states, short
episodes. The port's rollout against the JAX ``_eval_fn``; ``evaluate``,
``_eval_diagnostics`` and ``finalize`` against the JAX workspace's; the
offline CLI from episodes to ``eval.csv`` and ``test_rewards.json``.

Rollout tolerance: 20 control steps (200 substeps for the walker) of stiff
contacts in float32 with the policy in the loop: rtol 2e-2 with an atol of
5e-3 of each output's largest entry.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch import train_offline
from controllable_agent_torch.convert import load_fb_train_state
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import save_exorl_episodes
from controllable_agent_torch.envs import locomotion
from controllable_agent_torch.goals import get_reward_function
from controllable_agent_torch.pretrain import build_workspace
from controllable_agent_torch.train.loops import Rollout
from torch_threads import one_thread  # noqa: F401

HORIZON, EPISODES = 20, 3
SMALL = ["agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
         "agent.z_dim=8", "agent.batch_size=16", "agent.num_inference_steps=64"]
COMMON = ["agent=fb_ddpg", f"episode_length={HORIZON}", f"num_eval_episodes={EPISODES}",
          "save_eval_video=false", "use_console=false", "z_inference_draws=2",
          "replay_buffer_episodes=4", *SMALL]
ROLLOUT_RTOL, ROLLOUT_ATOL_OF_MAX = 2e-2, 5e-3


def _pair(tmp_path, task: str, *extra: str):
    """A JAX workspace and a port workspace of the same configuration, the
    port's agent loaded with the JAX agent's state."""
    args = [f"task={task}", *COMMON, *extra]
    jws = jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    tws = build_workspace(args + [f"folder={tmp_path}/torch", "device=cpu"])
    load_fb_train_state(tws.agent, jax.tree.map(np.asarray, jws.agent_state))
    return jws, tws


def _uniform_of(keys, nj: int) -> torch.Tensor:
    """The joint draw behind the JAX eval function's reset of each episode
    key: one_episode splits the key, reset splits it again."""
    draws = [jax.random.uniform(jax.random.split(jax.random.split(k)[0])[0], (nj,)) for k in keys]
    return torch.from_numpy(np.stack([np.asarray(d) for d in draws]))


def _close(got: torch.Tensor, want, rtol=ROLLOUT_RTOL, atol_of_max=ROLLOUT_ATOL_OF_MAX) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol_of_max * max(float(np.abs(want).max()), 1e-6))


def _walker_episodes(n: int = 4, steps: int = HORIZON):
    rng = np.random.RandomState(1)
    env = locomotion.make("walker_walk")
    episodes = []
    for _ in range(n):
        q = rng.uniform(-1.0, 1.0, (steps + 1, 9))
        q[:, 1] = rng.uniform(0.6, 1.5, steps + 1)
        physics = np.concatenate([q, rng.randn(steps + 1, 9) * 2], -1).astype(np.float32)
        episodes.append({
            "observation": env.obs_from_physics(torch.from_numpy(physics)).numpy(),
            "action": rng.uniform(-1, 1, (steps + 1, 6)).astype(np.float32),
            "reward": rng.rand(steps + 1, 1).astype(np.float32),
            "discount": np.ones((steps + 1, 1), np.float32), "physics": physics})
    return episodes


@pytest.fixture
def walker_dir(tmp_path):
    store = ReplayBuffer(4, discount=0.98, future=0.99, device="cpu")
    store.load_episodes(_walker_episodes())
    save_exorl_episodes(store.state, tmp_path / "walker")
    return tmp_path / "walker"


@pytest.mark.parametrize("task", ["walker_walk", "hopper_hop"])
def test_eval_rollout_matches_jax(tmp_path, task) -> None:
    """Totals, physics and observations of the port's ``Rollout`` against
    the JAX ``_eval_fn`` from the same initial states under the same z."""
    jws, tws = _pair(tmp_path, task)
    keys = jax.random.split(jax.random.key(7), EPISODES)
    z = np.random.RandomState(0).randn(8).astype(np.float32)
    z *= np.sqrt(8) / np.linalg.norm(z)
    want = jws._make_eval_fn()(jws.agent_state, {"z": jnp.asarray(z)}, keys)
    state, ts = tws.env.reset_from_uniform(_uniform_of(keys, tws.spec.action_dim))
    rollout = Rollout(tws.env, tws.agent, EPISODES)
    totals, physics, obs = rollout(torch.from_numpy(z), state, ts)
    assert physics.shape == (EPISODES, HORIZON, tws.spec.physics_dim)
    _close(totals, want[0])
    _close(physics, want[1])
    _close(obs, want[2])
    assert float(totals.min()) >= 0.0 and float(physics.abs().max()) > 0.0
    # a second run from the same inputs overwrites the buffers with the same values
    first = physics.clone()
    rollout(torch.from_numpy(z), state, ts)
    assert torch.equal(rollout.physics, first)


def test_rollout_takes_a_z_per_episode(tmp_path) -> None:
    """Episodes under different z in one batch equal the same episodes rolled
    out one z at a time (``finalize`` rolls all its tasks out together)."""
    _, tws = _pair(tmp_path, "walker_walk")
    gen = torch.Generator().manual_seed(0)
    zs = tws.agent.sample_z(2, gen)
    state, ts = tws.env.reset(gen, 2)
    both = Rollout(tws.env, tws.agent, 2)
    totals, physics, _ = (x.clone() for x in both(zs, state, ts))
    for i in range(2):
        alone = both(zs[i], state, ts)
        torch.testing.assert_close(alone[1][i], physics[i], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(alone[0][i], totals[i], rtol=1e-4, atol=1e-5)
    assert not torch.allclose(physics[0], both(zs[0], state, ts)[1][1])
    with pytest.raises(ValueError, match="CUDA"):
        Rollout(tws.env, tws.agent, 2, capture=True)
    with pytest.raises(ValueError, match="built for observations"):
        both(zs[0], *tws.env.reset(gen, 3))


def test_evaluate_metrics_match_the_jax_set(tmp_path, walker_dir) -> None:
    """``evaluate()`` logs the JAX workspace's metric keys (no video) into
    eval.csv, with a z inferred from the replay; two evaluations draw
    different initial states; ``custom_reward`` re-scores from the physics."""
    jws, tws = _pair(tmp_path, "walker_walk", "agent.additional_metric=true")
    episodes = _walker_episodes()
    jws.buffer.load_episodes(episodes)
    tws.buffer.load_episodes(episodes)
    want = jws.evaluate()
    got = tws.evaluate()
    assert set(got) == set(want)
    assert {"episode_reward", "episode_reward#std", "episode_length", "z_norm", "z_correl",
            "actor_success", "phys_x_mean", "phys_am_std", "step", "episode"} <= set(got)
    assert got["episode_length"] == HORIZON
    np.testing.assert_allclose(got["z_norm"], np.sqrt(8), rtol=1e-5)
    assert 0.0 <= got["episode_reward"] <= HORIZON and 0.0 <= got["actor_success"] <= 1.0
    first = tws._rollouts[EPISODES].physics.clone()
    again = tws.evaluate()
    assert not torch.equal(tws._rollouts[EPISODES].physics[:, 0], first[:, 0])
    assert tws.eval_rewards_history == [got["episode_reward"], again["episode_reward"]]
    rows = (tmp_path / "torch" / "eval.csv").read_text().splitlines()
    assert len(rows) == 3 and "episode_reward" in rows[0] and "phys_z_min" in rows[0]
    # custom_reward: the totals are that reward summed over the stored physics
    tws.cfg = dataclasses.replace(tws.cfg, custom_reward="walker_run")
    scored = tws.evaluate()
    physics = tws._rollouts[EPISODES].physics
    want_total = get_reward_function("walker_run").from_physics(physics).sum(1)
    np.testing.assert_allclose(scored["episode_reward"], float(want_total.mean()), rtol=1e-6)
    np.testing.assert_allclose(scored["episode_reward#std"],
                               float(want_total.numpy().std()), rtol=1e-4, atol=1e-7)


def test_eval_diagnostics_match_jax(tmp_path) -> None:
    """z_correl on the same rollout data (rtol 1e-4; with a goal space too);
    actor_success against its definition with the same generator state."""
    jws, tws = _pair(tmp_path, "walker_walk", "agent.additional_metric=true")
    rng = np.random.RandomState(3)
    phys = rng.randn(EPISODES, HORIZON, 18).astype(np.float32)
    obs = rng.randn(EPISODES, HORIZON, 24).astype(np.float32)
    z = rng.randn(8).astype(np.float32)
    want = jws._eval_diagnostics({"z": jnp.asarray(z)}, phys, jnp.asarray(obs))
    gen_state = tws.generator.get_state()
    got = tws._eval_diagnostics({"z": torch.from_numpy(z)}, torch.from_numpy(phys),
                                torch.from_numpy(obs))
    assert set(got) == set(want) == {"z_correl", "actor_success"}
    np.testing.assert_allclose(got["z_correl"], want["z_correl"], rtol=1e-4, atol=1e-6)
    tws.generator.set_state(gen_state)
    success = tws.agent.compute_actor_success(torch.from_numpy(obs).flatten(0, 1),
                                              torch.from_numpy(z), tws.generator)
    assert got["actor_success"] == float(success)
    tws.agent_cfg = dataclasses.replace(tws.agent.cfg, additional_metric=False)
    tws.agent.cfg = tws.agent_cfg
    assert tws._eval_diagnostics({"z": torch.from_numpy(z)}, torch.from_numpy(phys),
                                 torch.from_numpy(obs)) == {}


def test_eval_diagnostics_with_a_goal_space(tmp_path) -> None:
    jws, tws = _pair(tmp_path, "walker_walk", "agent.additional_metric=true",
                     "goal_space=simplified_walker")
    rng = np.random.RandomState(4)
    phys = rng.randn(EPISODES, HORIZON, 18).astype(np.float32)
    obs = rng.randn(EPISODES, HORIZON, 24).astype(np.float32)
    z = rng.randn(8).astype(np.float32)
    want = jws._eval_diagnostics({"z": jnp.asarray(z)}, phys, jnp.asarray(obs))
    got = tws._eval_diagnostics({"z": torch.from_numpy(z)}, torch.from_numpy(phys),
                                torch.from_numpy(obs))
    np.testing.assert_allclose(got["z_correl"], want["z_correl"], rtol=1e-4, atol=1e-6)


def test_finalize_matches_the_jax_battery(tmp_path) -> None:
    """``finalize()`` writes the JAX battery's task keys with ``final_tests``
    returns each; every return is that task's reward summed over an episode."""
    jws, tws = _pair(tmp_path, "walker_walk", f"final_tests={EPISODES}")
    episodes = _walker_episodes()
    jws.buffer.load_episodes(episodes)
    tws.buffer.load_episodes(episodes)
    want = jws.finalize()
    got = tws.finalize()
    assert list(got) == list(want) == ["walker_stand", "walker_walk", "walker_run", "walker_flip"]
    assert all(len(v) == EPISODES and all(0.0 <= r <= HORIZON for r in v) for v in got.values())
    assert json.loads((tmp_path / "torch" / "test_rewards.json").read_text()) == got
    physics = tws._rollouts[4 * EPISODES].physics
    for i, task in enumerate(got):
        total = get_reward_function(task).from_physics(physics[i * EPISODES:(i + 1) * EPISODES])
        np.testing.assert_allclose(got[task], total.sum(1).numpy(), rtol=1e-6)
    # nothing to test on: no battery for the domain, no episodes, final_tests=0
    tws.cfg = dataclasses.replace(tws.cfg, final_tests=0)
    assert tws.finalize() == {}
    empty = build_workspace(["task=walker_walk", *COMMON, "final_tests=2", "device=cpu",
                             f"folder={tmp_path}/empty"])
    assert empty.finalize() == {}


@pytest.mark.parametrize("task,tasks", [
    ("walker_walk", ["walker_stand", "walker_walk", "walker_run", "walker_flip"]),
    ("cheetah_run", ["cheetah_walk", "cheetah_walk_backward", "cheetah_run",
                     "cheetah_run_backward"]),
    ("hopper_hop", ["hopper_stand", "hopper_hop", "hopper_hop_backward", "hopper_flip"]),
])
def test_offline_cli_evaluates_and_finalizes(tmp_path, task, tasks) -> None:
    """The offline CLI on the CPU, from episodes to eval.csv rows and a
    test_rewards.json with the domain's four tasks."""
    env = locomotion.make(task)
    rng = np.random.RandomState(2)
    store = ReplayBuffer(4, discount=0.98, future=0.99, device="cpu")
    ndof = env.model.ndof
    episodes = []
    for _ in range(4):
        q = rng.uniform(-1.0, 1.0, (11, ndof))
        q[:, 1] = rng.uniform(0.6, 1.5, 11)
        physics = np.concatenate([q, rng.randn(11, ndof)], -1).astype(np.float32)
        episodes.append({"observation": env.obs_from_physics(torch.from_numpy(physics)).numpy(),
                         "action": rng.uniform(-1, 1, (11, ndof - 3)).astype(np.float32),
                         "reward": np.zeros((11, 1), np.float32),
                         "discount": np.ones((11, 1), np.float32), "physics": physics})
    store.load_episodes(episodes)
    save_exorl_episodes(store.state, tmp_path / "episodes")
    ws = train_offline.main([
        f"replay_dir={tmp_path}/episodes", f"task={task}", *SMALL, "device=cpu",
        "episode_length=10", "num_eval_episodes=2", "eval_every_steps=2", "final_tests=2",
        "save_eval_video=false", "num_grad_steps=4", "steps_per_call=2", "log_every_steps=2",
        "checkpoint_every=0", "replay_buffer_episodes=4", "z_inference_draws=2",
        f"folder={tmp_path}/run"])
    run = tmp_path / "run"
    rows = (run / "eval.csv").read_text().splitlines()
    header = rows[0].split(",")
    assert len(rows) == 3  # evaluations at steps 2 and 4
    assert [float(r.split(",")[header.index("step")]) for r in rows[1:]] == [2.0, 4.0]
    rewards = json.loads((run / "test_rewards.json").read_text())
    assert list(rewards) == tasks
    assert all(len(v) == 2 and all(np.isfinite(v)) for v in rewards.values())
    assert ws.global_step == 4 and len(ws.eval_rewards_history) == 2
    assert (run / "models" / "latest" / "agent.pt").exists()


def test_default_point_mass_task_evaluates(tmp_path) -> None:
    """The default task of ``WorkspaceConfig`` is a point-mass task: its
    evaluation, the 20-goal sweep and the ``maze_multi_goal`` battery."""
    rng = np.random.RandomState(5)
    store = ReplayBuffer(3, discount=0.98, future=0.99, device="cpu")
    store.load_episodes([{
        "observation": (phys := rng.uniform(-0.29, 0.29, (11, 4)).astype(np.float32)),
        "action": rng.uniform(-1, 1, (11, 2)).astype(np.float32),
        "reward": np.zeros((11, 1), np.float32), "discount": np.ones((11, 1), np.float32),
        "physics": phys} for _ in range(3)])
    save_exorl_episodes(store.state, tmp_path / "episodes")
    args = [f"replay_dir={tmp_path}/episodes", *SMALL, "device=cpu", "episode_length=10",
            "num_eval_episodes=2", "eval_every_steps=2", "save_eval_video=false",
            "num_grad_steps=2", "steps_per_call=2", "checkpoint_every=0",
            "replay_buffer_episodes=3", "z_inference_draws=2",
            "goal_space=simplified_point_mass_maze"]
    ws = train_offline.main(args + ["final_tests=2", f"folder={tmp_path}/run"])
    assert ws.cfg.task == "point_mass_maze_reach_top_left" and ws.spec.obs_dim == 4
    rows = (tmp_path / "run" / "eval.csv").read_text().splitlines()
    assert len(rows) == 2 and "phys_vx_mean" in rows[0]
    assert not (tmp_path / "run" / "test_rewards.json").exists()  # no battery for the maze
    multi = train_offline.main(args + ["final_tests=2", "custom_reward=maze_multi_goal",
                                       "eval_every_steps=0", f"folder={tmp_path}/multi"])
    rewards = json.loads((tmp_path / "multi" / "test_rewards.json").read_text())
    assert list(rewards) == ["rewards"] and 0.0 <= rewards["rewards"][0] <= 1.0
    sweep = multi.eval_maze_goals()
    assert set(sweep) == {"reward", "distance", "step"} and sweep["distance"] > 0.0
    assert multi._rollouts[40].physics.shape == (40, 10, 4)  # 20 goals x 2 episodes at once


def test_append_goal_to_observation_widens_the_observation(tmp_path) -> None:
    ws = build_workspace(["task=point_mass_maze_reach_top_left", *COMMON, "device=cpu",
                          "goal_space=simplified_point_mass_maze",
                          "append_goal_to_observation=true", "final_tests=0",
                          f"folder={tmp_path}/run"])
    assert ws.spec.obs_dim == 4 + 2 and ws.agent.obs_dim == 6 and ws.spec.goal_dim == 2
    _, ts = ws.env.reset(ws.generator, 2)
    assert ts.observation.shape == (2, 6) and ts.goal.shape == (2, 2)
    metrics = ws.evaluate()  # rolls out through the wrapper
    assert np.isfinite(metrics["episode_reward"])
    assert ws._base_env() is ws.env.env


def test_evaluation_refuses_a_video_and_a_non_finite_state(tmp_path) -> None:
    """A video is no longer refused: ``save_eval_video=true`` writes the
    first episode as ``eval_video/<step>.png``. A non-finite state raises."""
    ws = build_workspace(["task=walker_walk", *COMMON, "device=cpu", "final_tests=0",
                          "eval_every_steps=0", "save_eval_video=true", f"folder={tmp_path}/a"])
    ws.evaluate()
    assert (tmp_path / "a" / "eval_video" / "0.png").stat().st_size > 0
    ws.cfg = dataclasses.replace(ws.cfg, save_eval_video=False)
    with torch.no_grad():
        next(ws.agent.actor.parameters()).fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite"):
        ws.evaluate()
