"""The port's analysis tools (``controllable_agent_torch/tools/{buffer_stats,
replay_stats,z_study}.py``) against the root ``tools/`` of the JAX package on
the same small inputs, at rtol 1e-5: the quantiles and reward fractions of
the same episodes and replay, and z_study's statistics (reward quantiles,
Cov(B)'s eigenspectrum, draw coherences) on the same rows with the same
weights. The port's own draws are held on their distribution."""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import controllable_agent_tpu.pretrain as jax_pretrain
import controllable_agent_torch.pretrain as torch_pretrain
from controllable_agent_tpu.data.replay import ReplayBuffer as JaxReplayBuffer
from controllable_agent_tpu.train import checkpoint as jax_ckpt
from controllable_agent_torch.convert import load_fb_train_state
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.goals import get_reward_function
from controllable_agent_torch.pretrain import build_workspace
from controllable_agent_torch.tools import buffer_stats, replay_stats, z_study
from controllable_agent_torch.train import checkpoint as ckpt_lib
from controllable_agent_torch.train.workspace import OfflineWorkspace
from torch_small_run import small_run, walker_episodes
from tools import buffer_stats as jax_buffer_stats
from tools import replay_stats as jax_replay_stats
from tools import z_study as jax_z_study

RTOL = 1e-5
ROWS = 64  # z_study's num_inference_steps


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, path: str = "") -> None:
    """Equal structure; numbers at RTOL; everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}/{i}")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7, err_msg=path)
    else:
        assert got == want, path


def _run_jax_tool(module, argv, monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    module.main()


def test_buffer_stats_matches_jax(tmp_path, monkeypatch) -> None:
    """MuJoCo-layout walker episodes (raw [qpos, qvel])."""
    rng = np.random.RandomState(0)
    d = tmp_path / "eps"
    d.mkdir()
    for i in range(3):
        physics = rng.randn(26, 18).astype(np.float32) * 0.5
        physics[:, 0] = rng.uniform(-0.6, 0.2, 26)  # root height about 1.3 m lower
        np.savez(d / f"episode_{i:06d}_25.npz", physics=physics,
                 observation=rng.randn(26, 24).astype(np.float32))
    argv = ["--dir", str(d), "--physics-format", "mujoco_walker",
            "--tasks", "walker_stand,walker_walk,walker_run"]
    got = buffer_stats.main([*argv, "--out", str(tmp_path / "got.json"), "--device", "cpu"])
    _run_jax_tool(jax_buffer_stats, [*argv, "--out", str(tmp_path / "want.json")], monkeypatch)
    want = json.loads((tmp_path / "want.json").read_text())
    _close(got, want)
    _close(json.loads((tmp_path / "got.json").read_text()), want)
    assert got["frames"] == 78 and any(t["frame_frac_gt_0.5"] > 0 for t in got["tasks"].values())


def _quad_episodes(n: int = 3, steps: int = 40):
    rng = np.random.RandomState(1)
    episodes = []
    for _ in range(n):
        goal = np.concatenate([rng.uniform(-1, 1, (steps + 1, 1)), np.zeros((steps + 1, 1)),
                               rng.randn(steps + 1, 2), rng.uniform(0, 1, (steps + 1, 1)),
                               rng.randn(steps + 1, 3) * 2], -1).astype(np.float32)
        episodes.append({"observation": rng.randn(steps + 1, 10).astype(np.float32),
                         "action": rng.uniform(-1, 1, (steps + 1, 12)).astype(np.float32),
                         "reward": np.zeros((steps + 1, 1), np.float32),
                         "discount": np.ones((steps + 1, 1), np.float32), "goal": goal})
    return episodes


def test_replay_stats_matches_jax(tmp_path, monkeypatch) -> None:
    """One replay with a quad_pos_speed goal column, saved by each package."""
    episodes = _quad_episodes()
    buf = ReplayBuffer(4, discount=0.98, future=0.99, device="cpu")
    buf.load_episodes(episodes)
    ckpt_lib.save_checkpoint(tmp_path / "torch" / "models" / "latest",
                             {"replay": buf.state, "global_step": 0, "global_episode": 0})
    jbuf = JaxReplayBuffer(4, discount=0.98, future=0.99)
    jbuf.load_episodes(episodes)
    jax_ckpt.save_checkpoint(tmp_path / "jax" / "models" / "latest",
                             {"replay": jbuf.state, "global_step": 0, "global_episode": 0})
    tasks = ["--tasks", "quadruped_walk,quadruped_run", "--thresholds", "0.5,2.5"]
    got = replay_stats.main(["--folder", str(tmp_path / "torch"), *tasks, "--device", "cpu"])
    _run_jax_tool(jax_replay_stats, ["--folder", str(tmp_path / "jax"), *tasks,
                                     "--out", str(tmp_path / "want.json")], monkeypatch)
    _close(got, json.loads((tmp_path / "want.json").read_text()))
    assert got["frames"] == 3 * 40 and 0 < got["frac_frames_above_0.5"] < 1


class _FixedRows:
    """A replay's ``sample`` that returns the first n of fixed rows, with
    the rewards of ``custom_reward`` of their physics."""

    def __init__(self, obs: np.ndarray, physics: np.ndarray, as_array) -> None:
        self.obs, self.physics, self.as_array = obs, physics, as_array

    def __call__(self, key, n, custom_reward=None, with_physics=False):
        physics = self.as_array(self.physics[:n])
        return types.SimpleNamespace(next_obs=self.as_array(self.obs[:n]), next_goal=None,
                                     reward=custom_reward(physics), physics=physics)


def test_z_study_matches_jax_on_the_same_rows(tmp_path, monkeypatch) -> None:
    args = ["agent=fb_ddpg", "task=walker_walk", "use_console=false", "save_eval_video=false",
            "replay_buffer_episodes=4", "agent.hidden_dim=32", "agent.backward_hidden_dim=32",
            "agent.feature_dim=16", "agent.z_dim=8", "agent.batch_size=16",
            f"agent.num_inference_steps={ROWS}"]
    jws = jax_pretrain.build_workspace(args + [f"folder={tmp_path}/jax"], offline=True)
    tws = build_workspace(args + [f"folder={tmp_path}/torch", "device=cpu"], OfflineWorkspace)
    load_fb_train_state(tws.agent, jax.tree.map(np.asarray, jws.agent_state))
    episodes = walker_episodes(n=9, steps=30)
    physics = np.concatenate([ep["physics"] for ep in episodes])[:4 * ROWS]
    obs = np.concatenate([ep["observation"] for ep in episodes])[:4 * ROWS]
    jws.buffer.load_episodes(episodes)
    tws.buffer.load_episodes(episodes)
    jws.buffer.sample = _FixedRows(obs, physics, jnp.asarray)
    tws.buffer.sample = _FixedRows(obs, physics, torch.from_numpy)
    monkeypatch.setattr(jax_pretrain, "build_workspace", lambda *a, **k: jws)
    monkeypatch.setattr(torch_pretrain, "build_workspace", lambda *a, **k: tws)
    argv = ["--folder", "unused", "--tasks", "walker_walk,walker_run", "--draws", "3",
            "--eval-episodes", "0"]
    got = z_study.main([*argv, "--out", str(tmp_path / "got.json"), "--device", "cpu"])
    _run_jax_tool(jax_z_study, [*argv, "--out", str(tmp_path / "want.json")], monkeypatch)
    want = json.loads((tmp_path / "want.json").read_text())
    _close(got, want)
    assert want["cov_B"]["eig_min"] > 0 and want["tasks"]["walker_walk"]["reward"]["max"] > 0


def test_z_study_draws_on_their_distribution(tmp_path) -> None:
    """The port's own sampler (a small run's replay): more samples per draw
    make the draws more coherent, the reward sample's mean is within four
    standard errors of the mean over every row the sampler draws from, and
    the rollouts' returns are finite episode sums."""
    folder = tmp_path / "run"
    ws = small_run(folder)
    report = z_study.main(["--folder", str(folder), "--tasks", "walker_walk", "--draws", "8",
                           "--eval-episodes", "2", "--per-draw-evals", "2",
                           "--out", str(tmp_path / "z.json"), "--device", "cpu"])
    entry = report["tasks"]["walker_walk"]
    coherence = {k: v["coherence"] for k, v in entry["protocols"].items()}
    assert coherence["plain_4x"] > coherence["plain"]
    assert coherence["whitened_4x"] > coherence["whitened"]
    storage = ws.buffer.state.storage
    rewards = get_reward_function("walker_walk").from_physics(storage["physics"][:, 1:]).numpy()
    n = 4 * report["num_inference_steps"]
    assert abs(entry["reward"]["mean"] - rewards.mean()) < 4 * rewards.std() / np.sqrt(n)
    returns = entry["returns"]
    assert len(returns["plain_per_draw_mean"]) == 2 and len(returns["whitened_mean"]) == 2
    assert all(0.0 <= r <= 30 for r in returns["plain_spherical_mean"])
    assert json.loads((tmp_path / "z.json").read_text()) == report
