"""The port's online entry points on the CPU at small sizes: ``pretrain``,
``train_online`` and ``anytrain`` from the command line to ``train.csv``,
``eval.csv``, a checkpoint, videos and ``test_rewards.json``; a resumed
folder; the directed-rollout mix (the port of
``tests/test_directed_rollout.py``); ``--help``; the agents' registry."""

import csv
import json
import re

import numpy as np
import pytest

from controllable_agent_torch import anytrain, pretrain, train_offline, train_online
from controllable_agent_torch.agents import AGENTS
from torch_threads import one_thread  # noqa: F401

HORIZON = 20
SMALL = ["agent.hidden_dim=32", "agent.batch_size=16"]
FB_SMALL = [*SMALL, "agent.backward_hidden_dim=32", "agent.feature_dim=16", "agent.z_dim=8",
            "agent.num_inference_steps=64", "z_inference_draws=2"]
COMMON = ["device=cpu", "task=walker_walk", f"episode_length={HORIZON}", "num_envs=2",
          "num_eval_episodes=2", "use_console=false", "replay_buffer_episodes=16"]


def _rows(path) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("entry", ["pretrain", "train_online", "anytrain"])
def test_online_entry_points_train_evaluate_and_finalize(tmp_path, entry) -> None:
    """Three cycles of two episodes (for pretrain and anytrain the first is a
    seed cycle without updates): a train row per cycle, an evaluation with its
    video, a checkpoint, and the final battery of the walker's four tasks."""
    main = {"pretrain": pretrain.main, "train_online": train_online.main,
            "anytrain": anytrain.main}[entry]
    folder = tmp_path / "run"
    ws = main([*COMMON, *FB_SMALL, "num_train_frames=120", "num_seed_frames=40",
               "eval_every_steps=80", "checkpoint_every=40", "final_tests=2",
               "num_rollout_episodes=2", "num_agent_updates=4", f"folder={folder}"])
    train = _rows(folder / "train.csv")
    assert [int(float(r["step"])) for r in train] == [40, 80, 120]
    assert all(np.isfinite(float(r["episode_reward"])) for r in train)
    assert "fb_loss" in train[-1] and float(train[-1]["episode"]) == 6
    assert [int(float(r["step"])) for r in _rows(folder / "eval.csv")] == [80]
    assert (folder / "eval_video" / "80.png").exists()
    assert (folder / "models" / "latest" / "replay.pt").exists()
    rewards = json.loads((folder / "test_rewards.json").read_text())
    assert list(rewards) == [f"walker_{t}" for t in ("stand", "walk", "run", "flip")]
    assert all(len(v) == 2 and all(0 <= r <= HORIZON for r in v) for v in rewards.values())
    assert len(ws.buffer) == 6 and ws.global_step == 120
    # pretrain: none in the seed cycle; train_online: num_agent_updates every cycle
    updates = {"train_online": 3 * 4, "pretrain": 80 // 2, "anytrain": 80 // 2}[entry]
    assert ws.agent.step == updates


def test_a_resumed_folder_continues_from_the_saved_step(tmp_path) -> None:
    """The same command with a larger budget continues the counters, the
    replay and the agent's step from ``models/latest``."""
    args = [*COMMON, *FB_SMALL, "num_seed_frames=0", "eval_every_steps=0", "final_tests=0",
            "save_eval_video=false", f"folder={tmp_path}/run"]
    first = pretrain.main([*args, "num_train_frames=40"])
    assert first.global_step == 40 and first.agent.step == 20
    again = pretrain.main([*args, "num_train_frames=80"])
    assert again.global_step == 80 and again.global_episode == 4 and len(again.buffer) == 4
    assert again.agent.step == 40
    steps = [int(float(r["step"])) for r in _rows(tmp_path / "run" / "train.csv")]
    assert steps == [40, 80]


def test_train_online_directed_mix_runs(tmp_path) -> None:
    """Half of each cycle's episodes hold a task z inferred from the replay
    (two tasks); the task rewards are logged once past the seed frames."""
    ws = train_online.main([
        *COMMON, *FB_SMALL, "num_rollout_episodes=4", "num_agent_updates=2",
        f"num_train_frames={HORIZON * 4 * 3}", f"num_seed_frames={HORIZON * 4}",
        "eval_every_steps=0", "final_tests=0", "save_eval_video=false",
        "rollout_task_z_ratio=0.5", "rollout_task_z_tasks=walker_stand,walker_walk",
        "task_z_refresh_frames=1", "z_inference_draws=1", f"folder={tmp_path}"])
    assert ws.global_episode == 12 and len(ws.buffer) == 12  # 3 cycles x (2 random + 2 held)
    train_csv = (tmp_path / "train.csv").read_text()
    assert "task_episode_reward" in train_csv
    assert np.isfinite(float(_rows(tmp_path / "train.csv")[-1]["task_episode_reward"]))


def test_ratio_zero_is_the_plain_loop(tmp_path) -> None:
    ws = train_online.main([
        *COMMON, *FB_SMALL, "num_rollout_episodes=2", "num_agent_updates=1",
        f"num_train_frames={HORIZON * 2 * 2}", "num_seed_frames=0", "eval_every_steps=0",
        "final_tests=0", "save_eval_video=false", f"folder={tmp_path}"])
    assert ws.global_episode == 4 and ws.agent.step == 2


def test_a_frozen_buffer_trains_without_collecting(tmp_path) -> None:
    """``update_replay_buffer=false`` on a resumed folder: the loaded buffer
    stays as it was while the updates and the step go on."""
    args = [*COMMON, *FB_SMALL, "num_rollout_episodes=2", "num_agent_updates=3",
            "num_seed_frames=0", "eval_every_steps=0", "final_tests=0",
            "save_eval_video=false", f"folder={tmp_path}"]
    train_online.main([*args, f"num_train_frames={HORIZON * 2}"])
    ws = train_online.main([*args, f"num_train_frames={HORIZON * 2 * 3}",
                            "update_replay_buffer=false"])
    assert len(ws.buffer) == 2 and ws.global_step == HORIZON * 2 * 3 and ws.agent.step == 9


@pytest.mark.parametrize("agent", ["rnd", "ddpg"])
def test_the_explorers_pretrain_online(tmp_path, agent) -> None:
    """RND and DDPG through ``pretrain``: DDPG's n-step returns reach the
    sampler; RND's intrinsic reward is logged; evaluation runs without a
    task vector and the final battery, which needs one, is skipped."""
    ws = pretrain.main([*COMMON, *SMALL, f"agent={agent}", "num_train_frames=80",
                        "num_seed_frames=40", "eval_every_steps=80", "final_tests=2",
                        f"folder={tmp_path}"])
    assert ws.buffer.cfg.nstep == 3 and ws.agent.step == 20
    row = _rows(tmp_path / "train.csv")[-1]
    assert np.isfinite(float(row["critic_loss"]))
    assert (agent == "rnd") == ("intr_reward" in row)
    assert len(_rows(tmp_path / "eval.csv")) == 1 and not (tmp_path / "test_rewards.json").exists()


def test_the_registry_names_what_is_ported() -> None:
    ported = ["aps", "ddpg", "diayn", "disagreement", "discrete_fb", "discrete_sf", "fb_ddpg",
              "goal_sm", "goal_td3", "icm", "icm_apt", "max_ent", "new_aps", "proto", "rnd",
              "sf", "sf_svd", "smm", "uvf"]
    assert sorted(AGENTS) == ported
    # every agent and option is ported: a d4rl task without its dataset
    # raises the JAX workspace's ValueError
    with pytest.raises(ValueError, match="d4rl_dataset"):
        pretrain.build_workspace(["task=d4rl_hopper", "device=cpu"])
    with pytest.raises(ValueError, match=re.escape(f"known: {ported}")):
        pretrain.build_workspace(["agent=nope", "device=cpu"])


@pytest.mark.parametrize("entry", ["pretrain", "train_online", "anytrain", "train_offline"])
def test_help(capsys, entry) -> None:
    """``--help`` and ``-h`` print the usage, every workspace key and every
    ported agent's keys, and run nothing."""
    main = {"pretrain": pretrain.main, "train_online": train_online.main,
            "anytrain": anytrain.main, "train_offline": train_offline.main}[entry]
    for flag in ("--help", "-h"):
        assert main([flag]) is None
        out = capsys.readouterr().out
        assert f"controllable_agent_torch.{entry}" in out
        assert "num_train_frames=2000010" in out and "save_eval_video=True" in out
        assert "rnd: " in out and "rnd_rep_dim" in out
