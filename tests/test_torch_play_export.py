"""``play_behaviors`` and ``export_replay`` of the port on the CPU, over a
small run's folder: the files ``play_behaviors`` writes and its returns
against a ``Rollout`` of the same z from the same initial states; the
export's episodes against the checkpoint's replay to the bit; the unknown-key
and no-replay errors against the JAX tool's."""

import json

import numpy as np
import pytest
import torch

from controllable_agent_tpu import export_replay as jax_export_replay
from controllable_agent_tpu.train import checkpoint as jax_ckpt
from controllable_agent_torch import export_replay, play_behaviors
from controllable_agent_torch.data.exorl import load_exorl_episodes
from controllable_agent_torch.goals import get_reward_function
from controllable_agent_torch.pretrain import build_workspace
from controllable_agent_torch.train import checkpoint as ckpt_lib
from controllable_agent_torch.train.loops import Rollout
from controllable_agent_torch.train.workspace import OfflineWorkspace
from torch_small_run import small_run

EPISODES = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    run = tmp_path_factory.mktemp("play") / "run"
    small_run(run)
    return run


def test_play_behaviors_writes_rewards_and_videos(folder) -> None:
    summary = play_behaviors.main([f"folder={folder}", "play_task=walker_run",
                                   f"num_episodes={EPISODES}", "device=cpu"])
    written = json.loads((folder / "play_rewards.json").read_text())
    assert written == summary and written["task"] == "walker_run"
    assert len(written["rewards"]) == EPISODES
    assert all(np.isfinite(r) and 0.0 <= r <= 30 for r in written["rewards"])
    for ep in range(EPISODES):
        assert (folder / "eval_video" / f"play_{ep}.png").stat().st_size > 0

    # the same z (relabeled draws from the restored generator) and initial
    # states through a Rollout of a fresh workspace on the folder
    ws = build_workspace([f"folder={folder}", "device=cpu"], OfflineWorkspace)
    z = ws._infer_meta_from_replay(get_reward_function("walker_run", ws.cfg.seed))
    state, ts = ws.env.reset(ws.generator, EPISODES)
    totals, _, _ = Rollout(ws.env, ws.agent, EPISODES)(z, state, ts)
    assert totals.tolist() == written["rewards"]


def test_play_behaviors_without_task_takes_the_eval_z(folder) -> None:
    """No ``play_task``: the z that evaluation chooses; ``task=`` goes to the
    workspace (the JAX tool's quirk)."""
    summary = play_behaviors.main([f"folder={folder}", "task=walker_stand",
                                   "num_episodes=2", "device=cpu"])
    assert summary["task"] == "walker_stand" and len(summary["rewards"]) == 2


def test_export_replay_round_trips(folder, tmp_path) -> None:
    export_replay.main([f"checkpoint={folder}/models/latest", f"out_dir={tmp_path}/eps",
                        "device=cpu"])
    replay = ckpt_lib.load_checkpoint(folder / "models" / "latest", only=["replay"])["replay"]
    episodes = list(load_exorl_episodes(tmp_path / "eps"))
    assert len(episodes) == replay.n_episodes
    for i, episode in enumerate(episodes):
        t = int(replay.ep_lengths[i]) + 1
        assert set(episode) == set(replay.storage)
        for key, stored in replay.storage.items():
            assert np.array_equal(episode[key], stored[i, :t].numpy()), key


def _error(main, argv) -> str:
    with pytest.raises(ValueError) as err:
        main(argv)
    return str(err.value)


def test_export_errors_match_jax(folder, tmp_path) -> None:
    unknown = ["checkpoint=x", "out_dir=y", "bogus=1", "other=2"]
    assert _error(export_replay.main, unknown) == _error(jax_export_replay.main, unknown)
    # a checkpoint without a replay, in each package's format
    ckpt_lib.save_checkpoint(tmp_path / "torch", {"global_step": 3, "global_episode": 1})
    jax_ckpt.save_checkpoint(tmp_path / "jax", {"global_step": 3, "global_episode": 1})
    got = _error(export_replay.main, [f"checkpoint={tmp_path}/torch", "out_dir=y", "device=cpu"])
    want = _error(jax_export_replay.main, [f"checkpoint={tmp_path}/jax", "out_dir=y"])
    assert got == want.replace(f"{tmp_path}/jax", f"{tmp_path}/torch")
    assert got.endswith("holds no replay shard")


def test_export_needs_a_card_unless_told(folder, tmp_path) -> None:
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_replay.main([f"checkpoint={folder}/models/latest", f"out_dir={tmp_path}"])
