"""The port's buffer collector (``controllable_agent_torch/tools/collect_mujoco_buffer.py``):
its random episodes equal the root ``tools/collect_mujoco_buffer.py``'s to
the bit at the same seed (small widths through ``--agent-override``), a
policy episode's format, the acting copy of the actor and its refresh, and
the chain collector → ``train_offline physics_format=mujoco_walker`` →
``eval_mujoco`` on the walker's three suite tasks. Each of the port's three
dm_control tools, asked for the card where there is none, raises."""

import json
import sys

import numpy as np
import pytest

pytest.importorskip("dm_control")

import torch  # noqa: E402

from controllable_agent_torch import train_offline  # noqa: E402
from controllable_agent_torch.tools import collect_mujoco_buffer as collect  # noqa: E402
from controllable_agent_torch.tools import eval_mujoco, gen_parity_report  # noqa: E402
from tools import collect_mujoco_buffer as root_collect  # noqa: E402

T = 30
SMALL_AGENT = ["--agent-override", "hidden_dim=32", "--agent-override", "rnd_rep_dim=16"]
FB_SMALL = ["agent=fb_ddpg", "task=walker_walk", "agent.hidden_dim=32",
            "agent.backward_hidden_dim=32", "agent.feature_dim=16", "agent.z_dim=8", "agent.batch_size=16",
            "agent.num_inference_steps=64", "save_eval_video=false", "use_console=false",
            "final_tests=0", "eval_every_steps=0", f"episode_length={T}"]
WALKER_SUITE = ["walker_stand", "walker_walk", "walker_run"]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _args(out, episodes, random_episodes, *extra):
    return ["--task", "walker_stand", "--episodes", str(episodes), "--random-episodes",
            str(random_episodes), "--episode-length", str(T), "--batch-size", "16",
            "--updates-per-episode", "100", "--seed", "3", "--out", str(out), *SMALL_AGENT,
            *extra]


def _files(folder):
    return sorted(p.name for p in folder.glob("*.npz"))


def test_random_episodes_equal_the_jax_tool(tmp_path, monkeypatch) -> None:
    """Two random episodes (no update runs: the bursts start after the last
    random episode) from both tools at one seed: the same files, keys, dtypes
    and values."""
    monkeypatch.setattr(sys, "argv", ["collect"] + _args(tmp_path / "jax", 2, 3))
    root_collect.main()
    collect.main(_args(tmp_path / "port", 2, 3, "--device", "cpu"))
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") == [f"episode_00000{i}_{T}.npz" for i in (0, 1)]
    for name in names:
        with np.load(tmp_path / "jax" / name) as want, np.load(tmp_path / "port" / name) as got:
            assert list(got.keys()) == list(want.keys()) == [
                "observation", "action", "reward", "discount", "physics"]
            for key in want.keys():
                assert got[key].dtype == want[key].dtype == np.float32, key
                np.testing.assert_array_equal(got[key], want[key], key)


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """One random episode, then three of the policy, refreshed every two,
    with 100 updates after each, numbered from 5."""
    root = tmp_path_factory.mktemp("collected")
    torch.set_num_threads(1)
    collector = collect.main(_args(root / "episodes", 4, 1, "--policy-refresh-every", "2",
                                   "--start-ep", "5", "--device", "cpu"))
    return root, collector


def test_policy_episodes_format(collected) -> None:
    root, collector = collected
    assert _files(root / "episodes") == [f"episode_{i:06d}_{T}.npz" for i in range(5, 9)]
    with np.load(root / "episodes" / f"episode_000006_{T}.npz") as ep:
        shapes = {k: ep[k].shape for k in ep.keys()}
        assert shapes == {"observation": (T + 1, 24), "action": (T + 1, 6),
                          "reward": (T + 1, 1), "discount": (T + 1, 1),
                          "physics": (T + 1, 18)}
        assert all(ep[k].dtype == np.float32 for k in ep.keys())
        assert not ep["action"][0].any() and not ep["reward"][0].any()
        assert np.abs(ep["action"][1:]).max() <= 1.0 and ep["action"][1:].std() > 0.0
        assert (ep["discount"] == 1.0).all() and (ep["reward"] >= 0.0).all()
    # the replay holds the four episodes and samples RND's n-step returns
    assert len(collector.buffer) == 4 and collector.buffer.cfg.nstep == 3
    assert collector.updates == 400 and collector.agent.step == 400
    assert collector.agent.cfg.num_expl_steps == T and collector.agent.cfg.hidden_dim == 32


def test_the_acting_copy_is_refreshed(collected) -> None:
    """The policy acts from its own copy of the actor, which follows the
    trained actor only when refreshed."""
    _, collector = collected
    trained = collector._actor(collector.agent).state_dict()
    acting = collector._actor(collector.policy).state_dict()
    assert any(not torch.equal(acting[k], v) for k, v in trained.items())
    collector.refresh_policy()
    acting = collector._actor(collector.policy).state_dict()
    assert all(torch.equal(acting[k], v) for k, v in trained.items())
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(acting.values(), trained.values()))
    action = collector.act(np.zeros(24, np.float32), 10 ** 6)
    assert action.shape == (6,) and action.dtype == np.float32


def test_collected_episodes_train_and_score(collected, tmp_path) -> None:
    """The chain at a small size: the collected episodes through
    ``train_offline physics_format=mujoco_walker``, then ``eval_mujoco``
    scores the walker's three suite tasks on dm_control."""
    root, _ = collected
    ws = train_offline.main(FB_SMALL + [
        f"replay_dir={root}/episodes", "physics_format=mujoco_walker", "device=cpu",
        "num_grad_steps=10", "steps_per_call=5", "log_every_steps=5",
        f"folder={tmp_path}/run"])
    assert ws.global_step == 10 and len(ws.buffer) == 4
    out = tmp_path / "scores"
    eval_mujoco.main([
        "--replay-dir", str(root / "episodes"), "--tasks", ",".join(WALKER_SUITE),
        "--episodes", "1", "--episode-length", str(T), "--buffer-episodes", "4",
        "--z-draws", "2", "--out", str(out), "--device", "cpu", "--", f"folder={tmp_path}/run"])
    rewards = json.loads((out / "test_rewards.json").read_text())
    assert list(rewards) == WALKER_SUITE
    assert all(len(v) == 1 and 0.0 <= v[0] <= T for v in rewards.values())


@pytest.mark.parametrize("tool,argv", [
    (collect.main, ["--episodes", "1"]),
    (eval_mujoco.main, ["--replay-dir", "x", "--out", "y", "--", "folder=z"]),
    (gen_parity_report.main, []),
], ids=["collect_mujoco_buffer", "eval_mujoco", "gen_parity_report"])
def test_tools_run_on_the_card_unless_told(tool, argv, tmp_path, monkeypatch) -> None:
    """Without ``--device cpu`` each tool asks for the card and, where there
    is none, raises naming it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool(argv)
