"""The port's ``train_multihost`` CLI in two gloo processes, mirroring
``tests/test_multihost_2proc.py``: each process loads its shard of the
episode files, the updates are data-parallel, process 0 owns the logs, the
evaluation and the checkpoint, and process 1 logs quietly into ``host_1``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from controllable_agent_torch import train_multihost

REPO = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT = 240  # seconds for the two processes together


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _make_exorl_episodes(d: Path, n: int = 4) -> None:
    """Walker-shaped episodes with physics, as the JAX test makes them."""
    rng = np.random.RandomState(0)
    d.mkdir()
    T, ndof = 20, 9
    for i in range(n):
        q = rng.randn(T + 1, ndof).astype(np.float32) * 0.3
        q[:, 1] += 1.3
        qd = rng.randn(T + 1, ndof).astype(np.float32)
        np.savez(d / f"episode_{i}.npz",
                 observation=rng.randn(T + 1, 24).astype(np.float32),
                 action=rng.uniform(-1, 1, (T + 1, 6)).astype(np.float32),
                 reward=np.zeros((T + 1, 1), np.float32),
                 discount=np.ones((T + 1, 1), np.float32),
                 physics=np.concatenate([q, qd], axis=1))


def test_train_multihost_two_processes(tmp_path) -> None:
    episodes = tmp_path / "episodes"
    _make_exorl_episodes(episodes)
    folder = tmp_path / "xp_mh2"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    base_cmd = [
        sys.executable, "-m", "controllable_agent_torch.train_multihost",
        "agent=fb_ddpg", "task=walker_walk", "goal_space=simplified_walker",
        f"replay_dir={episodes}", "relabel=true", "device=cpu",
        f"coordinator=file://{tmp_path}/rendezvous", "num_processes=2",
        "num_grad_steps=20", "steps_per_call=10", "eval_every_steps=20",
        "checkpoint_every=20", "num_eval_episodes=1", "episode_length=20",
        "final_tests=0", "replay_buffer_episodes=8", f"folder={folder}",
        "use_console=false", "save_eval_video=false",
        "agent.hidden_dim=32", "agent.backward_hidden_dim=32",
        "agent.feature_dim=16", "agent.z_dim=8", "agent.batch_size=16",
        "agent.num_inference_steps=32",
    ]
    procs = [subprocess.Popen(base_cmd + [f"process_id={i}"], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the two processes did not finish in {SPAWN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"

    # process 0 owns the logs, the evaluation and the checkpoint
    assert (folder / "train.csv").exists()
    assert (folder / "eval.csv").exists()
    meta = json.loads((folder / "models" / "latest" / "meta.json").read_text())
    assert meta["global_step"] == 20
    # process 1 logged into its own folder, evaluated nothing, saved nothing
    host1 = folder / "host_1"
    assert (host1 / "train.csv").exists()
    assert not (host1 / "models" / "latest").exists()
    assert not (host1 / "eval.csv").exists() or (host1 / "eval.csv").read_text().strip() == ""
    # both took the same data-parallel updates: their train rows agree
    rows = [(f / "train.csv").read_text().splitlines() for f in (folder, host1)]
    header = rows[0][0].split(",")
    last = [dict(zip(header, r[-1].split(","))) for r in rows]
    assert last[0]["fb_loss"] == last[1]["fb_loss"]
    assert last[0]["actor_loss"] == last[1]["actor_loss"]


def test_help(capsys) -> None:
    for flag in ("--help", "-h"):
        assert train_multihost.main([flag]) is None
        out = capsys.readouterr().out
        assert "coordinator=" in out and "num_processes" in out
        assert "workspace config (key=value):" in out
