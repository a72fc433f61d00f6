"""The port's offline slice end to end on the CPU (``train_offline`` CLI from a
directory of ExORL ``.npz`` episodes), and the port's import hygiene."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from controllable_agent_torch import train_offline
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import save_exorl_episodes
from controllable_agent_torch.ops import fused_fb

REPO = Path(__file__).resolve().parent.parent
SMALL = ["agent.hidden_dim=32", "agent.backward_hidden_dim=32",
         "agent.feature_dim=16", "agent.z_dim=8", "agent.batch_size=16"]
SLICE = ["relabel=false", "eval_every_steps=0", "checkpoint_every=0",
         "final_tests=0", "device=cpu"]


@pytest.fixture
def replay_dir(tmp_path) -> Path:
    rng = np.random.RandomState(0)
    store = ReplayBuffer(6, discount=0.98, future=0.99, device="cpu")
    store.load_episodes([{
        "observation": rng.randn(31, 5).astype(np.float32),
        "action": rng.uniform(-1, 1, (31, 2)).astype(np.float32),
        "reward": rng.rand(31, 1).astype(np.float32),
        "discount": np.ones((31, 1), np.float32)} for _ in range(6)])
    save_exorl_episodes(store.state, tmp_path / "episodes")
    return tmp_path / "episodes"


@pytest.mark.parametrize("fused", [True, False], ids=["fused_loss", "unfused_loss"])
def test_train_offline_cli(replay_dir, tmp_path, capsys, fused) -> None:
    fused_fb.reset_launches()
    ws = train_offline.main([
        f"replay_dir={replay_dir}", "agent=fb_ddpg", *SMALL, *SLICE,
        f"agent.use_pallas_loss={str(fused).lower()}", "agent.compute_dtype=bfloat16",
        "num_grad_steps=6", "steps_per_call=2", "log_every_steps=4",
        "replay_buffer_episodes=6", "z_inference_draws=3", f"folder={tmp_path}/run"])
    out = capsys.readouterr().out
    assert ws.global_step == 6 and ws.agent.step == 6
    assert len(ws.buffer) == 6 and ws.buffer.state.max_episode_length == 30
    assert ws.agent.obs_dim == 5 and ws.agent.action_dim == 2
    assert all(np.isfinite(v) for v in ws.last_row.values())
    assert "fb_loss" in ws.last_row and "actor_loss" in ws.last_row
    assert ("target_M" in ws.last_row) is not fused  # full-matrix metric: unfused only
    z = ws.inferred_z
    assert z.shape == (8,) and bool(torch.isfinite(z).all())
    np.testing.assert_allclose(float(z.norm()), np.sqrt(8), rtol=1e-5)  # norm_z
    assert out.count("| train") == 2 and "inferred z" in out
    assert fused_fb.launches == {k: 0 for k in fused_fb.launches}  # CPU: plain path
    assert (tmp_path / "run" / "config.json").exists()


@pytest.mark.parametrize("args,item", [
    (["relabel=true"], "item 7"),
    (["load_replay=somewhere"], "item 7"),
    (["physics_format=mujoco_walker"], "item 7"),
    (["eval_every_steps=100"], "item 9"),
    (["checkpoint_every=100"], "item 7"),
    (["final_tests=3"], "item 8"),
    (["goal_space=walker_pos_speed"], "item 7"),
], ids=["relabel", "load_replay", "physics_format", "eval", "checkpoint",
        "finalize", "goal_space"])
def test_unported_options_raise(replay_dir, tmp_path, args, item) -> None:
    base = [f"replay_dir={replay_dir}", *SMALL, *SLICE, "num_grad_steps=2",
            "steps_per_call=2", f"folder={tmp_path}/run"]
    with pytest.raises(NotImplementedError, match=item):
        train_offline.main(base + args)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax() -> None:
    """No file of the port, and not chip_smoke.py, imports jax, flax, optax
    or the JAX package."""
    banned = {"jax", "jaxlib", "flax", "optax", "controllable_agent_tpu"}
    files = sorted((REPO / "controllable_agent_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in banned]
    assert not bad, bad


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path) -> None:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine that has one
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
