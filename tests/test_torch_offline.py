"""The port's offline slice end to end on the CPU (``train_offline`` CLI from a
directory of ExORL ``.npz`` episodes or from a checkpoint's replay, with
relabeling, goal spaces, foreign physics, checkpoints and resume), the
trainer against a loop of updates, and the port's import hygiene."""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from controllable_agent_torch import relabel_buffer, train_offline
from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import (load_exorl_episodes, save_exorl_episodes,
                                                 synthetic_episodes)
from controllable_agent_torch.envs import locomotion
from controllable_agent_torch.goals import get_reward_function
from controllable_agent_torch.ops import fused_fb
from controllable_agent_torch.train import checkpoint as ckpt
from controllable_agent_torch.train.loops import make_offline_trainer
from torch_threads import one_thread  # noqa: F401

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
        "observation": rng.randn(31, 4).astype(np.float32),  # the point-mass maze's sizes
        "action": rng.uniform(-1, 1, (31, 2)).astype(np.float32),
        "reward": rng.rand(31, 1).astype(np.float32),
        "discount": np.ones((31, 1), np.float32)} for _ in range(6)])
    save_exorl_episodes(store.state, tmp_path / "episodes")
    return tmp_path / "episodes"


def _walker_physics(rng, steps: int) -> np.ndarray:
    q = rng.uniform(-1.0, 1.0, (steps, 9))
    q[:, 1] = rng.uniform(0.6, 1.5, steps)
    return np.concatenate([q, rng.randn(steps, 9) * 2], -1).astype(np.float32)


@pytest.fixture
def walker_dir(tmp_path) -> Path:
    """4 walker-shaped episodes of 20 steps with native physics; the stored
    rewards are all -1, so a relabeled run is told from one that is not."""
    rng = np.random.RandomState(1)
    env = locomotion.make("walker_walk")
    store = ReplayBuffer(4, discount=0.98, future=0.99, device="cpu")
    episodes = []
    for _ in range(4):
        physics = _walker_physics(rng, 21)
        episodes.append({
            "observation": env.obs_from_physics(torch.from_numpy(physics)).numpy(),
            "action": rng.uniform(-1, 1, (21, 6)).astype(np.float32),
            "reward": -np.ones((21, 1), np.float32),
            "discount": np.ones((21, 1), np.float32),
            "physics": physics})
    store.load_episodes(episodes)
    save_exorl_episodes(store.state, tmp_path / "walker")
    return tmp_path / "walker"


WALKER = ["task=walker_walk", *SMALL, "eval_every_steps=0", "final_tests=0", "device=cpu",
          "steps_per_call=2", "log_every_steps=2", "replay_buffer_episodes=4",
          "z_inference_draws=2", "agent.num_inference_steps=64"]


def _walk_rewards(physics: torch.Tensor) -> torch.Tensor:
    return get_reward_function("walker_walk").from_physics(physics)


def test_cli_relabels_checkpoints_and_resumes(walker_dir, tmp_path, capsys) -> None:
    """relabel=true (the default) with checkpoint_every: the buffer holds the
    task's rewards, the folder holds models/latest, train.csv and hip.log,
    and the same command on the same folder resumes at the saved step."""
    args = [f"replay_dir={walker_dir}", *WALKER, "checkpoint_every=2",
            f"folder={tmp_path}/run"]
    ws = train_offline.main(args + ["num_grad_steps=4"])
    state = ws.buffer.state
    reward = state.storage["reward"][:, :, 0]
    torch.testing.assert_close(reward, _walk_rewards(state.storage["physics"]))
    assert float(reward.min()) >= 0.0 and float(reward.max()) > float(reward.min())
    assert ws.global_step == 4 and ws.agent.step == 4
    run = tmp_path / "run"
    assert ckpt.load_checkpoint(run / "models" / "latest", only=[])["global_step"] == 4
    rows = (run / "train.csv").read_text().splitlines()
    assert len(rows) == 3 and "fb_loss" in rows[0] and "fps" in rows[0]
    assert len((run / "hip.log").read_text().splitlines()) == 2
    out = capsys.readouterr().out
    assert out.count("| train") == 2 and "inferred z" in out
    np.testing.assert_allclose(float(ws.inferred_z.norm()), np.sqrt(8), rtol=1e-5)

    again = train_offline.main(args + ["num_grad_steps=8"])
    assert again.global_step == 8 and again.agent.step == 8
    assert again.agent.fw_opt.count == 8
    out = capsys.readouterr().out
    assert out.count("| train") == 2  # steps 6 and 8 only: it did not start over
    # offline rows carry no episode count, so, as in the JAX logger, a resumed
    # run appends below a second header
    steps = [float(r.split(",")[rows[0].split(",").index("step")])
             for r in (run / "train.csv").read_text().splitlines() if r != rows[0]]
    assert steps == [2.0, 4.0, 6.0, 8.0]
    # the folder's saved config is the base of the resumed run
    assert again.agent.cfg.z_dim == 8 and again.cfg.task == "walker_walk"


def test_cli_load_replay(walker_dir, tmp_path) -> None:
    """load_replay= takes the replay of a checkpoint, relabels it on the
    buffer's device and trains; relabel_buffer does the same for a file."""
    first = train_offline.main([f"replay_dir={walker_dir}", *WALKER, "relabel=false",
                                "num_grad_steps=2", f"folder={tmp_path}/a"])
    assert float(first.buffer.state.storage["reward"].max()) == -1.0  # stored rewards
    latest = tmp_path / "a" / "models" / "latest"
    ws = train_offline.main([f"load_replay={latest}", *WALKER, "task=walker_run",
                             "num_grad_steps=2", f"folder={tmp_path}/b"])
    state = ws.buffer.state
    assert len(ws.buffer) == 4 and ws.global_step == 2 and ws.agent.obs_dim == 24
    want = get_reward_function("walker_run").from_physics(state.storage["physics"])
    torch.testing.assert_close(state.storage["reward"][:, :, 0], want)
    assert ws.buffer.avg_episode_length == 20

    relabel_buffer.main([f"checkpoint={latest}", "task=walker_stand", f"out={tmp_path}/r",
                         "device=cpu"])
    replay = ckpt.load_checkpoint(tmp_path / "r")["replay"]
    want = get_reward_function("walker_stand").from_physics(replay.storage["physics"])
    torch.testing.assert_close(replay.storage["reward"][:, :, 0], want)
    with pytest.raises(ValueError, match="replay_dir=.*load_replay="):
        train_offline.main([*WALKER, f"folder={tmp_path}/c"])


def test_cli_physics_format(tmp_path) -> None:
    """physics_format=mujoco_walker: physics adapted to the native layout,
    observations recomputed from it, rewards relabeled from it."""
    rng = np.random.RandomState(2)
    out = tmp_path / "mj"
    out.mkdir()
    for i in range(3):
        np.savez(out / f"episode_{i:06d}_20.npz",
                 observation=rng.randn(21, 24).astype(np.float32),
                 action=rng.uniform(-1, 1, (21, 6)).astype(np.float32),
                 reward=np.zeros((21, 1), np.float32), discount=np.ones((21, 1), np.float32),
                 physics=(rng.randn(21, 18) * 0.5).astype(np.float32))
    ws = train_offline.main([f"replay_dir={out}", "physics_format=mujoco_walker", *WALKER,
                             "num_grad_steps=2", f"folder={tmp_path}/run"])
    state = ws.buffer.state
    native = next(load_exorl_episodes(out, physics_format="mujoco_walker"))["physics"]
    raw = next(load_exorl_episodes(out))["physics"]
    np.testing.assert_array_equal(state.storage["physics"][0].numpy(), native)
    np.testing.assert_allclose(native[:, 1], raw[:, 0] + 1.3, rtol=1e-6)  # rootz + torso offset
    env = locomotion.make("walker_walk")
    assert len(ws.buffer) == 3  # the fourth slot is empty
    torch.testing.assert_close(state.storage["observation"][:3],
                               env.obs_from_physics(state.storage["physics"][:3]))
    assert not np.allclose(state.storage["observation"][0].numpy(),
                           next(load_exorl_episodes(out))["observation"])
    torch.testing.assert_close(state.storage["reward"][:3, :, 0],
                               _walk_rewards(state.storage["physics"][:3]))
    with pytest.raises(ValueError, match="Unknown physics_format"):
        train_offline.main([f"replay_dir={out}", "physics_format=nope", *WALKER,
                            f"folder={tmp_path}/bad"])


def test_cli_goal_space(walker_dir, tmp_path) -> None:
    """goal_space=: the goal column comes from the physics, B takes goals, and
    the final z is B(registered goal of the task)."""
    ws = train_offline.main([f"replay_dir={walker_dir}", *WALKER, "goal_space=simplified_walker",
                             "num_grad_steps=2", f"folder={tmp_path}/run"])
    state = ws.buffer.state
    assert ws.agent.goal_dim == 3 and state.storage["goal"].shape == (4, 21, 3)
    torch.testing.assert_close(state.storage["goal"], ws.goal_fn(state.storage["physics"]))
    goal = torch.tensor([1.2, 1.0, 2.0])  # goals/spaces.py: walker_walk in simplified_walker
    torch.testing.assert_close(ws.inferred_z, ws.agent.get_goal_meta(goal))
    # a custom reward without a goal in that space: z by regression on its rewards
    ws.cfg = dataclasses.replace(ws.cfg, custom_reward="walker_random_equation")
    z = ws._init_eval_meta()["z"]
    assert z.shape == (8,) and bool(torch.isfinite(z).all())
    # and set_goals on the loaded buffer gives the same column
    ws.buffer.set_goals(ws.goal_fn)
    torch.testing.assert_close(state.storage["goal"], ws.goal_fn(state.storage["physics"]))
    with pytest.raises(ValueError, match="Unknown goal space"):
        train_offline.main([f"replay_dir={walker_dir}", *WALKER, "goal_space=quad_pos_speed",
                            f"folder={tmp_path}/bad"])


def test_cli_custom_reward_and_snapshots(walker_dir, tmp_path) -> None:
    """custom_reward=: the final z regresses on that reward's values of the
    sampled physics; snapshot_at= saves milestones."""
    ws = train_offline.main([f"replay_dir={walker_dir}", *WALKER, "custom_reward=walker_run",
                             "relabel=false", "num_grad_steps=4", "snapshot_at=2,3",
                             f"folder={tmp_path}/run"])
    models = sorted(p.name for p in (tmp_path / "run" / "models").iterdir())
    assert models == ["latest", "snapshot_2", "snapshot_3"]
    gen_state = ws.generator.get_state()
    z = ws._infer_meta_from_replay(get_reward_function("walker_run", ws.cfg.seed), draws=1)
    ws.generator.set_state(gen_state)
    batch = ws.buffer.sample(ws.generator, 64, with_physics=True)
    reward = get_reward_function("walker_run").from_physics(batch.physics)
    torch.testing.assert_close(
        z, ws.agent.infer_meta_from_obs_and_rewards(batch.next_obs, reward))
    assert float(batch.reward.max()) == -1.0  # the stored rewards were left alone


def test_trainer_on_the_cpu_is_a_loop_of_updates() -> None:
    """The trainer on the CPU runs the same updates as sampling and calling
    ``update`` in a loop: the same parameters to the bit, and the metrics'
    mean over the call."""
    cfg = FBDDPGConfig(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8,
                       batch_size=16, stddev_schedule="linear(1.0,0.1,4)")
    buf = ReplayBuffer(3, discount=0.98, future=0.99, device="cpu")
    buf.load_episodes(synthetic_episodes(3, 20, 5, 2, seed=2))
    a = FBDDPGAgent(cfg, 5, 2, device="cpu", seed=1)
    b = FBDDPGAgent(cfg, 5, 2, device="cpu", seed=1)
    trainer = make_offline_trainer(a, buf.cfg, 16, steps_per_call=3)
    gen_a, gen_b = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    for _ in range(2):  # the second call starts its sums from zero
        got = trainer(buf.state, gen_a)
        losses = [float(b.update(buf.sample(gen_b, 16), gen_b)["fb_loss"]) for _ in range(3)]
        np.testing.assert_allclose(float(got["fb_loss"]), np.mean(losses), rtol=1e-6)
    assert a.step == b.step == 6
    for k, v in b.train_state().items():
        assert torch.equal(a.train_state()[k], v), k
    with pytest.raises(ValueError, match="CUDA"):
        make_offline_trainer(a, buf.cfg, 16, steps_per_call=3, capture=True)


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
    assert ws.agent.obs_dim == 4 and ws.agent.action_dim == 2
    assert all(np.isfinite(v) for v in ws.last_row.values())
    assert "fb_loss" in ws.last_row and "actor_loss" in ws.last_row
    assert ("target_M" in ws.last_row) is not fused  # full-matrix metric: unfused only
    z = ws.inferred_z
    assert z.shape == (8,) and bool(torch.isfinite(z).all())
    np.testing.assert_allclose(float(z.norm()), np.sqrt(8), rtol=1e-5)  # norm_z
    assert out.count("| train") == 2 and "inferred z" in out
    assert fused_fb.launches == {k: 0 for k in fused_fb.launches}  # CPU: plain path
    assert (tmp_path / "run" / "config.json").exists()


@pytest.mark.parametrize("args", [
    ["eval_every_steps=2", "save_eval_video=true", "use_wandb=true"],
    ["use_tb=true"],
    ["profile_dir=PROFILES", "num_seed_frames=0"],
    ["task=d4rl_hopper"],
], ids=["eval_video", "tensorboard", "other_agent", "other_environment"])
def test_unported_options_raise(replay_dir, tmp_path, args) -> None:
    """The options the port once refused, each as the JAX package takes it:
    ``use_wandb`` without the wandb package raises its ModuleNotFoundError
    before any training; ``use_tb`` writes TensorBoard events beside the
    CSV; ``profile_dir`` writes one Chrome trace of the first cycle after
    the seed frames; a ``d4rl_*`` task without ``d4rl_dataset`` raises the
    JAX workspace's ValueError."""
    args = [a.replace("PROFILES", str(tmp_path / "profiles")) for a in args]
    base = [f"replay_dir={replay_dir}", *SMALL, *SLICE, "num_grad_steps=2",
            "steps_per_call=2", f"folder={tmp_path}/run"]
    run = tmp_path / "run"
    if "use_wandb=true" in args:
        with pytest.raises(ModuleNotFoundError, match="wandb"):
            train_offline.main(base + args)
        assert not (run / "train.csv").exists()  # refused before any training
    elif "task=d4rl_hopper" in args:
        with pytest.raises(ValueError, match="d4rl_dataset"):
            train_offline.main(base + args)
        assert not (run / "train.csv").exists()
    elif "use_tb=true" in args:
        ws = train_offline.main(base + args)
        assert ws.global_step == 2 and (run / "train.csv").exists()
        assert len(list((run / "tb").glob("events.out.tfevents.*"))) == 1
    else:
        ws = train_offline.main(base + args)
        assert ws.global_step == 2
        assert [p.name for p in (tmp_path / "profiles").iterdir()] == ["trace_0.json"]


def test_data_of_another_environment_is_refused(replay_dir, tmp_path) -> None:
    """The environment gives the sizes; episodes of other sizes raise."""
    with pytest.raises(ValueError, match="observation columns"):
        train_offline.main([f"replay_dir={replay_dir}", *SMALL, *SLICE, "task=walker_walk",
                            f"folder={tmp_path}/run"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax() -> None:
    """No file of the port, and not chip_smoke.py, imports jax, flax, optax,
    msgpack or the JAX package."""
    banned = {"jax", "jaxlib", "flax", "optax", "msgpack", "controllable_agent_tpu"}
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


def test_chip_smoke_refuses_its_removed_phase() -> None:
    """Phase 34 was removed but keeps its number: naming it is refused with
    the reason, a range steps over it, and a full run leaves it out."""
    import chip_smoke
    for selection in ("34", "33-34", "34-36", "4,34"):
        with pytest.raises(SystemExit, match="phase 34 .* was removed"):
            chip_smoke.parse_phases(["--phases", selection])
    assert chip_smoke.parse_phases(["--phases", "30-36"]) == [1, 30, 31, 32, 33, 35, 36]
    every = chip_smoke.parse_phases([])
    assert 34 not in every and every[-1] == chip_smoke.LAST_PHASE == 36 and len(every) == 35
