"""The port's evaluator on dm_control (``controllable_agent_torch/tools/eval_mujoco.py``)
against the root ``tools/eval_mujoco.py``'s protocol: a small JAX FBDDPG
state saved by the JAX ``train/checkpoint.py`` and read with ``load_model=``
acts as the JAX policy does on the same dm_control states (observations at
rtol 1e-5, actions at rtol 1e-4, each with atol 1e-6 for entries near 0) and
scores the same return on the same episode (rtol 1e-4), z is the
spherical mean of single draws with their coherence as the JAX tool computes
them in numpy (rtol 1e-6), and ``main()`` writes ``test_rewards.json`` and
``eval.csv`` for a run of the port."""

import csv
import json

import numpy as np
import pytest

pytest.importorskip("dm_control")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from controllable_agent_torch import train_offline  # noqa: E402
from controllable_agent_torch.tools import collect_mujoco_buffer, eval_mujoco  # noqa: E402
from controllable_agent_torch.tools import mujoco_bridge as bridge  # noqa: E402
from controllable_agent_tpu.data import exorl as jax_exorl  # noqa: E402
from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace  # noqa: E402
from tools.eval_mujoco import rollout_return as jax_rollout_return  # noqa: E402

SMALL = ["agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
         "agent.z_dim=8", "agent.batch_size=16", "agent.num_inference_steps=64"]
ARGS = ["agent=fb_ddpg", "task=walker_walk", "episode_length=50", "save_eval_video=false",
        "use_console=false", "final_tests=0", "eval_every_steps=0", *SMALL]
STEPS = 50


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_folder(tmp_path):
    """A small JAX FB workspace after one update, saved by the JAX ``save_checkpoint``."""
    ws = jax_build_workspace(ARGS + [f"folder={tmp_path}/jax"])
    rng = np.random.RandomState(0)
    ws.buffer.load_episodes([{
        "observation": rng.randn(51, 24).astype(np.float32),
        "action": rng.uniform(-1, 1, (51, 6)).astype(np.float32),
        "reward": rng.rand(51, 1).astype(np.float32),
        "discount": np.ones((51, 1), np.float32)} for _ in range(3)])
    batch = ws.buffer.sample(jax.random.key(0), 16)
    ws.agent_state, _ = ws.agent.update(ws.agent_state, batch, jax.random.key(1))
    ws.global_step, ws.global_episode = 7, 3
    ws.save_checkpoint()
    return ws, tmp_path / "jax" / "models" / "latest"


def test_policy_on_dm_control_matches_jax(jax_folder, tmp_path) -> None:
    """The same JAX state through ``load_model=`` and the JAX policy, the same
    z, 50 steps of walker_walk from the same dm_control seed: the same
    observation and action at every state, and the same return."""
    jws, folder = jax_folder
    evaluator = eval_mujoco.Evaluator.build(
        ARGS + [f"load_model={folder}", f"folder={tmp_path}/torch"], "cpu")
    assert evaluator.ws.global_step == 7 and evaluator.ws.agent.step == 1
    rng = np.random.RandomState(3)
    z = rng.randn(8).astype(np.float32)
    z *= np.sqrt(8) / np.linalg.norm(z)

    agent, key = jws.agent, jax.random.PRNGKey(1)
    act_jit = jax.jit(lambda st, obs, meta: agent.policy_act(
        st, obs, meta, jnp.asarray(0, jnp.int32), key, eval_mode=True))
    meta = {agent.meta_key: jnp.asarray(z)[None]}

    def jax_act(obs):
        return np.asarray(act_jit(jws.agent_state, jnp.asarray(obs)[None], meta)[0], np.float32)

    def jax_obs_fn(env):
        phys = jax_exorl.PHYSICS_ADAPTERS["mujoco_walker"](
            bridge.mj_state(env)[None].astype(np.float32))
        return np.asarray(jws.env.obs_from_physics(phys[0]))

    # in lockstep: both policies read the state that the JAX policy's actions led to
    port_act, port_obs_fn = evaluator.make_act(torch.from_numpy(z)), evaluator.obs_fn()
    env = bridge.make_env("walker_walk", seed=5)
    env.reset()
    got_a, want_a = [], []
    for _ in range(STEPS):
        got_o, want_o = port_obs_fn(env), jax_obs_fn(env)
        np.testing.assert_allclose(got_o, want_o, rtol=1e-5, atol=1e-6)
        got_a.append(port_act(got_o))
        want_a.append(jax_act(want_o))
        env.step(want_a[-1])
    np.testing.assert_allclose(np.stack(got_a), np.stack(want_a), rtol=1e-4, atol=1e-6)
    assert np.abs(np.stack(got_a)).max() > 0.05  # the policy moves the walker
    # each policy on its own: the trajectories part by float32 units of the
    # actions, which MuJoCo amplifies, and the returns stay the same
    got = eval_mujoco.rollout_return(bridge.make_env("walker_walk", seed=5), port_act, STEPS,
                                     port_obs_fn)
    want = jax_rollout_return(bridge.make_env("walker_walk", seed=5), jax_act, STEPS,
                              jax_obs_fn)
    assert got == pytest.approx(want, rel=1e-4) and want > 0.0


def test_infer_z_is_the_spherical_mean_of_single_draws(jax_folder, tmp_path,
                                                      monkeypatch) -> None:
    """``infer_z`` takes ``z_draws`` single-draw regressions and returns
    their spherical mean and coherence, as the JAX tool's numpy computes them
    (``tools/eval_mujoco.py:166-174``)."""
    _, folder = jax_folder
    evaluator = eval_mujoco.Evaluator.build(
        ARGS + [f"load_model={folder}", f"folder={tmp_path}/torch"], "cpu", z_draws=5)
    draws = np.random.RandomState(4).randn(5, 8).astype(np.float32)
    draws[:, 0] += 2.0  # draws of one direction, with their noise
    calls = []

    def one_draw(reward_fn, draws=None):
        calls.append((reward_fn, draws))
        return torch.from_numpy(draws_left.pop(0))
    draws_left = list(draws)
    monkeypatch.setattr(evaluator.ws, "_infer_meta_from_replay", one_draw)
    z, coherence = evaluator.infer_z("reward")
    assert calls == [("reward", 1)] * 5

    unit = draws / np.maximum(np.linalg.norm(draws, axis=-1, keepdims=True), 1e-12)
    n = len(unit)
    want_coherence = float((unit @ unit.T).sum() - n) / (n * (n - 1))
    want = unit.mean(0)
    want = want / max(np.linalg.norm(want), 1e-12) * np.linalg.norm(draws[0])
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-6)
    assert coherence == pytest.approx(want_coherence, rel=1e-6)
    assert 0.0 < coherence < 1.0
    one, one_coherence = eval_mujoco.spherical_mean(torch.from_numpy(draws[:1]))
    np.testing.assert_allclose(one.numpy(), draws[0], rtol=1e-6)
    assert one_coherence == 1.0


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Three random walker episodes of 30 steps from the port's collector,
    and a run of the port on them (10 updates, a snapshot at 5)."""
    root = tmp_path_factory.mktemp("port_run")
    torch.set_num_threads(1)
    collect_mujoco_buffer.main([
        "--task", "walker_stand", "--episodes", "3", "--random-episodes", "3",
        "--episode-length", "30", "--batch-size", "16", "--agent-override", "hidden_dim=32",
        "--agent-override", "rnd_rep_dim=16", "--out", str(root / "episodes"),
        "--device", "cpu"])
    train_offline.main(ARGS + [
        f"replay_dir={root}/episodes", "physics_format=mujoco_walker", "device=cpu",
        "episode_length=30", "num_grad_steps=10", "steps_per_call=5", "log_every_steps=5",
        "snapshot_at=5", f"folder={root}/run"])
    return root


def test_main_writes_test_rewards(port_run, tmp_path) -> None:
    """``main()`` on a run of the port: a return per episode for each task in
    ``test_rewards.json``, and ``eval.csv`` with the snapshot's row and the
    final one."""
    out = tmp_path / "scores"
    results = eval_mujoco.main([
        "--replay-dir", str(port_run / "episodes"), "--tasks", "walker_stand,walker_run",
        "--episodes", "2", "--episode-length", "30", "--buffer-episodes", "3",
        "--z-draws", "2", "--out", str(out), "--device", "cpu", "--snapshots", "--",
        f"folder={port_run}/run"])
    written = json.loads((out / "test_rewards.json").read_text())
    assert written == results and list(written) == ["walker_stand", "walker_run"]
    assert all(len(v) == 2 and all(0.0 <= r <= 30.0 for r in v) for v in written.values())
    with (out / "eval.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [5, 10]
    assert all(np.isfinite(float(r["episode_reward"])) for r in rows)


def test_an_untrained_folder_is_refused(tmp_path) -> None:
    with pytest.raises(ValueError, match="no checkpoint"):
        eval_mujoco.Evaluator.build(ARGS + [f"folder={tmp_path}/empty"], "cpu")
