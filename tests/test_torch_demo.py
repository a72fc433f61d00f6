"""The port's demo engine (``controllable_agent_torch/demo/core.py``) against
the JAX ``DemoEngine`` on the CPU: the same FB weights (``convert.py``), the
same goal and physics rows for the precompute, the same initial state for
the rollout.

Tolerances: z at rtol 2e-4 (the forward tolerance of the parity tests);
over a 20-step rollout the steps exactly, and the task reward and the
equation's reward at rtol 1e-4; the early stop's step exactly, against a
numpy transcription of the JAX loop's rule.
"""

import types

import jax
import numpy as np
import pytest
import torch

from controllable_agent_tpu.demo.core import DemoEngine as JaxDemoEngine
from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch.convert import load_fb_train_state
from controllable_agent_torch.demo.core import DemoEngine, stop_index
from controllable_agent_torch.envs import locomotion
from controllable_agent_torch.pretrain import build_workspace
from controllable_agent_torch.train.workspace import OfflineWorkspace

ROWS, STEPS = 64, 20
ARGS = ["agent=fb_ddpg", "task=walker_stand", "goal_space=walker_pos_speed_z",
        "replay_buffer_episodes=4", "use_console=false", "save_eval_video=false",
        "agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
        "agent.z_dim=8", "agent.batch_size=16", f"agent.num_inference_steps={ROWS}"]
EQUATIONS = ("vx", "up", "-vx", "exp(-(x-8)**2) * up")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _episodes(goal_fn, n: int = 4, steps: int = 30):
    rng = np.random.RandomState(3)
    env = locomotion.make("walker_stand")
    episodes = []
    for _ in range(n):
        q = rng.uniform(-1.0, 1.0, (steps + 1, 9))
        q[:, 1] = rng.uniform(0.6, 1.5, steps + 1)
        physics = np.concatenate([q, rng.randn(steps + 1, 9) * 2], -1).astype(np.float32)
        episodes.append({
            "observation": env.obs_from_physics(torch.from_numpy(physics)).numpy(),
            "action": rng.uniform(-1, 1, (steps + 1, 6)).astype(np.float32),
            "reward": rng.rand(steps + 1, 1).astype(np.float32),
            "discount": np.ones((steps + 1, 1), np.float32), "physics": physics,
            "goal": goal_fn(torch.from_numpy(physics)).numpy()})
    return episodes


class _Keys:
    """The JAX workspace's key chain, replaced by keys the test chooses."""

    def __init__(self, *keys) -> None:
        self._keys = list(keys)

    def next(self):
        return self._keys.pop(0)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) on the same weights, episodes and precompute
    rows: the port's precompute samples the rows the JAX one sampled."""
    tmp = tmp_path_factory.mktemp("demo")
    jws = jax_build_workspace(ARGS + [f"folder={tmp}/jax"], offline=True)
    tws = build_workspace(ARGS + [f"folder={tmp}/torch", "device=cpu"], OfflineWorkspace)
    load_fb_train_state(tws.agent, jax.tree.map(np.asarray, jws.agent_state))
    episodes = _episodes(tws.goal_fn)
    jws.buffer.load_episodes(episodes)
    tws.buffer.load_episodes(episodes)
    jax_engine, engine = JaxDemoEngine(jws, ROWS), DemoEngine(tws, ROWS)

    drawn = []
    jax_sample = jws.buffer.sample
    jws.buffer.sample = lambda *a, **k: drawn.append(jax_sample(*a, **k)) or drawn[-1]
    jax_engine.precompute()
    batch = drawn[0]
    tws.buffer.sample = lambda *a, **k: types.SimpleNamespace(
        next_goal=torch.from_numpy(np.array(batch.next_goal)),
        next_obs=torch.from_numpy(np.array(batch.next_obs)),
        physics=torch.from_numpy(np.array(batch.physics)))
    engine.precompute()
    return jax_engine, engine


@pytest.mark.parametrize("equation", EQUATIONS)
def test_infer_z_matches_jax(engines, equation) -> None:
    jax_engine, engine = engines
    want = np.asarray(jax_engine.infer_z(equation))
    got = engine.infer_z(equation)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)
    # float32 squares of tiny rewards (exp(-64)) lose the norm to 2e-4, in JAX too
    assert abs(float(torch.linalg.vector_norm(got)) - np.sqrt(8)) < 1e-3


def test_zero_z_is_guarded(engines) -> None:
    """A reward that is 0 everywhere gives z = 0, not a division by zero
    (JAX's ``or 1e-9``)."""
    jax_engine, engine = engines
    assert not np.asarray(jax_engine.infer_z("0 * vx")).any()
    assert not engine.infer_z("0 * vx").any()


@pytest.mark.parametrize("equation", ["vx", "exp(-(x-8)**2) * up"])
def test_rollout_matches_jax(engines, equation) -> None:
    """``run`` from the same initial state: the steps, the task reward and
    the equation's reward over the rollout's physics."""
    jax_engine, engine = engines
    reset_key = jax.random.key(11)
    jax_engine.ws.keys = _Keys(reset_key, jax.random.key(12))
    want = jax_engine.run(equation, num_steps=STEPS)
    env = engine.ws.env
    u = jax.random.uniform(jax.random.split(reset_key)[0], (env.model.ndof - 3,))
    start = env.reset_from_uniform(torch.from_numpy(np.array(u))[None])
    env.reset = lambda generator, n: start
    try:
        got = engine.run(equation, num_steps=STEPS)
    finally:
        del env.reset
    assert got["steps"] == want["steps"] == STEPS
    assert got["equation"] == equation
    np.testing.assert_allclose(got["reward"], want["reward"], rtol=1e-4)
    np.testing.assert_allclose(got["equation_reward"], want["equation_reward"], rtol=1e-4)
    assert engine.last_reset[0] is start[0] and engine.last_reset[1] is start[1]


def _jax_loop_steps(rows: np.ndarray) -> int:
    """The JAX demo's loop over physics rows (``demo/core.py:91-99``)."""
    physics_rows = [rows[0]]
    for t in range(len(rows) - 1):
        physics_rows.append(rows[t + 1])
        if t > 10 and np.allclose(physics_rows[-1], physics_rows[-6], atol=1e-7):
            break
    return len(physics_rows) - 1


def _trajectory(static_from: int, rows: int = 60, jitter: float = 0.0) -> np.ndarray:
    rng = np.random.RandomState(static_from)
    traj = np.cumsum(rng.randn(rows, 18), 0).astype(np.float32)
    if static_from < rows:
        traj[static_from:] = traj[static_from]
        # relative noise: inside allclose's rtol (1e-5) or beyond it
        traj[static_from:] *= 1 + jitter * rng.randn(rows - static_from, 18).astype(np.float32)
    return traj


@pytest.mark.parametrize("static_from, want", [(7, 12), (35, 40), (60, 59), (3, 12)])
def test_stop_index_matches_the_jax_loop(static_from, want) -> None:
    """Trajectories that go static (stopping at step 12, at step 40) and one
    that never does (all 59 steps)."""
    rows = _trajectory(static_from)
    assert _jax_loop_steps(rows) == want
    assert int(stop_index(torch.from_numpy(rows))) == want


@pytest.mark.parametrize("jitter, static", [(1e-6, True), (1e-3, False)])
def test_stop_index_tolerance(jitter, static) -> None:
    """Noise inside allclose's tolerance still stops, noise beyond it does
    not; both as the JAX loop decides."""
    rows = _trajectory(20, jitter=jitter)
    want = _jax_loop_steps(rows)
    assert (want < 59) == static
    assert int(stop_index(torch.from_numpy(rows))) == want


def test_demo_engine_rejects_injection(engines) -> None:
    engine = engines[1]
    with pytest.raises(ValueError, match="not allowed"):
        engine.run("__import__('os').system('true')")
    with pytest.raises(ValueError, match="not allowed"):
        engine.run("open('/etc/passwd')")


def test_demo_engine_video(engines, tmp_path) -> None:
    engine = engines[1]
    out = engine.run("up", num_steps=8, video_path=str(tmp_path / "rollout.mp4"))
    assert out.get("video") is not None
    assert (tmp_path / "eval_video" / "rollout.png").stat().st_size > 0
    assert out["steps"] == 8 and np.isfinite(out["reward"])
    assert set(engine.timings) >= {"infer_ms", "rollout_ms", "video_ms"}
