"""The port's gridworld against the JAX package's: every layout and
observation type, batched, on the same action sequences from a numpy seed,
bit for bit (observations, rewards, step types, discounts, physics, the
state and ``get_goal_obs``); the cases of ``tests/test_gridworld.py``;
``simple``'s goal distribution; ``render`` and the grid video frame against
JAX's to the byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.envs import gridworld as jgrid
from controllable_agent_tpu.train.video import Renderer as JaxRenderer
from controllable_agent_torch.envs import build_gridworld_task
from controllable_agent_torch.envs import gridworld as tgrid
from controllable_agent_torch.envs.base import StepType
from controllable_agent_torch.train.video import Renderer
from torch_threads import one_thread  # noqa: F401

E, STEPS, HORIZON = 24, 40, 30  # past the episode's end: LAST, then the episode goes on
LAYOUTS = ["simple", "obstacle", "random_goal"]


def _eq(got: torch.Tensor, want, msg: str = "") -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, msg
    np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=msg)


def _pair(layout: str, obs_type: str, **kwargs):
    kwargs = dict(observation_type=obs_type, max_episode_length=HORIZON, **kwargs)
    return (jgrid.build_gridworld_task(layout, **kwargs),
            build_gridworld_task(layout, **kwargs))


@pytest.mark.parametrize("obs_type", tgrid.OBSERVATION_TYPES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_trajectories_equal_the_jax_environment(layout, obs_type) -> None:
    """E environments from JAX's own resets, stepped by the same actions:
    every field of every step, the state and the goal observation, equal.
    A wall penalty and a discount other than 1 make those fields count."""
    jenv, tenv = _pair(layout, obs_type, penalty_for_walls=-0.25, discount=0.9)
    jstate, jts = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(3), E))
    tstate, tts = tenv.reset_with_goals(torch.from_numpy(np.array(jstate.goal)))
    actions = np.random.RandomState(5).randint(0, 5, (STEPS, E))
    jstep = jax.jit(jax.vmap(jenv.step))
    jgoal = jax.jit(jax.vmap(jenv.get_goal_obs))
    walls = 0
    for t in range(STEPS + 1):
        for field in ("observation", "reward", "discount", "physics"):
            _eq(getattr(tts, field), getattr(jts, field), f"{field} at step {t}")
        _eq(tts.step_type, jts.step_type, f"step_type at step {t}")
        _eq(tts.action[:, 0], np.asarray(jts.action, np.float32), f"action at step {t}")
        for field in ("pos", "goal", "t"):
            _eq(getattr(tstate, field), getattr(jstate, field), f"state.{field} at step {t}")
        _eq(tenv.get_goal_obs(tstate), jgoal(jstate), f"goal observation at step {t}")
        if t == STEPS:
            break
        a = actions[t]
        # the collector hands a float [E], the rollout may hand [E, 1]
        ta = torch.from_numpy(a.astype(np.float32))
        tstate, tts = tenv.step(tstate, ta if t % 2 else ta[:, None])
        jstate, jts = jstep(jstate, jnp.asarray(a, jnp.int32))
        walls += int((np.asarray(jts.reward) == -0.25).sum())
    assert walls > 0 and int((tts.step_type == StepType.LAST).sum()) == E


@pytest.mark.parametrize("layout", LAYOUTS)
def test_resets_and_spec_equal_jax(layout) -> None:
    """The spec, the candidate goal cells (the start excluded) in JAX's
    order, and the goals of the layouts that fix them."""
    jenv, tenv = _pair(layout, tgrid.OBS_AGENT_POS)
    for k in ("obs_dim", "action_dim", "discrete_actions", "n_actions", "physics_dim",
              "goal_dim", "episode_length"):
        assert getattr(tenv.spec, k) == getattr(jenv.spec, k), k
    np.testing.assert_array_equal(tenv.free_cells, np.asarray(jenv._free_cells))
    assert not np.any(np.all(tenv.free_cells == tenv.start, axis=1))
    if layout != "simple":
        tstate, tts = tenv.reset(torch.Generator().manual_seed(0), 3)
        jstate, jts = jenv.reset(jax.random.key(0))
        for e in range(3):
            _eq(tstate.goal[e], jstate.goal)
            _eq(tts.observation[e], jts.observation)


def test_simple_draws_every_free_goal_uniformly() -> None:
    """16,384 resets of ``simple``: only free cells other than the start,
    every one of them, each within 25% of its expected count."""
    env = build_gridworld_task("simple")
    state, _ = env.reset(torch.Generator().manual_seed(1), 16384)
    goals = state.goal.numpy()
    assert (env.layout[goals[:, 0], goals[:, 1]] == 0).all()
    assert not np.all(goals == env.start, axis=1).any()
    cells, counts = np.unique(goals, axis=0, return_counts=True)
    np.testing.assert_array_equal(cells, np.unique(env.free_cells, axis=0))
    expected = 16384 / len(env.free_cells)
    assert counts.min() > 0.75 * expected and counts.max() < 1.25 * expected
    other, _ = env.reset(torch.Generator().manual_seed(2), 16384)
    assert not torch.equal(other.goal, state.goal)


def test_walls_block_movement() -> None:
    env = build_gridworld_task("simple")
    state, _ = env.reset(torch.Generator().manual_seed(0), 1)
    for _ in range(2):  # up twice from (2, 2): the wall at row 0
        state, ts = env.step(state, torch.zeros(1))
    assert state.pos.tolist() == [[1, 2]] and float(ts.reward) == 0.0
    penalised = build_gridworld_task("simple", penalty_for_walls=-1.0)
    state, _ = penalised.reset(torch.Generator().manual_seed(0), 1)
    state, ts = penalised.step(state, torch.zeros(1))
    state, ts = penalised.step(state, torch.zeros(1))
    assert state.pos.tolist() == [[1, 2]] and float(ts.reward) == -1.0


def test_goal_pays_and_the_episode_goes_on() -> None:
    """``obstacle``'s fixed goal (2, 8): the path around the walls reaches
    it, pays ``reward_goal`` and the episode goes on; staying on it pays
    again; moving off pays nothing."""
    env = build_gridworld_task("obstacle")
    state, _ = env.reset(torch.Generator(), 1)
    # (2,2) up (1,2), right x3 (1,5), down (2,5), right x3 (2,8)
    path = [0, 1, 1, 1, 2, 1, 1, 1]
    for a in path:
        state, ts = env.step(state, torch.tensor([float(a)]))
    assert state.pos.tolist() == [[2, 8]] and float(ts.reward) == 1.0
    assert int(ts.step_type) == StepType.MID
    state, ts = env.step(state, torch.tensor([4.0]))  # stay
    assert float(ts.reward) == 1.0
    state, ts = env.step(state, torch.tensor([3.0]))  # left
    assert float(ts.reward) == 0.0 and state.pos.tolist() == [[2, 7]]


def test_episode_terminates_at_max_length() -> None:
    env = build_gridworld_task("simple", max_episode_length=5)
    state, ts = env.reset(torch.Generator(), 2)
    assert (ts.step_type == StepType.FIRST).all()
    for i in range(5):
        state, ts = env.step(state, torch.full((2,), 4.0))
        assert bool((ts.step_type == (StepType.LAST if i == 4 else StepType.MID)).all())


def test_onehot_and_grid_observations_and_goal_observation() -> None:
    env = build_gridworld_task("obstacle", observation_type=tgrid.OBS_AGENT_ONEHOT)
    state, ts = env.reset(torch.Generator(), 1)
    assert ts.observation.shape == (1, 90) and float(ts.observation.sum()) == 1.0
    assert float(ts.observation[0, 2 * 10 + 2]) == 1.0
    assert float(env.get_goal_obs(state)[0, 2 * 10 + 8]) == 1.0
    grid = build_gridworld_task("simple", observation_type=tgrid.OBS_GRID)
    state, ts = grid.reset(torch.Generator().manual_seed(0), 1)
    obs = ts.observation.reshape(grid.shape + (3,)).numpy()
    np.testing.assert_array_equal(obs[..., 0], grid.layout < 0)
    assert tuple(np.argwhere(obs[..., 1])[0]) == tuple(state.pos[0].tolist())
    assert tuple(np.argwhere(obs[..., 2])[0]) == tuple(state.goal[0].tolist())
    with pytest.raises(ValueError, match="Unknown observation type"):
        build_gridworld_task("simple", observation_type="pixels")
    with pytest.raises(ValueError, match="Unknown gridworld task"):
        build_gridworld_task("maze")


@pytest.mark.parametrize("layout", ["obstacle", "simple"])
def test_render_and_video_frames_equal_jax(layout) -> None:
    """``env.render`` and the video ``Renderer``'s grid frame, to the byte,
    over a few steps of a random walk."""
    jenv, tenv = _pair(layout, tgrid.OBS_AGENT_POS)
    jstate, _ = jenv.reset(jax.random.key(4))
    tstate, _ = tenv.reset_with_goals(torch.from_numpy(np.array(jstate.goal))[None])
    ours, theirs = Renderer("grid", tenv), JaxRenderer("grid", jenv)
    frames = set()
    for a in np.random.RandomState(0).randint(0, 5, 12):
        tstate, tts = tenv.step(tstate, torch.tensor([float(a)]))
        jstate, jts = jenv.step(jstate, jnp.asarray(a, jnp.int32))
        for px in (8, 24):
            np.testing.assert_array_equal(tenv.render(tstate, cell_px=px),
                                          jenv.render(jstate, cell_px=px))
        got = ours(tts.physics[0].numpy())
        assert got.dtype == np.uint8 and got.shape == (256, 256, 3)
        np.testing.assert_array_equal(got, theirs(np.asarray(jts.physics)))
        frames.add(got.tobytes())
    assert len(frames) > 1
