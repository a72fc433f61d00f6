"""The port's environments against the JAX package's: ``LocomotionEnv``
reset/step (the uniform draw of ``reset`` taken from the same JAX key),
``PointMassMaze`` with its wall, the three wrappers and ``StatefulEnv`` on
the cases of ``tests/test_wrappers.py``, and ``PhysicsAggregator``.

The JAX environments handle one instance and are ``vmap``-ed here; the
port's are batched by construction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.envs import locomotion as jloco
from controllable_agent_tpu.envs import pointmass as jpm
from controllable_agent_tpu.train import physics_stats as jstats
from controllable_agent_torch.envs import locomotion as tloco
from controllable_agent_torch.envs import pointmass as tpm
from controllable_agent_torch.envs.base import EnvSpec, StepType, TimeStep
from controllable_agent_torch.envs.wrappers import (ActionRepeatWrapper, FrameStackWrapper,
                                                    GoalAppendWrapper, StatefulEnv)
from controllable_agent_torch.train import physics_stats as tstats
from torch_threads import one_thread  # noqa: F401

ENVS = 4
TASKS = ["walker_walk", "cheetah_run", "hopper_hop"]


def _close(got: torch.Tensor, want, rtol: float, atol_of_max: float) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol_of_max * max(float(np.abs(want).max()), 1e-6))


def _reset_both(name: str, horizon: int = 20):
    """Both environments reset from the same keys: JAX ``reset(key)`` draws
    ``uniform(split(key)[0], (nj,))``; the port is handed that draw."""
    jenv, tenv = jloco.make(name, horizon), tloco.make(name, horizon)
    keys = jax.random.split(jax.random.key(3), ENVS)
    nj = jenv.model.ndof - 3
    u = np.stack([np.asarray(jax.random.uniform(jax.random.split(k)[0], (nj,))) for k in keys])
    jstate, jts = jax.jit(jax.vmap(jenv.reset))(keys)
    tstate, tts = tenv.reset_from_uniform(torch.from_numpy(u))
    return jenv, tenv, (jstate, jts), (tstate, tts)


@pytest.mark.parametrize("name", TASKS)
def test_locomotion_reset_matches_jax(name) -> None:
    """Joints within their limits at the drawn fractions, the root at
    ``init_z``; the cheetah after its 200 settling steps (rtol 1e-3: 800
    substeps on the ground in float32)."""
    jenv, tenv, (jstate, jts), (tstate, tts) = _reset_both(name)
    settles = name.startswith("cheetah")
    rtol, atol = (1e-3, 1e-3) if settles else (1e-5, 1e-6)
    _close(tts.observation, jts.observation, rtol, atol)
    _close(tts.physics, jts.physics, rtol, atol)
    _close(tstate.q, jstate.q, rtol, atol)
    assert tts.observation.shape == (ENVS, tenv.spec.obs_dim)
    assert bool(tts.first().all()) and float(tts.reward.abs().max()) == 0.0
    assert float(tts.discount.min()) == 1.0 and tts.step_type.dtype == torch.int32
    assert tstate.touch.shape == (ENVS, len(tenv.model.contact_body))
    if settles:  # it came to rest on the ground
        assert float(tstate.qd.abs().max()) < 0.5 and float(tstate.q[:, 1].max()) < 0.7
    else:
        assert float(tstate.qd.abs().max()) == 0.0


@pytest.mark.parametrize("name", TASKS)
def test_locomotion_steps_match_jax(name) -> None:
    """8 steps under random actions beyond [-1, 1] from the same reset:
    observation, reward, physics and step type; rtol 1e-2 with an atol of
    1e-3 of the largest entry (float32 over up to 80 substeps with contacts).
    The last step of the horizon is LAST on both sides."""
    horizon = 8
    jenv, tenv, (jstate, _), (tstate, _) = _reset_both(name, horizon)
    rng = np.random.RandomState(0)
    jstep = jax.jit(jax.vmap(jenv.step))
    for i in range(horizon):
        a = rng.uniform(-1.3, 1.3, (ENVS, tenv.spec.action_dim)).astype(np.float32)
        jstate, jts = jstep(jstate, a)
        tstate, tts = tenv.step(tstate, torch.from_numpy(a))
        assert float(tts.action.abs().max()) <= 1.0
        np.testing.assert_array_equal(tts.step_type.numpy(), np.asarray(jts.step_type))
        assert bool(tts.last().all()) == (i == horizon - 1)
    _close(tts.observation, jts.observation, 1e-2, 1e-3)
    _close(tts.physics, jts.physics, 1e-2, 1e-3)
    _close(tts.reward, jts.reward, 1e-2, 1e-3)
    _close(tstate.touch, jstate.touch, 1e-2, 1e-3)
    assert np.array_equal(tstate.t.numpy(), np.asarray(jstate.t))


def test_hopper_touch_observation() -> None:
    """A hopper dropped onto its foot senses toe and heel: the last two
    observation columns are log1p of those normal forces, as in JAX."""
    jenv, tenv = jloco.make("hopper_stand", 20), tloco.make("hopper_stand", 20)
    ndof = tenv.model.ndof
    q = np.zeros((1, ndof), np.float32)
    q[0, 1] = 0.88  # the foot's contact spheres just below the ground
    jstate = jloco.LocoState(q=jnp.asarray(q[0]), qd=jnp.zeros(ndof), touch=jnp.zeros(3),
                             t=jnp.zeros((), jnp.int32))
    tstate = tloco.LocoState(q=torch.from_numpy(q), qd=torch.zeros(1, ndof),
                             touch=torch.zeros(1, 3), t=torch.zeros(1, dtype=torch.int32))
    jstate, jts = jenv.step(jstate, jnp.zeros(4))
    tstate, tts = tenv.step(tstate, torch.zeros(1, 4))
    assert float(tts.observation[0, -2:].min()) > 1.0  # both sensors pressed
    _close(tts.observation[0], jts.observation, 1e-3, 1e-4)
    torch.testing.assert_close(tts.observation[0, -2:], torch.log1p(tstate.touch[0, 1:3]))
    # from stored physics the sensors read 0
    assert float(tenv.obs_from_physics(tts.physics)[0, -2:].abs().max()) == 0.0


def test_reset_draws_from_the_generator() -> None:
    env = tloco.make("walker_stand", 5)
    gen = torch.Generator().manual_seed(0)
    _, a = env.reset(gen, 3)
    _, b = env.reset(gen, 3)
    _, again = env.reset(torch.Generator().manual_seed(0), 3)
    assert not torch.equal(a.physics, b.physics)
    assert torch.equal(a.physics, again.physics)
    lo, hi = torch.from_numpy(env.model.limit_lo), torch.from_numpy(env.model.limit_hi)
    joints = a.physics[:, 3:9]
    assert bool(((joints >= lo) & (joints <= hi)).all())
    with pytest.raises(ValueError, match="Unknown walker task"):
        tloco.make("walker_hop")


def _pm_uniform(keys) -> np.ndarray:
    """The raw uniforms behind JAX ``PointMassMaze.reset``: x from the first
    half of the key, y from the second."""
    return np.asarray([[float(jax.random.uniform(k, ())) for k in jax.random.split(key)]
                       for key in keys], np.float32)


def test_point_mass_matches_jax() -> None:
    """Reset in the top-left room, then 200 steps pushed down and to the right
    into the wall: positions, velocities and rewards; atol 1e-6 (a few float32
    operations per substep, and the wall snaps to old coordinates exactly)."""
    jenv, tenv = jpm.PointMassMaze("reach_bottom_right", 200), tpm.PointMassMaze(
        "reach_bottom_right", 200)
    keys = jax.random.split(jax.random.key(5), 6)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    tstate, tts = tenv.reset_from_uniform(torch.from_numpy(_pm_uniform(keys)))
    _close(tts.observation, jts.observation, 1e-6, 1e-6)
    assert float(tts.physics[:, 0].max()) <= -0.15 and float(tts.physics[:, 1].min()) >= 0.15
    rng = np.random.RandomState(1)
    jstep = jax.jit(jax.vmap(jenv.step))
    blocked = False
    for _ in range(200):
        a = np.abs(rng.uniform(0.2, 1.3, (6, 2))).astype(np.float32) * [1.0, -1.0]
        jstate, jts = jstep(jstate, a.astype(np.float32))
        tstate, tts = tenv.step(tstate, torch.from_numpy(a.astype(np.float32)))
        blocked = blocked or bool((tstate.vel == 0.0).any())
        np.testing.assert_allclose(tts.physics.numpy(), np.asarray(jts.physics), atol=1e-6)
    assert blocked  # some instance ran into the wall and lost that velocity
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), atol=1e-6)
    assert bool(tts.last().all())


@pytest.mark.parametrize("case", range(6))
def test_blocked_matches_jax(case) -> None:
    """``_blocked`` on moves that enter each arm of the wall, slide along it,
    or stay clear."""
    moves = [((-0.1, 0.05), (-0.1, 0.02)), ((0.05, -0.1), (0.02, -0.1)),
             ((-0.1, 0.05), (-0.12, 0.05)), ((0.19, 0.035), (0.21, 0.02)),
             ((0.035, 0.035), (0.02, 0.02)), ((-0.25, 0.25), (-0.24, 0.26))]
    pos, new = (np.asarray(p, np.float32) for p in moves[case])
    want = np.asarray(jpm._blocked(jnp.asarray(pos), jnp.asarray(new)))
    got = tpm._blocked(torch.from_numpy(pos)[None], torch.from_numpy(new)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)


def _maze(horizon: int = 100) -> tpm.PointMassMaze:
    return tpm.PointMassMaze("reach_top_left", episode_length=horizon)


def test_action_repeat_sums_rewards() -> None:
    env = ActionRepeatWrapper(_maze(), 4)
    gen = torch.Generator().manual_seed(0)
    state, ts = env.reset(gen, 3)
    action = torch.tensor([[0.5, -0.5]]).expand(3, 2)
    inner_state, total = state, torch.zeros(3)
    for _ in range(4):
        inner_state, inner_ts = env.env.step(inner_state, action)
        total += inner_ts.reward
    state, ts = env.step(state, action)
    assert state.t.tolist() == [4, 4, 4]  # the inner environment advanced 4 steps
    torch.testing.assert_close(ts.reward, total)
    torch.testing.assert_close(ts.physics, inner_ts.physics)


def test_frame_stack() -> None:
    env = FrameStackWrapper(_maze(), 3)
    assert env.spec.obs_dim == 12
    state, ts = env.reset(torch.Generator().manual_seed(0), 2)
    assert ts.observation.shape == (2, 12)
    first = ts.observation
    torch.testing.assert_close(first[:, :4], first[:, 4:8])  # reset stacks one frame 3x
    state, ts = env.step(state, torch.tensor([[1.0, 0.0]]).expand(2, 2))
    assert not torch.allclose(ts.observation[:, :4], ts.observation[:, 8:])  # newest last
    torch.testing.assert_close(ts.observation[:, :8], first[:, 4:])
    torch.testing.assert_close(ts.observation[:, 8:], ts.physics)


def test_goal_append() -> None:
    env = GoalAppendWrapper(_maze(), lambda p: p[..., :2], append_goal_to_observation=True)
    assert env.spec.obs_dim == 6 and env.spec.goal_dim == 2
    state, ts = env.reset(torch.Generator().manual_seed(0), 4)
    assert ts.observation.shape == (4, 6)
    torch.testing.assert_close(ts.goal, ts.physics[:, :2])
    state, ts = env.step(state, torch.zeros(4, 2))
    torch.testing.assert_close(ts.observation, torch.cat([ts.physics, ts.goal], -1))
    plain = GoalAppendWrapper(_maze(), lambda p: p[..., :2])
    assert plain.spec.obs_dim == 4 and plain.spec.goal_dim == 2
    assert plain.reset(torch.Generator().manual_seed(0), 1)[1].goal.shape == (1, 2)


def test_stateful_adapter() -> None:
    env = StatefulEnv(_maze(10), seed=0, num_envs=2, device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        env.step([0.0, 0.0])
    ts = env.reset()
    assert ts.observation.shape == (2, 4)
    for _ in range(3):
        ts = env.step([0.3, 0.3])
    assert bool(torch.isfinite(ts.observation).all())
    assert not torch.equal(env.reset().observation, StatefulEnv(
        _maze(10), seed=1, num_envs=2, device="cpu").reset().observation)


def test_stateful_adapter_runs_on_the_card_by_default() -> None:
    """Like every entry point of the port: a CUDA device unless the caller
    asks for the CPU, and no silent switch where there is no card."""
    if torch.cuda.is_available():
        env = StatefulEnv(_maze(10), seed=0, num_envs=2)
        assert env.reset().observation.device.type == "cuda"
        assert env.step([0.3, 0.3]).observation.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StatefulEnv(_maze(10), seed=0, num_envs=2)


def test_timestep_and_spec() -> None:
    spec = EnvSpec(obs_dim=4, action_dim=2)
    assert (spec.obs_shape, spec.discrete_actions, spec.n_actions, spec.physics_dim,
            spec.goal_dim, spec.episode_length) == ((), False, 0, 0, 0, 1000)
    assert spec.replace(obs_dim=6).obs_dim == 6
    ts = TimeStep(step_type=torch.tensor([StepType.MID, StepType.LAST], dtype=torch.int32),
                  reward=torch.tensor([0.5, 1.0]), discount=torch.ones(2),
                  observation=torch.zeros(2, 4), action=torch.zeros(2, 2),
                  physics=torch.zeros(2, 4))
    assert ts.mid().tolist() == [True, False] and ts.last().tolist() == [False, True]
    row = ts.to_buffer_dict()
    assert set(row) == {"observation", "action", "reward", "discount", "physics"}
    assert row["reward"].shape == (2, 1) and row["discount"].shape == (2, 1)
    assert "goal" in ts.replace(goal=torch.zeros(2, 3)).to_buffer_dict()


@pytest.mark.parametrize("domain", ["walker", "point_mass_maze", "nowhere"])
def test_physics_aggregator_matches_jax(domain) -> None:
    rng = np.random.RandomState(0)
    dim = 18 if domain == "walker" else 4
    batches = [rng.randn(50, dim).astype(np.float32), rng.randn(30, dim).astype(np.float32)]
    if domain == "walker":
        jenv, tenv = jloco.make("walker_walk"), tloco.make("walker_walk")
        jfn, tfn = jax.jit(jenv.goal_features), tenv.goal_features
    else:
        jfn = tfn = None
    jagg = jstats.PhysicsAggregator(domain, features_fn=jfn)
    tagg = tstats.PhysicsAggregator(domain, features_fn=tfn)
    for batch in batches:
        jagg.add_batch(batch)
        tagg.add_batch(torch.from_numpy(batch))
    jagg.add(batches[0][:5])
    tagg.add(torch.from_numpy(batches[0][:5]))
    want, got = dict(jagg.dump()), dict(tagg.dump())
    assert set(got) == set(want) and (len(got) > 0) == (domain != "nowhere")
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-5)
    assert dict(tagg.dump()) == {}  # a dump clears the statistics
