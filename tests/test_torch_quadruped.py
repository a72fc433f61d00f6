"""The port's quadruped and jaco environments (``envs/quadruped.py``,
``envs/jaco.py``), their task rewards (``envs/dmc_tasks.py``), the
quadruped reward classes (``goals/rewards.py``) and the 3-D video frames
against the JAX package's, on the same numpy inputs and the same JAX draws.

The JAX environments handle one instance and are ``vmap``-ed here, each
control step compiled once per module; the port's are batched. Tolerances:
resets and one control step rtol 1e-4 / 1e-5 of the largest entry; three
control steps of the robot landing on its feet rtol 1e-2 / 1e-3 (float32
over 24 substeps of stiff contacts, as ``tests/test_torch_envs.py``);
rewards of the same physics and the reward classes rtol 1e-5; the terrain
atol 4e-6 (``test_generate_terrain_matches_jax`` says why); frames to the
byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.envs import dmc_tasks as jdmc
from controllable_agent_tpu.envs import jaco as jjaco
from controllable_agent_tpu.envs import quadruped as jquad
from controllable_agent_tpu.goals import rewards as jrewards
from controllable_agent_tpu.train.video import Renderer as JaxRenderer
from controllable_agent_torch.envs import dmc_tasks as tdmc
from controllable_agent_torch.envs import jaco as tjaco
from controllable_agent_torch.envs import physics3d as tp3d
from controllable_agent_torch.envs import quadruped as tquad
from controllable_agent_torch.goals import get_reward_function
from controllable_agent_torch.goals import rewards as trewards
from controllable_agent_torch.train.video import Renderer

ENVS, STEPS = 4, 3
BASE_TASKS = ["stand", "walk", "run", "jump", "roll", "roll_fast"]
JACO_TASKS = list(tjaco.TASKS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The engine's products are small (14 x 78 per environment): with the
    test workers sharing the cores, MKL's threads spend their time waiting
    for each other, so this module runs them on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got: torch.Tensor, want, rtol: float, atol_of_max: float) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol_of_max * max(float(np.abs(want).max()), 1e-6))


def _keys(n: int = ENVS, seed: int = 3):
    return jax.random.split(jax.random.key(seed), n)


def _uniform(keys, shape):
    return np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys])


def _draws(kind: str, keys):
    """The [0, 1) (and normal) draws behind each JAX reset key, in the
    order the port's ``reset_from_uniform`` takes them."""
    if kind == "escape":
        split = [jax.random.split(k) for k in keys]
        return (_uniform([s[1] for s in split], (8,)),
                _uniform([s[0] for s in split], (tquad.BUMP_RES, tquad.BUMP_RES)))
    if kind == "fetch":
        split = [jax.random.split(k, 5) for k in keys]
        spawn = np.stack([np.concatenate([_uniform([s[1]], ())[0][None], _uniform([s[2]], (2,))[0],
                                          _uniform([s[3]], (2,))[0]]) for s in split])
        normal = np.stack([np.asarray(jax.random.normal(s[4], (2,))) for s in split])
        return _uniform([s[0] for s in split], (8,)), spawn, normal
    if kind == "jaco":
        return (_uniform(keys, (6,)),)
    return (_uniform(keys, (8,)),)


def _envs(kind: str, task: str = "stand"):
    if kind == "jaco":
        return jjaco.make(f"jaco_{task}"), tjaco.make(f"jaco_{task}")
    name = f"quadruped_{kind if kind in ('escape', 'fetch') else task}"
    return jquad.make(name), tquad.make(name)


@pytest.fixture(scope="module")
def trajectories():
    """Per kind of environment (the flat-ground quadruped, escape, fetch,
    jaco), JAX's reset and ``STEPS`` control steps of one random action
    sequence, each step ``vmap``-ed and compiled once; and the port's
    reset from the same draws."""
    out = {}
    for kind in ("flat", "escape", "fetch", "jaco"):
        jenv, tenv = _envs(kind, "reach_top_left" if kind == "jaco" else "stand")
        keys = _keys()
        first = jax.vmap(jenv.reset)(keys)
        jstate, jts = first
        if kind == "jaco":  # one episode of each reach task in the batch
            targets = np.stack([jjaco.TASKS[t] for t in JACO_TASKS])
            jstate = jstate.replace(target=jnp.asarray(targets))
            jts = jts.replace(observation=jax.vmap(jenv._obs)(jstate),
                              physics=jax.vmap(jenv._physics)(jstate))
        actions = np.random.RandomState(0).uniform(
            -1.3, 1.3, (STEPS, ENVS, tenv.spec.action_dim)).astype(np.float32)
        step = jax.jit(jax.vmap(jenv.step))
        steps = []
        for a in actions:
            jstate, jts_step = step(jstate, a)
            steps.append((jstate, jts_step))
        out[kind] = {"reset": first, "draws": _draws(kind, keys),
                     "jaco_first": jts, "actions": actions, "steps": steps}
    return out


def _port_reset(kind: str, tenv, draws):
    state, ts = tenv.reset_from_uniform(*(torch.from_numpy(d) for d in draws))
    if kind == "jaco":
        targets = torch.from_numpy(np.stack([tjaco.TASKS[t] for t in JACO_TASKS]))
        state = tjaco.JacoState(q=state.q, qd=state.qd, touch=state.touch, t=state.t,
                                target=targets)
        ts = ts.replace(observation=tenv._obs(state), physics=tenv._physics(state))
    return state, ts


@pytest.mark.parametrize("kind", ["flat", "escape", "fetch", "jaco"])
def test_reset_matches_jax(trajectories, kind) -> None:
    """The reset from JAX's own draws: the stance with its joint noise, the
    terrain and the robot on it, the spawn of robot and ball, jaco's pose."""
    run = trajectories[kind]
    _, tenv = _envs(kind, "reach_top_left" if kind == "jaco" else "stand")
    state, ts = _port_reset(kind, tenv, run["draws"])
    jstate, jts = run["reset"]
    if kind == "jaco":
        jts = run["jaco_first"]
    _close(ts.observation, jts.observation, 1e-4, 1e-5)
    _close(ts.physics, jts.physics, 1e-4, 1e-5)
    _close(state.q, jstate.q, 1e-5, 1e-6)
    if kind == "escape":
        _close(state.terrain, jstate.terrain, 1e-5, 2e-7)
    assert bool(ts.first().all()) and ts.observation.shape == (ENVS, tenv.spec.obs_dim)
    assert ts.physics.shape == (ENVS, tenv.spec.physics_dim)
    assert float(ts.reward.abs().max()) == 0.0 and ts.step_type.dtype == torch.int32


def _port_steps(kind: str, tenv, run):
    state, _ = _port_reset(kind, tenv, run["draws"])
    out = []
    for a in run["actions"]:
        state, ts = tenv.step(state, torch.from_numpy(a))
        out.append((state, ts))
    return out


@pytest.mark.parametrize("task", BASE_TASKS + ["escape", "fetch"])
def test_quadruped_steps_match_jax(trajectories, task) -> None:
    """Every task's observations, physics, touch and rewards over the steps,
    the step types and clamped actions. The six flat-ground tasks share
    JAX's dynamics (one compiled step): each is held to its own JAX reward
    of that trajectory's physics."""
    kind = task if task in ("escape", "fetch") else "flat"
    run = trajectories[kind]
    jenv, tenv = _envs(kind, task)
    got = _port_steps(kind, tenv, run)
    reward_fn = jax.jit(jax.vmap(jenv.reward_from_physics))
    for i, ((tstate, tts), (jstate, jts)) in enumerate(zip(got, run["steps"])):
        rtol, atol = (1e-4, 1e-5) if i == 0 else (1e-2, 1e-3)
        _close(tts.observation, jts.observation, rtol, atol)
        _close(tts.physics, jts.physics, rtol, atol)
        _close(tstate.touch, jstate.touch, rtol, atol)
        _close(tts.reward, reward_fn(jts.physics), rtol, atol)
        # the reward of the same physics, to float32 rounding
        _close(tenv.reward_from_physics(torch.from_numpy(np.asarray(jts.physics))),
               reward_fn(jts.physics), 1e-5, 1e-6)
        np.testing.assert_array_equal(tts.step_type.numpy(), np.asarray(jts.step_type))
        assert float(tts.action.abs().max()) <= 1.0
    if kind == "escape":  # the terrain is handed on, not copied
        assert got[-1][0].terrain is got[0][0].terrain


def test_reward_from_features_matches_jax() -> None:
    """Each flat-ground task's reward as a function of the goal features
    (the relabeling path of foreign quadruped states)."""
    feats = np.random.RandomState(4).uniform(-2, 2, (64, 8)).astype(np.float32)
    feats[:, 0] = np.random.RandomState(5).uniform(-1, 1, 64)
    for task in BASE_TASKS:
        jenv, tenv = _envs("flat", task)
        _close(tenv.reward_from_features(torch.from_numpy(feats)),
               jax.vmap(jenv.reward_from_features)(feats), 1e-5, 1e-6)


def test_generate_terrain_matches_jax() -> None:
    """The bowl times the bumps resized by ``jax.image.resize(..., "linear")``
    against ``F.interpolate(mode="bilinear")`` on the same bumps, to 4e-6:
    the grid of ``jnp.linspace`` and ``torch.linspace`` differ by one float32
    unit (1.2e-7) at some points, which the bowl's slope (up to pi) and the
    height of 5 m make 1.9e-6; the resize adds up to 6e-7."""
    for k in _keys(3, seed=7):
        bumps = jax.random.uniform(k, (30, 30), minval=0.15, maxval=1.0)
        got = tquad.generate_terrain(torch.from_numpy(np.asarray(bumps)))
        want = jquad.generate_terrain(k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=4e-6)
        assert got.shape == (101, 101) and float(got.max()) > 1.0


def test_rangefinder_matches_jax() -> None:
    """The 20 rays against the terrain from torsos at random places and
    orientations over it: the same readings, some hitting within range,
    some not."""
    jenv, tenv = _envs("escape")
    rng = np.random.RandomState(8)
    n = 32
    terrain = np.asarray(jquad.generate_terrain(jax.random.key(9)))
    q = np.zeros((n, 14), np.float32)
    q[:, :2] = rng.uniform(-28, 28, (n, 2))
    hf = tp3d.Heightfield(torch.from_numpy(terrain), 30.0)
    q[:, 2] = tp3d.hf_height(hf, torch.from_numpy(q[:, :2])).numpy()
    q[:, 2] += rng.uniform(0.2, 1.5, n)
    q[:, 3:5] = rng.uniform(-0.6, 0.6, (n, 2))
    q[:, 5] = rng.uniform(-np.pi, np.pi, n)
    q[:, 6:] = rng.uniform(-1, 1, (n, 8))
    act = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
    zeros = np.zeros((n, 14), np.float32)
    terrains = np.broadcast_to(terrain, (n, 101, 101)).copy()
    jstate = jquad.EscapeState(q=q, qd=zeros, touch=np.zeros((n, 8), np.float32),
                               t=np.zeros(n, np.int32), act=act, terrain=terrains)
    want = jax.jit(jax.vmap(jenv._escape_obs))(jstate)
    tstate = tquad.EscapeState(q=torch.from_numpy(q), qd=torch.from_numpy(zeros),
                               touch=torch.zeros(n, 8), t=torch.zeros(n, dtype=torch.int32),
                               act=torch.from_numpy(act), terrain=torch.from_numpy(terrains))
    got = tenv._obs(tstate)
    _close(got, want, 1e-5, 1e-6)
    readings = got[:, -20:]
    assert float((readings < 1).float().mean()) > 0.1 and float((readings == 1).float().mean()) > 0.1


def test_fetch_ball_substep_matches_jax() -> None:
    """One ball substep from states that touch the ground, the arena's walls
    and the robot's collision spheres, against JAX's."""
    jenv, tenv = _envs("fetch")
    rng = np.random.RandomState(10)
    n = 48
    pts = rng.uniform(-1, 1, (n, 8, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(0, 0.6, (n, 8))
    pos = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(0.05, 0.4, (n, 1))], 1)
    pos[: n // 4, :2] = pts[: n // 4, 0, :2] + 0.05  # against a sphere
    pos[n // 4: n // 2, 0] = np.sign(rng.randn(n // 4)) * 14.95  # against a wall
    pos = pos.astype(np.float32)
    vel = (rng.randn(n, 3) * 2).astype(np.float32)
    angvel = (rng.randn(n, 3) * 5).astype(np.float32)
    pt_vels = rng.randn(n, 8, 3).astype(np.float32)
    radius = np.asarray(jenv.model.contact_radius)
    want = jax.vmap(lambda *x: jenv._ball_substep(*x, radius, 0.0025))(pos, vel, angvel, pts,
                                                                       pt_vels)
    got = tenv._ball_substep(*map(torch.from_numpy, (pos, vel, angvel, pts, pt_vels)),
                             torch.from_numpy(radius), 0.0025)
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-6)


def test_fetch_goal_features_match_jax() -> None:
    """The quadruped's features and the ball's position, for the
    ``quadruped_positions`` goal space."""
    jenv, tenv = _envs("fetch")
    physics = np.random.RandomState(11).randn(2, 5, tenv.spec.physics_dim).astype(np.float32)
    want = jenv.goal_features(jnp.asarray(physics))
    got = tenv.goal_features(torch.from_numpy(physics))
    assert got.shape == (2, 5, 11)
    _close(got, want, 1e-5, 1e-6)


@pytest.mark.parametrize("task", JACO_TASKS)
def test_jaco_task(trajectories, task) -> None:
    """Each reach task: its episode in the batch (the target in the state)
    over the steps, and its reward of every episode's physics."""
    run = trajectories["jaco"]
    jenv, tenv = _envs("jaco", task)
    got = _port_steps("jaco", tenv, run)
    row = JACO_TASKS.index(task)
    for i, ((tstate, tts), (jstate, jts)) in enumerate(zip(got, run["steps"])):
        rtol, atol = (1e-4, 1e-5) if i == 0 else (1e-3, 1e-4)
        _close(tts.observation[row], jts.observation[row], rtol, atol)
        _close(tts.physics[row], jts.physics[row], rtol, atol)
        _close(tts.reward[row], jts.reward[row], rtol, 1e-6)
    physics = np.asarray(run["steps"][-1][1].physics).copy()
    physics[:, -3:] = tjaco.TASKS[task]
    _close(tenv.reward_from_physics(torch.from_numpy(physics)),
           jax.vmap(jenv.reward_from_physics)(physics), 1e-5, 1e-6)
    assert tenv.spec.episode_length == 250 and tenv.spec.obs_dim == 24


def _quad_physics(n: int = 48, seed: int = 12) -> np.ndarray:
    rng = np.random.RandomState(seed)
    q = rng.uniform(-1, 1, (n, 14))
    q[:, :2] = rng.uniform(-6, 6, (n, 2))
    q[:, 2] = rng.uniform(0.2, 1.5, n)
    qd = rng.randn(n, 14) * 2
    return np.concatenate([q, qd], 1).astype(np.float32)


@pytest.mark.parametrize("name", [f"quadruped_{t}" for t in tquad.TASKS]
                         + [f"jaco_{t}" for t in JACO_TASKS])
def test_task_rewards_match_jax(name) -> None:
    """``get_reward_function`` serves every quadruped and jaco task: the
    same rewards of the same physics as JAX's ``dmc_tasks``."""
    physics = _quad_physics()
    if name == "quadruped_fetch":
        ball = np.random.RandomState(13).uniform(-2, 2, (len(physics), 9)).astype(np.float32)
        physics = np.concatenate([physics, ball], 1)
    if name.startswith("jaco"):
        physics = np.random.RandomState(14).uniform(-1, 1, (48, 27)).astype(np.float32)
        physics[:, 6:12] += [0.0, 0.9, 1.0, 0.0, 0.5, 0.0]
        physics[:, :6] = [-0.4, 0, 0, 0, 0, 0]
        physics[:, -3:] = tjaco.TASKS[name[len("jaco_"):]]
    reward = get_reward_function(name, seed=0)
    assert isinstance(reward, tdmc.TaskReward)
    _close(reward.from_physics(torch.from_numpy(physics)),
           jdmc.make_task_reward(name).from_physics(physics), 1e-5, 1e-6)


@pytest.mark.parametrize("seed,case", [(1, 0), (6, 1), (2, 2), (13, 3), (17, 4), (0, 5), (5, 6)])
def test_quadruped_mix_reward_matches_jax(seed, case) -> None:
    """``quadruped_mix``: the seed draws the same case and targets as JAX's,
    and the same rewards over leading axes."""
    ours, theirs = get_reward_function("quadruped_mix", seed), jrewards.QuadrupedReward(seed)
    assert ours._case == theirs._case == case
    np.testing.assert_array_equal(ours.x, theirs.x)
    np.testing.assert_array_equal(ours.quadrant, theirs.quadrant)
    physics = _quad_physics(seed=seed)
    physics[:, 14:16] *= 2.0  # speeds on both sides of the drawn one
    got = ours.from_physics(torch.from_numpy(physics.reshape(6, 8, -1)))
    assert got.shape == (6, 8)
    _close(got.reshape(-1), theirs.from_physics(physics), 1e-5, 1e-6)


def test_quadruped_position_reward_matches_jax() -> None:
    ours = get_reward_function("quadruped_position", 0)
    theirs = jrewards.QuadrupedPosReward(0)
    assert isinstance(ours, trewards.QuadrupedPosReward)
    np.testing.assert_array_equal(ours.get_goal("quad_pos_speed"),
                                  theirs.get_goal("quad_pos_speed"))
    physics = _quad_physics(seed=15)
    _close(ours.from_physics(torch.from_numpy(physics)), theirs.from_physics(physics), 1e-5, 1e-6)
    with pytest.raises(ValueError, match="not supported"):
        ours.get_goal("simplified_quadruped")


@pytest.mark.parametrize("domain", ["quadruped", "jaco"])
def test_3d_frames_equal_the_jax_renderer(domain) -> None:
    """The oblique projection of the 3-D tree, and jaco's target, to the byte."""
    if domain == "jaco":
        jenv, tenv = _envs("jaco", "reach_top_right")
        physics = np.random.RandomState(16).uniform(-1, 1, (8, 27)).astype(np.float32)
        physics[:, :6] = [-0.4, 0, 0, 0, 0, 0]
        physics[:, -3:] = tjaco.TASKS["reach_top_right"]
    else:
        jenv, tenv = _envs("flat")
        physics = _quad_physics(8, seed=17)
    ours, theirs = Renderer(domain, tenv), JaxRenderer(domain, jenv)
    for row in physics:
        got, want = ours(row), theirs(row)
        assert got.dtype == np.uint8 and got.shape == (256, 256, 3)
        assert np.array_equal(got, want)
    assert not np.array_equal(ours(physics[0]), ours(physics[1]))
