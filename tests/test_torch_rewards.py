"""The port's reward zoo (``ops/tolerance.py``, ``envs/physics2d.py``,
``envs/locomotion.py``, ``envs/dmc_tasks.py``, ``goals/``) and the foreign
physics adapters of ``data/exorl.py`` against the JAX package's, on inputs
made from a numpy seed and handed to both.

Tolerances: elementwise float32 math in another order (rtol 1e-5 for
``tolerance``; rtol 1e-4 for kinematics, whose sums run over 7 bodies and
whose velocities come from a hand-written recursion instead of ``jacfwd``;
atol 1e-5 for features, observations and rewards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.data import exorl as jexorl
from controllable_agent_tpu.envs import locomotion as jloco
from controllable_agent_tpu.envs import physics2d as jp2d
from controllable_agent_tpu.goals import registry as jregistry
from controllable_agent_tpu.goals import rewards as jrewards
from controllable_agent_tpu.goals import yoga as jyoga
from controllable_agent_tpu.ops.tolerance import tolerance as jtolerance
from controllable_agent_torch.data import exorl as texorl
from controllable_agent_torch.envs import locomotion as tloco
from controllable_agent_torch.envs import physics2d as tp2d
from controllable_agent_torch.goals import registry as tregistry
from controllable_agent_torch.goals import rewards as trewards
from controllable_agent_torch.goals import yoga as tyoga
from controllable_agent_torch.ops.tolerance import tolerance
from torch_threads import one_thread  # noqa: F401

DOMAINS = ("walker", "cheetah", "hopper")
SIGMOIDS = ("gaussian", "hyperbolic", "long_tail", "reciprocal", "cosine", "linear",
            "quadratic", "tanh_squared")


def _physics(domain: str, n: int = 64, seed: int = 0) -> np.ndarray:
    """Plausible [q, qd] rows: the root near standing height, joint angles
    within a radian, velocities of a few units."""
    ndof = {"walker": 9, "cheetah": 9, "hopper": 7}[domain]
    rng = np.random.RandomState(seed)
    q = rng.uniform(-1.0, 1.0, (n, ndof))
    q[:, 0] = rng.uniform(-3, 3, n)
    q[:, 1] = rng.uniform(0.3, 1.6, n)
    qd = rng.randn(n, ndof) * 2.0
    return np.concatenate([q, qd], -1).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6) -> None:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("sigmoid", SIGMOIDS)
def test_tolerance(sigmoid) -> None:
    x = np.random.RandomState(1).uniform(-3, 3, 200).astype(np.float32)
    for bounds, margin, value in (((0.0, 0.0), 1.0, 0.1), ((-0.5, 1.0), 2.0, 0.5),
                                  ((1.0, float("inf")), 0.5, 0.3)):
        _close(tolerance(torch.from_numpy(x), bounds, margin, sigmoid, value),
               jtolerance(jnp.asarray(x), bounds, margin, sigmoid, value))


def test_tolerance_without_margin_and_its_checks() -> None:
    x = np.linspace(-2, 2, 41).astype(np.float32)
    _close(tolerance(torch.from_numpy(x), (-1.0, 0.5)), jtolerance(jnp.asarray(x), (-1.0, 0.5)))
    # value_at_margin=0 with the linear sigmoid: the rewards of the tasks
    _close(tolerance(torch.from_numpy(x), (1.0, float("inf")), 1.0, "linear", 0),
           jtolerance(jnp.asarray(x), (1.0, float("inf")), 1.0, "linear", 0))
    with pytest.raises(ValueError, match="Lower bound"):
        tolerance(torch.zeros(1), (1.0, 0.0))
    with pytest.raises(ValueError, match="margin"):
        tolerance(torch.zeros(1), (0.0, 1.0), margin=-1.0)
    with pytest.raises(ValueError, match="Unknown sigmoid"):
        tolerance(torch.ones(1) * 3, (0.0, 1.0), margin=1.0, sigmoid="nope")


@pytest.mark.parametrize("domain", DOMAINS)
def test_models_match(domain) -> None:
    jm, tm = jloco._MODELS[domain](), tloco._MODELS[domain]()
    assert jm.parent == tm.parent and jm.contact_body == tm.contact_body
    assert (jm.nb, jm.ndof) == (tm.nb, tm.ndof)
    for name in ("anchor", "com", "mass", "inertia", "contact_point", "contact_radius",
                 "gear", "damping", "limit_lo", "limit_hi", "armature"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)), getattr(tm, name), name)
    assert (jm.stiffness is None) == (tm.stiffness is None)
    assert jm.friction == tm.friction
    assert tp2d.capsule_mass(0.05, 0.4) == jp2d.capsule_mass(0.05, 0.4)
    assert tp2d.capsule_inertia(0.05, 0.4) == jp2d.capsule_inertia(0.05, 0.4)
    assert tp2d.rod_inertia(2.0, 0.4, 0.05) == jp2d.rod_inertia(2.0, 0.4, 0.05)


@pytest.mark.parametrize("domain", DOMAINS)
def test_kinematics(domain) -> None:
    """fk, com_world, contact_world and subtree_momentum, batched in the port
    and vmapped in JAX; rtol 1e-4, atol 1e-5 for entries near zero."""
    jm, tm = jloco._MODELS[domain](), tloco._MODELS[domain]()
    phys = _physics(domain)
    ndof = tm.ndof
    q, qd = phys[:, :ndof], phys[:, ndof:]
    tq, tqd = torch.from_numpy(q), torch.from_numpy(qd)
    tol = dict(rtol=1e-4, atol=1e-5)
    for got, want in zip(tp2d.fk(tm, tq), jax.vmap(lambda x: jp2d.fk(jm, x))(q)):
        _close(got, want, **tol)
    for got, want in zip(tp2d.com_world(tm, tq), jax.vmap(lambda x: jp2d.com_world(jm, x))(q)):
        _close(got, want, **tol)
    _close(tp2d.contact_world(tm, tq), jax.vmap(lambda x: jp2d.contact_world(jm, x))(q), **tol)
    want = jax.vmap(lambda x, v: jp2d.subtree_momentum(jm, x, v))(q, qd)
    for got, ref in zip(tp2d.subtree_momentum(tm, tq, tqd), want):
        _close(got, ref, **tol)
    # a single row and a [2, 4, ndof] batch give the same numbers
    single = tp2d.subtree_momentum(tm, tq[3], tqd[3])
    _close(single[1], want[1][3], **tol)
    stacked = tp2d.subtree_momentum(tm, tq[:8].reshape(2, 4, -1), tqd[:8].reshape(2, 4, -1))
    _close(stacked[0].reshape(8, 2), want[0][:8], **tol)


TASKS = [(d, t) for d in DOMAINS for t in jloco.TASKS[d]]


def test_task_tables_match() -> None:
    assert tloco.TASKS == jloco.TASKS and tloco._SPEEDS == jloco._SPEEDS
    assert tloco._CONTROL == jloco._CONTROL and tloco._INIT_Z == jloco._INIT_Z


@pytest.mark.parametrize("domain,task", TASKS, ids=[f"{d}_{t}" for d, t in TASKS])
def test_features_observations_and_rewards(domain, task) -> None:
    jenv, tenv = jloco.make(f"{domain}_{task}"), tloco.make(f"{domain}_{task}")
    assert (tenv.spec.obs_dim, tenv.spec.action_dim, tenv.spec.physics_dim) == (
        jenv.spec.obs_dim, jenv.spec.action_dim, jenv.spec.physics_dim)
    phys = _physics(domain, seed=len(task))
    t = torch.from_numpy(phys)
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(tenv.goal_features(t), jenv.goal_features(jnp.asarray(phys)), rtol=1e-4, atol=1e-5)
    _close(tenv.obs_from_physics(t), jenv.obs_from_physics(jnp.asarray(phys)), **tol)
    want = jax.vmap(jenv.reward_from_physics)(jnp.asarray(phys))
    got = tenv.reward_from_physics(t)
    _close(got, want, **tol)
    assert got.shape == (phys.shape[0],) and float(got.max()) > float(got.min())
    # leading dimensions: [4, 16, D] in one call
    _close(tenv.reward_from_physics(t.reshape(4, 16, -1)).reshape(-1), want, **tol)
    # the reward of a step is this function of the physics it reaches
    state, _ = tenv.reset(torch.Generator().manual_seed(0), 2)
    _, ts = tenv.step(state, torch.zeros(2, tenv.spec.action_dim))
    torch.testing.assert_close(ts.reward, tenv.reward_from_physics(ts.physics))


def test_registries_match() -> None:
    assert {g: sorted(f) for g, f in tregistry.goal_spaces.funcs.items()} == {
        g: sorted(f) for g, f in jregistry.goal_spaces.funcs.items()}
    assert {g: sorted(f) for g, f in tregistry.goals.funcs.items()} == {
        g: sorted(f) for g, f in jregistry.goals.funcs.items()}
    with pytest.raises(ValueError, match="duplicate"):
        tregistry.goal_spaces("walker")(trewards._spaces.simplified_walker)
    with pytest.raises(KeyError):
        tregistry.goal_spaces.lookup("nope")


SPACES = sorted((g, n) for g, f in jregistry.goal_spaces.funcs.items() for n in f)


@pytest.mark.parametrize("group,name", SPACES, ids=[n for _, n in SPACES])
def test_goal_spaces(group, name) -> None:
    feats = np.random.RandomState(2).randn(5, 3, 11).astype(np.float32)
    jfn, tfn = jregistry.goal_spaces.funcs[group][name], tregistry.goal_spaces.funcs[group][name]
    _close(tfn(torch.from_numpy(feats)), jfn(jnp.asarray(feats)))
    assert trewards.get_goal_space_dim(name) == jrewards.get_goal_space_dim(name)


GOALS = sorted((g, n) for g, f in jregistry.goals.funcs.items() for n in f)


@pytest.mark.parametrize("space,name", GOALS, ids=[f"{s}-{n}" for s, n in GOALS])
def test_registered_goals(space, name) -> None:
    np.testing.assert_array_equal(tregistry.goals.funcs[space][name](),
                                  jregistry.goals.funcs[space][name]())


REWARD_NAMES = (["walker_position", "walker_random_equation", "walker_yoga_bridge",
                 "walker_yoga_head_stand", "point_mass_maze_reach_top_left",
                 "point_mass_maze_reach_bottom_right"]
                + [f"{d}_{t}" for d, t in TASKS])


@pytest.mark.parametrize("name", REWARD_NAMES)
def test_get_reward_function(name) -> None:
    """Each ported name: the same class, the same seeded draw, the same
    rewards on the same physics (atol 1e-5)."""
    domain = name.split("_")[0] if name.split("_")[0] in DOMAINS else "walker"
    phys = _physics(domain, seed=3)
    if name.startswith("point_mass"):
        phys = (np.random.RandomState(3).uniform(-0.3, 0.3, (64, 4))).astype(np.float32)
        phys[:8, :2] = [-0.15, 0.15] + np.random.RandomState(4).randn(8, 2) * 0.01
    for seed in (0, 5):
        jr, tr = jrewards.get_reward_function(name, seed), trewards.get_reward_function(name, seed)
        assert type(tr).__name__ == type(jr).__name__
        got = tr.from_physics(torch.from_numpy(phys))
        assert torch.is_tensor(got) and got.shape == (64,)
        _close(got, jr.from_physics(phys), rtol=1e-5, atol=1e-5)
        _close(tr(torch.from_numpy(phys[0])), jr(phys[0]), rtol=1e-5, atol=1e-5)


def test_reward_goals_and_the_equation_whitelist() -> None:
    for name, space in (("walker_position", "walker_pos_speed_z"),
                        ("walker_run", "simplified_walker"),
                        ("point_mass_maze_reach_top_right", "simplified_point_mass_maze")):
        np.testing.assert_array_equal(trewards.get_reward_function(name, 2).get_goal(space),
                                      jrewards.get_reward_function(name, 2).get_goal(space))
    with pytest.raises(ValueError, match="No registered goal"):
        trewards.get_reward_function("cheetah_run").get_goal("simplified_walker")
    with pytest.raises(ValueError, match="not supported"):
        trewards.get_reward_function("walker_position").get_goal("simplified_walker")
    with pytest.raises(ValueError, match="not allowed"):
        trewards.WalkerEquation("__import__('os').system('true')")
    with pytest.raises(ValueError, match="Unknown reward"):
        trewards.get_reward_function("nope")
    phys = _physics("walker", seed=6)
    for string in ("exp(-(x-1.5)**2) * up", "vx > 1", "abs(am) + sqrt(z) - sin(vz)", "1"):
        _close(trewards.WalkerEquation(string).from_physics(torch.from_numpy(phys)),
               jrewards.WalkerEquation(string).from_physics(phys), rtol=1e-4, atol=1e-5)
    feats = np.random.RandomState(7).randn(9, 6).astype(np.float32)
    _close(trewards.WalkerEquation("x + 2 * up").from_features(torch.from_numpy(feats)),
           jrewards.WalkerEquation("x + 2 * up").from_features(feats))
    assert trewards.extract_names("exp(x) + vx") == {"exp", "x", "vx"}


def test_maze_multi_goal() -> None:
    jm, tm = jrewards.MazeMultiGoal(), trewards.MazeMultiGoal()
    np.testing.assert_array_equal(tm.goals, jm.goals)
    achieved = (tm.goals[:, None] + np.random.RandomState(8).randn(20, 6, 2) * 0.02
                ).astype(np.float32)
    got = tm.from_goal(torch.from_numpy(achieved), torch.from_numpy(tm.goals[:, None]))
    want = jm.from_goal(achieved, jm.goals[:, None])
    _close(got[0], want[0], atol=1e-5)
    _close(got[1], want[1], atol=1e-6)


@pytest.mark.parametrize("pose", sorted(jyoga.get_walkeryoga_goals()))
def test_yoga_rewards(pose) -> None:
    np.testing.assert_array_equal(tyoga.get_walkeryoga_goals()[pose],
                                  jyoga.get_walkeryoga_goals()[pose])
    phys = _physics("walker", seed=9) * np.float32(2.5)  # angles past pi too
    _close(tyoga.WalkerYogaReward(pose).from_physics(torch.from_numpy(phys)),
           jyoga.WalkerYogaReward(pose).from_physics(phys), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="Unknown yoga pose"):
        tyoga.WalkerYogaReward("nope")


@pytest.mark.parametrize("name", ["quadruped_mix", "quadruped_position", "quadruped_walk",
                                  "jaco_reach_top_left"])
def test_rewards_of_unported_domains_raise(name) -> None:
    """The four rewards of the domains that were unported before the 3-D
    engine, now served: the same rewards as JAX's of the same physics."""
    width = 27 if name.startswith("jaco") else 28
    physics = np.random.RandomState(12).uniform(-1, 1, (32, width)).astype(np.float32)
    physics[:, 2] += 0.6
    if name.startswith("jaco"):
        physics[:, :6] = [-0.4, 0, 0, 0, 0, 0]
        physics[:, -3:] = [-0.09, 0.09, 0.001]
    _close(trewards.get_reward_function(name, seed=3).from_physics(torch.from_numpy(physics)),
           jrewards.get_reward_function(name, seed=3).from_physics(physics), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["mujoco_walker", "mujoco_cheetah", "mujoco_hopper"])
def test_physics_adapters(fmt) -> None:
    width = 14 if fmt == "mujoco_hopper" else 18
    phys = np.random.RandomState(10).randn(3, 11, width).astype(np.float32)
    np.testing.assert_array_equal(texorl.PHYSICS_ADAPTERS[fmt](phys),
                                  jexorl.PHYSICS_ADAPTERS[fmt](phys))
    assert texorl.PHYSICS_ADAPTERS["native"] is None
    assert sorted(texorl.PHYSICS_ADAPTERS) == sorted(jexorl.PHYSICS_ADAPTERS)


def test_quadruped_feature_adapter() -> None:
    phys = np.random.RandomState(11).randn(7, 45).astype(np.float32)
    np.testing.assert_array_equal(texorl.FEATURE_ADAPTERS["mujoco_quadruped"](phys),
                                  jexorl.FEATURE_ADAPTERS["mujoco_quadruped"](phys))
