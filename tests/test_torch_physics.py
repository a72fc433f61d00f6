"""The port's planar dynamics (``envs/physics2d.py``: ``mass_matrix`` ...
``step``) against the JAX package's on the same numpy-seeded states, for
walker, cheetah and hopper and for the two toy models of
``tests/test_physics2d.py``; and that file's physical checks on the port.

The JAX functions take one state and differentiate by autodiff; they are
``vmap``-ed here. The port's are batched and differentiate by hand. Both run
in float32: outputs are held to rtol 1e-4 with an atol of 1e-5 of the
output's largest entry (entries that cancel to near 0 carry the rounding of
the terms they cancel from).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.envs import locomotion as jloco
from controllable_agent_tpu.envs import physics2d as jp2d
from controllable_agent_torch.envs import locomotion as tloco
from controllable_agent_torch.envs import physics2d as tp2d
from controllable_agent_torch.tools import dynamics_check
from torch_threads import one_thread  # noqa: F401

STATES = 64
RTOL, ATOL_OF_MAX = 1e-4, 1e-5


def _toy(kind: str, xp) -> dict:
    """The ball and the double pendulum of tests/test_physics2d.py as keyword
    arguments of either package's ``PlanarModel``."""
    def arr(values, shape=None):
        out = np.asarray(values, np.float32)
        return xp.asarray(out if shape is None else out.reshape(shape))

    if kind == "ball":
        mass = jp2d.capsule_mass(0.1, 0.0)
        return dict(parent=(-1,), anchor=arr(np.zeros((1, 2))), com=arr(np.zeros((1, 2))),
                    mass=arr([mass]), inertia=arr([jp2d.rod_inertia(mass, 0.0, 0.1)]),
                    contact_body=(0,), contact_point=arr(np.zeros((1, 2))),
                    contact_radius=arr([0.1]), gear=arr([], (0,)), damping=arr([], (0,)),
                    limit_lo=arr([], (0,)), limit_hi=arr([], (0,)), armature=arr([], (0,)))
    m1 = jp2d.capsule_mass(0.05, 0.5)
    return dict(parent=(-1, 0), anchor=arr([[0, 0], [0, -0.5]]),
                com=arr([[0, -0.25], [0, -0.25]]), mass=arr([m1, m1]),
                inertia=arr([jp2d.rod_inertia(m1, 0.5, 0.05)] * 2), contact_body=(1,),
                contact_point=arr([[0.0, -0.5]]), contact_radius=arr([0.05]),
                gear=arr([10.0]), damping=arr([0.0]), limit_lo=arr([-0.3]),
                limit_hi=arr([0.3]), armature=arr([0.0]))


def _models(name: str):
    if name in ("ball", "pendulum"):
        return jp2d.PlanarModel(**_toy(name, jnp)), tp2d.PlanarModel(**_toy(name, np))
    return jloco._MODELS[name](), tloco._MODELS[name]()


MODELS = ["walker", "cheetah", "hopper", "ball", "pendulum"]


def _states(ndof: int, seed: int = 0):
    """Poses around the ground (a share of the contacts penetrate), joints
    up to 2.5 rad (beyond every limit for some), velocities of a few units."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-1, 1, (STATES, ndof)).astype(np.float32)
    q[:, 1] = rng.uniform(0.0, 1.5, STATES)
    q[:, 3:] *= 2.5
    qd = (rng.randn(STATES, ndof) * 3).astype(np.float32)
    action = rng.uniform(-1, 1, (STATES, ndof - 3)).astype(np.float32)
    return q, qd, action


def _close(got: torch.Tensor, want, rtol: float = RTOL, atol_of_max: float = ATOL_OF_MAX):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol_of_max * max(float(np.abs(want).max()), 1e-6))


CASES = {
    "mass_matrix": (lambda p, m, q, qd, a: p.mass_matrix(m, q), 1),
    "bias_forces": (lambda p, m, q, qd, a: p.bias_forces(m, q, qd), 1),
    "gravity_forces": (lambda p, m, q, qd, a: p.gravity_forces(m, q), 1),
    "contact_forces": (lambda p, m, q, qd, a: p.contact_forces(m, q, qd), 2),
    "joint_forces": (lambda p, m, q, qd, a: p.joint_forces(m, q, qd, a), 1),
    "forward_dynamics": (lambda p, m, q, qd, a: p.forward_dynamics(m, q, qd, a), 2),
}


@pytest.mark.parametrize("fn", list(CASES))
@pytest.mark.parametrize("name", MODELS)
def test_dynamics_function_matches_jax(name, fn) -> None:
    jmodel, tmodel = _models(name)
    q, qd, action = _states(jmodel.ndof)
    call, outputs = CASES[fn]
    want = jax.vmap(lambda *xs: call(jp2d, jmodel, *xs))(q, qd, action)
    got = call(tp2d, tmodel, *map(torch.from_numpy, (q, qd, action)))
    if outputs == 1:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        _close(g, w)
    if fn == "contact_forces":  # the states do exercise the contacts, and free flight
        share = float((np.asarray(want[1]) > 0).mean())
        assert 0.02 < share < 0.9, share
    if fn == "joint_forces" and name != "ball":
        lo, hi = np.asarray(jmodel.limit_lo), np.asarray(jmodel.limit_hi)
        assert ((q[:, 3:] < lo) | (q[:, 3:] > hi)).any()  # some joints beyond their limits


@pytest.mark.parametrize("name", MODELS)
def test_one_control_step_matches_jax(name) -> None:
    """``step`` over one control step (4 to 10 substeps) at rtol 1e-3."""
    jmodel, tmodel = _models(name)
    q, qd, action = _states(jmodel.ndof, seed=1)
    dt, substeps = jloco._CONTROL.get(name, (0.02, 8))
    want = jax.vmap(lambda *xs: jp2d.step(jmodel, *xs, dt, substeps))(q, qd, action)
    got = tp2d.step(tmodel, *map(torch.from_numpy, (q, qd, action)), dt, substeps)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-3, atol_of_max=1e-4)


@pytest.mark.parametrize("name", ["walker", "cheetah", "hopper"])
def test_twenty_control_steps_match_jax(name) -> None:
    """20 control steps under fixed random actions from airborne states (no
    contact closes within the horizon, so no discontinuous gate can flip on
    one side alone): rtol 1e-2 with an atol of 1e-3 of the largest entry, for
    float32 rounding compounded over up to 200 substeps of stiff joint limits."""
    jmodel, tmodel = _models(name)
    q, qd, action = _states(jmodel.ndof, seed=2)
    q[:, 1] += 6.0
    q[:, 3:] *= 0.2
    qd *= 0.3
    dt, substeps = jloco._CONTROL[name]

    def rollout(q, qd, a):
        def body(carry, _):
            q, qd, _ = jp2d.step(jmodel, carry[0], carry[1], a, dt, substeps)
            return (q, qd, _), None
        touch0 = jnp.zeros(len(jmodel.contact_body))
        return jax.lax.scan(body, (q, qd, touch0), None, length=20)[0]

    want = jax.jit(jax.vmap(rollout))(q, qd, action)
    tq, tqd, ta = map(torch.from_numpy, (q, qd, action))
    for _ in range(20):
        tq, tqd, touch = tp2d.step(tmodel, tq, tqd, ta, dt, substeps)
    assert float(touch.max()) == 0.0 and float(np.asarray(want[2]).max()) == 0.0
    _close(tq, want[0], rtol=1e-2, atol_of_max=1e-3)
    _close(tqd, want[1], rtol=1e-2, atol_of_max=1e-3)


def test_leading_dimensions_and_float64() -> None:
    """Any leading dimensions; float64 states give float64 dynamics that the
    float32 ones agree with."""
    _, model = _models("walker")
    q, qd, action = map(torch.from_numpy, _states(model.ndof))
    flat = tp2d.forward_dynamics(model, q, qd, action)
    shaped = tp2d.forward_dynamics(model, q.reshape(4, 16, -1), qd.reshape(4, 16, -1),
                                   action.reshape(4, 16, -1))
    torch.testing.assert_close(shaped[0].reshape(64, -1), flat[0])
    double = tp2d.forward_dynamics(model, q.double(), qd.double(), action.double())
    assert double[0].dtype == torch.float64
    _close(flat[0], double[0].numpy(), rtol=1e-3, atol_of_max=1e-4)
    one = tp2d.forward_dynamics(model, q[0], qd[0], action[0])
    torch.testing.assert_close(one[0], flat[0][0], rtol=1e-4, atol=1e-2)


# -- the physical checks of tests/test_physics2d.py, on the port ----------------

def _ball(radius: float = 0.1) -> tp2d.PlanarModel:
    kwargs = _toy("ball", np)
    mass = tp2d.capsule_mass(radius, 0.0)
    kwargs.update(mass=np.asarray([mass], np.float32),
                  inertia=np.asarray([tp2d.rod_inertia(mass, 0.0, radius)], np.float32),
                  contact_radius=np.asarray([radius], np.float32))
    return tp2d.PlanarModel(**kwargs)


def _pendulum(lo: float = -10.0, hi: float = 10.0) -> tp2d.PlanarModel:
    kwargs = _toy("pendulum", np)
    kwargs.update(limit_lo=np.asarray([lo], np.float32), limit_hi=np.asarray([hi], np.float32))
    return tp2d.PlanarModel(**kwargs)


def test_free_fall_acceleration() -> None:
    qdd, _ = tp2d.forward_dynamics(_ball(), torch.tensor([0.0, 5.0, 0.0]), torch.zeros(3),
                                   torch.zeros(0))
    np.testing.assert_allclose(qdd.numpy(), [0.0, -tp2d.GRAVITY, 0.0], atol=1e-4)


def test_ball_rests_on_ground() -> None:
    model = _ball(0.1)
    q, qd = torch.tensor([[0.0, 0.3, 0.0]]), torch.zeros(1, 3)
    for _ in range(200):
        q, qd, touch = tp2d.step(model, q, qd, torch.zeros(1, 0), 0.02, 8)
    assert 0.05 < float(q[0, 1]) < 0.12  # resting on the surface, slight spring sag
    assert abs(float(qd[0, 1])) < 0.05
    assert float(touch[0, 0]) > 0  # normal force registered


def test_mass_matrix_symmetric_posdef() -> None:
    m = tp2d.mass_matrix(_pendulum(), torch.tensor([0.0, 2.0, 0.3, 0.5])).numpy()
    np.testing.assert_allclose(m, m.T, atol=1e-5)
    assert np.linalg.eigvalsh(m).min() > 0


def test_pendulum_energy_stable() -> None:
    """Passive double pendulum in the air: free fall conserves energy up to
    the integrator's error (< 2%)."""
    model = _pendulum()
    q, qd = torch.tensor([0.0, 3.0, 0.0, 1.0]), torch.zeros(4)

    def energy(q, qd) -> float:
        coms, _ = tp2d.com_world(model, q)
        kinetic = 0.5 * qd @ tp2d.mass_matrix(model, q) @ qd
        return float(kinetic + tp2d.GRAVITY * (torch.from_numpy(model.mass) * coms[:, 1]).sum())

    e0 = energy(q, qd)
    for _ in range(20):
        q, qd, _ = tp2d.step(model, q, qd, torch.zeros(1), 0.02, 8)
    assert abs(energy(q, qd) - e0) / abs(e0) < 0.02


def test_actuation_and_joint_limits() -> None:
    """Opposite torques turn the joint opposite ways; a soft limit keeps a
    driven joint near its range."""
    model = _pendulum()
    ends = []
    for torque in (1.0, -1.0):
        q, qd = torch.tensor([0.0, 3.0, 0.0, 0.0]), torch.zeros(4)
        for _ in range(10):
            q, qd, _ = tp2d.step(model, q, qd, torch.tensor([torque]), 0.02, 8)
        ends.append(float(q[3]))
    assert ends[0] > ends[1]
    limited = _pendulum(-0.2, 0.2)
    q, qd = torch.tensor([0.0, 3.0, 0.0, 0.0]), torch.zeros(4)
    for _ in range(100):
        q, qd, _ = tp2d.step(limited, q, qd, torch.tensor([1.0]), 0.02, 8)
    assert float(q[3]) < 0.6


@pytest.mark.parametrize("domain", dynamics_check.DOMAINS)
def test_float32_dynamics_hold_to_float64(domain) -> None:
    """The comparison that the card's dynamics are held by, run on the CPU:
    float32 against float64, ``forward_dynamics`` at 1e-4 and one control step
    at 1e-3 of each output's largest entry, with the share of states that may
    cross a contact gate in another substep and their bound as
    ``tools/dynamics_check.py`` states them."""
    pressed, held = dynamics_check.check_domain(domain, 2048, "cpu", seed=1)
    assert 0.05 < pressed < 0.95  # the states exercise both sides of the gates
    assert [h.what for h in held] == ["forward_dynamics qdd", "forward_dynamics fn",
                                      "step q", "step qd", "step touch"]
    assert all(h.ok for h in held), "; ".join(str(h) for h in held)


def test_dynamics_check_bounds_its_outliers() -> None:
    """``hold`` allows a share of states beyond the limit, not any error: one
    state in a thousand at 10x the limit passes, two in a hundred do not, and
    neither does one at more than ``OUTLIER_FACTOR`` times it or a state over
    the limit where none is allowed."""
    want = torch.ones(1000, 3, dtype=torch.float64)
    tol = dynamics_check.STEP_TOL

    def off(rows: int, by: float) -> torch.Tensor:
        got = want.clone().float()
        got[:rows, 0] += by
        return got

    assert dynamics_check.hold("x", off(1, 10 * tol), want, tol, 0.003).ok
    assert not dynamics_check.hold("x", off(20, 10 * tol), want, tol, 0.003).ok
    assert not dynamics_check.hold(
        "x", off(1, 2 * dynamics_check.OUTLIER_FACTOR * tol), want, tol, 0.003).ok
    assert not dynamics_check.hold("x", off(1, 10 * tol), want, tol).ok
    assert not dynamics_check.hold("x", off(1, float("nan")), want, tol, 0.003).ok
    assert dynamics_check.hold("x", off(1000, 0.5 * tol), want, tol).ok
