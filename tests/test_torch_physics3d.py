"""The port's 3-D dynamics (``envs/physics3d.py``) against the JAX package's
on the same numpy-seeded states, for the quadruped (flat ground and an escape
terrain) and jaco (fixed base); the hand-written derivatives against
``torch.func`` of the port's own kinematics; and the float32 dynamics
against float64 (``tools/dynamics_check.py``).

The JAX functions take one state and differentiate by autodiff; they are
``vmap``-ed and compiled once per module. The port's are batched and
differentiate by hand. Tolerances follow ``tests/test_torch_physics.py``:
rtol 1e-4 with an atol of 1e-5 of the output's largest entry for the
dynamics functions, 1e-3 / 1e-4 for one control step, 1e-2 / 1e-3 for twenty
control steps in the air; the hand derivatives are held to ``torch.func``
at 1e-10 in float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import func as tfunc

from controllable_agent_tpu.envs import jaco as jjaco
from controllable_agent_tpu.envs import physics3d as jp3d
from controllable_agent_tpu.envs import quadruped as jquad
from controllable_agent_torch.envs import jaco as tjaco
from controllable_agent_torch.envs import physics3d as tp3d
from controllable_agent_torch.envs import quadruped as tquad
from controllable_agent_torch.tools import dynamics_check

STATES = 48
RTOL, ATOL_OF_MAX = 1e-4, 1e-5
MODELS = ["quadruped", "escape", "jaco"]
CONTROL = {"quadruped": 0.02, "escape": 0.02, "jaco": 0.04}  # control step, 8 substeps


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The engine's products are small (14 x 78 per environment): with the
    test workers sharing the cores, MKL's threads spend their time waiting
    for each other, so this module runs them on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got: torch.Tensor, want, rtol: float = RTOL, atol_of_max: float = ATOL_OF_MAX):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol_of_max * max(float(np.abs(want).max()), 1e-6))


def _terrain() -> np.ndarray:
    bumps = np.random.RandomState(5).uniform(0.15, 1.0, (30, 30)).astype(np.float32)
    return np.asarray(tquad.generate_terrain(torch.from_numpy(bumps)))


def _models(name: str):
    """(JAX model, port model, JAX heightfield or None, port heightfield or None)."""
    if name == "jaco":
        return jjaco.jaco_model(), tjaco.jaco_model(), None, None
    jhf = thf = None
    if name == "escape":
        terrain = _terrain()
        jhf = jp3d.Heightfield(data=jnp.asarray(terrain), half_size=30.0)
        thf = tp3d.Heightfield(data=torch.from_numpy(terrain), half_size=30.0)
    return jquad.quadruped_model(), tquad.quadruped_model(), jhf, thf


def _states(name: str, seed: int = 0, count: int = STATES):
    """(q, qd, action) float32: the root near the ground (a share of the
    contacts pressed), roll and pitch within half a radian, joints within a
    radian (some beyond their limits), velocities of a few units; jaco at
    its pinned root with joints around the ready pose, a share of them
    with the tool centre point under the table."""
    rng = np.random.RandomState(seed)
    ndof = 12 if name == "jaco" else 14
    q = rng.uniform(-1, 1, (count, ndof))
    qd = rng.randn(count, ndof) * 2
    action = rng.uniform(-1, 1, (count, ndof - 6))
    if name == "jaco":
        q[:, :6] = [-0.4, 0, 0, 0, 0, 0]
        q[:, 6:] = q[:, 6:] + np.asarray([0.0, 1.4, 1.4, 0.0, 1.0, 0.0])  # leaning to the table
        qd[:, :6] = 0.0
    else:
        q[:, 2] = rng.uniform(0.0, 0.8, count)
        q[:, 3:5] *= 0.5
        q[:, 5] *= np.pi
        if name == "escape":
            q[:, :2] = rng.uniform(-25, 25, (count, 2))
            _, _, _, thf = _models(name)
            q[:, 2] += tp3d.hf_height(thf, torch.from_numpy(q[:, :2]).float()).numpy()
    return [x.astype(np.float32) for x in (q, qd, action)]


@pytest.fixture(scope="module")
def jax_fns():
    """Per model, every JAX dynamics function in one program and one control
    step, each ``vmap``-ed over states and compiled once."""
    out = {}
    for name in MODELS:
        jm, _, jhf, _ = _models(name)

        def functions(q, qd, a, jm=jm, jhf=jhf):
            jac = jax.jacfwd(lambda x: jp3d.contact_world(jm, x))(q)
            return {"mass_matrix": jp3d.mass_matrix(jm, q),
                    "bias_forces": jp3d.bias_forces(jm, q, qd),
                    "gravity_forces": jp3d.gravity_forces(jm, q),
                    "contact_forces": jp3d.contact_forces(jm, q, qd, jhf),
                    "joint_forces": jp3d.joint_forces(jm, q, qd, a),
                    "forward_dynamics": jp3d.forward_dynamics(jm, q, qd, a, jhf),
                    "body_omegas": jp3d.body_omegas(jm, q, qd),
                    "contact_velocities": jnp.einsum("cid,d->ci", jac, qd)}

        def step(q, qd, a, jm=jm, jhf=jhf, dt=CONTROL[name]):
            return jp3d.step(jm, q, qd, a, dt, 8, jhf)

        out[name] = {"functions": _compiled(functions), "step": _compiled(step)}
    return out


def _compiled(fn):
    """``fn`` vmap-ed, compiled for the first shapes it is called with, at
    XLA's backend optimization level 0 (a fifth of the compile time here;
    the values agree to float32 rounding)."""
    programs = {}

    def call(*args):
        key = tuple(np.shape(x) for x in args)
        if key not in programs:
            programs[key] = jax.jit(jax.vmap(fn)).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return programs[key](*args)

    return call


def _port_call(fn: str, name: str, q, qd, a):
    _, tm, _, thf = _models(name)
    return {
        "mass_matrix": lambda: tp3d.mass_matrix(tm, q),
        "bias_forces": lambda: tp3d.bias_forces(tm, q, qd),
        "gravity_forces": lambda: tp3d.gravity_forces(tm, q),
        "contact_forces": lambda: tp3d.contact_forces(tm, q, qd, thf),
        "joint_forces": lambda: tp3d.joint_forces(tm, q, qd, a),
        "forward_dynamics": lambda: tp3d.forward_dynamics(tm, q, qd, a, thf),
        "body_omegas": lambda: tp3d.body_omegas(tm, q, qd),
        "contact_velocities": lambda: tp3d.contact_motion(tm, q, qd)[1],
        "step": lambda: tp3d.step(tm, q, qd, a, CONTROL[name], 8, thf),
    }[fn]()


FUNCTIONS = ["mass_matrix", "bias_forces", "gravity_forces", "contact_forces", "joint_forces",
             "forward_dynamics", "body_omegas", "contact_velocities"]


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("name", MODELS)
def test_dynamics_function_matches_jax(jax_fns, name, fn) -> None:
    q, qd, a = _states(name)
    want = jax_fns[name]["functions"](q, qd, a)[fn]
    got = _port_call(fn, name, *map(torch.from_numpy, (q, qd, a)))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        _close(g, w)
    if fn == "contact_forces":  # the states do exercise the contacts, and free flight
        share = float((np.asarray(want[1]) > 0).any(-1).mean())
        assert 0.05 < share < 0.95, share
    if fn == "joint_forces":
        jm = _models(name)[0]
        lo, hi = np.asarray(jm.limit_lo), np.asarray(jm.limit_hi)
        assert ((q[:, 6:] < lo) | (q[:, 6:] > hi)).any()  # some joints beyond their limits
    if fn == "forward_dynamics" and name == "jaco":  # the pinned root does not move
        assert float(got[0][:, :6].abs().max()) == 0.0


@pytest.mark.parametrize("name", MODELS)
def test_one_control_step_matches_jax(jax_fns, name) -> None:
    """``step`` over one control step of 8 substeps at rtol 1e-3. On the
    escape terrain a contact point that crosses a cell edge (where the
    bilinear normal jumps) in another substep on one side than on the other
    is pushed another way: there a share of the states may miss, as
    ``tools/dynamics_check.py`` allows escape's float32 against float64."""
    q, qd, a = _states(name, seed=1, count=2 * STATES)
    want = jax_fns[name]["step"](q, qd, a)
    got = _port_call("step", name, *map(torch.from_numpy, (q, qd, a)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if name == "escape":
            atol = 1e-4 * float(np.abs(w).max())
            miss = (np.abs(g - w) > atol + 1e-3 * np.abs(w)).reshape(len(w), -1).any(-1)
            assert np.isfinite(g).all() and miss.mean() <= dynamics_check.ALLOWANCES["quadruped_escape"][0], miss
            g, w = g[~miss], w[~miss]
        _close(torch.from_numpy(g), w, rtol=1e-3, atol_of_max=1e-4)


@pytest.mark.parametrize("name", ["quadruped", "jaco"])
def test_twenty_control_steps_match_jax(jax_fns, name) -> None:
    """20 control steps under fixed random actions from states lifted so far
    that no contact closes within the horizon: rtol 1e-2 with an atol of 1e-3
    of the largest entry."""
    jm, tm, _, _ = _models(name)
    q, qd, a = _states(name, seed=2, count=2 * STATES)
    q[:, 2] += 6.0
    q[:, 6:] = 0.2 * q[:, 6:] + 0.8 * np.asarray(jm.limit_lo + jm.limit_hi) / 2
    qd *= 0.3
    if name == "jaco":
        qd[:, :6] = 0.0
    jq, jqd = q, qd
    tq, tqd, ta = map(torch.from_numpy, (q, qd, a))
    for _ in range(20):
        jq, jqd, jtouch = jax_fns[name]["step"](jq, jqd, a)
        tq, tqd, touch = tp3d.step(tm, tq, tqd, ta, CONTROL[name], 8)
        assert float(touch.max()) == 0.0 and float(np.asarray(jtouch).max()) == 0.0
    _close(tq, jq, rtol=1e-2, atol_of_max=1e-3)
    _close(tqd, jqd, rtol=1e-2, atol_of_max=1e-3)


def test_heightfield_inside_and_outside_the_grid() -> None:
    """Heights and normals at points inside the terrain, outside it (clamped
    to the border, the slope across the border 0), and exactly on grid
    lines, against the JAX ``hf_height`` and ``hf_normal`` (its ``jax.grad``)."""
    terrain = _terrain()
    jhf = jp3d.Heightfield(data=jnp.asarray(terrain), half_size=30.0)
    thf = tp3d.Heightfield(data=torch.from_numpy(terrain), half_size=30.0)
    rng = np.random.RandomState(3)
    xy = np.concatenate([rng.uniform(-29.9, 29.9, (40, 2)), rng.uniform(30.5, 60, (10, 2)),
                         -rng.uniform(30.5, 60, (10, 2)),
                         np.stack([rng.uniform(-29, 29, 10), rng.uniform(31, 40, 10)], 1),
                         np.asarray([[0.0, 0.0], [30.0, 0.0], [-30.0, 6.0], [0.6, 1.2]])]
                        ).astype(np.float32)
    _close(tp3d.hf_height(thf, torch.from_numpy(xy)),
           jax.vmap(lambda p: jp3d.hf_height(jhf, p))(xy), 1e-5, 1e-6)
    got = tp3d.hf_normal(thf, torch.from_numpy(xy))
    _close(got, jax.vmap(lambda p: jp3d.hf_normal(jhf, p))(xy), 1e-5, 1e-6)
    outside = torch.from_numpy(np.abs(xy).max(1) > 30.0)
    assert float(got[outside][:, :2].abs().min()) == 0.0  # the clamped axis has no slope
    # a single terrain answers any shape of queries, one per environment a batch
    batched = tp3d.Heightfield(data=torch.from_numpy(np.stack([terrain, terrain * 0.5])),
                               half_size=30.0)
    pts = torch.from_numpy(xy[:8]).reshape(2, 4, 2)
    torch.testing.assert_close(tp3d.hf_height(batched, pts)[1],
                               0.5 * tp3d.hf_height(thf, pts[1]), rtol=1e-6, atol=1e-6)


# -- the hand derivatives against torch.func of the port's own kinematics ------

def _omega(model, q, qd):
    """w = unskew(Rdot R^T), Rdot by a forward-mode jvp of fk's rotations."""
    rots, rdots = tfunc.jvp(lambda x: tp3d.fk(model, x)[1], (q,), (qd,))
    w = rdots @ rots.mT
    return torch.stack([w[..., 2, 1], w[..., 0, 2], w[..., 1, 0]], -1)


def _mass_matrix_by_autodiff(model, q):
    jac_c = tfunc.jacfwd(lambda x: tp3d.com_world(model, x))(q)  # [nb, 3, ndof]
    jac_w = tfunc.jacfwd(lambda v: _omega(model, q, v))(torch.zeros_like(q))
    _, rots = tp3d.fk(model, q)
    inertia = torch.from_numpy(np.asarray(model.inertia, np.float64))
    i_world = torch.einsum("bij,bj,bkj->bik", rots, inertia, rots)
    mass = torch.from_numpy(np.asarray(model.mass, np.float64))
    m = torch.einsum("b,bid,bie->de", mass, jac_c, jac_c)
    m = m + torch.einsum("bid,bij,bje->de", jac_w, i_world, jac_w)
    arm = np.concatenate([np.zeros(6), np.asarray(model.armature, np.float64)])
    return m + torch.diag(torch.from_numpy(arm))


@pytest.mark.parametrize("name", ["quadruped", "jaco"])
def test_hand_derivatives_match_torch_func(name) -> None:
    """M, the Coriolis and centrifugal forces (Mdot qd - 1/2 d(qd^T M qd)/dq
    by jvp and grad of the autodiff M), gravity (-dV/dq by grad), the contact
    Jacobian (jacfwd of the contact points), the body angular velocities and
    the heightfield's normal, in float64 at 1e-10."""
    _, tm, _, _ = _models(name)
    q, qd, _ = (torch.from_numpy(x.astype(np.float64)) for x in _states(name, seed=4, count=3))
    mass = torch.from_numpy(np.asarray(tm.mass, np.float64))
    for i in range(3):
        qi, qdi = q[i], qd[i]
        m_ref = _mass_matrix_by_autodiff(tm, qi)
        torch.testing.assert_close(tp3d.mass_matrix(tm, qi), m_ref, rtol=1e-10, atol=1e-10)
        mdot = tfunc.jvp(lambda x: _mass_matrix_by_autodiff(tm, x) @ qdi, (qi,), (qdi,))[1]
        kinetic = tfunc.grad(lambda x: 0.5 * qdi @ _mass_matrix_by_autodiff(tm, x) @ qdi)(qi)
        torch.testing.assert_close(tp3d.bias_forces(tm, qi, qdi), mdot - kinetic,
                                   rtol=1e-10, atol=1e-10)
        gravity = -tfunc.grad(
            lambda x: tp3d.GRAVITY * (mass * tp3d.com_world(tm, x)[:, 2]).sum())(qi)
        torch.testing.assert_close(tp3d.gravity_forces(tm, qi), gravity, rtol=1e-10,
                                   atol=1e-10)
        # the contact Jacobian, column by column: the velocities of unit rates
        jac = tfunc.jacfwd(lambda x: tp3d.contact_world(tm, x))(qi)
        units = torch.eye(len(qi), dtype=torch.float64)
        by_hand = torch.stack([tp3d.contact_motion(tm, qi, e)[1] for e in units], -1)
        torch.testing.assert_close(by_hand, jac, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(tp3d.contact_motion(tm, qi, qdi)[1], jac @ qdi,
                                   rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(tp3d.body_omegas(tm, qi, qdi), _omega(tm, qi, qdi),
                                   rtol=1e-10, atol=1e-10)
    if name == "quadruped":
        hf = tp3d.Heightfield(data=torch.from_numpy(_terrain().astype(np.float64)),
                              half_size=30.0)
        for p in torch.from_numpy(np.random.RandomState(6).uniform(-40, 40, (8, 2))):
            g = tfunc.grad(lambda x: tp3d.hf_height(hf, x))(p)
            n = torch.cat([-g, torch.ones(1, dtype=torch.float64)])
            torch.testing.assert_close(tp3d.hf_normal(hf, p), n / n.norm(), rtol=1e-10,
                                       atol=1e-10)


# -- physical checks, and the float32 dynamics against float64 --------------------

def test_free_fall_and_symmetry() -> None:
    """Without the servos, a quadruped high in the air falls at g with no
    lateral acceleration (the JAX package's own check)."""
    model = dataclasses.replace(tquad.quadruped_model(), servo_gain=None, servo_center=None,
                                servo_half=None)
    q = torch.zeros(model.ndof)
    q[2] = 5.0
    qdd, fn = tp3d.forward_dynamics(model, q, torch.zeros(model.ndof), torch.zeros(8))
    assert abs(float(qdd[2]) + tp3d.GRAVITY) < 1e-3 * tp3d.GRAVITY
    assert abs(float(qdd[0])) < 1e-3 and abs(float(qdd[1])) < 1e-3 and float(fn.max()) == 0.0


def test_mass_matrix_symmetric_posdef_and_batched() -> None:
    """Any leading axes; float64 states give float64 dynamics that float32
    agrees with; M symmetric positive definite."""
    _, tm, _, _ = _models("quadruped")
    q, qd, a = map(torch.from_numpy, _states("quadruped", count=16))
    flat = tp3d.forward_dynamics(tm, q, qd, a)
    shaped = tp3d.forward_dynamics(tm, q.reshape(4, 4, -1), qd.reshape(4, 4, -1),
                                   a.reshape(4, 4, -1))
    torch.testing.assert_close(shaped[0].reshape(16, -1), flat[0])
    double = tp3d.forward_dynamics(tm, q.double(), qd.double(), a.double())
    assert double[0].dtype == torch.float64
    _close(flat[0], double[0].numpy(), rtol=1e-3, atol_of_max=1e-4)
    m = tp3d.mass_matrix(tm, q.double())
    torch.testing.assert_close(m, m.mT)
    assert float(torch.linalg.eigvalsh(m).min()) > 0


def test_model_constants_match_jax() -> None:
    """The port's quadruped and jaco models carry the JAX package's numbers."""
    for jm, tm in ((jquad.quadruped_model(), tquad.quadruped_model()),
                   (jjaco.jaco_model(), tjaco.jaco_model())):
        for f in dataclasses.fields(tp3d.Model3D):
            if f.name.startswith("_"):
                continue
            want, got = getattr(jm, f.name), getattr(tm, f.name)
            if isinstance(got, np.ndarray):
                np.testing.assert_array_equal(got, np.asarray(want))
            else:
                assert got == want, f.name


@pytest.mark.parametrize("domain", dynamics_check.DOMAINS_3D)
def test_float32_dynamics_hold_to_float64(domain) -> None:
    """The comparison that the card's 3-D dynamics are held by, run on the
    CPU: float32 against float64, ``forward_dynamics`` at 1e-4 and one
    control step at 1e-3 of each output's largest entry, with the share of
    states allowed beyond it as ``tools/dynamics_check.py`` states it."""
    pressed, held = dynamics_check.check_domain(domain, 1024, "cpu", seed=1)
    assert 0.05 < pressed < 0.95  # the states exercise both sides of the gates
    assert [h.what for h in held] == ["forward_dynamics qdd", "forward_dynamics fn",
                                      "step q", "step qd", "step touch"]
    assert all(h.ok for h in held), "; ".join(str(h) for h in held)
