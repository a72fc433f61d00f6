"""The port's 3-D engine and quadruped against the benchmark's plain
reference (``perfbench/reference/physics3d.py``, ``quadruped.py``), and the
engine's spans and substep counter (``utils/trace.py``).

The reference differentiates the Lagrangian by autodiff (``torch.func``)
where the port writes its derivatives by hand; both run here in float64.
The two are different arithmetic for the same equations, so they agree to
rounding: 1e-10 of the largest entry for one substep and for one control
step of 8 (measured: 1.5e-15 and 4.9e-14 of it on these states; the contact
stiffness and the servo gains amplify a few ulps over 8 substeps, and 1e-10
leaves three decades of room without hiding a wrong term, which moves the
step by 1e-4 or more). The observation, reward and goal are the same
formulas in float64: 1e-12.
"""

import numpy as np
import pytest
import torch

from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig
from controllable_agent_torch.envs import physics3d as tp3d
from controllable_agent_torch.envs import quadruped as tquad
from controllable_agent_torch.goals import spaces
from controllable_agent_torch.train.loops import WARMUP_RUNS, EpisodeCollector, init_meta_batched
from controllable_agent_torch.utils import trace
from perfbench.reference import physics3d as rp3d
from perfbench.reference import quadruped as rquad
# CapturedProgram over stand-ins for torch.cuda's graphs: warm-up runs and the
# capture run eagerly, a replay does nothing
from test_torch_trace import fake_graphs  # noqa: F401
from torch_threads import one_thread  # noqa: F401

STATES = 40
SPANS = ("p3d_kinematics", "p3d_contacts", "p3d_solve")


def _states(seed: int, count: int = STATES):
    """(q, qd, action) in float64: the root near the ground (a share of the
    contacts pressed), roll and pitch within half a radian, joints within a
    radian (some beyond their limits), velocities of a few units."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-1, 1, (count, 14))
    q[:, 2] = rng.uniform(0.0, 0.8, count)
    q[:, 3:5] *= 0.5
    q[:, 5] *= np.pi
    qd = rng.randn(count, 14) * 2
    action = rng.uniform(-1, 1, (count, 8)).astype(np.float32)  # the env casts to float32
    return [torch.from_numpy(x).double() for x in (q, qd, action)]


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float64
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-6), err


@pytest.mark.parametrize("substeps", [1, 8])
def test_step_matches_the_reference(substeps) -> None:
    """One substep and one control step (0.02 s) from the same states: the
    port's hand-written derivatives against the reference's autodiff."""
    q, qd, action = _states(substeps)
    model = tquad.quadruped_model()
    dt = 0.02 * substeps / 8
    got_q, got_qd, touch = tp3d.step(model, q, qd, action, dt, substeps)
    want_q, want_qd = rp3d.step(rquad.MODEL, q, qd, action, dt, substeps)
    _close(got_q, want_q, 1e-10)
    _close(got_qd, want_qd, 1e-10)
    # the states reach both sides of the gates: contacts pressed and free, joints
    # beyond their limits and inside them
    pressed = float((touch > 0).any(-1).double().mean())
    lo, hi = torch.from_numpy(model.limit_lo).double(), torch.from_numpy(model.limit_hi).double()
    beyond = float(((q[:, 6:] < lo) | (q[:, 6:] > hi)).any(-1).double().mean())
    assert 0.1 < pressed < 0.9 and 0.1 < beyond < 0.95, (pressed, beyond)


def test_reference_model_is_the_ports() -> None:
    """The reference's quadruped has the port's constants, to the bit."""
    port, ref = tquad.quadruped_model(), rquad.MODEL
    assert port.parent == ref.parent and port.contact_body == ref.contact_body
    for name in ("anchor", "com", "mass", "inertia", "contact_point", "contact_radius",
                 "damping", "limit_lo", "limit_hi", "armature", "servo_gain", "servo_center",
                 "servo_half"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    assert np.array_equal(port.axis[1:], ref.axis[1:])


def test_environment_matches_the_reference() -> None:
    """``QuadrupedEnv``'s reset, step (the filter carried in the state),
    observation, ``quadruped_stand`` reward and ``quad_pos_speed`` goal
    against the reference's, in float64."""
    env = tquad.QuadrupedEnv("stand")
    rng = np.random.RandomState(3)
    u = torch.from_numpy(rng.uniform(0, 1, (STATES, 8))).double()
    state, ts = env.reset_from_uniform(u)
    start = rquad.start(u)
    assert start.shape[-1] == rquad.PHYSICS + len(rquad.CARRIED)
    _close(torch.cat([state.q, state.qd, state.act], -1), start, 1e-12)
    _close(ts.observation, rquad.observation(start), 1e-12)
    # a state off the stance, with the filter part way: then one control step
    q, qd, action = _states(4)
    act = torch.from_numpy(rng.uniform(-1, 1, (STATES, 8))).double()
    state = tquad.QuadState(q=q, qd=qd, touch=torch.zeros_like(q[:, :8]),
                            t=torch.zeros(STATES, dtype=torch.int32), act=act)
    ref_state = torch.cat([q, qd, act], -1)
    new, ts = env.step(state, action)
    want = rquad.step(ref_state, action)
    _close(torch.cat([new.q, new.qd, new.act], -1), want, 1e-10)
    observation = ts.observation
    _close(observation, rquad.observation(torch.cat([new.q, new.qd, new.act], -1)), 1e-12)
    # the carried columns are the observation's filter columns
    _close(observation[:, list(rquad.CARRIED)], new.act, 0.0)
    physics = ts.physics
    _close(env.reward_from_physics(physics), rquad.REWARDS["quadruped_stand"](physics), 1e-12)
    _, space = spaces.goal_spaces.lookup("quad_pos_speed")
    _close(space(env.goal_features(physics)), rquad.GOALS["quad_pos_speed"](physics), 1e-12)
    # the states span the reward's slope
    reward = rquad.REWARDS["quadruped_stand"](physics)
    assert float(reward.min()) < 0.95 and float(reward.max()) > 0.99


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.reset_captures()
    yield
    trace.disable()
    trace.reset_captures()


def _collector(horizon: int = 4):
    env = tquad.QuadrupedEnv("stand", episode_length=horizon)
    agent = FBDDPGAgent(FBDDPGConfig(hidden_dim=32, backward_hidden_dim=16, feature_dim=16,
                                     z_dim=8, batch_size=16, goal_space="quad_pos_speed"),
                        37, 8, goal_dim=7, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(5)
    collector = EpisodeCollector(env, agent, 3, gen)
    collector.capture = True

    def call() -> None:
        state, ts = env.reset(gen, 3)
        collector(init_meta_batched(agent, gen, 3), state, ts, 0)

    return collector, call


def test_substep_counter_through_a_captured_control_step(fake_graphs) -> None:
    """``physics3d.substeps`` counts 8 a ``step`` call: the capture's warm-up
    steps count, the capture holds its step back, each replay adds 8. The
    float32 agent's layers read no bf16 copy."""
    collector, call = _collector(horizon=4)
    trace.reset_counters()
    call()
    program = collector._program
    held = dict(next(h for counts, h in program.held if counts is trace.counters))
    assert held == {"physics3d.substeps": 8, "bf16_copy.uses": 0, "bf16_copy.refreshes": 0}
    assert trace.counters["physics3d.substeps"] == 8 * (WARMUP_RUNS + 4)
    call()  # replays of the same capture
    assert collector._program is program
    assert trace.counters["physics3d.substeps"] == 8 * (WARMUP_RUNS + 8)
    trace.reset_counters()
    assert trace.counters == {"physics3d.substeps": 0, "bf16_copy.uses": 0,
                              "bf16_copy.refreshes": 0}


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def test_tracing_off_holds_no_mark_and_opens_no_span(fake_graphs) -> None:
    """With tracing off a captured 3-D control step holds no mark and the
    engine opens no span; with it on, each substep opens the three spans."""
    collector, call = _collector(horizon=3)
    events = _profiled(call)
    assert [r.marks for r in trace.captures()] == [0]
    assert not {e.name for e in events} & set(SPANS)
    with trace.traced():
        events = _profiled(call)  # captured anew, with the spans
    names = [e.name for e in events]
    # two warm-up steps and the capture's, each 8 substeps of the three spans
    assert all(names.count(s) == 8 * (WARMUP_RUNS + 1) for s in SPANS), names
    assert [r.marks for r in trace.captures()] == [0, 0]  # marks are the card's


def test_spans_hold_every_operation_of_the_step() -> None:
    """Every operation ``physics3d.step`` issues lies inside one of its three
    spans, and the spans follow each other in each substep."""
    q, qd, action = (x.float() for x in _states(6, count=8))
    model = tquad.quadruped_model()
    with trace.traced():
        events = _profiled(lambda: tp3d.step(model, q, qd, action, 0.02, 8))
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.name in SPANS)
    assert [n for _, _, n in spans] == list(SPANS) * 8
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    outside = [e.name for e in ops if not any(s <= e.time_range.start and e.time_range.end <= t
                                              for s, t, _ in spans)]
    assert not outside, outside
