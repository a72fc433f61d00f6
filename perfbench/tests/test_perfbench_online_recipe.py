"""The recipe driver (``drivers/online_recipe.py``) on the CPU at small
widths: the state's carried columns, the replay's fill, the collector's
kernels per replay and the marked cycle's metrics on synthetic events, the
check failing a step that leaves out a substep, and a program without the
substep counter stopping at once."""

import json

import pytest
import torch

from perfbench import harness, program_trace
from perfbench import run as bench_run
from perfbench.drivers import online, online_recipe

CELL = "fb_quadruped.online"
SEED = 2 ** 31 + 29
NEW = ("launches_per_control_step.online", "physics3d_ms.online",
       "physics3d_solve_share.online", "physics3d_contact_share.online")
METRICS = {name: harness.load_module(harness.HERE / "metrics" / f"{name}.py")
           for name in NEW + ("env_step_share.online",)}


@pytest.fixture(scope="module")
def built():
    torch.set_num_threads(2)
    workload, config = harness.cell(CELL, rehearse=True)
    ctx = harness.Context(workload, config, torch.device("cpu"), 1, SEED, 0.0, False, 0.0)
    trainer, _, _, b = online_recipe.build(ctx, warm=False)
    return ctx, trainer, b


def test_the_fill_and_the_seed_cycle(built):
    """The replay holds ``fill_share`` of its episodes after the seed cycle:
    the synthetic ones first, as ``data.replay`` draws them, then the
    program's own; at the cell's size 990 synthetic and 10 collected."""
    ctx, trainer, b = built
    wl = ctx.workload
    fill = int(wl["replay_episodes"] * wl["fill_share"]) - wl["num_envs"] * wl["seed_cycles"]
    assert b.seed_cycle == fill > 0
    assert len(trainer.buffer) == b.collected["physics"].shape[0] == fill + wl["num_envs"]
    drawn = online_recipe.data.replay(fill, wl["episode_length"], ctx.config["env"], SEED,
                                      ctx.device, ctx.environment.replay_physics)
    for k, v in drawn.items():
        assert torch.equal(b.collected[k][:fill], v), k
    z = b.collected["z"][:fill]
    assert torch.allclose(torch.linalg.vector_norm(z, dim=-1), torch.full(z.shape[:2], 8 ** 0.5))
    full, _ = harness.cell(CELL)
    assert int(full["replay_episodes"] * full["fill_share"]) - full["num_envs"] == 990


def test_carried_columns_make_the_state(built):
    """The reference's state is the written physics with the observation's
    filter columns: with them the written next state follows the
    reference's step; with the filter zeroed it does not."""
    ctx, _, b = built
    cols, state = online_recipe._seed_cycle(ctx, b.collected, b.seed_cycle)
    env = ctx.environment
    assert state.shape[-1] == env.PHYSICS + len(env.CARRIED) == 36
    assert torch.equal(state[..., env.PHYSICS:], cols["observation"][..., list(env.CARRIED)])
    assert float(state[:, 1:, env.PHYSICS:].abs().max()) > 0.1  # the filter moved
    gaps = online.quantiles(online.step_gaps(env, state, cols["action"]))
    blind = state.clone()
    blind[..., env.PHYSICS:] = 0.0
    wrong = online.quantiles(online.step_gaps(env, blind, cols["action"], state[:, 1:]))
    assert gaps["step_gap"] < 1e-3 < wrong["step_gap"], (gaps, wrong)


class _Event:
    def __init__(self, kind, name, start, end, corr=0):
        self._kind, self._name, self._start, self._end, self._corr = kind, name, start, end, corr

    def activity_type(self):
        return self._kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr


def test_control_step_kernels():
    """Two collector replays of 3 kernels and a copy each, an eager reset
    kernel, then the commit's and a trainer replay's kernels after the
    collection's sync: 3 kernels a control step."""
    events = [_Event("user_annotation", "collect", 0, 50),
              _Event("user_annotation", "sync", 60, 100),
              _Event("user_annotation", "commit", 110, 120),
              _Event("kernel", "reset", 1, 2, 1),
              *[_Event("kernel", f"k{i}", 10 * r + i, 10 * r + i + 1, 10 + r)
                for r in (1, 2) for i in range(3)],
              *[_Event("gpu_memcpy", "Memcpy DtoD", 10 * r + 5, 10 * r + 6, 10 + r)
                for r in (1, 2)],
              _Event("gpu_user_annotation", "collect", 0, 50, 10),
              _Event("kernel", "commit", 111, 112, 30),
              *[_Event("kernel", f"t{i}", 130 + i, 131 + i, 40) for i in range(5)]]
    assert online_recipe.control_step_kernels(events) == 3.0
    # a third replay with one kernel's record dropped does not move the count
    dropped = events + [_Event("kernel", f"k{i}", 30 + i, 31 + i, 13) for i in range(2)]
    assert online_recipe.control_step_kernels(dropped) == 3.0
    assert online_recipe.control_step_kernels(events[1:]) is None  # no collection
    assert METRICS["launches_per_control_step.online"].read({"control_step_kernels": 3.0}) == 3.0


def test_marked_cycle_metrics():
    """The engine's metrics on a marked collector's reading: 4 control
    steps of 11 ns of work, ``env_step`` 7 of them, of which the solve 3 and
    the contacts 1."""
    names = {0: "act", 1: "env_step", 2: "p3d_kinematics", 3: "p3d_contacts", 4: "p3d_solve"}
    ops = [("trace_begin_0", 0, 1), ("policy", 2, 5), ("trace_end_0", 5, 6),
           ("trace_begin_1", 6, 7), ("trace_begin_2", 7, 8), ("kin", 8, 10),
           ("trace_end_2", 10, 11), ("trace_begin_3", 11, 12), ("contact", 12, 13),
           ("trace_end_3", 13, 14), ("trace_begin_4", 14, 15), ("solve", 15, 18),
           ("trace_end_4", 18, 19), ("obs", 19, 20), ("trace_end_1", 20, 21), ("write", 21, 22)]
    events = [_Event("user_annotation", "profiled_window", 0, 200),
              *[_Event("kernel", n, 30 * r + s, 30 * r + t, 50 + r) for r in range(4)
                for n, s, t in ops]]
    reading = program_trace.reduce(events, names)
    record = {"program_trace": reading}
    got = {name: METRICS[name].read(record) for name in METRICS}
    assert got["physics3d_ms.online"] == pytest.approx(1e3 * 4 * 7e-9 / 4)
    assert got["physics3d_solve_share.online"] == pytest.approx(100 * 3 / 7)
    assert got["physics3d_contact_share.online"] == pytest.approx(100 * 1 / 7)
    assert got["env_step_share.online"] == pytest.approx(100 * 7 / 11)
    for name in NEW:  # nothing to read: None, never 0
        assert METRICS[name].read({}) is None
    bare = reading._replace(span_busy_s={"env_step": 1.0})
    assert METRICS["physics3d_solve_share.online"].read({"program_trace": bare}) is None
    # read replay by replay, the same; then the profiler loses the second
    # replay's end of ``env_step``, and the fourth replay's timestamps overlap
    # the third's: the window's one stack goes wrong, the replays' do not
    busy, programs, broken = online_recipe.replay_spans(events, names)
    assert broken == 0 and programs == reading.programs
    assert busy == pytest.approx(reading.span_busy_s)
    lost = [e for e in events if not (e.name() == "trace_end_1" and e.correlation_id() == 51)]
    lost = [_Event(e.activity_type(), e.name(), e.start_ns() - 20 * (e.correlation_id() == 53),
                   e.end_ns() - 20 * (e.correlation_id() == 53), e.correlation_id())
            if e.start_ns() else e for e in lost]
    wrong = program_trace.reduce(lost, names)
    assert wrong.unmatched > 0 and wrong.programs != reading.programs
    busy, programs, broken = online_recipe.replay_spans(lost, names)
    assert broken == 1 and programs["act+env_step"]["replays"] == 3
    again = wrong._replace(span_busy_s=busy, programs=programs)
    for name in METRICS:
        assert METRICS[name].read({"program_trace": again}) == pytest.approx(got[name])


def correct(capsys):
    assert bench_run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.3",
                           "--rehearse"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return result["correct"], {k: v["value"] <= v["limit"] for k, v in result["checks"].items()}


def test_a_substep_left_out_fails(capsys, monkeypatch):
    """The 3-D step running 7 of its 8 substeps fails the check: the step's
    gap and the substep count."""
    from controllable_agent_torch.envs import physics3d
    step = physics3d.step

    def short(model, q, qd, action, dt, n_substeps, hfield=None):
        return step(model, q, qd, action, dt * (n_substeps - 1) / n_substeps, n_substeps - 1,
                    hfield)

    monkeypatch.setattr(physics3d, "step", short)
    ok, passed = correct(capsys)
    assert not ok and not passed["step_gap"] and not passed["substep_miscount"], passed


def test_a_program_without_the_counter_stops_at_once(monkeypatch):
    from controllable_agent_torch.utils import trace
    monkeypatch.delattr(trace, "counters")
    with pytest.raises(SystemExit, match="physics3d.substeps"):
        bench_run.main(["--workload", CELL, "--seed", "1", "--seconds", "1", "--rehearse"])
