"""The reading of a marked sub-window (``program_trace.py``) on a synthetic
event list, the metrics that read it, the runner that takes it
(``program_run.py``) rehearsed on the CPU and, marked ``cuda``, on a card."""

import json
import subprocess
import sys

import pytest

from controllable_agent_torch.utils.trace import Capture
from perfbench import harness, mode_windows, program_run, program_trace

METRICS = {name: harness.load_module(harness.HERE / "metrics" / f"{name}.py")
           for name in program_run.METRICS}
NAMES = {0: "sample", 1: "update", 2: "optimizer"}


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


class _Untyped(_Event):
    """An event of a PyTorch whose events do not name their activity (the
    harness reads it from the device and the name)."""

    activity_type = None

    def __getattribute__(self, attr):
        if attr == "activity_type":
            raise AttributeError(attr)
        return super().__getattribute__(attr)

    def device_type(self):
        return "DeviceType.CUDA"


def _replay(at, corr):
    """One replay of the trainer's program from ``at`` (ns): sample's work,
    8 ns of idle between the spans, the update's work with one optimizer
    step inside it, the metric sums after the spans."""
    ops = [("trace_begin_0", 0, 1), ("sample_kernel", 2, 10), ("trace_end_0", 11, 12),
           ("trace_begin_1", 20, 21), ("update_kernel", 22, 40), ("trace_begin_2", 41, 42),
           ("adam_kernel", 45, 50), ("trace_end_2", 51, 52), ("trace_end_1", 53, 54),
           ("sums_kernel", 55, 60)]
    return [_Event("kernel", name, at + s, at + t, corr) for name, s, t in ops]


def _events():
    return [_Event("user_annotation", "profiled_window", 0, 1000),
            _Event("user_annotation", "updates", 8, 990),
            _Event("user_annotation", "graph_replay", 2, 4),
            _Event("user_annotation", "graph_replay", 80, 90),
            *_replay(10, 7), *_replay(100, 8),
            # a host span's shadow on the device, as each PyTorch reads it
            _Untyped("", "graph_replay", 10, 70, 5),
            _Event("gpu_user_annotation", "graph_replay", 100, 160, 6),
            _Event("cuda_runtime", "cudaGraphLaunch", 2, 3, 7),
            _Event("cuda_runtime", "cudaGraphLaunch", 81, 89, 8),
            _Event("gpu_memcpy", "Memcpy DtoH", 900, 910, 99)]


def test_reduce_splits_busy_and_idle():
    r = program_trace.reduce(_events(), NAMES)
    assert r.replays == 2 and r.marks == 12 and r.kernels == 20 and r.ops == 21
    assert r.unmatched == 0
    assert r.span_busy_s == pytest.approx({"sample": 16e-9, "update": 46e-9,
                                           "optimizer": 10e-9})
    assert r.programs == {"sample+update": {"replays": 2, "busy_s": pytest.approx(72e-9)}}
    assert r.replay_busy_s == pytest.approx(72e-9)
    # inside a replay: 1 + 1 ns in sample, 8 between the spans and 1 after them,
    # 1 + 1 + 1 in update, 3 + 1 in the optimizer step
    assert r.replay_gap_s == pytest.approx(2 * 18e-9)
    assert r.between_replays_s == pytest.approx(30e-9)
    assert r.edge_idle_s == pytest.approx(10e-9 + 740e-9 + 90e-9)
    assert r.marks_s == pytest.approx(12e-9)
    idle = r.window_s - r.busy_s
    assert r.replay_gap_s + r.between_replays_s + r.edge_idle_s == pytest.approx(idle)
    gaps = dict(r.gaps)
    assert gaps["replay"] == pytest.approx(2 * 9e-9)
    assert gaps["optimizer"] == pytest.approx(2 * 4e-9)
    assert gaps["sample"] == pytest.approx(2 * 2e-9)
    assert gaps["update"] == pytest.approx(2 * 3e-9)
    assert gaps["graph_replay"] == pytest.approx(30e-9)  # between the replays
    assert gaps["updates"] == pytest.approx(740e-9 + 90e-9)
    assert gaps["outside_program_spans"] == pytest.approx(10e-9)
    assert r.host_s == {"updates": [1, pytest.approx(982e-9)],
                        "graph_replay": [2, pytest.approx(12e-9)],
                        "cudaGraphLaunch": [2, pytest.approx(9e-9)]}


@pytest.mark.parametrize("lost", ["trace_end_2", "trace_begin_2"])
def test_reduce_counts_a_lost_mark(lost):
    """A mark the profiler dropped: its pair is counted in ``unmatched``,
    and the other spans read as before."""
    events = [e for e in _events() if not (e.name() == lost and e.start_ns() > 100)]
    r = program_trace.reduce(events, NAMES)
    assert r.unmatched == 1 and r.marks == 11
    assert r.span_busy_s["sample"] == pytest.approx(16e-9)
    assert r.span_busy_s["update"] == pytest.approx(46e-9)


def test_reduce_needs_the_window():
    with pytest.raises(RuntimeError, match="window"):
        program_trace.reduce(_events()[1:], NAMES)


def test_metrics_read_the_marked_reading():
    r = program_trace.reduce(_events(), NAMES)
    record = {"program_trace": r, "profile_steps": 2,
              "captures": [Capture("trainer", 1.5, 0, 0), Capture("collector", 0.25, 0, 0)]}
    got = {name: m.read(record) for name, m in METRICS.items()}
    assert got["sample_ms.offline"] == pytest.approx(1e3 * 8e-9)
    assert got["optimizer_ms.offline"] == pytest.approx(1e3 * 5e-9)
    assert got["replay_gap_ms.offline"] == pytest.approx(1e3 * 18e-9)
    assert got["between_replays_ms.offline"] == pytest.approx(1e3 * 15e-9)
    assert got["env_step_share.online"] is None  # no collector in this window
    assert got["capture_s"] == pytest.approx(1.75)
    collector = r._replace(span_busy_s={"env_step": 3.0, "act": 1.0},
                           programs={"act+env_step": {"replays": 4, "busy_s": 5.0},
                                     "sample+update": {"replays": 2, "busy_s": 50.0}})
    assert METRICS["env_step_share.online"].read({"program_trace": collector}) == 60.0


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_reads_nothing_without_its_keys(name):
    assert METRICS[name].read({}) is None


@pytest.mark.parametrize("cell", ["fb_walker.offline", "fb_walker.online"])
def test_rehearsal_reads_no_metric(capsys, cell):
    """On the CPU nothing is marked and no capture is made: every metric
    reads None, and the window captured nothing."""
    rc = program_run.main(["--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds", "0.3",
                           "--rehearse"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["card"] == "cpu (rehearsal)"
    assert set(result["metrics"]) == set(METRICS)
    assert all(v is None for v in result["metrics"].values())
    assert result["setup_captures"] == result["window_captures"] == []


OFFLINE = ("sample_ms.offline", "optimizer_ms.offline", "replay_gap_ms.offline",
           "between_replays_ms.offline", "capture_s")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
def test_marked_run_on_the_card(cell):
    """A 5-s run of each cell on a card: its metrics read; no capture in the
    window; the marks are all the marked window adds to the unmarked one's
    device operations (a re-capture runs 3-4 of the first capture's copy
    kernels on the copy engine, so kernels alone differ); offline, ``sample``
    and ``update`` cover 95% of the replays' busy time, and the idle inside
    and between replays is the window's idle but for its edges (to 5%)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/program_run.py", "--workload", cell,
                          "--seed", str(2 ** 31 + 7), "--seconds", "5"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    wanted = OFFLINE if cell.endswith(".offline") else ("env_step_share.online", "capture_s")
    assert all(result["metrics"][m] is not None for m in wanted), result["metrics"]
    assert result["setup_captures"] and result["window_captures"] == []
    unmarked, marked, recaptured = result["unmarked"], result["marked"], result["recaptured"]
    assert marked["ops"] - marked["marks"] == pytest.approx(unmarked["ops"], abs=0.05)
    assert marked["kernels"] - marked["marks"] == pytest.approx(recaptured["kernels"], abs=0.05)
    program = result["program"]
    if cell.endswith(".offline"):
        spans = program["span_busy_s"]
        assert spans["sample"] + spans["update"] >= 0.95 * program["replay_busy_s"]
        idle = program["window_s"] - program["busy_s"] - program["edge_idle_s"]
        assert program["replay_gap_s"] + program["between_replays_s"] == pytest.approx(
            idle, rel=0.05)
        assert program["replays"] == result["per"]


def test_mode_windows_rehearsal(capsys):
    """One round of ``mode_windows.py`` on the CPU: a line with the untraced
    rate and the profiled split, no replay to split."""
    rc = mode_windows.main(["--workload", "sf_lap_walker.offline", "--seed", str(2 ** 31 + 9),
                            "--rounds", "1", "--seconds", "0.2", "--rehearse"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["round"] == 0 and line["updates_per_s"] > 0
    assert line["inside_ms"] == line["between_ms"] == 0.0
    assert mode_windows.main(["--workload", "fb_walker.online", "--seed", "1", "--rounds", "1",
                              "--seconds", "0.1", "--rehearse"]) == 2
