"""The reading of a profiled sub-window in which the port's tracing was on
(``controllable_agent_torch/utils/trace.py``): its device spans, marked on
the device by a pair of empty kernels each (``trace_begin_<id>``,
``trace_end_<id>``) inside every replay of a captured program, and its host
spans.

``reduce`` gives, from the profiler's events:

- each device span's busy time: the union of the intervals of the device
  operations between its begin and its end mark, the marks' own intervals
  left out, over every instance of the span (a mark whose pair is missing,
  as when the profiler drops records of a window of millions of kernels,
  is counted in ``unmatched`` and closes nothing);
- the replays: the device operations of one graph launch share the launch's
  correlation id (an eager launch runs one operation), so a correlation id
  that more than one operation shares is a replay, with or without marks.
  A replay's extent is its first to its last operation; ``programs`` sums each
  program's busy time (its operations' union, marks left out), keyed by
  its outermost spans in order (``sample+update`` for the trainer,
  ``act+env_step`` for the collector);
- the device's idle time inside the replays' extents, between one replay's
  end and the next one's start, and before the first and after the last
  replay (the closing synchronisation), which together are the window's
  idle time;
- every idle gap named by the innermost device span open on the device at
  its midpoint; inside a replay but outside any device span, ``replay``;
  between replays, by the innermost of the program's host spans open on
  the host at its midpoint (``graph_replay``, ``updates``, ``collect``, ...);
- each of the program's host spans' count and summed seconds (``host_s``),
  and those of the CUDA runtime's ``cudaGraphLaunch`` calls: the host's
  time launching the replays.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import typing as tp

import torch

from . import trace as bench_trace
from .harness import span

MARK = re.compile(r"^trace_(begin|end)_(\d+)$")
# the port's host spans (utils/trace.py and the layers that open them)
HOST_SPANS = ("graph_replay", "collect", "commit", "updates", "sample", "update", "optimizer",
              "act", "env_step")
TOP = 12
LAUNCH = "cudaGraphLaunch"


class ProgramReading(tp.NamedTuple):
    window_s: float
    busy_s: float  # the union of every device operation, marks included
    ops: int  # device operations (kernels, copies, sets), marks included
    kernels: int  # of which kernels
    marks: int
    marks_s: float  # the marks' own device time
    unmatched: int  # marks without their pair (the profiler dropped a record)
    replays: int
    span_busy_s: tp.Dict[str, float]
    programs: tp.Dict[str, tp.Dict[str, float]]  # {key: {"replays", "busy_s"}}
    replay_busy_s: float  # inside the replays, marks left out
    replay_gap_s: float
    between_replays_s: float
    edge_idle_s: float  # before the first replay and after the last
    gaps: tp.List[tp.List[tp.Any]]  # [name, seconds], the longest first
    host_s: tp.Dict[str, tp.List[float]]  # {name: [count, seconds]}


class _Op(tp.NamedTuple):
    start: int
    end: int
    name: str
    kernel: bool
    corr: int


@contextlib.contextmanager
def window(device: torch.device, events: tp.List[tp.Any]) -> tp.Iterator[None]:
    """Profile the block (CPU and CUDA activities, inside the benchmark's
    window span, closed by a synchronisation) and append its kineto events
    to ``events``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with span(bench_trace.WINDOW):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    events.extend(prof.profiler.kineto_results.events())


def _correlation(e: tp.Any) -> int:
    return int(e.correlation_id()) if hasattr(e, "correlation_id") else 0


class _Union:
    """The length of the union of intervals added in the order of their
    starts."""

    def __init__(self, reach: int = -1) -> None:
        self.reach, self.total = reach, 0

    def add(self, start: int, end: int) -> None:
        if end > self.reach:
            self.total += end - max(start, self.reach)
            self.reach = end


def _innermost_host(hosts: tp.Sequence[tp.Tuple[int, int, str]], starts: tp.Sequence[int],
                    at: float) -> str:
    """The innermost host span open at ``at`` (the spans nest, so the open
    one that started last), or ``outside_program_spans``."""
    i = bisect.bisect_right(starts, at)
    while i > 0:
        i -= 1
        if hosts[i][1] > at:
            return hosts[i][2]
    return "outside_program_spans"


def reduce(events: tp.Sequence[tp.Any], names: tp.Mapping[int, str]) -> ProgramReading:
    """``names``: each device span's name by its id
    (``trace.device_span_names()``). One sweep over the window's device
    operations in the order of their starts (an online cycle holds some two
    million)."""
    window, ops, hosts = None, [], []
    for e in events:
        kind = bench_trace._kind(e)
        if kind in bench_trace.DEVICE_ACTIVITIES:
            # a host span's shadow on the device (kineto's gpu_user_annotation,
            # which a PyTorch that does not name activities reads as a kernel)
            if e.name() not in HOST_SPANS:
                ops.append(_Op(e.start_ns(), e.end_ns(), e.name(), kind == "kernel",
                               _correlation(e)))
        elif kind == "gpu_user_annotation":
            continue
        elif kind == "user_annotation" and e.name() == bench_trace.WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif e.name() in HOST_SPANS or e.name() == LAUNCH:
            hosts.append((e.start_ns(), e.end_ns(), e.name()))
    if window is None:
        raise RuntimeError("the profiled window's span is missing from the trace")
    w0, w1 = window
    ops = sorted(op._replace(start=max(op.start, w0), end=min(op.end, w1))
                 for op in ops if op.end > w0 and op.start < w1)
    hosts = sorted((s, t, name) for s, t, name in hosts if t > w0 and s < w1)
    launches = [h for h in hosts if h[2] == LAUNCH]
    hosts = [h for h in hosts if h[2] != LAUNCH]
    host_starts = [s for s, _, _ in hosts]

    # the replays: the graph launches (correlation ids of more than one operation)
    extent: tp.Dict[int, tp.List[int]] = {}
    count: tp.Dict[int, int] = {}
    for op in ops:
        ext = extent.setdefault(op.corr, [op.start, op.end])
        ext[1] = max(ext[1], op.end)
        count[op.corr] = count.get(op.corr, 0) + 1
    replayed = {c for c, n in count.items() if n > 1}
    extents = sorted(tuple(extent[c]) for c in replayed)
    outer: tp.Dict[int, tp.List[str]] = {c: [] for c in replayed}
    program_busy = {c: _Union() for c in replayed}

    span_busy: tp.Dict[str, _Union] = {}
    stack: tp.List[str] = []
    busy = _Union(reach=w0)
    gaps: tp.Dict[str, float] = {}
    idle = {"inside": 0, "between": 0, "outside": 0}
    first, last = (extents[0][0], extents[-1][1]) if extents else (w1, w0)
    at = 0
    n_marks = marks_ns = unmatched = 0

    def gap(start: int, end: int) -> None:
        nonlocal at
        mid = (start + end) / 2
        while at < len(extents) and extents[at][1] <= mid:
            at += 1
        if at < len(extents) and extents[at][0] <= mid:
            where, name = "inside", (stack[-1] if stack else "replay")
        else:
            where = "between" if first <= mid < last else "outside"
            name = _innermost_host(hosts, host_starts, mid)
        idle[where] += end - start
        gaps[name] = gaps.get(name, 0.0) + (end - start) * 1e-9

    for op in ops:
        if op.start > busy.reach:
            gap(busy.reach, op.start)
        busy.add(op.start, op.end)
        m = MARK.match(op.name)
        if m is not None:
            n_marks += 1
            marks_ns += op.end - op.start
            name = names.get(int(m.group(2)), f"span_{m.group(2)}")
            if m.group(1) == "begin":
                if not stack and op.corr in outer:
                    outer[op.corr].append(name)
                stack.append(name)
            elif name in stack:  # spans opened inside it and not closed lost an end
                while stack.pop() != name:
                    unmatched += 1
            else:
                unmatched += 1
            continue
        for name in set(stack):
            span_busy.setdefault(name, _Union()).add(op.start, op.end)
        if op.corr in program_busy:
            program_busy[op.corr].add(op.start, op.end)
    if w1 > busy.reach:
        gap(busy.reach, w1)

    host: tp.Dict[str, tp.List[float]] = {}
    for start, end, name in hosts + launches:
        totals = host.setdefault(name, [0, 0.0])
        totals[0] += 1
        totals[1] += (end - start) * 1e-9
    programs: tp.Dict[str, tp.Dict[str, float]] = {}
    for c in replayed:
        entry = programs.setdefault("+".join(dict.fromkeys(outer[c])) or "unmarked",
                                    {"replays": 0, "busy_s": 0.0})
        entry["replays"] += 1
        entry["busy_s"] += program_busy[c].total * 1e-9
    return ProgramReading(
        window_s=(w1 - w0) * 1e-9, busy_s=busy.total * 1e-9,
        ops=len(ops), kernels=sum(op.kernel for op in ops), marks=n_marks,
        marks_s=marks_ns * 1e-9, unmatched=unmatched + len(stack),
        replays=len(replayed), span_busy_s={k: v.total * 1e-9 for k, v in span_busy.items()},
        programs=programs, replay_busy_s=sum(v["busy_s"] for v in programs.values()),
        replay_gap_s=idle["inside"] * 1e-9, between_replays_s=idle["between"] * 1e-9,
        edge_idle_s=idle["outside"] * 1e-9,
        gaps=[[n, v] for n, v in sorted(gaps.items(), key=lambda x: -x[1])[:TOP]], host_s=host)
