"""The traced run's reading of the device: ``torch.profiler`` (CPU and
CUDA activities) over a short steady sub-window, reduced without building
the profiler's per-event Python objects (a whole online cycle holds some
two million kernels).

``reduce`` gives the device operations (kernels, copies, sets) inside the
sub-window, the union of their intervals (the device's busy time), the
kernels by name, and the idle gaps between busy intervals, each named by
the innermost of the benchmark's own spans open at its midpoint.
"""

from __future__ import annotations

import contextlib
import typing as tp

import torch

from .harness import span

WINDOW = "profiled_window"
SPANS = (WINDOW, "trainer_call", "sync", "collect", "commit")  # the benchmark's own
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _kind(e: tp.Any) -> str:
    """The event's activity, as kineto names it; on a PyTorch whose events
    do not say, from the device and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    on_device = str(e.device_type()).endswith("CUDA")
    name = e.name()
    if name in SPANS:
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "sync" if "Sync" in name else "kernel"


class Reading(tp.NamedTuple):
    window_s: float
    busy_s: float
    kernels: tp.List[tp.Tuple[str, float]]  # (name, seconds) of each kernel, in order
    device_ops: tp.List[tp.List[tp.Any]]  # [name, seconds] by total time, the longest first
    idle_gaps: tp.List[tp.List[tp.Any]]  # [span, seconds], the longest first


class Profiler:
    """``with prof.window(): ...`` profiles the block; ``prof.reading``
    then holds its reduction."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.reading: tp.Optional[Reading] = None

    @contextlib.contextmanager
    def window(self) -> tp.Iterator[None]:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        with profile(activities=activities) as prof:
            with span(WINDOW):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        self.reading = reduce(prof.profiler.kineto_results.events())


def _union(intervals: tp.List[tp.Tuple[int, int]]) -> tp.List[tp.Tuple[int, int]]:
    merged: tp.List[tp.Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def _segments(spans: tp.List[tp.Tuple[int, int, str]]) -> tp.List[tp.Tuple[int, str]]:
    """The timeline cut at every span's ends: (start, innermost open span)
    of each piece, in order; the spans nest."""
    points = sorted({x for s, t, _ in spans for x in (s, t)})
    out = []
    for p in points:
        open_ = [(t - s, name) for s, t, name in spans if s <= p < t]
        out.append((p, min(open_)[1] if open_ else "outside_spans"))
    return out


def reduce(events: tp.Sequence[tp.Any]) -> Reading:
    spans, device = [], []
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.end_ns(), e.name(), kind == "kernel"))
        elif kind == "user_annotation" and e.name() in SPANS:
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    window = [(s, t) for s, t, name in spans if name == WINDOW]
    if not window:
        raise RuntimeError("the profiled window's span is missing from the trace")
    w0, w1 = window[0]
    inside = [(max(s, w0), min(t, w1), name, k) for s, t, name, k in device
              if t > w0 and s < w1]
    busy = _union([(s, t) for s, t, _, _ in inside])
    by_name: tp.Dict[str, float] = {}
    for s, t, name, _ in inside:
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-9
    segments = _segments([(s, t, name) for s, t, name in spans if name != WINDOW])
    gaps: tp.Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    at = 0
    for start, end in zip(edges[::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) // 2
        while at + 1 < len(segments) and segments[at + 1][0] <= mid:
            at += 1
        name = segments[at][1] if segments and segments[at][0] <= mid else "outside_spans"
        gaps[name] = gaps.get(name, 0.0) + (end - start) * 1e-9
    return Reading(
        window_s=(w1 - w0) * 1e-9, busy_s=sum(t - s for s, t in busy) * 1e-9,
        kernels=[(name, (t - s) * 1e-9) for s, t, name, k in sorted(inside) if k],
        device_ops=[[n, v] for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:TOP]],
        idle_gaps=[[n, v] for n, v in sorted(gaps.items(), key=lambda x: -x[1])[:TOP]])
