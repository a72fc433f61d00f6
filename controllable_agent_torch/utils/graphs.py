"""A function captured once in CUDA graphs and replayed.

The updates, the evaluation rollout, the episode collector and the
cheetah's settle all run this way on a CUDA device, so that a step costs
the host one graph launch instead of hundreds of kernel launches.

A step that a graph cannot hold (an SVD, whose result PyTorch checks on the
host) is marked with ``eager_step``: the capture ends a graph before it,
runs it eagerly and begins the next graph after it, and each replay runs
the graphs with the eager steps between them.
"""

from __future__ import annotations

import contextlib
import gc
import time
import typing as tp

import torch

from . import trace

# eager runs before a capture: they build the kernels, opt into their shared
# memory and let cuBLAS and the allocator reach their steady state
WARMUP_RUNS = 2

# the kernel wrappers' launch counts (``ops/fused_fb.py``, ``optim.py``) and the
# program's counters (``trace.counters``), which every capture holds back and
# every replay adds again
_counted: tp.List[tp.Dict[str, int]] = [trace.counters]
# the program being captured, if any (a capture does not nest)
_capturing: tp.List["CapturedProgram"] = []
# the program being built, from its first warm-up run to the end of its capture
_building: tp.List["CapturedProgram"] = []
# one side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace for each stream it has run on, so a new stream per program would
# hold tens of MiB more for every program built
_side_streams: tp.Dict[torch.device, torch.cuda.Stream] = {}


def counted(counts: tp.Dict[str, int]) -> tp.Dict[str, int]:
    """``counts``, a wrapper's launches by kernel, made known to every
    ``CapturedProgram``: a capture holds back the launches it records and a
    replay counts them again (``held_by_capture``, ``count_replay``)."""
    _counted.append(counts)
    return counts


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


@contextlib.contextmanager
def held_by_capture(counts: tp.Dict[str, int]) -> tp.Iterator[tp.Dict[str, int]]:
    """Around a CUDA graph capture: the kernel launches a wrapper counts in
    ``counts`` inside it are recorded into the graph, not run, so on exit
    the counts are what they were on entry and the yielded dict holds, by
    name, how many launches one replay of the graph makes."""
    before = dict(counts)
    held: tp.Dict[str, int] = {}
    try:
        yield held
    finally:
        for name in counts:
            held[name] = counts[name] - before[name]
            counts[name] = before[name]


def count_replay(counts: tp.Dict[str, int], held: tp.Mapping[str, int], times: int = 1) -> None:
    """Count in ``counts`` ``times`` replays of a graph that holds ``held``
    launches."""
    for name, count in held.items():
        counts[name] += count * times


def keep_fresh(data: tp.Any) -> None:
    """Hand ``data`` to the program being built, if any: data that the
    program reads and that code outside it may leave stale between replays
    (a parameter's bfloat16 compute copy, ``optim.Bf16Copy``). It
    has ``stale()``, and ``type(data).refresh(items)`` brings the stale ones
    of a list up to date. The program refreshes what it was handed after its
    warm-up runs are undone, before its capture, and before each replay."""
    if _building:
        _building[-1]._fresh.setdefault(id(data), data)


def eager_step(fn: tp.Callable[[], torch.Tensor]) -> torch.Tensor:
    """``fn()``, run eagerly between the graphs of the program being
    captured (outside a capture: just ``fn()``). ``fn`` reads tensors that
    the graph before it wrote and returns one tensor, which the graph after
    it reads: each replay copies ``fn()``'s new result into the tensor
    returned here."""
    if not _capturing:
        return fn()
    return _capturing[-1]._split(fn)


class CapturedProgram:
    """``fn()`` captured in CUDA graphs on ``device``.

    ``fn`` is warmed up eagerly on a side stream, then everything the
    warm-up changed is put back: ``state``, the tensors that ``fn`` changes
    in place (an agent's ``train_state()`` for an update, a rollout's
    environment state and buffers), and the state of every generator in
    ``generators``. So building the program leaves no trace but the kernels'
    launch counts. Every generator that ``fn`` draws from must be listed: it
    is registered with the graphs, which makes each replay draw fresh
    numbers and advances the generator as eager draws would. Whatever ``fn``
    returns is kept in ``out``; its tensors are overwritten by each replay.
    ``fn`` itself is kept too: the graph reads the tensors its closure holds
    (a constant input such as a zero action) at their addresses, so they
    must live as long as the graph, or the allocator hands their memory to
    other tensors and the replays read whatever those hold.

    Most programs are one graph. Each ``eager_step`` inside ``fn`` splits
    it: the graph before the step is replayed once at capture time so that
    the step sees real inputs, and what that replay changed is put back
    after the capture as the warm-up's is. The graphs share one memory pool
    and are always replayed in capture order. ``warmup_runs`` is at least 1.
    A failure to capture raises.

    What ``fn`` hands to ``keep_fresh`` while the program is built is
    refreshed eagerly whenever the warm-up's or a split's changes have been
    put back, and before each ``replay`` call: a copy that code outside the
    program left stale is never read by a replay.

    Each build is recorded (``trace.captures()``) under ``name``: its
    seconds from the first warm-up run to the end of the capture, the bytes
    the allocator reserved for its graphs, and the device spans' marks one
    replay runs. ``traced`` is whether tracing was on when it was captured;
    each replay is the host span ``graph_replay`` while tracing is on.
    """

    def __init__(self, fn: tp.Callable[[], tp.Any], device: torch.device,
                 state: tp.Iterable[torch.Tensor] = (),
                 generators: tp.Sequence[torch.Generator] = (),
                 warmup_runs: int = WARMUP_RUNS, name: str = "program") -> None:
        started = time.perf_counter()
        self.fn = fn
        self.traced = trace.enabled()
        state = list(state)
        saved = [t.clone() for t in state]
        self._generators = list(generators)
        gen_states = [g.get_state() for g in self._generators]

        def restore() -> None:
            with torch.no_grad():
                for t, before in zip(state, saved):
                    t.copy_(before)
            for g, before in zip(self._generators, gen_states):
                g.set_state(before)

        # what fn reads that code outside the program may leave stale (keep_fresh)
        self._fresh: tp.Dict[int, tp.Any] = {}
        side = _side_stream(device)
        _building.append(self)
        try:
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(warmup_runs):
                    fn()
            torch.cuda.current_stream(device).wait_stream(side)
            restore()
            self._refresh()
            self.graphs: tp.List[torch.cuda.CUDAGraph] = []
            # (fn, the tensor the next graph reads) of each eager step, in order
            self.steps: tp.List[tp.Tuple[tp.Callable[[], torch.Tensor], torch.Tensor]] = []
            self._pool: tp.Any = None
            self._open = False  # whether a graph is being captured
            torch.cuda.synchronize(device)
            gc.collect()
            torch.cuda.empty_cache()
            reserved, marks = torch.cuda.memory_reserved(device), trace.marks_launched()
            _capturing.append(self)
            try:
                with contextlib.ExitStack() as holding, torch.cuda.stream(side):
                    # (counts, the launches one replay makes) of each counted wrapper
                    self.held = [(counts, holding.enter_context(held_by_capture(counts)))
                                 for counts in _counted]
                    self._begin()
                    try:
                        self.out = fn()
                    except BaseException:
                        # end the capture, but raise fn's error, not the invalid capture's
                        try:
                            self._end()
                        except RuntimeError:
                            pass
                        raise
                    self._end()
            finally:
                _capturing.pop()
        finally:
            _building.pop()
        if self.steps:
            torch.cuda.synchronize(device)
            restore()
            self._refresh()
        self.record = trace.Capture(
            name, time.perf_counter() - started, torch.cuda.memory_reserved(device) - reserved,
            trace.marks_launched() - marks)
        trace.record_capture(self.record)

    def _refresh(self) -> None:
        stale = [data for data in self._fresh.values() if data.stale()]
        if stale:
            type(stale[0]).refresh(stale)

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in self._generators:
            graph.register_generator_state(g)
        graph.capture_begin(pool=self._pool)
        self._open = True
        self.graphs.append(graph)

    def _end(self) -> None:
        if self._open:
            self._open = False
            self.graphs[-1].capture_end()
            if self._pool is None:  # the later graphs allocate from the first one's pool
                self._pool = self.graphs[-1].pool()

    def _split(self, fn: tp.Callable[[], torch.Tensor]) -> torch.Tensor:
        self._end()
        # a capture computes nothing: run the graph so that fn reads real values
        self.graphs[-1].replay()
        out = fn()
        self.steps.append((fn, out))
        self._begin()
        return out

    def replay(self, times: int = 1) -> None:
        self._refresh()
        for _ in range(times):
            for i, graph in enumerate(self.graphs):
                with trace.span("graph_replay"):
                    graph.replay()
                if i < len(self.steps):
                    fn, out = self.steps[i]
                    out.copy_(fn())
        for counts, held in self.held:
            count_replay(counts, held, times)
