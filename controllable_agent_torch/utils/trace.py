"""The port's tracing: host spans, device spans inside captured programs,
and a record of every program captured.

Off by default. ``enable()`` and ``disable()`` flip one process-wide
switch; ``enabled()`` reads it.

- ``span(name)`` is a host span: while tracing is on,
  ``torch.profiler.record_function(name)``, which lands in whatever
  ``torch.profiler`` is recording, on its clock, and is written out by its
  exporter; while off, one shared null context.
- ``device_span(name, device)`` is the host span plus, on a CUDA device, a
  begin and an end marker kernel (``csrc/trace_marks.cu``) launched on the
  current stream. A host span runs only when a CUDA graph is captured, but
  the marks launched inside a capture are nodes of the graph and run on
  every replay, so the device's timeline shows each span of each replay.
  The kernels are named by the span's id (``trace_begin_<id>``,
  ``trace_end_<id>``); ``device_span_names()`` maps ids to names. They are
  built and loaded on the first ``enable()`` on a machine with a card.
  On the CPU a device span is the host span alone.

A program captured while tracing was off holds no mark; one captured while
it was on holds the marks of every device span inside it. The trainer, the
collector and the rollout capture anew when the switch has flipped since
their capture (``CapturedProgram.traced``).

``captures()`` lists one ``Capture`` per ``CapturedProgram`` built since
``reset_captures()``: its name, the host seconds from its first warm-up
run to the end of its capture, the bytes the allocator reserved for it
(its graphs' pool, with what the warm-up left), and how many marks one
replay of it runs.

``counters`` holds the program's counts of work by name, advanced on the
host where the work is issued (``count``), whether tracing is on or off:
``physics3d.substeps``, the 3-D engine's substeps (``envs/physics3d.py:step``);
``bf16_copy.uses``, the ``Linear`` calls of a bfloat16 network served from
its layers' bfloat16 copies of their weights (``models/networks.py:Dense``);
``bf16_copy.refreshes``, the casts that brought stale copies up to date
outside Adam and the soft-update (``optim.py:Bf16Copy.refresh``).
A capture holds back what it records and each replay adds it again
(``utils/graphs.py``), as the kernel wrappers' launch counts are.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import typing as tp

import torch

_on = False
_NULL = contextlib.nullcontext()
# span name -> id of its pair of marks, in the order of first use
_ids: tp.Dict[str, int] = {}
# mark kernels launched so far (begin and end each count one); a capture
# reads it before and after to know how many marks one replay runs
_marks = 0


class Capture(tp.NamedTuple):
    name: str
    seconds: float
    pool_bytes: int
    marks: int


_captures: tp.List[Capture] = []

counters: tp.Dict[str, int] = {"physics3d.substeps": 0, "bf16_copy.uses": 0,
                               "bf16_copy.refreshes": 0}


def count(name: str, n: int = 1) -> None:
    counters[name] += n


def reset_counters() -> None:
    for name in counters:
        counters[name] = 0


def enable() -> None:
    """Turn tracing on (on a machine with a card, building the marks first)."""
    global _on
    if torch.cuda.is_available():
        _lib()
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def traced() -> tp.Iterator[None]:
    """Tracing on inside the block, and as it was after it."""
    was = _on
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def span(name: str) -> tp.ContextManager[tp.Any]:
    return torch.profiler.record_function(name) if _on else _NULL


def device_span(name: str, device: torch.device) -> tp.ContextManager[tp.Any]:
    if not _on:
        return _NULL
    if device.type != "cuda":
        return torch.profiler.record_function(name)
    return _DeviceSpan(name, device)


def device_span_names() -> tp.Dict[int, str]:
    """The name of each device span's id."""
    return {i: name for name, i in _ids.items()}


def marks_launched() -> int:
    return _marks


def record_capture(capture: Capture) -> None:
    _captures.append(capture)


def captures() -> tp.List[Capture]:
    return list(_captures)


def reset_captures() -> None:
    _captures.clear()


class _DeviceSpan:
    def __init__(self, name: str, device: torch.device) -> None:
        if name not in _ids:
            if len(_ids) >= _lib().trace_mark_ids():
                raise ValueError(f"no marks left for device span {name!r}: "
                                 f"{sorted(_ids)} hold them all")
            _ids[name] = len(_ids)
        self._host = torch.profiler.record_function(name)
        self._id, self._device = _ids[name], device

    def _mark(self, begin: bool) -> None:
        global _marks
        stream = torch.cuda.current_stream(self._device).cuda_stream
        rc = _lib().trace_mark(self._id, int(begin), stream)
        if rc != 0:
            raise RuntimeError(f"trace mark {self._id}: launch failed: CUDA error {rc}")
        _marks += 1

    def __enter__(self) -> None:
        self._host.__enter__()
        self._mark(True)

    def __exit__(self, *exc: tp.Any) -> None:
        self._mark(False)
        self._host.__exit__(*exc)


@functools.cache
def _lib() -> ctypes.CDLL:
    from .. import _build
    lib = _build.load("trace_marks")
    lib.trace_mark_ids.argtypes = []
    lib.trace_mark_ids.restype = ctypes.c_int
    lib.trace_mark.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.trace_mark.restype = ctypes.c_int
    return lib
