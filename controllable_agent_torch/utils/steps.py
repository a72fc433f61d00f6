"""Host-side loop cadence helpers (mirror of ``controllable_agent_tpu/utils/steps.py``).

The loops advance in strides (one trainer call covers ``steps_per_call``
updates), so the cadence primitive asks whether the last stride crossed a
multiple of the cadence.
"""

from __future__ import annotations

import time
import typing as tp


def crossed(step: int, every: tp.Optional[int], stride: int = 1) -> bool:
    """Did the window ``(step - stride, step]`` cross a multiple of ``every``?

    ``every=None`` (or 0) disables the cadence.
    """
    if not every:
        return False
    return step % every < stride


def frames_remaining(step: int, budget: tp.Optional[int],
                     action_repeat: int = 1) -> int:
    """Agent steps still owed under a frame budget; ``budget=None`` is
    unbounded (a large sentinel)."""
    if budget is None:
        return 1 << 62
    return budget // action_repeat - step


class Stopwatch:
    """Lap + total wall-clock timer (monotonic clock)."""

    def __init__(self) -> None:
        now = time.perf_counter()
        self._t0 = now
        self._lap = now

    def lap(self) -> tp.Tuple[float, float]:
        """(seconds since the previous lap, seconds since construction)."""
        now = time.perf_counter()
        out = (now - self._lap, now - self._t0)
        self._lap = now
        return out

    @property
    def total(self) -> float:
        return time.perf_counter() - self._t0
