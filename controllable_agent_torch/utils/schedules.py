"""Schedule string parser (mirror of ``controllable_agent_tpu/utils/schedules.py``).

A constant (``"0.2"``), ``linear(init,final,duration)`` and
``step_linear(init,final1,duration1,final2,duration2)``. ``schedule(spec)``
parses once and returns a function of the integer step. The step is a host
integer in the port (the agent counts its updates on the host), so the
function returns a Python float.
"""

from __future__ import annotations

import re
import typing as tp


def schedule(spec: str) -> tp.Callable[[int], float]:
    try:
        const = float(spec)
        return lambda step: const
    except ValueError:
        pass

    match = re.match(r"linear\((.+),(.+),(.+)\)", spec)
    if match:
        init, final, duration = (float(g) for g in match.groups())

        def _linear(step: int) -> float:
            mix = min(max(step / duration, 0.0), 1.0)
            return (1.0 - mix) * init + mix * final

        return _linear

    match = re.match(r"step_linear\((.+),(.+),(.+),(.+),(.+)\)", spec)
    if match:
        init, final1, duration1, final2, duration2 = (float(g) for g in match.groups())

        def _step_linear(step: int) -> float:
            if step <= duration1:
                mix1 = min(max(step / duration1, 0.0), 1.0)
                return (1.0 - mix1) * init + mix1 * final1
            mix2 = min(max((step - duration1) / duration2, 0.0), 1.0)
            return (1.0 - mix2) * final1 + mix2 * final2

        return _step_linear

    raise NotImplementedError(spec)
