"""Schedule string parser (mirror of ``controllable_agent_tpu/utils/schedules.py``).

A constant (``"0.2"``), ``linear(init,final,duration)`` and
``step_linear(init,final1,duration1,final2,duration2)``. ``schedule(spec)``
parses once and returns a function of the step. The step may be a host
integer (acting) or a device tensor (the agent's update counter): a tensor
step is evaluated with tensor operations and gives a float32 tensor on its
device, so a schedule inside a captured update advances with the counter.
A constant schedule returns its Python float either way.
"""

from __future__ import annotations

import re
import typing as tp

import torch

Step = tp.Union[int, torch.Tensor]
Value = tp.Union[float, torch.Tensor]


def _mix(step: Step, duration: float) -> Value:
    """clip(step / duration, 0, 1)."""
    if isinstance(step, torch.Tensor):
        return (step.float() / duration).clamp(0.0, 1.0)
    return min(max(step / duration, 0.0), 1.0)


def schedule(spec: str) -> tp.Callable[[Step], Value]:
    try:
        const = float(spec)
        return lambda step: const
    except ValueError:
        pass

    match = re.match(r"linear\((.+),(.+),(.+)\)", spec)
    if match:
        init, final, duration = (float(g) for g in match.groups())

        def _linear(step: Step) -> Value:
            mix = _mix(step, duration)
            return (1.0 - mix) * init + mix * final

        return _linear

    match = re.match(r"step_linear\((.+),(.+),(.+),(.+),(.+)\)", spec)
    if match:
        init, final1, duration1, final2, duration2 = (float(g) for g in match.groups())

        def _step_linear(step: Step) -> Value:
            mix1 = _mix(step, duration1)
            mix2 = _mix(step - duration1, duration2)
            first = (1.0 - mix1) * init + mix1 * final1
            second = (1.0 - mix2) * final1 + mix2 * final2
            if isinstance(step, torch.Tensor):
                return torch.where(step <= duration1, first, second)
            return first if step <= duration1 else second

        return _step_linear

    raise NotImplementedError(spec)
