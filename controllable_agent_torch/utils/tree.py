"""Target-network updates (mirror of ``controllable_agent_tpu/utils/tree.py``)."""

from __future__ import annotations

import torch
from torch import nn

from .. import optim
from . import trace


@torch.no_grad()
def soft_update(module: nn.Module, target: nn.Module, tau: float) -> None:
    """target <- tau * params + (1 - tau) * target.

    Unlike the JAX version, which returns a new tree, this updates the
    target's parameters in place (target + tau * (p - target)), all of them
    in one ``optim.lerp_``: ``torch._foreach_lerp_``, or on a card one launch
    of the multi-tensor lerp kernel. No second copy of the target net is
    allocated per step, and the step costs one launch instead of one per
    parameter. The target's bfloat16 compute copies, where its layers keep
    them (``optim.Bf16Copy``), are written in the same pass. It is the
    device span ``optimizer`` (``utils/trace.py``).
    """
    params = list(module.parameters())
    targets = list(target.parameters())
    copies = optim.copies_of(target, targets)
    with trace.device_span("optimizer", params[0].device):
        optim.lerp_(targets, params, tau, optim.step_copies(copies))
    optim.mark_written(copies)
