"""Target-network updates (mirror of ``controllable_agent_tpu/utils/tree.py``)."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def soft_update(module: nn.Module, target: nn.Module, tau: float) -> None:
    """target <- tau * params + (1 - tau) * target.

    Unlike the JAX version, which returns a new tree, this updates the
    target's parameters in place with ``lerp_`` (target + tau * (p - target)):
    no second copy of the target net is allocated per step.
    """
    for p, t in zip(module.parameters(), target.parameters()):
        t.lerp_(p, tau)
