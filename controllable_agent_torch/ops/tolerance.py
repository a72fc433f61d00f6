"""dm_control-style tolerance reward (mirror of
``controllable_agent_tpu/ops/tolerance.py``).

Elementwise over tensors of any shape on any device, so a whole buffer's
rewards are computed where the buffer lives.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

Tensor = torch.Tensor


def _sigmoid(x: Tensor, value_at_1: float, sigmoid: str) -> Tensor:
    # the scales are host constants in float32, as the JAX version computes
    # them (value_at_1 = 0 gives an infinite scale for some sigmoids)
    v = np.float32(value_at_1)
    with np.errstate(divide="ignore", invalid="ignore"):
        if sigmoid == "gaussian":
            scale = float(np.sqrt(-2.0 * np.log(v)))
            return torch.exp(-0.5 * torch.square(x * scale))
        if sigmoid == "hyperbolic":
            scale = float(np.arccosh(1.0 / v))
            return 1.0 / torch.cosh(x * scale)
        if sigmoid == "long_tail":
            scale = float(np.sqrt(1.0 / v - 1.0))
            return 1.0 / (torch.square(x * scale) + 1.0)
        if sigmoid == "reciprocal":
            scale = float(1.0 / v - 1.0)
            return 1.0 / (torch.abs(x) * scale + 1.0)
        if sigmoid == "cosine":
            scaled = x * float(np.arccos(2.0 * v - 1.0) / np.float32(np.pi))
            return torch.where(torch.abs(scaled) < 1,
                               (1.0 + torch.cos(math.pi * scaled)) / 2.0, 0.0)
        if sigmoid == "linear":
            scaled = x * float(1.0 - v)
            return torch.where(torch.abs(scaled) < 1, 1.0 - scaled, 0.0)
        if sigmoid == "quadratic":
            scaled = x * float(np.sqrt(1.0 - v))
            return torch.where(torch.abs(scaled) < 1, 1.0 - torch.square(scaled), 0.0)
        if sigmoid == "tanh_squared":
            scale = float(np.arctanh(np.sqrt(1.0 - v)))
            return 1.0 - torch.square(torch.tanh(x * scale))
    raise ValueError(f"Unknown sigmoid type {sigmoid!r}.")


def tolerance(x: Tensor,
              bounds: tp.Tuple[float, float] = (0.0, 0.0),
              margin: float = 0.0,
              sigmoid: str = "gaussian",
              value_at_margin: float = 0.1) -> Tensor:
    """Reward 1 inside ``bounds``, dropping to ``value_at_margin`` at
    ``margin`` outside, via the chosen sigmoid."""
    lower, upper = bounds
    if lower > upper:
        raise ValueError("Lower bound must be <= upper bound.")
    if margin < 0:
        raise ValueError("margin must be non-negative.")
    x = torch.as_tensor(x)
    in_bounds = (lower <= x) & (x <= upper)
    if margin == 0:
        return torch.where(in_bounds, 1.0, 0.0)
    d = torch.where(x < lower, lower - x, x - upper) / margin
    return torch.where(in_bounds, 1.0, _sigmoid(d, value_at_margin, sigmoid))
