"""Policy distributions (mirror of ``controllable_agent_tpu/utils/distributions.py``).

Sampling takes the standard-normal draw as an argument instead of a PRNG
key: the caller draws it from a ``torch.Generator`` (or a test hands in the
JAX package's own draw), so both packages can be fed identical noise.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F


class TruncatedNormal:
    """Normal with straight-through clamped samples in [low, high]."""

    def __init__(self, loc: torch.Tensor, scale: tp.Union[torch.Tensor, float],
                 low: float = -1.0, high: float = 1.0, eps: float = 1e-6) -> None:
        self.loc = loc
        self.scale = scale
        self.low = low
        self.high = high
        self.eps = eps

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    def _clamp(self, x: torch.Tensor) -> torch.Tensor:
        clamped = x.clamp(self.low + self.eps, self.high - self.eps)
        # straight-through: forward value is clamped, gradient is identity
        return x + (clamped - x).detach()

    def sample(self, normal: torch.Tensor,
               clip: tp.Optional[float] = None) -> torch.Tensor:
        eps = normal.to(self.loc.dtype) * self.scale
        if clip is not None:
            eps = eps.clamp(-clip, clip)
        return self._clamp(self.loc + eps)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        # a float scale stays on the host: making a device tensor of it
        # would be a copy, which a CUDA graph capture refuses
        scale = self.scale
        log_scale = torch.log(scale) if isinstance(scale, torch.Tensor) else math.log(scale)
        return (-(value - self.loc) ** 2 / (2 * scale ** 2)
                - log_scale - 0.5 * math.log(2 * math.pi))


class SquashedNormal:
    """tanh(Normal(loc, scale)) with stable log-det-Jacobian."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor) -> None:
        self.loc = loc
        self.scale = scale

    @property
    def mean(self) -> torch.Tensor:
        return torch.tanh(self.loc)

    def sample(self, normal: torch.Tensor) -> torch.Tensor:
        """Reparameterized sample."""
        return torch.tanh(self.loc + normal.to(self.loc.dtype) * self.scale)

    def sample_with_pre_tanh(self, normal: torch.Tensor
                             ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        x = self.loc + normal.to(self.loc.dtype) * self.scale
        return torch.tanh(x), x

    def _normal_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return (-(x - self.loc) ** 2 / (2 * self.scale ** 2)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def log_prob_from_pre_tanh(self, pre_tanh: torch.Tensor) -> torch.Tensor:
        # log|d tanh(x)/dx| = 2*(log2 - x - softplus(-2x)); numerically stable
        log_det = 2.0 * (math.log(2.0) - pre_tanh - F.softplus(-2.0 * pre_tanh))
        return self._normal_log_prob(pre_tanh) - log_det

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        pre_tanh = torch.atanh(value.clamp(-1 + 1e-6, 1 - 1e-6))
        return self.log_prob_from_pre_tanh(pre_tanh)
