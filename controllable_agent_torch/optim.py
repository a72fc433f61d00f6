"""Adam matching ``optax.adam(lr, mu_dtype=...)``, the optimizer of the JAX
agents.

Stock ``torch.optim.Adam`` keeps its moments in the parameters' dtype; the
JAX agents keep the first moment in bfloat16 (``adam_mu_dtype``: the update
is bound by memory traffic and momentum tolerates bf16). This Adam follows
optax's arithmetic step for step:

    mu  = (1 - b1) * g + b1 * mu          # b1 * mu rounds in mu's dtype
    nu  = (1 - b2) * g**2 + b2 * nu       # float32
    mu_hat = mu / (1 - b1**t);  nu_hat = nu / (1 - b2**t)
    p  += -lr * mu_hat / (sqrt(nu_hat) + eps)
    mu is stored in mu_dtype after the step (optax casts after using the
    float32 value for the update)

The moments are keyed by parameter name, so ``convert.py`` can load optax's
``ScaleByAdamState`` into them.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn


class Adam:
    def __init__(self, module: nn.Module, lr: float,
                 mu_dtype: torch.dtype = torch.float32, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.params: tp.Dict[str, nn.Parameter] = dict(module.named_parameters())
        self.mu = {k: torch.zeros_like(p, dtype=mu_dtype) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: tp.Sequence[torch.Tensor]) -> None:
        """Apply one update; ``grads`` are in ``self.params`` order."""
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for (name, p), g in zip(self.params.items(), grads):
            mu = (1.0 - self.b1) * g + self.b1 * self.mu[name]
            nu = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[name]
            p.add_(-self.lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)))
            self.mu[name] = mu.to(self.mu[name].dtype)
            self.nu[name] = nu
