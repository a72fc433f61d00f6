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

The step count and both moments live in fixed device tensors that ``step``
updates in place, and the bias corrections are computed on the device from
the count: a step captured in a CUDA graph advances them on every replay.
Each line above is one ``torch._foreach_*`` call over the parameter list.

The moments are keyed by parameter name, so ``convert.py`` can load optax's
``ScaleByAdamState`` into them.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .utils import trace


class Adam:
    """Adam over a module's parameters, or over named parameters (a
    feature learner's, its target networks left out)."""

    def __init__(self, module: tp.Union[nn.Module, tp.Mapping[str, nn.Parameter]], lr: float,
                 mu_dtype: torch.dtype = torch.float32, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.params: tp.Dict[str, nn.Parameter] = dict(
            module.named_parameters() if isinstance(module, nn.Module) else module)
        self.mu = {k: torch.zeros_like(p, dtype=mu_dtype) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        device = next(iter(self.params.values())).device
        self.count_t = torch.zeros((), dtype=torch.int32, device=device)

    @property
    def count(self) -> int:
        """The number of steps taken (reading it waits for the device)."""
        return int(self.count_t)

    @count.setter
    def count(self, value: int) -> None:
        self.count_t.fill_(value)

    def state(self) -> tp.Dict[str, torch.Tensor]:
        """The optimizer's own tensors by name (not copies): ``mu.<param>``,
        ``nu.<param>`` and ``count``."""
        out = {f"mu.{k}": v for k, v in self.mu.items()}
        out.update({f"nu.{k}": v for k, v in self.nu.items()})
        out["count"] = self.count_t
        return out

    @torch.no_grad()
    def step(self, grads: tp.Sequence[torch.Tensor]) -> None:
        """Apply one update; ``grads`` are in ``self.params`` order. The
        step is the device span ``optimizer`` (``utils/trace.py``)."""
        with trace.device_span("optimizer", self.count_t.device):
            params, grads = list(self.params.values()), list(grads)
            mus, nus = list(self.mu.values()), list(self.nu.values())
            self.count_t += 1
            count = self.count_t.float()
            bc1 = 1.0 - torch.pow(self.b1, count)
            bc2 = 1.0 - torch.pow(self.b2, count)

            decayed = torch._foreach_mul(mus, self.b1)  # rounds in mu's dtype
            if decayed[0].dtype != torch.float32:
                widened = [torch.empty_like(g) for g in grads]
                torch._foreach_copy_(widened, decayed)
                decayed = widened
            mu = torch._foreach_mul(grads, 1.0 - self.b1)
            torch._foreach_add_(mu, decayed)
            squares = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(squares, 1.0 - self.b2)
            torch._foreach_mul_(nus, self.b2)
            torch._foreach_add_(nus, squares)

            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(mu, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(params, update, alpha=-self.lr)
            torch._foreach_copy_(mus, mu)
