"""What the reference's agents share: Adam in float32 as optax computes it,
the targets' soft update, and ``follow``, which runs the first updates of a
training cell from the benchmark's weights and data and reports what the
comparison reads.

An agent module (``fb.py``, ``sf.py``) gives ``leaves(shapes)``, the
state's named tensors with their shapes; ``OPTIMIZERS``, each optimizer's
name in the program and the prefix of the leaves it steps; ``TARGETS``,
each target network's prefix and its online network's; ``LOSSES``, the
losses the comparison reads; ``settings(config)``, the update's numbers;
``update(...)``, one step; and ``update_flops(shapes, n)``, the model FLOPs
of one update at batch ``n``.

The rows of each update (episode and step in the benchmark's data) and its
noise are the ones the program drew: ``check.rows`` finds each row the
program sampled among the data's transitions, and ``check.noise`` holds the
draws to their distributions.
"""

from __future__ import annotations

import typing as tp

import torch

from .nets import Params, Products, Shapes

Tensor = torch.Tensor


class Adam:
    """optax.adam(lr) over the leaves whose names start with ``prefix``;
    both moments in float32."""

    def __init__(self, params: Params, prefix: str, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.names = [k for k in params if k.startswith(prefix + ".")]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(params[k]) for k in self.names}
        self.nu = {k: torch.zeros_like(params[k]) for k in self.names}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Params, grads: tp.Sequence[Tensor]) -> None:
        self.count += 1
        bc1, bc2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k, g in zip(self.names, grads):
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            params[k] = params[k] - self.lr * (self.mu[k] / bc1) / (
                torch.sqrt(self.nu[k] / bc2) + self.eps)


def grads_of(loss: Tensor, params: Params, names: tp.Sequence[str]) -> tp.List[Tensor]:
    return list(torch.autograd.grad(loss, [params[k] for k in names]))


def with_grad(params: Params, names: tp.Sequence[str]) -> Params:
    """``params`` with the named leaves made fresh leaves that want a gradient."""
    out = dict(params)
    for k in names:
        out[k] = params[k].detach().requires_grad_(True)
    return out


@torch.no_grad()
def soft_update(params: Params, targets: tp.Mapping[str, str], tau: float) -> None:
    """target <- target + tau (online - target), for every target leaf."""
    for target, online in targets.items():
        for k in [k for k in params if k.startswith(target + ".")]:
            src = online + k[len(target):]
            params[k] = params[k] + tau * (params[src] - params[k])


def batch_of(data: tp.Mapping[str, Tensor], ep: Tensor, step: Tensor,
             discount: float) -> tp.Dict[str, Tensor]:
    """The rows of one batch, as the program's sampler lays them out (the
    goals where the data holds goal columns)."""
    out = {"obs": data["observation"][ep, step - 1], "action": data["action"][ep, step],
           "next_obs": data["observation"][ep, step],
           "discount": discount * data["discount"][ep, step]}
    if "goal" in data:
        out.update(goal=data["goal"][ep, step - 1], next_goal=data["goal"][ep, step])
    return out


class Followed(tp.NamedTuple):
    """What the reference read: each step's losses and their scales, each
    leaf's first gradient norm, and each leaf's change after the steps."""

    losses: tp.List[tp.Dict[str, float]]
    scales: tp.List[tp.Dict[str, float]]
    grad_norms: tp.Dict[str, float]
    grad_abs: tp.Dict[str, Tensor]  # |g| of each element of the first gradient
    change_norms: tp.Dict[str, float]


class Drawn(tp.NamedTuple):
    """One update's draws: the episode and step of each row, and the noise."""

    ep: Tensor
    step: Tensor
    noise: tp.Dict[str, Tensor]


def follow(agent: tp.Any, cfg: tp.Mapping[str, tp.Any], shapes: Shapes, params: Params,
           data: tp.Mapping[str, Tensor], drawn: tp.Sequence[Drawn], prod: Products,
           rows: tp.Optional[int] = None, dtype: torch.dtype = torch.float32) -> Followed:
    """One update of ``agent`` from ``params`` for each of ``drawn``, on its
    rows of ``data`` with its noise, computed in ``dtype``. ``rows`` keeps
    only the first rows of each batch (a fault: half of the batch left
    out)."""

    def cast(values: tp.Mapping[str, Tensor]) -> tp.Dict[str, Tensor]:
        return {k: v.to(dtype) if v.is_floating_point() else v for k, v in values.items()}

    params = cast(params)
    start = {k: v.clone() for k, v in params.items()}
    opts = {name: Adam(params, prefix, cfg["lr"]) for name, prefix in agent.OPTIMIZERS.items()}
    losses, scales, grad_norms, grad_abs = [], [], {}, {}
    for i, (ep, step, noise) in enumerate(drawn):
        batch, noise = cast(batch_of(data, ep, step, cfg["discount"])), cast(noise)
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
            noise = {k: v[:rows] if k != "perm" else v[v < rows] for k, v in noise.items()}
        out, scale, grads = agent.update(params, opts, cfg, shapes, batch, noise, prod)
        losses.append(out)
        scales.append(scale)
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            grad_abs = {k: g.abs() for k, g in grads.items()}
    change = {k: float(torch.linalg.vector_norm(params[k] - start[k]))
              for k in params if params[k].is_floating_point()}
    return Followed(losses, scales, grad_norms, grad_abs, change)
