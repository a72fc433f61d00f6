"""Running mean and variance (mirror of ``rms_update`` in
``controllable_agent_tpu/ops/pbe.py``).

RND divides its prediction error by the running standard deviation of that
error. The state is three tensors on the device, and ``rms_update`` is a
function of them, so an update captured in a CUDA graph advances it on
every replay. The particle-based entropy reward (``pbe``) of APT/APS comes
with those agents (ROADMAP Queue A item 13).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class RMSState:
    """Running statistics of a stream of rows: mean, variance and count."""

    mean: Tensor
    var: Tensor
    n: Tensor

    @classmethod
    def create(cls, shape: tp.Tuple[int, ...] = (1,),
               device: tp.Optional[torch.device] = None) -> "RMSState":
        return cls(mean=torch.zeros(shape, device=device),
                   var=torch.ones(shape, device=device),
                   n=torch.ones((), device=device))


def rms_update(state: RMSState, x: Tensor) -> tp.Tuple[RMSState, Tensor, Tensor]:
    """Fold the rows of ``x`` [batch, ...] into ``state``; returns the new
    state, its mean and its standard deviation (population variance, as
    ``jnp.var``)."""
    bs = x.shape[0]
    delta = x.mean(0) - state.mean
    new_n = state.n + bs
    new_mean = state.mean + delta * bs / new_n
    new_var = (state.var * state.n + x.var(0, unbiased=False) * bs
               + delta.square() * state.n * bs / new_n) / new_n
    return RMSState(mean=new_mean, var=new_var, n=new_n), new_mean, new_var.sqrt()
