"""Particle-based entropy and running mean and variance (mirror of
``controllable_agent_tpu/ops/pbe.py``).

RND divides its prediction error by the running standard deviation of that
error; ICM-APT and MaxEnt reward the distance to the k nearest neighbours
in a batch (``pbe``), scaled by the running standard deviation of those
distances. The running state is three tensors on the device, and both
functions are functions of them, so an update captured in a CUDA graph
advances it on every replay. Data-parallel (a ``Shard`` of a process
group), ``pbe`` takes this process's rows, finds their neighbours among the
rows of every process and advances the statistics by the global batch's
distances, as the single-process ``pbe`` of the whole batch does.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..utils.dist import Shard

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


def pbe(rep: Tensor, rms: RMSState, knn_k: int = 16, knn_avg: bool = True,
        knn_clip: float = 0.0005, knn_rms: bool = True,
        shard: Shard = Shard()) -> tp.Tuple[Tensor, RMSState]:
    """The k-nearest-neighbour entropy reward of ``rep`` [batch, dim]:
    distances from one float32 product (JAX asks for HIGHEST precision: on
    a card this wants ``torch.backends.cuda.matmul.allow_tf32`` False,
    PyTorch's default), the k smallest per row (each row's
    zero distance to itself included), divided by the running standard
    deviation (``knn_rms``), less ``knn_clip`` and floored at 0, averaged
    over the k (``knn_avg``; else the k-th only), then log(1 + r). Returns
    ([batch, 1], the new running state). With a ``shard``, ``rep`` is this
    process's rows: the neighbours are found among every process's rows
    and the statistics advance by every process's distances."""
    every = shard.gather(rep)
    sq, sq_every = rep.square().sum(1), every.square().sum(1)
    d2 = sq[:, None] + sq_every[None, :] - 2.0 * (rep @ every.T)
    dist = d2.clamp_min(0.0).sqrt()
    nearest = -torch.topk(-dist, knn_k, dim=1).values  # [batch, k], ascending
    # every process's distances, laid out as ``nearest`` is: the statistics
    # then sum in the same order as the single-process ones at one process
    every_nearest = shard.gather(nearest)
    if not knn_avg:  # only the k-th nearest
        reward = nearest[:, -1:]
        new_rms, _, std = rms_update(rms, every_nearest[:, -1:].reshape(-1, 1))
        if knn_rms:
            reward = reward / std
        reward = (reward - knn_clip).clamp_min(0.0)
    else:
        reward = nearest.reshape(-1, 1)  # [batch * k, 1]
        new_rms, _, std = rms_update(rms, every_nearest.reshape(-1, 1))
        if knn_rms:
            reward = reward / std
        reward = (reward - knn_clip).clamp_min(0.0)
        reward = reward.reshape(rep.shape[0], knn_k).mean(1, keepdim=True)
    return torch.log(reward + 1.0), new_rms
