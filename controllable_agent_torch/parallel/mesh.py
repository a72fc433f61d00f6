"""Data parallelism for every agent over a ``torch.distributed`` process
group (mirror of ``controllable_agent_tpu/parallel/mesh.py``).

The JAX package shards the batch over a 1-D ``dp`` mesh of devices and lets
XLA insert the collectives of its SPMD program. Here each process drives one
device (a card with NCCL, the CPU with gloo), the group plays the mesh, and
the update inserts its collectives itself (``utils/dist.py``): the batch's
rows are spread over the processes, the terms that couple the batch are
computed from gathered rows, and the gradients are summed before each
optimizer step, so that every process holds the parameters that the
single-process update on the whole batch would give. Every agent of
``agents.AGENTS`` has such an update: ``update(batch, generator, group)``
and ``_update(batch, noise, group=group)``.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.distributed as dist

from ..data.replay import SampleConfig
from ..train.loops import OfflineTrainer
from ..utils.dist import Shard

Metrics = tp.Dict[str, torch.Tensor]


def make_group(n_processes: tp.Optional[int] = None) -> tp.Any:
    """The group of the first ``n_processes`` processes (all of them by
    default) of the initialized default group: the JAX ``make_mesh``. Every
    process of the default group must call it."""
    world = dist.get_world_size()
    if n_processes is None or n_processes == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n_processes)))


def shard_batch(batch: tp.Any, group: tp.Any) -> tp.Any:
    """This process's rows of every tensor of ``batch`` (which every process
    holds whole)."""
    return Shard(group).batch(batch)


def make_dp_trainer(agent: tp.Any, group: tp.Any
                    ) -> tp.Callable[[tp.Any, tp.Any], Metrics]:
    """``dp_update(batch, noise)``: one data-parallel update of ``agent`` in
    place from the whole ``batch`` (each process keeps its rows) with the
    global batch's ``noise`` (the agent's noise dataclass, or a generator
    seeded alike on every process to draw it from); returns the global
    batch's metrics."""

    def dp_update(batch: tp.Any, noise: tp.Any) -> Metrics:
        local = shard_batch(batch, group)
        if isinstance(noise, torch.Generator):
            return agent.update(local, noise, group=group)
        return agent._update(local, noise, group=group)

    return dp_update


def make_dp_offline_trainer(agent: tp.Any, sample_cfg: SampleConfig, batch_size: int,
                            steps_per_call: int, group: tp.Any) -> OfflineTrainer:
    """The captured sample -> update program of ``train/loops.py``, made
    data-parallel: ``trainer(replay_state, generator)`` runs
    ``steps_per_call`` updates, each sampling the global batch and updating
    on this process's rows of it."""
    return OfflineTrainer(agent, sample_cfg, batch_size, steps_per_call, group=group)
