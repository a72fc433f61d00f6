"""Multi-process training over ``torch.distributed`` (mirror of
``controllable_agent_tpu/parallel/multihost.py``).

The JAX design for N hosts, kept here with a process per device:

  * ``initialize()`` joins the processes into one group (NCCL between
    cards, gloo on the CPU);
  * parameters are replicated: every process builds the agent from the same
    seed, and the data-parallel update keeps them equal;
  * each process holds its own replay shard (episode files round-robined by
    rank) and samples its rows of every batch from it, with a generator
    seeded by its rank, so no replay crosses processes;
  * the update is the agent's data-parallel update (``utils/dist.py``; any
    agent of ``agents.AGENTS``), its noise drawn for the global batch from
    a generator seeded alike on every process;
  * evaluation and checkpoints run on process 0 alone. Parameters are plain
    local tensors, so ``host_local_state`` has nothing to do.
"""

from __future__ import annotations

import gc
import typing as tp

import torch
import torch.distributed as dist

from ..data import replay as replay_lib
from ..train.loops import OfflineTrainer
from ..utils.device import resolve_device

# the sampling generator of process r is seeded this far from the update's, times r + 1
SAMPLE_SEED_STRIDE = 7_919


def initialize(coordinator_address: tp.Optional[str] = None,
               num_processes: tp.Optional[int] = None,
               process_id: tp.Optional[int] = None, device: str = "cuda") -> bool:
    """Join the default process group: ``init_method=tcp://<coordinator>``
    (or the coordinator as given when it names a scheme, such as
    ``file://``), NCCL for a card and gloo for ``device=cpu``. Nothing
    happens for a single process unless a coordinator is given. A process
    on a card drives card ``process_id`` modulo the cards on its host.
    Returns whether a group was joined (``shutdown`` leaves it)."""
    if (num_processes is None or num_processes <= 1) and coordinator_address is None:
        return False
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need coordinator=<host:port>")
    rank, world = process_id or 0, num_processes or 1
    on_card = resolve_device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if on_card else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    return True


def shutdown() -> None:
    """Leave the default process group, after every process got here. Free
    the captured programs that hold its collectives first
    (``OfflineTrainer.release``): on cards, destroying the group waits for
    them."""
    if dist.is_initialized():
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dist.barrier()
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_local_batch_size(global_batch: int) -> int:
    """This process's rows of the global batch."""
    return global_batch // process_count()


def host_local_state(state: tp.Any) -> tp.Any:
    """The JAX package pulls a replicated global array to plain host-local
    arrays here; a torch parameter is already local, so ``state`` is
    returned as it is."""
    return state


class MultiHostTrainer(OfflineTrainer):
    """Host-local replay shard + data-parallel learner.

    Every process builds this with its own replay buffer. ``step()`` runs
    ``steps_per_call`` updates: each samples this process's
    ``batch_size / world`` rows from its buffer (``sample_generator``,
    seeded by rank) and takes the data-parallel update, whose noise comes
    from ``update_generator`` (seeded alike everywhere). Captured on a card
    as the single-process trainer is. Without an initialized group it is
    the single-process trainer.
    """

    def __init__(self, agent: tp.Any, buffer: tp.Any, batch_size: int, steps_per_call: int,
                 group: tp.Any = None, seed: int = 0) -> None:
        if group is None and dist.is_initialized():
            group = dist.group.WORLD
        super().__init__(agent, buffer.cfg, batch_size, steps_per_call, group=group)
        if batch_size % self.shard.world:
            raise ValueError(f"batch_size {batch_size} must divide evenly "
                             f"over {self.shard.world} processes")
        self.buffer = buffer
        self.local_batch = batch_size // self.shard.world
        device = agent.device
        self.update_generator = torch.Generator(device=device).manual_seed(seed)
        self.sample_generator = torch.Generator(device=device).manual_seed(
            seed + SAMPLE_SEED_STRIDE * (self.shard.rank + 1))

    def _sample(self, replay_state: replay_lib.ReplayState,
                generator: torch.Generator) -> tp.Any:
        return replay_lib.sample(replay_state, self.sample_generator, self.local_batch,
                                 self.sample_cfg, with_future=self.with_future)

    def _generators(self, generator: torch.Generator) -> tp.List[torch.Generator]:
        return [generator, self.sample_generator]

    def step(self) -> tp.Dict[str, torch.Tensor]:
        """``steps_per_call`` updates; their mean metrics, on the device."""
        return self(self.buffer.state, self.update_generator)
