"""This process's rows of a batch spread over a ``torch.distributed`` group.

A data-parallel update in the JAX package is one SPMD program: the batch is
sharded over devices, but every value is what the single-device update on
the whole batch would compute, and XLA inserts the collectives that keep it
so. The port's data-parallel update does the same by hand. Each process
holds ``local`` consecutive rows of a global batch of ``local * world`` rows
(process ``rank`` holds rows ``rank * local`` on); terms that couple the
batch (the FB measure matrices, B's covariance, mixtures over the batch)
are computed on rows gathered from every process, and gradients are summed
over the group before each optimizer step.

``Shard(None)`` is one process holding the whole batch: ``gather`` returns
its input and the sums do nothing, so an update written against a shard is
the single-process update unchanged. With a group, even of one process, the
collectives run; they are identities at world size 1, so such an update
equals the single-process one to the bit.

Every agent's update is written so: it takes the noise of the global batch
and keeps its rows (``Shard.noise``; a noise dataclass is a ``RowNoise``),
differentiates its part of the global loss (``Shard.grad``: a mean over its
rows, or a term that every process computes from gathered rows, scaled by
``share``, the gradients summed over the group) and reports the global
batch's metrics (``Shard.mean``).

The collectives are the ones a CUDA graph can hold once the group's
communicator exists (``all_gather_into_tensor`` and ``all_reduce`` on the
current stream, no host read of their results).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _all_gather(out: Tensor, x: Tensor, group: tp.Any) -> None:
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)


class _GatherRows(torch.autograd.Function):
    """[local, ...] on each process -> [world * local, ...] in rank order on
    every process. Backward: the gradients of the gathered rows are summed
    over the group and each process keeps its own rows', as for the adjoint
    of a gather whose output feeds a loss that each process computes."""

    @staticmethod
    def forward(ctx: tp.Any, x: Tensor, group: tp.Any) -> Tensor:  # type: ignore[override]
        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x, group)
        return out

    @staticmethod
    def backward(ctx: tp.Any, grad: Tensor) -> tp.Tuple[Tensor, None]:  # type: ignore[override]
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        local = grad.shape[0] // dist.get_world_size(ctx.group)
        rank = dist.get_rank(ctx.group)
        return grad[rank * local:(rank + 1) * local], None


class Shard:
    """Where this process's rows sit in a batch spread over ``group`` (None:
    one process, every row)."""

    def __init__(self, group: tp.Any = None) -> None:
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)

    def rows(self, n: int) -> slice:
        """This process's rows of a global batch of ``n`` rows."""
        if n % self.world:
            raise ValueError(f"a batch of {n} rows does not split over {self.world} processes")
        local = n // self.world
        return slice(self.rank * local, (self.rank + 1) * local)

    @property
    def share(self) -> float:
        """This process's share of a batch: the factor that turns a mean over
        its rows into its part of the mean over the global batch."""
        return 1.0 / self.world

    def noise(self, noise: tp.Any, local: int) -> tp.Any:
        """This process's draws of the global batch's ``noise`` (a
        ``RowNoise``), for a batch of ``local`` rows on each process."""
        return noise if self.group is None else noise.rows(self.rows(local * self.world))

    def gather(self, x: Tensor) -> Tensor:
        """Every process's rows of ``x`` ([local, ...] each), concatenated in
        rank order; gradients reach this process's rows."""
        return x if self.group is None else _GatherRows.apply(x, self.group)

    def sum(self, tensors: tp.Sequence[Tensor]) -> tp.List[Tensor]:
        """``tensors`` (of one dtype) summed over the group, with one
        collective over a flat copy; at one process, ``tensors`` themselves."""
        if self.group is None:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                   tensors)]

    def grad(self, loss: Tensor, params: tp.Sequence[Tensor], **kwargs: tp.Any
             ) -> tp.List[Tensor]:
        """The gradient of the global batch's loss with respect to
        ``params``. ``loss`` is this process's part of it: a mean over its
        rows, or a term that every process computes alike from gathered
        rows, or a sum of both; the global loss is the mean of the parts over
        the group. Each part is differentiated at ``share`` and the gradients
        summed over the group (a parameter that the loss does not reach, with
        ``materialize_grads``, keeps a zero gradient). The gradient of a
        bfloat16 compute copy (``optim.Adam.leaves``) is summed in float32,
        widened first as autocast's cast widened it."""
        if self.group is None:
            return list(torch.autograd.grad(loss, params, **kwargs))
        grads = torch.autograd.grad(loss * self.share, params, **kwargs)
        return self.sum([g.float() if g.dtype == torch.bfloat16 else g for g in grads])

    def mean(self, local_means: tp.Mapping[str, Tensor]) -> tp.Dict[str, Tensor]:
        """Means over this process's rows -> means over the global batch, on
        every process (one collective)."""
        if self.group is None or not local_means:
            return dict(local_means)
        names = list(local_means)
        stacked = torch.stack([local_means[k].float() for k in names]) * self.share
        dist.all_reduce(stacked, group=self.group)
        return dict(zip(names, stacked.unbind()))

    def batch(self, batch: tp.Any) -> tp.Any:
        """This process's rows of every tensor of a batch (a dataclass of
        tensors, optional tensors and dicts of tensors, such as
        ``EpisodeBatch``) that every process holds whole."""
        def part(x: tp.Any) -> tp.Any:
            if isinstance(x, Tensor):
                return x[self.rows(x.shape[0])]
            if isinstance(x, dict):
                return {k: part(v) for k, v in x.items()}
            return x

        if self.group is None:
            return batch
        return dataclasses.replace(batch, **{f.name: part(getattr(batch, f.name))
                                             for f in dataclasses.fields(batch)})


class RowNoise:
    """Mixin of an update's noise dataclass whose fields are draws for the
    rows of the global batch ([n, ...], None when not drawn), those named
    in ``WHOLE`` excepted (a permutation of the global batch, a draw over
    it): ``rows`` keeps a slice of the rows of the others."""

    WHOLE: tp.ClassVar[tp.Tuple[str, ...]] = ()

    def rows(self, rows: slice) -> tp.Any:
        """The draws of the rows ``rows`` of the global batch."""
        fields = dataclasses.fields(tp.cast(tp.Any, self))
        parts = {f.name: getattr(self, f.name) for f in fields}
        return dataclasses.replace(tp.cast(tp.Any, self), **{
            name: value[rows] for name, value in parts.items()
            if value is not None and name not in self.WHOLE})
