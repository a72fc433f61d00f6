"""The comparison that decides ``correct`` for a training cell.

The program's first three updates, taken through the window's own call, are
held against the plain reference's three updates from the same weights on
the same rows with the same noise. The rows and the noise are the ones the
program drew, each held to what it must be:

- ``row_miss``: the share of a batch's rows (of the configured batch size)
  that are no transition of the benchmark's data, field for field (each row
  is found among the data's transitions by its observation and action; the
  reference then gathers that transition from its own copy of the data);
- ``noise_gap``: the largest gap, in standard errors, of a noise draw's mean
  or standard deviation from its distribution's (the draws named
  ``*_normal`` standard normal, ``*_uniform`` uniform on [0, 1)); a
  ``perm`` that is no permutation reads infinite.

Then three numbers of the updates:

- ``loss_gap``: the largest gap of a loss the cell names, over the three
  steps, relative to the sum of the magnitudes of the loss's terms in the
  reference (a loss of terms that cancel, or a mean of rows of either
  sign, has no scale of its own);
- ``grad_gap``: the first gradient as the optimizer got it (from Adam's
  second moment after one step, ‖g‖ = sqrt(Σ ν / (1 - β2))), by the worst
  leaf: |‖g‖ - ‖g_ref‖| over the larger of ‖g_ref‖ and the median leaf's;
- ``change_gap``: each leaf's change over the three steps, ‖θ3 - θ0‖, by the
  worst leaf, measured the same way. Leaves whose reference gradient is
  under a thousandth of the median leaf's move by round-off alone and are
  left out (a target network follows its online one).

Beside them, steadier from seed to seed: ``median_grad_gap``, the median
leaf's ``grad_gap``, and ``grad_abs_all``: the first gradient's magnitudes
element by element, ‖|g| - |g_ref|‖ / ‖g_ref‖ over all the leaves that
move (Adam's second moment holds |g| of every element). The norms average
the rounding of each element away; ``grad_abs_all`` reads it.
``grad_abs_least_net`` is the same over each trained network's leaves
alone, the least over the networks: a float32 update's gradient jumps where
a row sits on a kink of its loss (the minimum of the twin heads, a ReLU),
and which rows do depends on the rounding, so one network's gap can jump on
some seeds; a precision lowered everywhere moves every network.

A cell's file names the numbers it compares and their limits. A number
that is not finite fails.
"""

from __future__ import annotations

import math
import statistics
import typing as tp

import torch

Tensor = torch.Tensor

ADAM_B2 = 0.999
NEGLIGIBLE = 1e-3
CHUNK = 256  # episodes hashed at a time


def _keys(x: Tensor) -> Tensor:
    """An int64 key of each row of float32 ``x`` (its last axis) from the
    bits of its values: equal rows give equal keys. The weights are under
    2**26 and the bits under 2**32, so no sum of up to 32 columns overflows."""
    weights = torch.randint(1, 2 ** 26, (x.shape[-1],),
                            generator=torch.Generator().manual_seed(20_221_004))
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (bits * weights.to(x.device)).sum(-1)


def rows(batch: tp.Mapping[str, Tensor], data: tp.Mapping[str, Tensor], discount: float,
         batch_size: int) -> tp.Tuple[Tensor, Tensor, float]:
    """Each row of the program's ``batch`` found among the transitions of
    ``data`` (full episodes, [E, T+1, ...]): its episode and step, and the
    share of ``batch_size`` rows that are no transition of the data."""
    from .reference.train import batch_of
    obs, action = data["observation"], data["action"]
    length = obs.shape[1] - 1
    keys = torch.cat([_keys(torch.cat([obs[i:i + CHUNK, :-1], action[i:i + CHUNK, 1:]], -1))
                      .reshape(-1) for i in range(0, obs.shape[0], CHUNK)])
    keys, where = torch.sort(keys)
    mine = _keys(torch.cat([batch["obs"], batch["action"]], -1))
    at = torch.searchsorted(keys, mine).clamp_max(keys.shape[0] - 1)
    flat = where[at]
    ep, step = flat // length, flat % length + 1
    same = keys[at] == mine
    for name, theirs in batch_of(data, ep, step, discount).items():
        if name not in batch or batch[name].shape != theirs.shape:
            same = torch.zeros_like(same)
            continue
        same &= (batch[name] == theirs).reshape(theirs.shape[0], -1).all(-1)
    found = int(same.sum())
    return ep, step, (max(batch_size, same.shape[0]) - found) / batch_size


def noise(draws: tp.Iterable[tp.Mapping[str, Tensor]]) -> float:
    """``noise_gap`` over the draws of some updates."""
    worst = 0.0
    for drawn in draws:
        for name, x in drawn.items():
            if name == "perm":
                ordered = torch.arange(x.shape[0], device=x.device, dtype=x.dtype)
                worst = worst if torch.equal(x.sort().values, ordered) else math.inf
                continue
            if name.endswith("_normal"):
                v, sd_of_std = x.double(), 0.5 * math.sqrt(2.0)
            elif name.endswith("_uniform"):
                v, sd_of_std = (x.double() - 0.5) * math.sqrt(12.0), 0.5 * math.sqrt(0.8)
            else:
                raise ValueError(f"no distribution known for the draw {name!r}")
            k = v.numel()
            worst = max(worst, abs(float(v.mean())) * math.sqrt(k),
                        abs(float(v.std()) - 1.0) * math.sqrt(k) / sd_of_std)
    return worst


def _gaps(program: tp.Mapping[str, float], reference: tp.Mapping[str, float],
          names: tp.Iterable[str]) -> tp.Dict[str, float]:
    """Each leaf's gap of norms, over the larger of the reference's norm of
    that leaf and of the median leaf."""
    names = list(names)
    median = statistics.median(reference[k] for k in names)
    return {k: (abs(program[k] - reference[k]) / max(reference[k], median, 1e-30)
                if math.isfinite(program[k]) else math.inf) for k in names}


def _worst(gaps: tp.Mapping[str, float]) -> tp.Tuple[float, str]:
    leaf = max(gaps, key=lambda k: gaps[k])
    return gaps[leaf], leaf


def grad_norms_from_adam(nu_sums: tp.Mapping[str, float]) -> tp.Dict[str, float]:
    """‖g‖ of each leaf from the sum of its Adam second moment after one step."""
    return {k: math.sqrt(max(v, 0.0) / (1.0 - ADAM_B2)) for k, v in nu_sums.items()}


def training(program_losses: tp.Sequence[tp.Mapping[str, float]],
             program_grads: tp.Mapping[str, float], program_change: tp.Mapping[str, float],
             reference: tp.Any, losses: tp.Sequence[str], targets: tp.Mapping[str, str],
             program_grad_abs: tp.Optional[tp.Mapping[str, tp.Any]] = None,
             nets: tp.Iterable[str] = ()) -> tp.Dict[str, tp.Tuple[float, str]]:
    """The three numbers, each with what it was read at (a step and loss,
    or a leaf)."""
    loss_gap, loss_at = 0.0, ""
    for i, (p, r) in enumerate(zip(program_losses, reference.losses)):
        for name in losses:
            g = abs(p[name] - r[name]) / max(reference.scales[i][name], 1e-30)
            g = g if math.isfinite(p[name]) else math.inf
            if g > loss_gap or not loss_at:
                loss_gap, loss_at = g, f"step {i + 1} {name}"
    ref_grads = reference.grad_norms
    median = statistics.median(ref_grads.values())

    def moved(leaf: str) -> bool:
        for target, online in targets.items():
            if leaf.startswith(target + "."):
                leaf = online + leaf[len(target):]
        return ref_grads.get(leaf, 0.0) >= NEGLIGIBLE * median

    changed = [k for k in reference.change_norms if moved(k)]
    grad_gaps = _gaps(program_grads, ref_grads, ref_grads)
    change_gaps = _gaps(program_change, reference.change_norms, changed)
    out = {"loss_gap": (loss_gap, loss_at),
            "grad_gap": _worst(grad_gaps),
            "change_gap": _worst(change_gaps),
            "median_grad_gap": (statistics.median(grad_gaps.values()), "median leaf")}
    if program_grad_abs is not None:
        moving = [k for k in ref_grads if ref_grads[k] >= NEGLIGIBLE * median]
        diff2, ref2 = {}, {}
        for k in moving:
            mine, theirs = program_grad_abs[k], reference.grad_abs[k]
            mine = mine.to(theirs.device, theirs.dtype)
            net = next((n for n in nets if k.startswith(n + ".")), "")
            diff2[net] = diff2.get(net, 0.0) + float(torch.linalg.vector_norm(mine - theirs)) ** 2
            ref2[net] = ref2.get(net, 0.0) + float(torch.linalg.vector_norm(theirs)) ** 2
        out["grad_abs_all"] = (math.sqrt(sum(diff2.values()) / max(sum(ref2.values()), 1e-60)),
                               "all leaves")
        by_net = {n: math.sqrt(diff2[n] / max(ref2[n], 1e-60)) for n in diff2 if n}
        if by_net:
            least = min(by_net, key=lambda n: by_net[n])
            out["grad_abs_least_net"] = (by_net[least], least)
    return out
