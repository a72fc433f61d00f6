"""Roofline reading of the FB update on the card (the port's counterpart of
the JAX package's ``tools/bench_roofline.py``).

    python -m controllable_agent_torch.tools.bench_roofline [batch_size] [steps_per_call]
    python -m controllable_agent_torch.tools.bench_roofline 64 2 --device cpu \\
        --agent-override hidden_dim=32   # a CPU rehearsal

At ``tools/bench.py``'s geometry (bf16 products, the plain loss), with the
batch given (default 1024), it counts the work of ONE update and times the
captured trainer of ``steps_per_call`` (default 50) updates per call, the
best of 3 rounds of 20 calls (one CUDA graph, captured once and replayed:
the counterpart of the JAX tool's one AOT-compiled program). It prints the
card's name and power limit, then one JSON line with the JAX tool's keys:
``batch_size``, ``steps_per_call``, ``updates_per_s``, ``flops_per_update``,
``bytes_per_update``, ``achieved_tflops``, ``achieved_gbps`` and
``op_intensity_flop_per_byte``.

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one eager step
    (sample -> update), made before the capture: the products' 2·m·k·n,
    forward and backward (``aten.addmm`` for the layers, ``aten.mm`` for
    their gradients and the loss's matrices). Elementwise work is not
    counted. The count is of one update and does not depend on
    ``steps_per_call``. The JAX tool divides XLA's ``cost_analysis()`` of
    its scanned program by ``steps_per_call`` (``tools/bench_roofline.py``,
    the JAX package's, lines 78-83), but XLA counts a scan's body once,
    whatever its trip count, so its FLOPs and bytes per update read
    ``steps_per_call`` times too low there. ``plain_update_flops`` is the
    same count worked out from the networks' shapes.
  * Bytes: every aten operation of the same step reads each of its tensor
    inputs once and writes each output once (views move nothing), summed
    over the step: the traffic of an unfused program, as XLA's ``bytes
    accessed`` is on an unfused backend. A captured update's kernels move
    no less than this, except where one kernel fuses several operations.

It divides by no peak: the share of the card's peak belongs to the
benchmark. The fused loss's CUDA kernels run outside PyTorch's dispatcher,
so the counter would not see them; this tool times the plain loss only.
"""

from __future__ import annotations

import argparse
import json
import typing as tp

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from controllable_agent_torch.data import replay as replay_lib
from controllable_agent_torch.train.loops import OfflineTrainer
from controllable_agent_torch.tools.bench import (TRAINER_SEED, add_bench_args, bench_agent,
                                                  bench_buffer, bench_config, bench_device,
                                                  best_seconds)


class BytesCounter(TorchDispatchMode):
    """Bytes that the aten operations run under it read and write: each
    tensor input once and each tensor output once, per operation; a view
    (``t``, ``view``, ``expand``, ...) moves nothing."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func: tp.Any, types: tp.Any, args: tp.Any = (),
                           kwargs: tp.Any = None) -> tp.Any:
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count_update(agent: tp.Any, buf: tp.Any, generator: torch.Generator,
                 batch_size: int) -> tp.Tuple[int, int]:
    """(FLOPs, bytes) of one eager step of the trainer: the sample and the
    update. The update is taken: the agent moves one step on."""
    with FlopCounterMode(display=False) as flops, BytesCounter() as moved:
        batch = replay_lib.sample(buf.state, generator, batch_size, buf.cfg)
        agent.update(batch, generator)
    return flops.get_total_flops(), moved.total


def _dense(module: nn.Module) -> tp.List[nn.Linear]:
    return [m for m in module.modules() if isinstance(m, nn.Linear)]


def _macs(module: nn.Module, first_only: bool = False) -> int:
    layers = _dense(module)[:1] if first_only else _dense(module)
    return sum(layer.in_features * layer.out_features for layer in layers)


def plain_update_flops(agent: tp.Any, batch_size: int) -> int:
    """2·m·k·n over the products of one FB update with the plain loss,
    worked out from the networks' shapes, for the bench's configuration
    (``preprocess``, no trunk, a deterministic actor, ``mix_ratio`` > 0
    without random weights, no future goals, no Q-loss). Per row of the
    batch, in the update's order:

      z            B of the permuted goals (no gradient)
      targets      the actor at the next state, target F, target B
      FB loss      F and B forward; every weight's gradient; every input's
                   gradient but the first layers' (their inputs are data)
      actor loss   the actor and F forward; F's input gradients from its
                   heads back to the action (the (obs, action) branch
                   only); the actor's weight gradients and its input
                   gradients but the first layers'
      a metric     the orthonormality diagnostic BᵀB (z·z per row)

    and per pair of rows (n² z each): target M = min(TF1·TBᵀ, TF2·TBᵀ)
    (2), M1 = F1·Bᵀ and M2 = F2·Bᵀ (2) and their gradients (4), Cov = B·Bᵀ
    (1) and its gradient (2).
    """
    cfg = agent.cfg
    if (cfg.boltzmann or cfg.q_loss or cfg.use_pallas_loss or cfg.debug or cfg.add_trunk
            or not cfg.preprocess or cfg.mix_ratio <= 0 or cfg.rand_weight
            or cfg.future_ratio > 0):
        raise ValueError("plain_update_flops counts the bench's configuration only")
    actor, fwd, bwd = agent.actor, agent.forward_net, agent.backward_net
    a, f, b = _macs(actor), _macs(fwd), _macs(bwd)
    a_first = _macs(actor.mlps[0], True) + _macs(actor.mlps[1], True)
    f_first = _macs(fwd.mlps[0], True) + _macs(fwd.mlps[1], True)
    b_first = _macs(bwd.mlps[0], True)
    f_to_action = _macs(fwd.mlps[0]) + _macs(fwd.mlps[2]) + _macs(fwd.mlps[3])
    per_row = (b
               + a + f + b
               + f + b + f + (f - f_first) + b + (b - b_first)
               + a + f + f_to_action + a + (a - a_first)
               + cfg.z_dim ** 2)
    per_pair = 11 * cfg.z_dim
    n = batch_size
    return 2 * (n * per_row + n * n * per_pair)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("batch_size", type=int, nargs="?", default=1024)
    parser.add_argument("steps_per_call", type=int, nargs="?", default=50)
    add_bench_args(parser, rounds=3, calls=20)
    args = parser.parse_args(argv)
    device = bench_device(args.device, "bench_roofline")
    cfg = bench_config(args.agent_override, batch_size=args.batch_size)
    agent = bench_agent(cfg, device)
    buf = bench_buffer(device)
    gen = torch.Generator(device=device).manual_seed(TRAINER_SEED)
    flops, moved = count_update(agent, buf, gen, cfg.batch_size)

    trainer = OfflineTrainer(agent, buf.cfg, cfg.batch_size, args.steps_per_call)

    def call() -> torch.Tensor:
        return trainer(buf.state, gen)["fb_loss"]

    call().item()  # warm-up: the capture and a first call
    per_update = (best_seconds(call, args.rounds, args.calls)
                  / (args.calls * args.steps_per_call))
    out = {
        "batch_size": cfg.batch_size,
        "steps_per_call": args.steps_per_call,
        "updates_per_s": round(1.0 / per_update, 1),
        "flops_per_update": flops,  # one update's products, 2·m·k·n
        "bytes_per_update": moved,  # unfused: each operation's inputs and outputs once
        "achieved_tflops": round(flops / per_update / 1e12, 2),
        "achieved_gbps": round(moved / per_update / 1e9, 1),
        "op_intensity_flop_per_byte": round(flops / moved, 2),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
