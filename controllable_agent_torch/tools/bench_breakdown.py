"""Where the microseconds of an FB update go (the port's counterpart of the
JAX package's ``tools/bench_breakdown.py``).

    python -m controllable_agent_torch.tools.bench_breakdown
    python -m controllable_agent_torch.tools.bench_breakdown --device cpu --steps 2 \\
        --agent-override hidden_dim=32 --agent-override batch_size=16   # a CPU rehearsal

At ``tools/bench.py``'s geometry it times three programs, each one step
captured once as a CUDA graph and replayed ``--steps`` (50) times per call,
the trainer's design (one graph per update; deeper graphs measured no
faster):

  full    the trainer's update: sample, z, the FB and actor losses, their
          gradients, Adam and the target soft-updates (``OfflineTrainer``)
  fwdbwd  sample, ``_build_train_z``, ``_fb_loss`` and ``_actor_loss`` with
          ``torch.autograd.grad`` by the optimizers' ``leaves``; the gradients'
          summed |g| goes into an accumulator (no optimizer, no target update)
  opt     the three Adam steps on gradients fixed at 1e-9 x the parameters,
          and the soft-updates of both targets

``full - fwdbwd`` is the optimizer's and the targets' cost inside the real
update; ``opt`` measures it alone. Each time is the best of 3 rounds of 10
calls, per update. The card's name and power limit come first, then one
JSON line ``{"full_us", "fwdbwd_us", "opt_us", "implied_opt_share"}`` with
``implied_opt_share = 1 - fwdbwd / full``. On the CPU the programs run
eagerly.
"""

from __future__ import annotations

import argparse
import json
import typing as tp

import torch

from controllable_agent_torch.agents import UpdateNoise
from controllable_agent_torch.data import replay as replay_lib
from controllable_agent_torch.train.loops import OfflineTrainer
from controllable_agent_torch.tools.bench import (TRAINER_SEED, add_bench_args, bench_agent,
                                                  bench_buffer, bench_config, bench_device,
                                                  best_seconds)
from controllable_agent_torch.utils.graphs import CapturedProgram
from controllable_agent_torch.utils.tree import soft_update


def replayed(step: tp.Callable[[], None], device: torch.device, steps: int,
             state: tp.Sequence[torch.Tensor], generators: tp.Sequence[torch.Generator],
             read: torch.Tensor) -> tp.Callable[[], torch.Tensor]:
    """A call of ``steps`` runs of ``step`` that returns ``read``: replays of
    one captured graph of ``step`` on a card (``state``: the tensors it
    changes in place; ``generators``: those it draws from), eager runs on
    the CPU."""
    if device.type != "cuda":
        def eager() -> torch.Tensor:
            for _ in range(steps):
                step()
            return read
        return eager
    program = CapturedProgram(step, device, state, generators)

    def replay() -> torch.Tensor:
        program.replay(steps)
        return read
    return replay


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--steps", type=int, default=50, help="updates per call")
    add_bench_args(parser, rounds=3, calls=10)
    args = parser.parse_args(argv)
    device = bench_device(args.device, "bench_breakdown")
    cfg = bench_config(args.agent_override)
    agent = bench_agent(cfg, device)
    buf = bench_buffer(device)
    state = agent.train_state()
    initial = {k: v.clone() for k, v in state.items()}

    def per_update_us(call: tp.Callable[[], torch.Tensor]) -> float:
        call().item()  # warm-up
        seconds = best_seconds(call, args.rounds, args.calls)
        agent.load_train_state(initial)  # every program starts from the same agent
        return seconds / (args.calls * args.steps) * 1e6

    # fwdbwd: the losses and their gradients, summed into an accumulator
    gen = torch.Generator(device=device).manual_seed(2)
    acc = torch.zeros((), device=device)
    fb_leaves = agent.fw_opt.leaves + agent.bw_opt.leaves
    actor_leaves = agent.actor_opt.leaves

    def fwdbwd() -> None:
        batch = replay_lib.sample(buf.state, gen, cfg.batch_size, buf.cfg)
        noise = UpdateNoise.draw(cfg, cfg.batch_size, agent.action_dim, gen, device)
        z = agent._build_train_z(batch, noise)
        fb_loss, _ = agent._fb_loss(batch, z, batch.next_obs, noise.next_action_normal)
        grads = torch.autograd.grad(fb_loss, fb_leaves)
        actor_loss, _ = agent._actor_loss(batch.obs, z, noise.actor_normal)
        grads += torch.autograd.grad(actor_loss, actor_leaves)
        # one _foreach_norm a dtype (bf16: the Linear layers' copies, float32: the
        # rest); over mixed dtypes it would take one kernel a tensor
        for dtype in (torch.bfloat16, torch.float32):
            part = [g for g in grads if g.dtype == dtype]
            if part:
                acc.add_(torch.stack(torch._foreach_norm(part, 1)).sum())

    fwdbwd_us = per_update_us(replayed(fwdbwd, device, args.steps, [acc], [gen], acc))

    # opt: the Adam steps and the soft-updates on fixed gradients
    fixed = [(opt, [p.detach() * 1e-9 for p in opt.params.values()])
             for opt in (agent.fw_opt, agent.bw_opt, agent.actor_opt)]

    def opt_only() -> None:
        for opt, grads in fixed:
            opt.step(grads)
        soft_update(agent.forward_net, agent.target_forward_net, cfg.fb_target_tau)
        soft_update(agent.backward_net, agent.target_backward_net, cfg.fb_target_tau)

    opt_us = per_update_us(replayed(opt_only, device, args.steps, list(state.values()), [],
                                    agent.actor_opt.count_t))

    # full: the trainer's update
    trainer = OfflineTrainer(agent, buf.cfg, cfg.batch_size, args.steps)
    trainer_gen = torch.Generator(device=device).manual_seed(TRAINER_SEED)
    full_us = per_update_us(lambda: trainer(buf.state, trainer_gen)["fb_loss"])

    out = {"full_us": round(full_us, 1), "fwdbwd_us": round(fwdbwd_us, 1),
           "opt_us": round(opt_us, 1), "implied_opt_share": round(1 - fwdbwd_us / full_us, 3)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
