"""FB updates/s against the number of processes of a data-parallel group
(the port's counterpart of the JAX package's ``bench_scaling.py``).

    python -m controllable_agent_torch.tools.bench_scaling [--batch 1024] [--steps 30]
    python -m controllable_agent_torch.tools.bench_scaling --device cpu --world 2 \\
        --batch 16 --steps 2 --agent-override hidden_dim=32   # a rehearsal over gloo

The JAX harness times its data-parallel scan on meshes of 1, 2, 4, ...
devices. Here each world size n in (1, 2, 4, ...) up to the number of cards
(``--world`` on the CPU, 2 by default) is n processes, one card each (NCCL;
gloo with ``--device cpu``), joined through a file in a fresh temporary
folder and stopped after 240 s, as ``tools/dryrun_multichip.py`` runs them.
Every process builds ``tools/bench.py``'s agent (bf16 products, the plain
loss, the global batch ``--batch``) and a replay of 32 synthetic 500-step
episodes, and times ``parallel/mesh.py:make_dp_offline_trainer`` with
``--steps`` updates per call: one warm-up call (the capture included), then
the best of ``--repeats`` calls, each closed by one ``.item()``.

The card's name and power limit come first; then, from process 0 of each
world size, the JAX harness's line ``{"metric": "fb_updates_per_s",
"devices": n, "value", "unit": "updates/s", "efficiency": rate_n / (n *
rate_1)}``. The batch is global, as in JAX: n processes share it. On one
card only ``devices`` 1 is measured.
"""

from __future__ import annotations

import argparse
import json
import sys
import typing as tp

import torch

from controllable_agent_torch.tools.bench import (TRAINER_SEED, bench_agent, bench_buffer,
                                                  bench_config, bench_device, best_seconds)
from controllable_agent_torch.tools.dryrun_multichip import spawn

EPISODES, EPISODE_LENGTH = 32, 500  # the JAX harness's replay
WORKER_MODULE = "controllable_agent_torch.tools.bench_scaling"
SIZES = (1, 2, 4, 8, 16, 32, 64)
TIMEOUT = 240.0  # seconds for the processes of one world size together


def worker(rank: int, world: int, init_method: str, device: str, batch: int, steps: int,
           repeats: int, overrides: tp.Sequence[str]) -> float:
    """One process of a world size: its updates/s (global updates)."""
    from controllable_agent_torch.parallel import make_dp_offline_trainer, make_group, multihost

    multihost.initialize(init_method, world, rank, device=device)
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" \
            else torch.device(device)
        cfg = bench_config(overrides, batch_size=batch)
        agent = bench_agent(cfg, dev)
        buf = bench_buffer(dev, EPISODES, EPISODE_LENGTH)
        trainer = make_dp_offline_trainer(agent, buf.cfg, batch, steps, make_group())
        # seeded alike on every process: each draws the same global batch and noise
        gen = torch.Generator(device=dev).manual_seed(TRAINER_SEED)

        def call() -> torch.Tensor:
            return trainer(buf.state, gen)["fb_loss"]

        call().item()  # warm-up: the capture and a first call
        seconds = best_seconds(call, repeats, 1)
        trainer.release()  # its graphs hold the group's collectives
        return steps / seconds
    finally:
        multihost.shutdown()


def world_sizes(device: str, world: tp.Optional[int]) -> tp.List[int]:
    """1, 2, 4, ... up to the cards (or ``world``; 2 on the CPU)."""
    most = world if world is not None else (
        torch.cuda.device_count() if device == "cuda" else 2)
    return [n for n in SIZES if n <= most]


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.List[tp.Dict[str, tp.Any]]:
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["--worker"]:
        rank, world, init, device, batch, steps, repeats = args[1:8]
        rate = worker(int(rank), int(world), init, device, int(batch), int(steps),
                      int(repeats), args[8:])
        print(f"rank {rank} of {world}: updates/s {rate!r}", flush=True)
        return []
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--batch", type=int, default=1024,
                        help="global batch size (shared by the processes)")
    parser.add_argument("--steps", type=int, default=30, help="updates per timed call")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--world", type=int, default=None,
                        help="the largest world size (default: the cards; 2 on the CPU)")
    parser.add_argument("--agent-override", action="append", default=[], metavar="KEY=VALUE")
    opts = parser.parse_args(args)
    bench_device(opts.device, "bench_scaling")
    lines = []
    rate1 = None
    for n in world_sizes(opts.device, opts.world):
        results = spawn(WORKER_MODULE, n, lambda rank, init: [
            "--worker", str(rank), str(n), init, opts.device, str(opts.batch), str(opts.steps),
            str(opts.repeats), *opts.agent_override], TIMEOUT, f"the world size {n}")
        for rank, (code, out) in enumerate(results):
            if code != 0:
                raise RuntimeError(f"process {rank} of the world size {n} failed:\n{out[-4000:]}")
        said = [line for line in results[0][1].splitlines() if line.startswith("rank 0 of")]
        rate = float(said[-1].rsplit(" ", 1)[1])
        rate1 = rate if rate1 is None else rate1
        line = {"metric": "fb_updates_per_s", "devices": n, "value": round(rate, 2),
                "unit": "updates/s", "efficiency": round(rate / (n * rate1), 4)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
