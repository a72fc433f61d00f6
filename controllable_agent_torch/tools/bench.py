"""Headline benchmark: FB gradient updates/s on one card (the port's
counterpart of the JAX package's ``bench.py``).

    python -m controllable_agent_torch.tools.bench
    python -m controllable_agent_torch.tools.bench --device cpu \\
        --agent-override hidden_dim=32 --agent-override batch_size=16   # a CPU rehearsal

It runs the flagship FBDDPGAgent at the JAX bench's geometry: the JAX
``FBDDPGConfig`` defaults (z 50, hidden 1024, feature 512, backward hidden
526, batch 1024) with the networks' products in bf16 and the plain FB loss
(``use_pallas_loss`` is off by default in both packages), walker-sized
observations and actions (24, 6), and a replay of 64 synthetic 1,000-step
episodes drawn from ``np.random.RandomState(0)`` in the JAX bench's order
(``data/exorl.py:synthetic_episodes``). The trainer is the captured
``OfflineTrainer`` with ``BENCH_STEPS_PER_CALL`` (default 200) updates per
call: one CUDA graph of sample -> update, replayed. Timing as the JAX bench:
one warm-up call (the capture included) closed by one ``.item()``, then the
best of 3 rounds, each of 20 calls closed by one ``.item()``.

The card's name and power limit are printed first; then ONE JSON line
``{"metric": "fb_gradient_updates_per_s", "value", "unit", "vs_baseline"}``,
where ``vs_baseline`` divides by the JAX bench's anchor of 60 updates/s
(its estimate of the PyTorch reference's single-GPU rate). Without a card,
and without ``--device cpu``, it exits non-zero.

The other tools of the harness (``bench_roofline``, ``bench_breakdown``,
``bench_scaling``) share this module's set-up.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import typing as tp

import torch

from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig
from controllable_agent_torch.config import apply_overrides
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import synthetic_episodes
from controllable_agent_torch.train.loops import OfflineTrainer
from controllable_agent_torch.utils.device import card_name_and_power_limit

BASELINE_UPDATES_PER_S = 60.0
OBS_DIM, ACTION_DIM = 24, 6  # walker's proprioceptive observations and actions
EPISODES, EPISODE_LENGTH = 64, 1000  # the JAX bench's synthetic replay
AGENT_SEED, TRAINER_SEED = 0, 1  # the JAX bench's keys 0 and 1


def add_bench_args(parser: argparse.ArgumentParser, rounds: int, calls: int) -> None:
    """The options of bench, bench_roofline and bench_breakdown."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu, for a rehearsal at small widths")
    parser.add_argument("--agent-override", action="append", default=[], metavar="KEY=VALUE",
                        help="FBDDPGConfig overrides (repeatable), e.g. hidden_dim=32")
    parser.add_argument("--rounds", type=int, default=rounds,
                        help="timed rounds; the best one is reported")
    parser.add_argument("--calls", type=int, default=calls,
                        help="calls per round, the round closed by one read of a metric")


def bench_device(device: str, tool: str) -> torch.device:
    """The device a tool measures on: the card unless ``device`` is the CPU.
    Without a card it exits non-zero: a rate taken on the CPU must not pass
    for the card's. The card's name and power limit are printed first."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device is available; pass --device cpu to "
                         "rehearse on the CPU")
    print(f"card: {card_name_and_power_limit()}" if dev.type == "cuda"
          else "card: none (--device cpu)", flush=True)
    return dev


def bench_config(overrides: tp.Sequence[str] = (), **fields: tp.Any) -> FBDDPGConfig:
    """The JAX defaults with bf16 products, then ``fields``, then the
    ``key=value`` overrides."""
    cfg = FBDDPGConfig(compute_dtype="bfloat16", **fields)
    return apply_overrides(cfg, list(overrides))


def bench_agent(cfg: FBDDPGConfig, device: torch.device) -> FBDDPGAgent:
    return FBDDPGAgent(cfg, OBS_DIM, ACTION_DIM, device=device, seed=AGENT_SEED)


def bench_buffer(device: torch.device, episodes: int = EPISODES,
                 length: int = EPISODE_LENGTH) -> ReplayBuffer:
    """The JAX bench's replay: ``ReplayBuffer(episodes, 0.98, 0.99)`` holding
    ``episodes`` synthetic episodes of ``length`` steps (seed 0)."""
    buf = ReplayBuffer(episodes, discount=0.98, future=0.99, device=device)
    buf.load_episodes(synthetic_episodes(episodes, length, OBS_DIM, ACTION_DIM, 0))
    return buf


def best_seconds(call: tp.Callable[[], torch.Tensor], rounds: int, calls: int) -> float:
    """The fastest of ``rounds`` rounds of ``calls`` calls, each round closed
    by one ``.item()`` of what the last call returned (checked finite)."""
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = call()
        value = out.item()
        best = min(best, time.perf_counter() - t0)
        if not math.isfinite(value):
            raise FloatingPointError(f"a timed call returned {value}")
    return best


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    add_bench_args(parser, rounds=3, calls=20)
    args = parser.parse_args(argv)
    device = bench_device(args.device, "bench")
    cfg = bench_config(args.agent_override)
    agent = bench_agent(cfg, device)
    buf = bench_buffer(device)
    steps_per_call = int(os.environ.get("BENCH_STEPS_PER_CALL", "200"))
    trainer = OfflineTrainer(agent, buf.cfg, cfg.batch_size, steps_per_call)
    gen = torch.Generator(device=device).manual_seed(TRAINER_SEED)

    def call() -> torch.Tensor:
        return trainer(buf.state, gen)["fb_loss"]

    call().item()  # warm-up: the capture and a first call
    updates_per_s = args.calls * steps_per_call / best_seconds(call, args.rounds, args.calls)
    out = {"metric": "fb_gradient_updates_per_s", "value": round(updates_per_s, 2),
           "unit": "updates/s",
           "vs_baseline": round(updates_per_s / BASELINE_UPDATES_PER_S, 2)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
