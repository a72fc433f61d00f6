"""An online run through ``train_online`` with its cycles' timings (NVIDIA GPU).

    python -m controllable_agent_torch.tools.online_curve agent=fb_ddpg \\
        task=quadruped_stand goal_space=quad_pos_speed ... folder=DIR

Every argument goes to ``train_online.main`` unchanged, so the run writes
what that entry point writes (``train.csv``, ``eval.csv``, the checkpoint,
``test_rewards.json``). Then it prints the card's name and power limit, the
evaluation curve (frame and episode reward of each ``eval.csv`` row), and
the collection's share of a cycle: the seconds of collection (resets
included) over those of collection, commits and updates, summed over the
cycles after the seed frames. ``DIR/cycle_timings.json`` keeps every
cycle's seconds.
"""

from __future__ import annotations

import csv
import json
import sys
import typing as tp
from pathlib import Path

import torch

from controllable_agent_torch import train_online
from controllable_agent_torch.utils.device import card_name_and_power_limit


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    if not torch.cuda.is_available():
        print("online_curve: no CUDA device is available", file=sys.stderr)
        return 1
    ws = train_online.main(list(argv if argv is not None else sys.argv[1:]))
    if ws is None:
        return 0
    timings = ws.cycle_timings
    (ws.work_dir / "cycle_timings.json").write_text(json.dumps(timings))
    print(f"card: {card_name_and_power_limit()}")
    with (Path(ws.work_dir) / "eval.csv").open() as f:
        for row in csv.DictReader(f):
            print(f"eval frame {row['frame']}: episode_reward {row['episode_reward']}")
    trained = [t for t in timings if t["updates"] > 0]
    collect = sum(t["collect"] for t in trained)
    total = collect + sum(t["update"] for t in trained)
    print(f"cycles with updates: {len(trained)}, collection {collect:.3f} s of "
          f"{total:.3f} s, share {collect / max(total, 1e-9):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
