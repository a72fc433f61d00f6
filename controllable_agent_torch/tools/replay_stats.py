"""Locomotion content of a run's replay (the port's counterpart of the root
``tools/replay_stats.py``).

Reads ``models/latest/replay.pt`` of a run folder of the port and reports,
from the stored goal column (goal-space features, e.g. quad_pos_speed's
body-frame velocity):

  * quantiles of |feature| for one component (default: body-forward speed,
    index 5 of quad_pos_speed),
  * the fraction of frames above given thresholds (defaults: the quadruped
    walk and run target speeds),
  * optionally per-task relabeled frame rewards through the task's
    environment's ``reward_from_features``, computed on the device.

    python -m controllable_agent_torch.tools.replay_stats --folder exp_local/quad \\
        --tasks quadruped_walk,quadruped_run [--device cpu] [--out report.json]

The replay is read onto the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import typing as tp
from pathlib import Path

import numpy as np
import torch


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--folder", required=True, help="run folder containing models/latest")
    p.add_argument("--feature-index", type=int, default=5,
                   help="goal-column component to quantile (5 = body-forward speed in "
                        "quad_pos_speed)")
    p.add_argument("--thresholds", default="0.5,2.5",
                   help="comma-separated |feature| thresholds to report frame fractions for")
    p.add_argument("--tasks", default=None,
                   help="comma-separated task names for relabeled frame rewards")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from controllable_agent_torch.train import checkpoint as ckpt_lib
    from controllable_agent_torch.train.workspace import make_env
    from controllable_agent_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    restored = ckpt_lib.load_checkpoint(Path(args.folder) / "models" / "latest",
                                        only=["replay"], device=device)
    replay = restored["replay"]
    n = int(replay.n_episodes)
    lengths = replay.ep_lengths[:n]
    goal = replay.storage["goal"][:n]  # [n, T+1, gdim]
    # mask out the first dummy row and any unused tail of each episode
    t_idx = torch.arange(goal.shape[1], device=device)[None, :]
    mask = (t_idx >= 1) & (t_idx <= lengths[:, None])
    frames = goal[mask]
    vals = frames[:, args.feature_index].abs().cpu().numpy()
    report: tp.Dict[str, tp.Any] = {
        "episodes": n,
        "frames": int(mask.sum()),
        "feature_index": args.feature_index,
        "abs_feature_quantiles": {q: float(np.quantile(vals, float(q)))
                                  for q in ("0.5", "0.9", "0.95", "0.99")},
        "abs_feature_max": float(vals.max()),
    }
    for thr in args.thresholds.split(","):
        report[f"frac_frames_above_{thr.strip()}"] = float((vals > float(thr)).mean())

    if args.tasks:
        for task in (t.strip() for t in args.tasks.split(",")):
            env = make_env(task)
            if not hasattr(env, "reward_from_features"):
                raise SystemExit(f"{task}: env has no reward_from_features")
            r = env.reward_from_features(frames.float()).cpu().numpy()
            report[task] = {"frame_reward_mean": float(r.mean()),
                            "frame_reward_p95": float(np.quantile(r, 0.95)),
                            "frac_frames_r>0.9": float((r > 0.9).mean())}

    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return report


if __name__ == "__main__":
    main()
