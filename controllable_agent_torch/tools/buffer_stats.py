"""Exploration-buffer quality report for ExORL-format episode directories
(the port's counterpart of the root ``tools/buffer_stats.py``).

Every weak battery row of an offline run can be a ceiling of its data
(e.g. a cheetah buffer whose p99 speed is 2 m/s against a target of 10).
This makes that check a step of its own: run it on a collected buffer
before spending an offline run on it. It reports, from the raw MuJoCo
physics rows ([qpos, qvel]):

  * forward-speed quantiles (planar domains: qvel[vx index]),
  * torso-height quantiles,
  * per-task relabeled rewards (the port's reward functions over the
    adapted physics, on the device: the values offline FB trains on): per
    episode mean, p95 and max, and the fraction of frames above reward
    thresholds.

    python -m controllable_agent_torch.tools.buffer_stats --dir exorl_data/cheetah_rnd \\
        --physics-format mujoco_cheetah --tasks cheetah_walk,cheetah_run \\
        --out results/cheetah_buffer.json [--device cpu]

The rewards are computed on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import typing as tp
from pathlib import Path

import numpy as np
import torch

# raw MuJoCo [qpos, qvel] layout per planar domain:
# (ndof, index of vx in qvel, index of root-height in qpos, height offset)
_LAYOUT = {
    "mujoco_walker": (9, 1, 0, 1.3),
    "mujoco_cheetah": (9, 0, 1, 0.7),
    "mujoco_hopper": (7, 0, 1, 1.0),
}
QUANTILES = (0.05, 0.5, 0.9, 0.95, 0.99, 1.0)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--dir", required=True)
    p.add_argument("--physics-format", required=True, choices=sorted(_LAYOUT))
    p.add_argument("--tasks", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--skip", type=int, default=0, help="skip the first N episode files")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from controllable_agent_torch.data.exorl import PHYSICS_ADAPTERS
    from controllable_agent_torch.goals import get_reward_function
    from controllable_agent_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ndof, vx_i, z_i, z_off = _LAYOUT[args.physics_format]
    adapter = PHYSICS_ADAPTERS[args.physics_format]
    fns = sorted(Path(args.dir).glob("*.npz"))[args.skip:]
    if args.limit:
        fns = fns[:args.limit]
    if not fns:
        raise ValueError(f"no episodes in {args.dir}")

    phys_rows = []
    for fn in fns:
        with np.load(fn) as ep:
            phys_rows.append(ep["physics"].astype(np.float32))
    lengths = [p_.shape[0] for p_ in phys_rows]
    phys = np.concatenate(phys_rows, 0)
    vx = phys[:, ndof + vx_i]
    height = phys[:, z_i] + z_off

    def quant(x: np.ndarray) -> tp.Dict[str, float]:
        return {f"p{int(q * 100)}": float(np.quantile(x, q)) for q in QUANTILES}

    report: tp.Dict[str, tp.Any] = {
        "dir": args.dir, "episodes": len(fns), "frames": int(phys.shape[0]),
        "forward_speed": quant(vx), "abs_speed": quant(np.abs(vx)),
        "torso_height": quant(height), "tasks": {},
    }
    print(f"{args.dir}: {len(fns)} eps, |vx| p99 {report['abs_speed']['p99']:.2f} max "
          f"{report['abs_speed']['p100']:.2f}; height p95 "
          f"{report['torso_height']['p95']:.2f}", flush=True)

    native = torch.as_tensor(adapter(phys), device=device)
    offsets = np.cumsum([0] + lengths)
    for task in args.tasks.split(","):
        r = get_reward_function(task, 1).from_physics(native).reshape(-1).cpu().numpy()
        per_ep = np.asarray([r[offsets[i]:offsets[i + 1]].sum() for i in range(len(lengths))])
        t = {"episode_mean": float(per_ep.mean()),
             "episode_p95": float(np.quantile(per_ep, 0.95)),
             "episode_max": float(per_ep.max()),
             "frame_frac_gt_0.5": float((r > 0.5).mean()),
             "frame_frac_gt_0.9": float((r > 0.9).mean())}
        report["tasks"][task] = t
        print(f"  {task}: ep mean {t['episode_mean']:.0f} p95 {t['episode_p95']:.0f} max "
              f"{t['episode_max']:.0f}; frames>0.9: {100 * t['frame_frac_gt_0.9']:.2f}%",
              flush=True)

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2))
        print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
