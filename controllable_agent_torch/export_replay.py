"""CLI: export a checkpoint's replay as ExORL-format .npz episodes (mirror of
``controllable_agent_tpu/export_replay.py``).

The reference ecosystem exchanges exploration datasets as directories of
per-episode .npz files (keys observation/action/reward/discount/physics,
arrays [T+1, ...]). This turns the replay of any checkpoint of the port
(pretrain, anytrain, train_online, train_offline) into that format, which
``replay_dir=`` of ``train_offline`` reads back:

    python -m controllable_agent_torch.export_replay \\
        checkpoint=exp_local/models/latest out_dir=/tmp/episodes [device=cuda]

The replay is read onto ``device`` (the card unless ``device=cpu``).
"""

from __future__ import annotations

import sys
import typing as tp
from pathlib import Path

from .data.exorl import save_exorl_episodes
from .train.checkpoint import load_checkpoint
from .utils.device import resolve_device


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--help" in argv or "-h" in argv or not argv:
        print(__doc__)
        return
    opts = dict(arg.split("=", 1) for arg in argv)
    unknown = set(opts) - {"checkpoint", "out_dir", "device"}
    if unknown:
        raise ValueError(f"Unknown override keys: {sorted(unknown)}")
    ckpt = Path(opts["checkpoint"])
    out_dir = Path(opts["out_dir"])
    restored = load_checkpoint(ckpt, only=["replay"],
                               device=resolve_device(opts.get("device", "cuda")))
    if "replay" not in restored:
        raise ValueError(f"{ckpt} holds no replay shard")
    n = save_exorl_episodes(restored["replay"], out_dir)
    print(f"wrote {n} episodes to {out_dir}")


if __name__ == "__main__":
    main()
