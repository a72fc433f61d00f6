"""CLI: relabel a stored replay buffer's rewards for a named task (mirror of
``controllable_agent_tpu/relabel_buffer.py``).

Load the replay of a checkpoint, relabel its rewards from the stored
physics with the named task's reward function in one batched pass on the
device, and save it back.

    python -m controllable_agent_torch.relabel_buffer \\
        checkpoint=/path/to/models/latest task=walker_run out=/path/out

``device=cpu`` runs on the CPU; the default is the card.
"""

from __future__ import annotations

import sys
import typing as tp
from pathlib import Path

from .data.replay import ReplayBuffer
from .goals import get_reward_function
from .train import checkpoint as ckpt_lib
from .utils import resolve_device


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return
    opts = dict(arg.split("=", 1) for arg in argv)
    path = Path(opts["checkpoint"])
    task = opts["task"]
    out = Path(opts.get("out", str(path) + "_relabeled"))
    device = resolve_device(opts.get("device"))

    restored = ckpt_lib.load_checkpoint(path, only=["replay"], device=device)
    replay_state = restored["replay"]
    buf = ReplayBuffer(max_episodes=replay_state.max_episodes,
                       discount=0.99, future=0.99, device=device)
    buf.state = replay_state
    buf.relabel(get_reward_function(task).from_physics)
    ckpt_lib.save_checkpoint(out, {
        "replay": buf.state,
        "global_step": restored["global_step"],
        "global_episode": restored["global_episode"],
    })
    print(f"relabeled buffer for {task} -> {out}")


if __name__ == "__main__":
    main()
