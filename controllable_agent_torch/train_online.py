"""CLI: episode-granular online training (mirror of
``controllable_agent_tpu/train_online.py``): each cycle rolls out
``num_rollout_episodes`` episodes, then runs ``num_agent_updates`` updates.

    python -m controllable_agent_torch.train_online agent=fb_ddpg \\
        task=walker_walk num_rollout_episodes=10 num_agent_updates=50 \\
        rollout_task_z_ratio=0.5

``rollout_task_z_ratio`` of the episodes hold a task z inferred from the
replay for ``rollout_task_z_tasks`` (default: the task);
``update_replay_buffer=false`` trains on the frozen buffer of a resumed
folder. The other keys are those of ``pretrain`` (``--help``).
"""

from __future__ import annotations

import sys
import typing as tp

from .pretrain import build_workspace, wants_help
from .train.workspace import TrainOnlineWorkspace


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Any:
    """Runs the CLI; returns the trained workspace (None after ``--help``)."""
    args = list(argv if argv is not None else sys.argv[1:])
    if wants_help(args, __doc__):
        return None
    # build_workspace restores a resumed folder's saved config as the base
    ws = build_workspace(args, workspace_cls=TrainOnlineWorkspace)
    ws.train()
    return ws


if __name__ == "__main__":
    main()
