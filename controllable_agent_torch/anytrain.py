"""CLI: anytrain, episode-granular online training with updates matched to
the environment steps (mirror of ``controllable_agent_tpu/anytrain.py``; the
recipe that trained the public demo agent). It is ``pretrain`` under
another name:

    python -m controllable_agent_torch.anytrain agent=fb_ddpg \\
        task=walker_walk goal_space=walker_pos_speed_z
"""

from __future__ import annotations

import sys
import typing as tp

from . import pretrain


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Any:
    """Runs the CLI; returns the trained workspace (None after ``--help``)."""
    args = list(argv if argv is not None else sys.argv[1:])
    if pretrain.wants_help(args, __doc__):
        return None
    return pretrain.main(args)


if __name__ == "__main__":
    main()
