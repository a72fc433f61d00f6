"""Command-line plumbing shared by the port's entry points (mirror of
``controllable_agent_tpu/pretrain.py``).

``agent=NAME`` selects the agent; ``agent.*`` keys override the agent
config; every other ``key=value`` overrides the workspace config. The
online pretraining loop itself is not ported yet (ROADMAP Queue A item 10),
so running this module raises.
"""

from __future__ import annotations

import sys
import typing as tp

from .config import apply_overrides
from .train.workspace import EnvSpec, OfflineWorkspace, WorkspaceConfig


def split_overrides(argv: tp.Sequence[str]
                    ) -> tp.Tuple[str, tp.List[str], tp.List[str]]:
    agent_name = "fb_ddpg"
    ws_overrides: tp.List[str] = []
    agent_overrides: tp.List[str] = []
    for arg in argv:
        if arg.startswith("agent="):
            agent_name = arg.split("=", 1)[1]
        elif arg.startswith("agent."):
            agent_overrides.append(arg[len("agent."):])
        else:
            ws_overrides.append(arg)
    return agent_name, ws_overrides, agent_overrides


def build_workspace(argv: tp.Sequence[str], spec: EnvSpec,
                    workspace_cls: type = OfflineWorkspace) -> tp.Any:
    agent_name, ws_overrides, agent_overrides = split_overrides(argv)
    cfg = apply_overrides(WorkspaceConfig(agent_name=agent_name), ws_overrides)
    return workspace_cls(cfg, spec, agent_cfg_overrides=agent_overrides)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    raise NotImplementedError(
        "online pretraining is not ported to controllable_agent_torch yet "
        "(ROADMAP Queue A item 10); use controllable_agent_torch.train_offline")


if __name__ == "__main__":
    main(sys.argv[1:])
