"""Command-line plumbing shared by the port's entry points (mirror of
``controllable_agent_tpu/pretrain.py``).

``agent=NAME`` selects the agent; ``agent.*`` keys override the agent
config; every other ``key=value`` overrides the workspace config. The
online pretraining loop itself is not ported yet (ROADMAP Queue A item 10),
so running this module raises.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import typing as tp
from pathlib import Path

from .config import apply_overrides
from .train.workspace import OfflineWorkspace, WorkspaceConfig

AgentConfigBase = tp.Optional[tp.Dict[str, tp.Any]]


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


def build_config(argv: tp.Sequence[str]
                 ) -> tp.Tuple[WorkspaceConfig, tp.List[str], AgentConfigBase]:
    """The workspace config, the agent overrides and, for a resumed folder,
    the saved agent config.

    Resuming a folder that already has a config.json: the SAVED config is
    the base and the command line's arguments are overrides. Without this
    a partial command line would rebuild the default workspace and, since
    construction saves config.json again, overwrite the training run's
    recorded configuration.
    """
    agent_name, ws_overrides, agent_overrides = split_overrides(argv)
    base = WorkspaceConfig(agent_name=agent_name)
    folder = next((o.split("=", 1)[1] for o in ws_overrides
                   if o.startswith("folder=")), None)
    cfg_path = Path(folder) / "config.json" if folder else None
    agent_cfg_base: AgentConfigBase = None
    if cfg_path is not None and cfg_path.exists():
        saved = json.loads(cfg_path.read_text())
        valid = {f.name for f in dataclasses.fields(WorkspaceConfig)}
        fixed = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in saved.items() if k in valid}
        if any(a.startswith("agent=") for a in argv):
            fixed.pop("agent_name", None)  # the command line's agent wins
        base = dataclasses.replace(base, **fixed)
        # the saved run's resolved agent.* keys are the agent-config base
        # (checkpoints only load into identically-shaped networks), unless
        # the command line switches to a different agent class
        if base.agent_name == saved.get("agent_name", base.agent_name):
            agent_cfg_base = {k[len("agent."):]: v for k, v in saved.items()
                              if k.startswith("agent.")} or None
    return apply_overrides(base, ws_overrides), agent_overrides, agent_cfg_base


def build_workspace(argv: tp.Sequence[str],
                    workspace_cls: type = OfflineWorkspace) -> tp.Any:
    cfg, agent_overrides, agent_cfg_base = build_config(argv)
    return workspace_cls(cfg, agent_cfg_overrides=agent_overrides,
                         agent_cfg_base=agent_cfg_base)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    raise NotImplementedError(
        "online pretraining is not ported to controllable_agent_torch yet "
        "(ROADMAP Queue A item 10); use controllable_agent_torch.train_offline")


if __name__ == "__main__":
    main(sys.argv[1:])
