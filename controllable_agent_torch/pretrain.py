"""CLI: online reward-free pretraining (mirror of
``controllable_agent_tpu/pretrain.py``), and the command-line plumbing that
the port's other entry points share.

    python -m controllable_agent_torch.pretrain agent=fb_ddpg task=walker_walk \
        agent.use_pallas_loss=true agent.compute_dtype=bfloat16 num_train_frames=100000

    python -m controllable_agent_torch.pretrain agent=discrete_fb task=grid_simple

    python -m controllable_agent_torch.pretrain agent=ddpg obs_type=pixels task=walker_walk

``agent=NAME`` selects the agent (fb_ddpg, ddpg, the explorers rnd, diayn,
icm, icm_apt, disagreement and max_ent, sf, sf_svd, and on the gridworld's
``grid_simple``, ``grid_obstacle`` and ``grid_random_goal`` tasks
discrete_fb and discrete_sf; ``agent=sf`` and ``agent=discrete_sf``
take one of thirteen φ learners as ``agent.feature_learner``, an unknown
one raising ``ValueError`` with the known list); ``agent.*`` keys
override the agent config; every other ``key=value`` overrides the workspace
config; ``--help`` lists them all. The run (``OnlineWorkspace``) collects
``num_envs`` episodes at a time and trains on them as it goes, writing
``train.csv``, ``eval.csv``, ``eval_video/``, ``models/latest`` and, at the
end, ``test_rewards.json`` into ``folder``; the same command again resumes
from that checkpoint. ``device=cpu`` runs on the CPU; the default is the
card. ``obs_type=pixels`` renders 84 x 84 frames, a stack of
``frame_stack``, of the point-mass maze and the planar walker, cheetah and
hopper (DDPG encodes them; FB takes them as flat columns). ``use_tb=true``
adds TensorBoard event files (``folder/tb``), ``use_wandb=true`` a wandb run
(the package must be installed), and ``profile_dir=DIR`` a Chrome trace of
the first cycle after the seed frames.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import typing as tp
from pathlib import Path

from .config import apply_overrides
from .train.workspace import OnlineWorkspace, WorkspaceConfig

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


def print_help(doc: tp.Optional[str]) -> None:
    """``--help``: the entry point's usage, then every workspace field and
    every ported agent's fields, with their defaults."""
    from .agents import AGENTS, FEATURE_LEARNERS
    print(doc or "")
    print("workspace config (key=value):")
    for f in dataclasses.fields(WorkspaceConfig):
        print(f"  {f.name}={f.default!r}")
    print("\nagents (agent=NAME; fields via agent.KEY=value):")
    for name, (cfg_cls, _) in sorted(AGENTS.items()):
        fields = ", ".join(f.name for f in dataclasses.fields(cfg_cls) if f.name != "name")
        print(f"  {name}: {fields}")
    print(f"\nagent.feature_learner of sf and discrete_sf: "
          f"{', '.join(sorted(FEATURE_LEARNERS))}")


def wants_help(argv: tp.Sequence[str], doc: tp.Optional[str]) -> bool:
    """Print the help and return True when ``argv`` asks for it."""
    if "--help" in argv or "-h" in argv:
        print_help(doc)
        return True
    return False


def build_workspace(argv: tp.Sequence[str],
                    workspace_cls: type = OnlineWorkspace) -> tp.Any:
    cfg, agent_overrides, agent_cfg_base = build_config(argv)
    return workspace_cls(cfg, agent_cfg_overrides=agent_overrides,
                         agent_cfg_base=agent_cfg_base)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Any:
    """Runs the CLI; returns the trained workspace for callers that drive
    it from Python (None after ``--help``)."""
    args = list(argv if argv is not None else sys.argv[1:])
    if wants_help(args, __doc__):
        return None
    ws = build_workspace(args)
    ws.train()
    return ws


if __name__ == "__main__":
    main(sys.argv[1:])
