"""Agent registry (mirror of ``controllable_agent_tpu/agents/registry.py``):
name -> (config class, agent class)."""

from __future__ import annotations

import typing as tp

from .aps import APSAgent, APSConfig, NEWAPSAgent, NEWAPSConfig, NEWAPSNoise
from .ddpg import DDPGAgent, DDPGConfig, DDPGNoise
from .discrete_fb import DiscreteFBAgent, DiscreteFBConfig
from .discrete_sf import DiscreteSFAgent, DiscreteSFConfig
from .exploration import (DIAYNAgent, DIAYNConfig, DisagreementAgent, DisagreementConfig,
                          ICMAgent, ICMAPTAgent, ICMAPTConfig, ICMConfig, IntrinsicDDPGAgent,
                          MaxEntAgent, MaxEntConfig, RNDAgent, RNDConfig)
from .fb_ddpg import FBDDPGAgent, FBDDPGConfig, UpdateNoise
from .goal_agents import GoalNoise, GoalSMAgent, GoalSMConfig, GoalTD3Agent, GoalTD3Config
from .proto import ProtoAgent, ProtoConfig, ProtoNoise
from .sf import FEATURE_LEARNERS, SFAgent, SFConfig, SFNoise
from .sf_svd import SFSVDAgent, SFSVDConfig
from .smm import SMMAgent, SMMConfig, SMMNoise
from .uvf import UVFAgent, UVFConfig, UVFNoise

AGENTS: tp.Dict[str, tp.Tuple[type, type]] = {
    "fb_ddpg": (FBDDPGConfig, FBDDPGAgent),
    "ddpg": (DDPGConfig, DDPGAgent),
    "rnd": (RNDConfig, RNDAgent),
    "diayn": (DIAYNConfig, DIAYNAgent),
    "icm": (ICMConfig, ICMAgent),
    "icm_apt": (ICMAPTConfig, ICMAPTAgent),
    "disagreement": (DisagreementConfig, DisagreementAgent),
    "max_ent": (MaxEntConfig, MaxEntAgent),
    "sf": (SFConfig, SFAgent),
    "sf_svd": (SFSVDConfig, SFSVDAgent),
    "discrete_fb": (DiscreteFBConfig, DiscreteFBAgent),
    "discrete_sf": (DiscreteSFConfig, DiscreteSFAgent),
    "aps": (APSConfig, APSAgent),
    "new_aps": (NEWAPSConfig, NEWAPSAgent),
    "smm": (SMMConfig, SMMAgent),
    "proto": (ProtoConfig, ProtoAgent),
    "uvf": (UVFConfig, UVFAgent),
    "goal_td3": (GoalTD3Config, GoalTD3Agent),
    "goal_sm": (GoalSMConfig, GoalSMAgent),
}

# the JAX registry's names that the port lacks: none
NOT_PORTED: tp.Tuple[str, ...] = ()


def agent_classes(name: str) -> tp.Tuple[type, type]:
    """(config class, agent class) of ``name``; an unknown name raises
    ``ValueError`` with the known ones."""
    if name in AGENTS:
        return AGENTS[name]
    raise ValueError(f"Unknown agent {name!r}; known: {sorted(AGENTS)}")


__all__ = ["AGENTS", "APSAgent", "APSConfig", "DDPGAgent", "DDPGConfig", "DDPGNoise",
           "DIAYNAgent", "DIAYNConfig",
           "DisagreementAgent", "DisagreementConfig", "DiscreteFBAgent", "DiscreteFBConfig",
           "DiscreteSFAgent", "DiscreteSFConfig", "FBDDPGAgent", "FBDDPGConfig",
           "FEATURE_LEARNERS", "GoalNoise", "GoalSMAgent", "GoalSMConfig", "GoalTD3Agent",
           "GoalTD3Config", "ICMAgent", "ICMAPTAgent", "ICMAPTConfig", "ICMConfig",
           "IntrinsicDDPGAgent", "MaxEntAgent", "MaxEntConfig", "NEWAPSAgent", "NEWAPSConfig",
           "NEWAPSNoise", "NOT_PORTED", "ProtoAgent", "ProtoConfig", "ProtoNoise", "RNDAgent",
           "RNDConfig", "SFAgent", "SFConfig", "SFNoise", "SFSVDAgent", "SFSVDConfig",
           "SMMAgent", "SMMConfig", "SMMNoise", "UVFAgent", "UVFConfig", "UVFNoise",
           "UpdateNoise", "agent_classes"]
