"""Agent registry (mirror of ``controllable_agent_tpu/agents/registry.py``):
name -> (config class, agent class)."""

from __future__ import annotations

import typing as tp

from .ddpg import DDPGAgent, DDPGConfig, DDPGNoise
from .discrete_fb import DiscreteFBAgent, DiscreteFBConfig
from .discrete_sf import DiscreteSFAgent, DiscreteSFConfig
from .exploration import (DIAYNAgent, DIAYNConfig, DisagreementAgent, DisagreementConfig,
                          ICMAgent, ICMAPTAgent, ICMAPTConfig, ICMConfig, IntrinsicDDPGAgent,
                          MaxEntAgent, MaxEntConfig, RNDAgent, RNDConfig)
from .fb_ddpg import FBDDPGAgent, FBDDPGConfig, UpdateNoise
from .sf import FEATURE_LEARNERS, SFAgent, SFConfig, SFNoise
from .sf_svd import SFSVDAgent, SFSVDConfig

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
}

# the JAX registry's other names: their agents are ROADMAP Queue A item 13
NOT_PORTED = ("aps", "new_aps", "smm", "proto", "uvf", "goal_td3", "goal_sm")


def agent_classes(name: str) -> tp.Tuple[type, type]:
    """(config class, agent class) of ``name``; a name of the JAX package
    that is not ported raises ``NotImplementedError``, any other unknown
    name ``ValueError`` with the known ones."""
    if name in AGENTS:
        return AGENTS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"agent {name!r} is not ported to controllable_agent_torch yet "
            f"(ROADMAP Queue A item 13); ported: {sorted(AGENTS)}")
    raise ValueError(f"Unknown agent {name!r}; known: {sorted(AGENTS)}")


__all__ = ["AGENTS", "DDPGAgent", "DDPGConfig", "DDPGNoise", "DIAYNAgent", "DIAYNConfig",
           "DisagreementAgent", "DisagreementConfig", "DiscreteFBAgent", "DiscreteFBConfig",
           "DiscreteSFAgent", "DiscreteSFConfig", "FBDDPGAgent", "FBDDPGConfig",
           "FEATURE_LEARNERS", "ICMAgent", "ICMAPTAgent", "ICMAPTConfig", "ICMConfig",
           "IntrinsicDDPGAgent", "MaxEntAgent", "MaxEntConfig", "NOT_PORTED", "RNDAgent",
           "RNDConfig", "SFAgent", "SFConfig", "SFNoise", "SFSVDAgent", "SFSVDConfig",
           "UpdateNoise", "agent_classes"]
