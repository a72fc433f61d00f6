from .fb_ddpg import FBDDPGAgent, FBDDPGConfig, UpdateNoise

AGENTS = {"fb_ddpg": (FBDDPGConfig, FBDDPGAgent)}

__all__ = ["AGENTS", "FBDDPGAgent", "FBDDPGConfig", "UpdateNoise"]
