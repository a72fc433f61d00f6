from .episode_batch import EpisodeBatch
from .replay import ReplayBuffer, ReplayState, SampleConfig

__all__ = ["EpisodeBatch", "ReplayBuffer", "ReplayState", "SampleConfig"]
