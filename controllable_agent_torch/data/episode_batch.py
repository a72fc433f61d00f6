"""EpisodeBatch — the transition batch (mirror of
``controllable_agent_tpu/data/episode_batch.py``), a dataclass of tensors."""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class EpisodeBatch:
    obs: Tensor
    action: Tensor
    reward: Tensor
    next_obs: Tensor
    discount: Tensor
    meta: tp.Dict[str, Tensor] = dataclasses.field(default_factory=dict)
    goal: tp.Optional[Tensor] = None
    next_goal: tp.Optional[Tensor] = None
    future_obs: tp.Optional[Tensor] = None
    future_goal: tp.Optional[Tensor] = None
    physics: tp.Optional[Tensor] = None
