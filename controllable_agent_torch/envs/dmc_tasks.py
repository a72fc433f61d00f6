"""Native task rewards by name (mirror of
``controllable_agent_tpu/envs/dmc_tasks.py``).

Every locomotion task reward is a batched function of the physics tensor,
so relabeling needs no state replay. Quadruped and jaco tasks wait for
their environments (ROADMAP Queue A item 12).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..goals.rewards import BaseReward
from . import locomotion


class TaskReward(BaseReward):
    """reward_from_physics of a named walker, cheetah or hopper task."""

    def __init__(self, name: str, seed: tp.Optional[int] = None) -> None:
        super().__init__(seed)
        self.name = name
        if name.startswith("quadruped_") or name.startswith("jaco_"):
            raise NotImplementedError(
                f"task reward {name!r}: the quadruped and jaco environments are "
                "not ported to controllable_agent_torch yet (ROADMAP Queue A "
                "item 12)")
        self._env = locomotion.make(name)

    def get_goal(self, goal_space: str) -> np.ndarray:
        from ..goals.registry import goals
        fns = goals.funcs.get(goal_space, {})
        if self.name in fns:
            return fns[self.name]()
        raise ValueError(f"No registered goal for {self.name} in {goal_space}")

    def from_physics(self, physics: torch.Tensor) -> torch.Tensor:
        return self._env.reward_from_physics(torch.as_tensor(physics))


def make_task_reward(name: str, seed: tp.Optional[int] = None) -> TaskReward:
    return TaskReward(name, seed)
