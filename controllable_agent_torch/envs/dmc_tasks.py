"""Native task rewards by name (mirror of
``controllable_agent_tpu/envs/dmc_tasks.py``).

Every walker, cheetah, hopper, quadruped and jaco task reward is a batched
function of the physics tensor, so relabeling needs no state replay.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..goals.rewards import BaseReward
from . import locomotion


class TaskReward(BaseReward):
    """reward_from_physics of a named walker, cheetah, hopper, quadruped or
    jaco task."""

    def __init__(self, name: str, seed: tp.Optional[int] = None) -> None:
        super().__init__(seed)
        self.name = name
        self._env: tp.Any
        if name.startswith("quadruped_"):
            from . import quadruped
            self._env = quadruped.make(name)
        elif name.startswith("jaco_"):
            from . import jaco
            self._env = jaco.make(name)
        else:
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
