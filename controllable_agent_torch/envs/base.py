"""Environment API (mirror of ``controllable_agent_tpu/envs/base.py``).

An Environment is a pair of functions over an explicit state,

    reset(generator, num_envs) -> (state, timestep)
    step(state, action)        -> (state, timestep)

as in the JAX package, with one difference: where the JAX functions handle
one instance and are ``vmap``-ed over thousands, here an environment is
batched by construction. Every tensor of a state or a ``TimeStep`` has a
leading ``[E]`` axis of instances and lives on the device of the generator
that ``reset`` was handed; ``step`` changes nothing in place, so the caller
decides where the new state goes (a captured rollout copies it into fixed
tensors).

``TimeStep`` carries step_type / reward / discount / observation / action,
plus ``physics`` (the flat state vector used for reward relabeling) and an
optional ``goal``.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

Tensor = torch.Tensor


class StepType:
    FIRST = 0
    MID = 1
    LAST = 2


@dataclasses.dataclass(frozen=True)
class TimeStep:
    step_type: Tensor  # [E] int32
    reward: Tensor  # [E] float32
    discount: Tensor  # [E] float32
    observation: Tensor  # [E, obs_dim]
    action: Tensor  # [E, action_dim]
    physics: Tensor  # [E, physics_dim]
    goal: tp.Optional[Tensor] = None  # [E, goal_dim]

    def first(self) -> Tensor:
        return self.step_type == StepType.FIRST

    def mid(self) -> Tensor:
        return self.step_type == StepType.MID

    def last(self) -> Tensor:
        return self.step_type == StepType.LAST

    def replace(self, **changes: tp.Any) -> "TimeStep":
        return dataclasses.replace(self, **changes)

    def to_buffer_dict(self) -> tp.Dict[str, Tensor]:
        """Flatten to the replay buffer's storage-name convention."""
        out = {
            "observation": self.observation,
            "action": self.action,
            "reward": self.reward.unsqueeze(-1),
            "discount": self.discount.unsqueeze(-1),
            "physics": self.physics,
        }
        if self.goal is not None:
            out["goal"] = self.goal
        return out


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static description of an environment's interface."""

    obs_dim: int
    action_dim: int
    # non-empty for image observations: the (H, W, C) the flat observation
    # reshapes to
    obs_shape: tp.Tuple[int, ...] = ()
    # the observation's dtype: uint8 for pixel frames
    obs_dtype: torch.dtype = torch.float32
    discrete_actions: bool = False
    n_actions: int = 0
    physics_dim: int = 0
    goal_dim: int = 0
    episode_length: int = 1000

    def replace(self, **changes: tp.Any) -> "EnvSpec":
        return dataclasses.replace(self, **changes)


class Environment:
    """Protocol base: subclasses implement ``reset`` and ``step`` as
    functions of their arguments alone (all dynamic data in the state), so a
    rollout can be captured and replayed."""

    spec: EnvSpec

    def reset(self, generator: torch.Generator, num_envs: int) -> tp.Tuple[tp.Any, TimeStep]:
        raise NotImplementedError

    def step(self, state: tp.Any, action: Tensor) -> tp.Tuple[tp.Any, TimeStep]:
        raise NotImplementedError
