"""Environment wrappers (mirror of ``controllable_agent_tpu/envs/wrappers.py``).

Each wrapper is an Environment over another Environment's reset/step, batched
like it. ``StatefulEnv`` adapts an environment to a mutable reset()/step()
API for host-side consumers (demos, notebooks).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..utils.device import DeviceLike, resolve_device
from .base import Environment, TimeStep

Tensor = torch.Tensor


class ActionRepeatWrapper(Environment):
    """Repeat each action k times, summing the discounted rewards."""

    def __init__(self, env: Environment, num_repeats: int) -> None:
        self.env = env
        self.num_repeats = num_repeats
        self.spec = env.spec

    def reset(self, generator: torch.Generator, num_envs: int) -> tp.Tuple[tp.Any, TimeStep]:
        return self.env.reset(generator, num_envs)

    def step(self, state: tp.Any, action: Tensor) -> tp.Tuple[tp.Any, TimeStep]:
        state, ts = self.env.step(state, action)
        reward, discount = ts.reward, ts.discount
        for _ in range(self.num_repeats - 1):
            state, ts = self.env.step(state, action)
            reward = reward + ts.reward * discount
            discount = discount * ts.discount
        return state, ts.replace(reward=reward, discount=discount)


@dataclasses.dataclass(frozen=True)
class FrameStackState:
    inner: tp.Any
    frames: Tensor  # [E, k, obs_dim]


class FrameStackWrapper(Environment):
    """Stack the last k observations, flattened, the newest last."""

    def __init__(self, env: Environment, num_frames: int) -> None:
        self.env = env
        self.num_frames = num_frames
        self.spec = env.spec.replace(obs_dim=env.spec.obs_dim * num_frames)

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> tp.Tuple[FrameStackState, TimeStep]:
        state, ts = self.env.reset(generator, num_envs)
        frames = ts.observation.unsqueeze(1).repeat(1, self.num_frames, 1)
        return (FrameStackState(inner=state, frames=frames),
                ts.replace(observation=frames.flatten(1)))

    def step(self, state: FrameStackState, action: Tensor
             ) -> tp.Tuple[FrameStackState, TimeStep]:
        inner, ts = self.env.step(state.inner, action)
        frames = torch.cat([state.frames[:, 1:], ts.observation.unsqueeze(1)], 1)
        return (FrameStackState(inner=inner, frames=frames),
                ts.replace(observation=frames.flatten(1)))


class GoalAppendWrapper(Environment):
    """Compute the goal-space vector each step and optionally append it to
    the observation."""

    def __init__(self, env: Environment, goal_fn: tp.Callable[[Tensor], Tensor],
                 append_goal_to_observation: bool = False) -> None:
        self.env = env
        self.goal_fn = goal_fn
        self.append = append_goal_to_observation
        goal_dim = int(goal_fn(torch.zeros(env.spec.physics_dim)).shape[-1])
        obs_dim = env.spec.obs_dim + (goal_dim if append_goal_to_observation else 0)
        self.spec = env.spec.replace(obs_dim=obs_dim, goal_dim=goal_dim)

    def _augment(self, ts: TimeStep) -> TimeStep:
        goal = self.goal_fn(ts.physics)
        obs = torch.cat([ts.observation, goal], -1) if self.append else ts.observation
        return ts.replace(goal=goal, observation=obs)

    def reset(self, generator: torch.Generator, num_envs: int) -> tp.Tuple[tp.Any, TimeStep]:
        state, ts = self.env.reset(generator, num_envs)
        return state, self._augment(ts)

    def step(self, state: tp.Any, action: Tensor) -> tp.Tuple[tp.Any, TimeStep]:
        state, ts = self.env.step(state, action)
        return state, self._augment(ts)


class StatefulEnv:
    """Mutable reset()/step() adapter over an environment: it owns the
    generator and the state of ``num_envs`` instances on ``device`` (a CUDA
    device unless the caller asks for the CPU)."""

    def __init__(self, env: Environment, seed: int = 0, num_envs: int = 1,
                 device: DeviceLike = None) -> None:
        self.env = env
        self.spec = env.spec
        self.num_envs = num_envs
        self._generator = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        self._state: tp.Any = None

    def reset(self) -> TimeStep:
        self._state, ts = self.env.reset(self._generator, self.num_envs)
        return ts

    def step(self, action: tp.Any) -> TimeStep:
        if self._state is None:
            raise RuntimeError("call reset() first")
        action = torch.as_tensor(action, dtype=torch.float32, device=self._generator.device)
        self._state, ts = self.env.step(self._state, action.expand(self.num_envs, -1))
        return ts
