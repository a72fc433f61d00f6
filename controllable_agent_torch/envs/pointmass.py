"""Point-mass maze (mirror of ``controllable_agent_tpu/envs/pointmass.py``).

A 2D point mass in a +-0.3 arena divided into four rooms by a plus-shaped
wall of half-length 0.18 centered at the origin; slide joints limited to
+-0.29 with damping 1 and motor gear 0.1; reach targets at (+-0.15, +-0.15)
with a tolerance reward shaped by a small-control bonus. The dynamics are an
analytic damped point mass integrated semi-implicitly, and the wall blocks
motion per axis. physics = observation = [x, y, vx, vy]; batched over a
leading ``[E]`` axis.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from ..ops.tolerance import tolerance
from .base import Environment, EnvSpec, StepType, TimeStep

Tensor = torch.Tensor

TASKS: tp.Dict[str, np.ndarray] = {
    "reach_top_left": np.array([-0.15, 0.15], np.float32),
    "reach_top_right": np.array([0.15, 0.15], np.float32),
    "reach_bottom_left": np.array([-0.15, -0.15], np.float32),
    "reach_bottom_right": np.array([0.15, -0.15], np.float32),
}

# geometry: arena |x|,|y| <= 0.29 (joint limit), cross walls along the axes
# with half-length 0.18 and half-thickness 0.02
_JOINT_LIMIT = 0.29
_WALL_HALF_LEN = 0.18
_WALL_HALF_THICK = 0.02
_MASS = 0.3
_DAMPING = 1.0
_GEAR = 0.1
_CONTROL_DT = 0.02  # 1000 steps over the 20 s time limit
_N_SUBSTEPS = 4


@dataclasses.dataclass(frozen=True)
class PointMassState:
    pos: Tensor  # [E, 2]
    vel: Tensor  # [E, 2]
    t: Tensor  # [E] int32


def _blocked(pos: Tensor, new_pos: Tensor) -> Tensor:
    """Block per-axis motion that would enter the cross-shaped wall.

    The wall region is {|x| <= 0.18+eps and |y| <= 0.02} u {|y| <= 0.18+eps
    and |x| <= 0.02} (two crossing boxes). Movement is resolved per axis: if
    moving only along one axis would put the point inside a wall box, that
    axis keeps its old coordinate.
    """
    t = _WALL_HALF_THICK + 0.01  # wall half-thickness + point radius
    half_len = _WALL_HALF_LEN

    def inside_wall(x: Tensor, y: Tensor) -> Tensor:
        in_x_arm = (x.abs() <= half_len + t) & (y.abs() <= t)
        in_y_arm = (y.abs() <= half_len + t) & (x.abs() <= t)
        return in_x_arm | in_y_arm

    x = torch.where(inside_wall(new_pos[..., 0], pos[..., 1]), pos[..., 0], new_pos[..., 0])
    y = torch.where(inside_wall(pos[..., 0], new_pos[..., 1]), pos[..., 1], new_pos[..., 1])
    return torch.stack([x, y], -1)


class PointMassMaze(Environment):
    """Four-room point-mass maze. Observation = [pos, vel] (4D)."""

    def __init__(self, task: str = "reach_top_left", episode_length: int = 1000) -> None:
        self.task = task
        self.target = TASKS.get(task, TASKS["reach_top_left"])
        self._target_on: tp.Dict[tp.Tuple[torch.device, torch.dtype], Tensor] = {}
        self.episode_length = episode_length
        self.spec = EnvSpec(obs_dim=4, action_dim=2, physics_dim=4, goal_dim=2,
                            episode_length=episode_length)

    def reward_from_physics(self, physics: Tensor, action: Tensor) -> Tensor:
        """Task reward: tolerance on target distance x small-control bonus."""
        pos = physics[..., :2]
        target_size = 0.015
        control = tolerance(action, bounds=(0.0, 0.0), margin=1.0,
                            value_at_margin=0.0, sigmoid="quadratic")
        small_control = (control.mean(-1) + 4.0) / 5.0
        key = (pos.device, pos.dtype)
        if key not in self._target_on:  # placed once: a captured step copies nothing from the host
            self._target_on[key] = torch.as_tensor(self.target, dtype=pos.dtype).to(pos.device)
        dist = torch.linalg.vector_norm(pos - self._target_on[key], dim=-1)
        near = tolerance(dist, bounds=(0.0, target_size), margin=target_size)
        return near * small_control

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> tp.Tuple[PointMassState, TimeStep]:
        return self.reset_from_uniform(
            torch.rand((num_envs, 2), generator=generator, device=generator.device))

    def reset_from_uniform(self, u: Tensor) -> tp.Tuple[PointMassState, TimeStep]:
        """``reset`` with its uniform draw ``u`` [E, 2] handed in: every
        episode starts in the top-left room."""
        lo = torch.tensor([-0.29, 0.15], dtype=u.dtype, device=u.device)
        pos = lo + u * 0.14
        state = PointMassState(pos=pos, vel=torch.zeros_like(pos),
                               t=torch.zeros(u.shape[0], dtype=torch.int32, device=u.device))
        physics = torch.cat([state.pos, state.vel], -1)
        ts = TimeStep(
            step_type=torch.full_like(state.t, StepType.FIRST),
            reward=torch.zeros_like(pos[:, 0]), discount=torch.ones_like(pos[:, 0]),
            observation=physics, action=torch.zeros_like(pos), physics=physics)
        return state, ts

    def step(self, state: PointMassState, action: Tensor
             ) -> tp.Tuple[PointMassState, TimeStep]:
        action = action.float().clamp(-1.0, 1.0)
        dt = _CONTROL_DT / _N_SUBSTEPS
        force = _GEAR * action
        pos, vel = state.pos, state.vel
        for _ in range(_N_SUBSTEPS):
            acc = (force - _DAMPING * vel) / _MASS
            vel = vel + dt * acc  # semi-implicit Euler
            new_pos = (pos + dt * vel).clamp(-_JOINT_LIMIT, _JOINT_LIMIT)
            pos = _blocked(pos, new_pos)
            vel = torch.where(pos == new_pos, vel, 0.0)  # kill velocity along blocked axes
        t = state.t + 1
        physics = torch.cat([pos, vel], -1)
        ts = TimeStep(
            step_type=torch.where(t >= self.episode_length, StepType.LAST,
                                  StepType.MID).to(torch.int32),
            reward=self.reward_from_physics(physics, action).float(),
            discount=torch.ones_like(pos[:, 0]),
            observation=physics, action=action, physics=physics)
        return PointMassState(pos=pos, vel=vel, t=t), ts
