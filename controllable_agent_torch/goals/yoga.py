"""WalkerYogaReward: 12 posture goals with an oracle pose distance (mirror
of ``controllable_agent_tpu/goals/yoga.py``).

Named target poses (lie_back, kneel, bridge, head_stand, ...) and a reward
equal to minus the oracle distance: the max absolute error over (height,
shortest-angle trunk rotation, hip and knee angles), minimized over the two
leg orderings (legs are interchangeable).

Pose constants are in the walker layout q = [x, z, theta, r_hip, r_knee,
r_ankle, l_hip, l_knee, l_ankle] with absolute torso height (the source
poses are dm_control's [dz, x, rot, ...] with height relative to the 1.3
init, converted below).
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from .rewards import BaseReward

Tensor = torch.Tensor

_INIT_Z = 1.3

# source poses: [dz, x, rot, hip1, knee1, ankle1, hip2, knee2, ankle2]
_REF_POSES: tp.Dict[str, tp.List[float]] = {
    "lie_back": [-1.2, 0., -1.57, 0., 0., 0., 0., -0., 0.],
    "lie_front": [-1.2, -0., 1.57, 0., 0., 0., 0., 0., 0.],
    "legs_up": [-1.24, 0., -1.57, 1.57, 0., 0.0, 1.57, -0., 0.0],
    "kneel": [-0.5, 0., 0., 0., -1.57, -0.8, 1.57, -1.57, 0.0],
    "side_angle": [-0.3, 0., 0.9, 0., 0., -0.7, 1.87, -1.07, 0.0],
    "stand_up": [-0.15, 0., 0.34, 0.74, -1.34, -0., 1.1, -0.66, -0.1],
    "lean_back": [-0.27, 0., -0.45, 0.22, -1.5, 0.86, 0.6, -0.8, -0.4],
    "boat": [-1.04, 0., -0.8, 1.6, 0., 0.0, 1.6, -0., 0.0],
    "bridge": [-1.1, 0., -2.2, -0.3, -1.5, 0., -0.3, -0.8, -0.4],
    "head_stand": [-1., 0., -3., 0.6, -1., -0.3, 0.9, -0.5, 0.3],
    "one_feet": [-0.2, 0., 0., 0.7, -1.34, 0.5, 1.5, -0.6, 0.1],
    "arabesque": [-0.34, 0., 1.57, 1.57, 0., 0., 0., -0., 0.],
}


def get_walkeryoga_goals() -> tp.Dict[str, np.ndarray]:
    """Poses in the walker's q layout (9-dim)."""
    out = {}
    for name, p in _REF_POSES.items():
        dz, x, rot = p[0], p[1], p[2]
        legs = p[3:9]
        out[name] = np.array([x, _INIT_Z + dz, rot] + legs, np.float32)
    return out


def _shortest_angle(angle: Tensor) -> Tensor:
    angle = torch.remainder(angle, 2 * math.pi)
    return torch.where(angle > math.pi, 2 * math.pi - angle, angle)


def oracle_distance(q1: Tensor, q2: Tensor) -> Tensor:
    """Max absolute error over (height, trunk rotation, hips, knees),
    minimized over the two leg orderings. Batched over leading dims of q1."""
    q1 = q1[..., :9]
    q2 = q2[..., :9]

    def dist_to(goal: Tensor) -> Tensor:
        d = torch.abs(q1 - goal)
        # z, theta (shortest angle), r_hip, r_knee, l_hip, l_knee
        parts = torch.stack([
            d[..., 1], _shortest_angle(d[..., 2]),
            d[..., 3], d[..., 4], d[..., 6], d[..., 7]], -1)
        return parts.max(-1).values

    swapped = torch.cat([q2[..., :3], q2[..., 6:9], q2[..., 3:6]], -1)
    return torch.minimum(dist_to(q2), dist_to(swapped))


class WalkerYogaReward(BaseReward):
    """reward = -oracle_distance(q, goal_pose)."""

    def __init__(self, pose: str = "stand_up",
                 seed: tp.Optional[int] = None) -> None:
        super().__init__(seed)
        goals = get_walkeryoga_goals()
        if pose not in goals:
            raise ValueError(f"Unknown yoga pose {pose!r}; "
                             f"known: {sorted(goals)}")
        self.pose = pose
        self.goal_pose = goals[pose]
        self.goals = goals

    def compute_reward(self, physics: Tensor, pose: str) -> Tensor:
        physics = torch.as_tensor(physics)
        goal = torch.as_tensor(self.goals[pose], dtype=physics.dtype,
                               device=physics.device)
        return -oracle_distance(physics, goal)

    def from_physics(self, physics: Tensor) -> Tensor:
        return self.compute_reward(physics, self.pose)
