"""Goal-space and goal registrations (mirror of
``controllable_agent_tpu/goals/spaces.py``).

Goal-space functions are functions of the owning domain's *feature tensor*,
batched over leading dimensions; each env documents the layout its
``goal_features`` produces:

  * point_mass_maze: physics = [x, y, vx, vy]
  * walker (planar): features = [x, z, up, vx, vz, am]   (am = subtree
    angular momentum around y)
  * quadruped: features = [up, |v|, wx, wy, wz, vx, vy, vz]  (workspace
    position wx..wz)
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import goal_spaces, goals

Tensor = torch.Tensor

# ---------------------------------------------------------------- spaces

# walker feature layout indices
_WX, _WZ, _WUP, _WVX, _WVZ, _WAM = range(6)


@goal_spaces("point_mass_maze")
def simplified_point_mass_maze(physics: Tensor) -> Tensor:
    """(x, y) of the point mass."""
    return physics[..., :2]


@goal_spaces("walker")
def simplified_walker(features: Tensor) -> Tensor:
    """(torso height, torso upright, horizontal velocity)."""
    return features[..., [_WZ, _WUP, _WVX]]


@goal_spaces("walker")
def walker_pos_speed(features: Tensor) -> Tensor:
    """simplified_walker + x position."""
    return features[..., [_WZ, _WUP, _WVX, _WX]]


@goal_spaces("walker")
def walker_pos_speed_z(features: Tensor) -> Tensor:
    """walker_pos_speed + vertical velocity + y-angular momentum: the 6D
    demo control space."""
    return features[..., [_WZ, _WUP, _WVX, _WX, _WVZ, _WAM]]


@goal_spaces("quadruped")
def simplified_quadruped(features: Tensor) -> Tensor:
    """(upright, speed norm)."""
    speed = torch.linalg.vector_norm(features[..., 5:8], dim=-1, keepdim=True)
    return torch.cat([features[..., :1], speed], -1)


@goal_spaces("quadruped")
def quad_pos_speed(features: Tensor) -> Tensor:
    """(upright, workspace xyz, torso velocity xyz), 7D."""
    return features[..., [0, 2, 3, 4, 5, 6, 7]]


@goal_spaces("quadruped")
def quadruped_positions(features: Tensor) -> Tensor:
    """(ball - target, torso - target), target at the origin, 6D. Only
    meaningful with task=quadruped_fetch, whose features carry the ball in
    columns 8:11."""
    return torch.cat([features[..., 8:11], features[..., 2:5]], -1)


@goal_spaces("grid")
def grid_simple(physics: Tensor) -> Tensor:
    """Normalized (y, x) agent position from gridworld physics [y,x,gy,gx]."""
    return physics[..., :2]


@goal_spaces("jaco")
def simplified_jaco(features: Tensor) -> Tensor:
    """Tool-centre-point xyz; jaco's goal features are the tcp position."""
    return features[..., :3]


# ---------------------------------------------------------------- goals

@goals("simplified_walker")
def walker_stand() -> np.ndarray:
    return np.array([1.2, 1.0, 0], dtype=np.float32)


@goals("simplified_walker")
def walker_walk() -> np.ndarray:
    return np.array([1.2, 1.0, 2], dtype=np.float32)


@goals("simplified_walker")
def walker_run() -> np.ndarray:
    return np.array([1.2, 1.0, 4], dtype=np.float32)


@goals("simplified_quadruped")
def quadruped_stand() -> np.ndarray:
    return np.array([1.0, 0], dtype=np.float32)


@goals("simplified_quadruped")
def quadruped_walk() -> np.ndarray:
    return np.array([1.0, 0.6], dtype=np.float32)


@goals("simplified_quadruped")
def quadruped_run() -> np.ndarray:
    return np.array([1.0, 6], dtype=np.float32)


@goals("quadruped_positions")
def quadruped_fetch() -> np.ndarray:
    """Ball at the target and torso at the target."""
    return np.zeros((6,), dtype=np.float32)


@goals("simplified_point_mass_maze")
def point_mass_maze_reach_top_left() -> np.ndarray:
    return np.array([-0.15, 0.15], dtype=np.float32)


@goals("simplified_point_mass_maze")
def point_mass_maze_reach_top_right() -> np.ndarray:
    return np.array([0.15, 0.15], dtype=np.float32)


@goals("simplified_point_mass_maze")
def point_mass_maze_reach_bottom_left() -> np.ndarray:
    return np.array([-0.15, -0.15], dtype=np.float32)


@goals("simplified_point_mass_maze")
def point_mass_maze_reach_bottom_right() -> np.ndarray:
    return np.array([0.15, -0.15], dtype=np.float32)


@goals("walker_pos_speed_z")
def walker_dummy() -> np.ndarray:
    return np.zeros((6,), dtype=np.float32)


@goals("simplified_jaco")
def jaco_reach_top_left() -> np.ndarray:
    return np.array([-0.09, 0.09, 0.001], dtype=np.float32)


@goals("simplified_jaco")
def jaco_reach_top_right() -> np.ndarray:
    return np.array([0.09, 0.09, 0.001], dtype=np.float32)


@goals("simplified_jaco")
def jaco_reach_bottom_left() -> np.ndarray:
    return np.array([-0.09, -0.09, 0.001], dtype=np.float32)


@goals("simplified_jaco")
def jaco_reach_bottom_right() -> np.ndarray:
    return np.array([0.09, -0.09, 0.001], dtype=np.float32)
