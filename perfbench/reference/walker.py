"""The planar walker of the repository's environments in plain PyTorch,
in the dtype of its inputs.

The walker (7 capsule bodies, 9 dof; the dm_control walker's geometry as
the JAX package builds it) advances by ``physics2d.step`` at a control step
of 0.025 s in 10 substeps. Its observation is the bodies' orientations
(cos, sin), the torso height and the velocities (24); its goal features
[x, z, up, vx, vz, angular momentum]; the stand task's reward
(3 standing + upright) / 4 with dm_control's gaussian tolerance.

An environment module (this one; a configuration names it as its
``environment``) gives ``RESET_DRAWS``, ``start(uniform)``, ``step``,
``observation``, ``GOALS`` (goal columns by goal space), ``REWARDS`` (by
task) and ``replay_physics``, the physics columns of synthetic replay.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from . import physics2d as p2d

Tensor = torch.Tensor

CONTROL_DT, SUBSTEPS = 0.025, 10
STAND_HEIGHT = 1.2


def _deg(lo: float, hi: float) -> tp.Tuple[float, float]:
    return (float(np.deg2rad(lo)), float(np.deg2rad(hi)))


def model() -> p2d.PlanarModel:
    """Torso, right thigh/leg/foot, left thigh/leg/foot."""
    r_t, l_t = 0.07, 0.6
    links = [(0.05, 0.45), (0.04, 0.5), (0.05, 0.2)] * 2
    mass = [p2d.capsule_mass(r_t, l_t)] + [p2d.capsule_mass(r, n) for r, n in links]
    inertia = [p2d.capsule_inertia(r_t, l_t)] + [p2d.capsule_inertia(r, n) for r, n in links]
    hip, ft_com, l_ft, r_ft = (0.0, -l_t / 2), 0.06, 0.2, 0.05
    contacts = [(0, (0.0, l_t / 2), r_t), (0, (0.0, -l_t / 2), r_t),
                (3, (ft_com - l_ft / 2, 0.0), r_ft), (3, (ft_com + l_ft / 2, 0.0), r_ft),
                (6, (ft_com - l_ft / 2, 0.0), r_ft), (6, (ft_com + l_ft / 2, 0.0), r_ft)]
    limits = [_deg(-20, 100), _deg(-150, 0), _deg(-45, 45)] * 2

    def f32(values: tp.Any) -> np.ndarray:
        return np.asarray(values, np.float32)

    return p2d.PlanarModel(
        parent=(-1, 0, 1, 2, 0, 4, 5),
        anchor=f32([(0, 0), hip, (0.0, -0.45), (0.0, -0.5), hip, (0.0, -0.45), (0.0, -0.5)]),
        com=f32([(0, 0), (0, -0.225), (0, -0.25), (ft_com, 0), (0, -0.225), (0, -0.25),
                 (ft_com, 0)]),
        mass=f32(mass), inertia=f32(inertia), contact_body=tuple(c[0] for c in contacts),
        contact_point=f32([c[1] for c in contacts]),
        contact_radius=f32([c[2] for c in contacts]), gear=f32([100, 50, 20, 100, 50, 20]),
        damping=f32([0.1] * 6), limit_lo=f32([lim[0] for lim in limits]),
        limit_hi=f32([lim[1] for lim in limits]), armature=f32([0.01] * 6))


MODEL = model()
NDOF = MODEL.ndof


def observation(physics: Tensor) -> Tensor:
    q, qd = physics[..., :NDOF], physics[..., NDOF:]
    angles = q[..., 2:] @ MODEL.tensors(q.device, q.dtype).body_frames.T
    orient = torch.stack([torch.cos(angles), torch.sin(angles)], -1)
    return torch.cat([orient.flatten(-2), q[..., 1:2], qd], -1)


def features(physics: Tensor) -> Tensor:
    q, qd = physics[..., :NDOF], physics[..., NDOF:]
    v_com, l_y, _ = p2d.subtree_momentum(MODEL, q, qd)
    return torch.stack([q[..., 0], q[..., 1], torch.cos(q[..., 2]), v_com[..., 0],
                        v_com[..., 1], l_y], -1)


def walker_pos_speed_z(physics: Tensor) -> Tensor:
    """(height, upright, vx, x, vz, angular momentum)."""
    return features(physics)[..., [1, 2, 3, 0, 4, 5]]


GOALS = {"walker_pos_speed_z": walker_pos_speed_z}


def stand_reward(physics: Tensor) -> Tensor:
    """(3 standing + upright) / 4; standing is 1 at a height of 1.2 and over,
    falling as a gaussian to 0.1 at 0.6 below."""
    f = features(physics)
    below = (STAND_HEIGHT - f[..., 1]) / (STAND_HEIGHT / 2)
    scale = float(np.sqrt(-2.0 * np.log(np.float32(0.1))))
    standing = torch.where(f[..., 1] >= STAND_HEIGHT, 1.0,
                           torch.exp(-0.5 * torch.square(below * scale)))
    return (3 * standing + (1 + f[..., 2]) / 2) / 4


REWARDS = {"walker_stand": stand_reward}
RESET_DRAWS = NDOF - 3  # one uniform for each joint


def start(uniform: Tensor) -> Tensor:
    """A reset's physics from its draws: the torso upright at a height of
    1.3 and at rest, each joint uniform in its range."""
    c = MODEL.tensors(uniform.device, uniform.dtype)
    joints = c.limit_lo + uniform * (c.limit_hi - c.limit_lo)
    n = uniform.shape[0]
    root = torch.tensor([0.0, 1.3, 0.0], dtype=uniform.dtype, device=uniform.device)
    return torch.cat([root.expand(n, 3), joints,
                      torch.zeros(n, NDOF, dtype=uniform.dtype, device=uniform.device)], -1)


def replay_physics(uniform: tp.Callable[[float, float, int], Tensor],
                   normal: tp.Callable[[int], Tensor], width: int) -> Tensor:
    """Synthetic physics columns in dm_control walker's MuJoCo layout
    ([qpos, qvel], qpos = rootz, rootx, rooty, six joints), near the
    standing pose."""
    qpos = torch.cat([uniform(-0.1, 0.05, 1), uniform(-1.0, 1.0, 1), uniform(-0.3, 0.3, 1),
                      uniform(-0.5, 0.5, width // 2 - 3)], -1)
    return torch.cat([qpos, normal(width - qpos.shape[-1])], -1)


def step(physics: Tensor, action: Tensor) -> Tensor:
    """The next physics [q, qd] after one control step."""
    q, qd, _ = p2d.step(MODEL, physics[..., :NDOF], physics[..., NDOF:],
                        action.clamp(-1.0, 1.0), CONTROL_DT, SUBSTEPS)
    return torch.cat([q, qd], -1)
