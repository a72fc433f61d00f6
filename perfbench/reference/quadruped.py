"""The quadruped of the repository's environments in plain PyTorch, in the
dtype of its inputs, on ``physics3d`` (the reference's own 3-D engine).

A box torso with four two-joint legs (hip and knee pitch; 9 bodies, 14
dof) on position servos, whose commands pass a first-order filter (time
constant 0.1 s) before the physics sees them; a control step of 0.02 s in
8 substeps. The geometry is the JAX package's quadruped as the port builds
it, its constants rounded to float32 as there.

An environment module (see ``walker.py``). The quadruped's state is more
than its physics columns [q, qd] (28): the filter's 8 values are the last
8 columns of the observation and nowhere else. ``CARRIED`` names those
observation columns; ``start``, ``step`` and ``observation`` take and give
the state as the physics with the carried columns appended (36), while the
goals and rewards read the physics columns alone.

Observation (37): joint angles (8), joint velocities (8), the torso
rotation's rows x and z (6), torso height (1), root linear (3) and Euler
rate (3) velocity, the filter (8). Goal features [up, 0, x, y, z, vx, vy,
vz], the velocity in the torso's frame; ``quad_pos_speed`` drops the 0.
``quadruped_stand``: the upright tolerance, 1 at up >= 1 and falling
linearly to 0 at a margin of 2.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from . import physics3d as p3d

Tensor = torch.Tensor

CONTROL_DT, SUBSTEPS = 0.02, 8
ACT_DECAY = float(np.exp(-CONTROL_DT / 0.1))  # the filter's exact step over a control step
TORSO_HALF = (0.23, 0.23, 0.07)
UPPER, LOWER, LEG_R = 0.20, 0.25, 0.04
INIT_Z, STANCE = 0.55, (0.3, -0.6)


def _box(mass: float, hx: float, hy: float, hz: float) -> tp.Tuple[float, float, float]:
    return (mass * (hy ** 2 + hz ** 2) / 3.0, mass * (hx ** 2 + hz ** 2) / 3.0,
            mass * (hx ** 2 + hy ** 2) / 3.0)


def _rod(mass: float, length: float) -> tp.Tuple[float, float, float]:
    """A leg as a cylinder along z."""
    across = mass * (length ** 2 / 12.0 + LEG_R ** 2 / 4.0)
    return (across, across, mass * LEG_R ** 2 / 2.0)


def model() -> p3d.Model3D:
    """Torso, then (upper, lower) for the legs at (+x, +y), (+x, -y),
    (-x, +y), (-x, -y); contacts at the torso's four bottom-plane corners
    and the four feet."""
    torso = 1000.0 * 8 * TORSO_HALF[0] * TORSO_HALF[1] * TORSO_HALF[2]
    upper, lower = (1000.0 * np.pi * LEG_R ** 2 * n for n in (UPPER, LOWER))
    parent, anchor, com = [-1], [(0.0, 0.0, 0.0)], [(0.0, 0.0, 0.0)]
    mass, inertia = [torso], [_box(torso, *TORSO_HALF)]
    contacts = [(0, (hx, hy, 0.0), 0.08) for hx in (-TORSO_HALF[0], TORSO_HALF[0])
                for hy in (-TORSO_HALF[1], TORSO_HALF[1])]
    for sx, sy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        hip = len(parent)
        parent += [0, hip]
        anchor += [(sx * TORSO_HALF[0], sy * TORSO_HALF[1], -TORSO_HALF[2]), (0.0, 0.0, -UPPER)]
        com += [(0.0, 0.0, -UPPER / 2), (0.0, 0.0, -LOWER / 2)]
        mass += [upper, lower]
        inertia += [_rod(upper, UPPER), _rod(lower, LOWER)]
        contacts.append((hip + 1, (0.0, 0.0, -LOWER), LEG_R))

    def f32(values: tp.Any) -> np.ndarray:
        return np.asarray(values, np.float32)

    def deg(*values: float) -> np.ndarray:
        return f32([float(np.deg2rad(v)) for v in values] * 4)

    return p3d.Model3D(
        parent=tuple(parent), anchor=f32(anchor), axis=f32([(0.0, 0.0, 1.0)] + [(0.0, 1.0, 0.0)] * 8),
        com=f32(com), mass=f32(mass), inertia=f32(inertia),
        contact_body=tuple(b for b, _, _ in contacts),
        contact_point=f32([p for _, p, _ in contacts]),
        contact_radius=f32([r for _, _, r in contacts]), damping=f32([30.0] * 8),
        limit_lo=deg(-60, -120), limit_hi=deg(60, 10), armature=f32([0.05] * 8),
        servo_gain=f32([1000.0] * 8), servo_center=deg(15, -30), servo_half=deg(45, 40))


MODEL = model()
NDOF = MODEL.ndof
PHYSICS = 2 * NDOF
CARRIED = tuple(range(29, 37))  # the observation's filter columns
RESET_DRAWS = 8  # one uniform for each joint


def start(uniform: Tensor) -> Tensor:
    """A reset's state from its draws: the crouched stance with each joint
    moved by uniform * 0.2 - 0.1, at rest, the filter at 0."""
    n = uniform.shape[0]
    stance = torch.tensor([0.0, 0.0, INIT_Z, 0.0, 0.0, 0.0] + list(STANCE) * 4,
                          dtype=uniform.dtype, device=uniform.device)
    q = stance.expand(n, NDOF).clone()
    q[:, 6:] += uniform * 0.2 - 0.1
    return torch.cat([q, torch.zeros_like(q), torch.zeros_like(uniform)], -1)


def step(state: Tensor, action: Tensor, substeps: int = SUBSTEPS) -> Tensor:
    """The next state [q, qd, filter] after one control step: the filter
    moves toward the clamped action, the servos track the filter. With
    ``substeps`` below ``SUBSTEPS``, that many of the step's substeps alone
    (a fault the check must see)."""
    action = action.clamp(-1.0, 1.0)
    act = action + (state[..., PHYSICS:] - action) * ACT_DECAY
    q, qd = p3d.step(MODEL, state[..., :NDOF], state[..., NDOF:PHYSICS], act,
                     CONTROL_DT * substeps / SUBSTEPS, substeps)
    return torch.cat([q, qd, act], -1)


def _rotations(q: Tensor) -> Tensor:
    flat = q[..., 3:6].reshape(-1, 3)
    return torch.func.vmap(p3d.euler_rot)(flat).reshape(*q.shape[:-1], 3, 3)


def observation(state: Tensor) -> Tensor:
    q, qd = state[..., :NDOF], state[..., NDOF:PHYSICS]
    rot = _rotations(q)
    return torch.cat([q[..., 6:], qd[..., 6:], rot[..., 0, :], rot[..., 2, :], q[..., 2:3],
                      qd[..., 0:3], qd[..., 3:6], state[..., PHYSICS:]], -1)


def features(physics: Tensor) -> Tensor:
    """[up, 0, x, y, z, vx, vy, vz]: the torso's z axis against the world's,
    the root's position and its velocity in the torso's frame."""
    q, qd = physics[..., :NDOF], physics[..., NDOF:PHYSICS]
    rot = _rotations(q)
    v_body = (rot.mT @ qd[..., 0:3, None]).squeeze(-1)
    return torch.cat([rot[..., 2, 2:3], torch.zeros_like(q[..., :1]), q[..., 0:3], v_body], -1)


def quad_pos_speed(physics: Tensor) -> Tensor:
    return features(physics)[..., [0, 2, 3, 4, 5, 6, 7]]


GOALS = {"quad_pos_speed": quad_pos_speed}


def stand_reward(physics: Tensor) -> Tensor:
    up = features(physics)[..., 0]
    below = (1.0 - up) / 2.0
    return torch.where(up >= 1.0, 1.0, torch.clamp(1.0 - below, min=0.0))


REWARDS = {"quadruped_stand": stand_reward}


def replay_physics(uniform: tp.Callable[[float, float, int], Tensor],
                   normal: tp.Callable[[int], Tensor], width: int) -> Tensor:
    """Synthetic physics columns in the quadruped's layout [q, qd]: the root
    within a metre of the origin at a height of 0.2-0.6, roll and pitch
    within 0.3 rad, any yaw, the joints around the stance; normal
    velocities."""
    qpos = torch.cat([uniform(-1.0, 1.0, 2), uniform(0.2, 0.6, 1), uniform(-0.3, 0.3, 2),
                      uniform(-np.pi, np.pi, 1), uniform(-1.0, 0.5, width // 2 - 6)], -1)
    return torch.cat([qpos, normal(width - qpos.shape[-1])], -1)
