"""Jaco reach: a fixed-base six-joint arm on ``physics3d`` (mirror of
``controllable_agent_tpu/envs/jaco.py``).

A pedestal with shoulder yaw, shoulder pitch, elbow pitch, forearm roll,
wrist pitch and wrist yaw, torque-driven, its root pinned (``fixed_base``);
one contact at the tool centre point (TCP) keeps the hand above the table.
Four reach tasks at (+-0.09, +-0.09, 0.001), reward tolerance(|tcp -
target|, (0, 0.05), margin 0.05); the episode starts from the ready pose with
joint noise in +-0.3 rad; episodes are 250 control steps of 0.04 s.

Observation: [sin q (6), cos q (6), qd (6), tcp (3), target (3)] -> 24.
Physics: [q (12), qd (12), target (3)] -> 27, so that rewards relabel from
stored physics alone. Goal features: the TCP's position. Batched over a
leading ``[E]`` axis, on the tensors' device.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.tolerance import tolerance
from . import physics3d as p3d
from .base import Environment, EnvSpec, StepType, TimeStep

Tensor = torch.Tensor

_TARGET_RADIUS = 0.05
TASKS: tp.Dict[str, np.ndarray] = {
    "reach_top_left": np.array([-0.09, 0.09, 0.001], np.float32),
    "reach_top_right": np.array([0.09, 0.09, 0.001], np.float32),
    "reach_bottom_left": np.array([-0.09, -0.09, 0.001], np.float32),
    "reach_bottom_right": np.array([0.09, -0.09, 0.001], np.float32),
}

# geometry
_BASE_POS = (-0.4, 0.0, 0.0)  # the pedestal's root, behind the target board
_PEDESTAL_H = 0.15
_UPPER_LEN = 0.25
_FORE_LEN = 0.12  # elbow -> forearm-roll joint
_ROLL_LEN = 0.12  # forearm-roll joint -> wrist
_WRIST_LEN = 0.08
_HAND_LEN = 0.06  # wrist-yaw body -> tool centre point
_LINK_R = 0.03
_READY_POSE = np.array([0.0, 0.9, 1.0, 0.0, 0.5, 0.0], np.float32)


def jaco_model() -> p3d.Model3D:
    """7 bodies: the fixed pedestal and 6 hinged links. ndof = 12, the root pinned."""
    link_specs = [
        # (anchor in the parent's frame, hinge axis, length along +z)
        ((0.0, 0.0, _PEDESTAL_H), (0.0, 0.0, 1.0), 0.04),   # shoulder yaw
        ((0.0, 0.0, 0.04), (0.0, 1.0, 0.0), _UPPER_LEN),    # shoulder pitch
        ((0.0, 0.0, _UPPER_LEN), (0.0, 1.0, 0.0), _FORE_LEN),  # elbow pitch
        ((0.0, 0.0, _FORE_LEN), (0.0, 0.0, 1.0), _ROLL_LEN),   # forearm roll
        ((0.0, 0.0, _ROLL_LEN), (0.0, 1.0, 0.0), _WRIST_LEN),  # wrist pitch
        ((0.0, 0.0, _WRIST_LEN), (0.0, 0.0, 1.0), _HAND_LEN),  # wrist yaw
    ]
    parent = [-1]
    anchor = [(0.0, 0.0, 0.0)]
    axis = [(0.0, 0.0, 1.0)]
    com = [(0.0, 0.0, _PEDESTAL_H / 2)]
    mass = [4.0]
    inertia = [p3d.box_inertia(4.0, 0.06, 0.06, _PEDESTAL_H / 2)]
    for i, (anc, ax, length) in enumerate(link_specs):
        parent.append(i)  # a chain: body b's parent is body b - 1
        anchor.append(anc)
        axis.append(ax)
        com.append((0.0, 0.0, length / 2))
        m = 0.6 if i < 3 else 0.35
        mass.append(m)
        inertia.append(p3d.rod_inertia3(m, max(length, 0.04), _LINK_R, 2))

    def f32(values: tp.Any) -> np.ndarray:
        return np.asarray(values, np.float32)

    deg = np.deg2rad
    return p3d.Model3D(
        parent=tuple(parent), anchor=f32(anchor), axis=f32(axis), com=f32(com),
        mass=f32(mass), inertia=f32(inertia),
        # one contact at the TCP keeps the hand above the table (z = 0); radius
        # 0: the force engages once the point dips under
        contact_body=(6,), contact_point=f32([[0.0, 0.0, _HAND_LEN]]),
        contact_radius=f32([0.0]),
        gear=f32([12.0, 25.0, 18.0, 6.0, 6.0, 4.0]),
        damping=f32([1.5, 2.5, 2.0, 0.8, 0.8, 0.5]),
        limit_lo=f32([float(deg(v)) for v in (-180, -80, -150, -180, -100, -180)]),
        limit_hi=f32([float(deg(v)) for v in (180, 100, 150, 180, 100, 180)]),
        armature=f32([0.1, 0.1, 0.1, 0.05, 0.05, 0.05]),
        contact_stiffness=5.0e3, contact_damping=50.0, fixed_base=True)


@dataclasses.dataclass(frozen=True)
class JacoState:
    q: Tensor  # [E, 12]
    qd: Tensor  # [E, 12]
    touch: Tensor  # [E, 1]
    t: Tensor  # [E] int32
    target: Tensor  # [E, 3]


def tcp_position(model: p3d.Model3D, q: Tensor) -> Tensor:
    """The tool centre point (the tip of the last link) in the world frame, [..., 3]."""
    origins, rots = p3d.fk(model, q)
    return origins[..., 6, :] + rots[..., 6, :, 2] * _HAND_LEN


def jaco_features(model: p3d.Model3D, physics: Tensor) -> Tensor:
    """Goal features: the TCP's position, batched over leading axes."""
    return tcp_position(model, physics[..., :model.ndof])


class JacoEnv(Environment):
    def __init__(self, task: str, episode_length: int = 250) -> None:
        if task not in TASKS:
            raise ValueError(f"Unknown jaco task {task!r}")
        self.task = task
        self.model = jaco_model()
        self.episode_length = episode_length
        self.control_dt, self.n_substeps = 0.04, 8
        ndof = self.model.ndof
        self.spec = EnvSpec(obs_dim=24, action_dim=6, physics_dim=2 * ndof + 3, goal_dim=0,
                            episode_length=episode_length)
        self._constants: tp.Dict[tp.Tuple[torch.device, torch.dtype], tp.Tuple[Tensor, Tensor]] = {}

    def constants(self, device: torch.device, dtype: torch.dtype) -> tp.Tuple[Tensor, Tensor]:
        """The ready pose with the pinned root [12] and the target [3]."""
        key = (torch.device(device), dtype)
        if key not in self._constants:
            pose = np.concatenate([_BASE_POS, np.zeros(3), _READY_POSE.astype(np.float64)])
            self._constants[key] = (torch.as_tensor(pose, dtype=dtype).to(device),
                                    torch.as_tensor(TASKS[self.task], dtype=dtype).to(device))
        return self._constants[key]

    def _obs(self, state: JacoState) -> Tensor:
        qj = state.q[..., 6:]
        return torch.cat([torch.sin(qj), torch.cos(qj), state.qd[..., 6:],
                          tcp_position(self.model, state.q), state.target], -1)

    def _physics(self, state: JacoState) -> Tensor:
        return torch.cat([state.q, state.qd, state.target], -1)

    def goal_features(self, physics: Tensor) -> Tensor:
        return jaco_features(self.model, torch.as_tensor(physics))

    def reward_from_physics(self, physics: Tensor) -> Tensor:
        """tolerance(|tcp - target|), batched over leading axes."""
        physics = torch.as_tensor(physics)
        ndof = self.model.ndof
        tcp = tcp_position(self.model, physics[..., :ndof])
        dist = torch.linalg.vector_norm(tcp - physics[..., 2 * ndof:2 * ndof + 3], dim=-1)
        return tolerance(dist, (0.0, _TARGET_RADIUS), margin=_TARGET_RADIUS)

    def reset(self, generator: torch.Generator, num_envs: int) -> tp.Tuple[JacoState, TimeStep]:
        return self.reset_from_uniform(
            torch.rand((num_envs, 6), generator=generator, device=generator.device))

    def reset_from_uniform(self, u: Tensor) -> tp.Tuple[JacoState, TimeStep]:
        """``reset`` with its uniform draw ``u`` [E, 6] handed in: the ready
        pose plus u * 0.6 - 0.3 on each joint, at rest."""
        pose, target = self.constants(u.device, u.dtype)
        q = pose + F.pad(u * 0.6 - 0.3, (6, 0))
        e = u.shape[0]
        state = JacoState(q=q, qd=torch.zeros_like(q), touch=torch.zeros_like(q[:, :1]),
                          t=torch.zeros(e, dtype=torch.int32, device=u.device),
                          target=target.expand(e, 3).clone())
        ts = TimeStep(step_type=torch.full_like(state.t, StepType.FIRST),
                      reward=torch.zeros_like(q[:, 0]), discount=torch.ones_like(q[:, 0]),
                      observation=self._obs(state), action=torch.zeros_like(u),
                      physics=self._physics(state))
        return state, ts

    def step(self, state: JacoState, action: Tensor) -> tp.Tuple[JacoState, TimeStep]:
        action = action.float().clamp(-1.0, 1.0)
        q, qd, touch = p3d.step(self.model, state.q, state.qd, action, self.control_dt,
                                self.n_substeps)
        new = JacoState(q=q, qd=qd, touch=touch, t=state.t + 1, target=state.target)
        physics = self._physics(new)
        ts = TimeStep(
            step_type=torch.where(new.t >= self.episode_length, StepType.LAST,
                                  StepType.MID).to(torch.int32),
            reward=self.reward_from_physics(physics).float(),
            discount=torch.ones_like(q[:, 0]), observation=self._obs(new), action=action,
            physics=physics)
        return new, ts


def make(name: str, episode_length: int = 250) -> JacoEnv:
    domain, task = name.split("_", 1)
    assert domain == "jaco"
    return JacoEnv(task, episode_length=episode_length)
