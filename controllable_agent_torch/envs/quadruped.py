"""Quadruped: 3-D locomotion on ``physics3d`` (mirror of
``controllable_agent_tpu/envs/quadruped.py``).

A box torso with four two-joint legs (hip pitch and knee) on position servos
whose commands pass through a first-order filter (time constant 0.1 s); the
filter's state is part of the observation. Eight tasks: stand, walk, run,
jump, roll and roll_fast on flat ground; ``escape`` on a bowl-shaped
heightfield drawn per episode, with a 20-ray rangefinder in the observation;
``fetch`` with a free ball (soft contacts against the ground, the arena's
walls and the robot's collision spheres, the ball's reaction on the robot
neglected). The model, the task set, the observation layouts and the reward
shapes are the JAX package's:

  stand/walk/run/jump/roll/roll_fast: joint angles (8), joint velocities (8),
    torso rotation rows x and z (6), torso height (1), torso linear (3) and
    angular (3) velocity, actuator filter (8)                         -> 37
  escape: + the origin in the torso frame (3) + rangefinder (20)     -> 60
  fetch: + ball position, velocity and spin in the torso frame (9) + the
    target in the torso frame (3)                                     -> 49

The physics vector is [q, qd] (28), fetch appends the ball's position,
velocity and spin (37). Goal features are [up, 0, x, y, z, vx, vy, vz] (the
torso velocity in its own frame), fetch's with the ball's position after
them. Every function is batched over a leading ``[E]`` axis (features and
rewards over any leading axes) and runs on the tensors' device; an escape
state carries its terrain, which ``step`` hands on as the same tensor.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.tolerance import tolerance
from . import physics3d as p3d
from .base import Environment, EnvSpec, StepType, TimeStep

Tensor = torch.Tensor

_WALK_SPEED = 0.5
_RUN_SPEED = 5.0
_JUMP_HEIGHT = 1.0

# escape terrain: a 60 m square, 5 m high, 101 x 101 heights
_TERRAIN_HALF = 30.0
_TERRAIN_ZMAX = 5.0
_TERRAIN_RES = 101
_TERRAIN_SMOOTHNESS = 0.15
_TERRAIN_BUMP_SCALE = 2.0
BUMP_RES = int(2 * _TERRAIN_HALF / _TERRAIN_BUMP_SCALE)  # 30 x 30 bumps per terrain
_N_RANGEFINDERS = 20
_RAY_SAMPLES = 16

# fetch arena
_FLOOR_HALF = 15.0
_BALL_RADIUS = 0.15
_BALL_MASS = 1.0
_TARGET_RADIUS = 0.4
_WORKSPACE_OFFSET = (0.4, 0.0, -0.1)  # in the torso frame
_WORKSPACE_RADIUS = 0.3

TASKS = ["stand", "walk", "run", "jump", "roll", "roll_fast", "escape", "fetch"]

_ACT_TAU = 0.1  # the actuator filter's time constant

# geometry
_TORSO_HALF = (0.23, 0.23, 0.07)
_UPPER_LEN = 0.20
_LOWER_LEN = 0.25
_LEG_R = 0.04
_INIT_Z = 0.55
_STANCE = (0.3, -0.6)  # hip and knee of the crouched stance at reset


def quadruped_model() -> p3d.Model3D:
    """9 bodies: torso + 4 x (upper, lower) legs. 14 dof (6 root + 8 hinges)."""
    tm = 1000.0 * (2 * _TORSO_HALF[0]) * (2 * _TORSO_HALF[1]) * (2 * _TORSO_HALF[2])
    upper_mass = 1000.0 * np.pi * _LEG_R ** 2 * _UPPER_LEN
    lower_mass = 1000.0 * np.pi * _LEG_R ** 2 * _LOWER_LEN
    parent = [-1]
    anchor = [(0.0, 0.0, 0.0)]
    axis = [(0.0, 0.0, 1.0)]
    com = [(0.0, 0.0, 0.0)]
    mass = [tm]
    inertia = [p3d.box_inertia(tm, *_TORSO_HALF)]
    contacts = [(0, (hx, hy, 0.0), 0.08)
                for hx in (-_TORSO_HALF[0], _TORSO_HALF[0])
                for hy in (-_TORSO_HALF[1], _TORSO_HALF[1])]
    body = 1
    for (sx, sy) in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        hip = (sx * _TORSO_HALF[0], sy * _TORSO_HALF[1], -_TORSO_HALF[2])
        # the hips pitch about the lateral (y) axis: the legs swing fore and aft
        parent += [0, body]
        anchor += [hip, (0.0, 0.0, -_UPPER_LEN)]
        axis += [(0.0, 1.0, 0.0), (0.0, 1.0, 0.0)]
        com += [(0.0, 0.0, -_UPPER_LEN / 2), (0.0, 0.0, -_LOWER_LEN / 2)]
        mass += [upper_mass, lower_mass]
        inertia += [p3d.rod_inertia3(upper_mass, _UPPER_LEN, _LEG_R, 2),
                    p3d.rod_inertia3(lower_mass, _LOWER_LEN, _LEG_R, 2)]
        contacts.append((body + 1, (0.0, 0.0, -_LOWER_LEN), _LEG_R))
        body += 2

    def f32(values: tp.Any) -> np.ndarray:
        return np.asarray(values, np.float32)

    deg = np.deg2rad
    return p3d.Model3D(
        parent=tuple(parent), anchor=f32(anchor), axis=f32(axis), com=f32(com),
        mass=f32(mass), inertia=f32(inertia),
        contact_body=tuple(c[0] for c in contacts),
        contact_point=f32([c[1] for c in contacts]),
        contact_radius=f32([c[2] for c in contacts]),
        gear=f32([60.0, 40.0] * 4), damping=f32([30.0] * 8),
        limit_lo=f32([float(deg(-60)), float(deg(-120))] * 4),
        limit_hi=f32([float(deg(60)), float(deg(10))] * 4),
        armature=f32([0.05] * 8),
        # position servos (gain 1000, damping 30); action 0 commands a
        # statically stable stance, the ranges stay inside the joint limits
        servo_gain=f32([1000.0] * 8),
        servo_center=f32([float(deg(15)), float(deg(-30))] * 4),
        servo_half=f32([float(deg(45)), float(deg(40))] * 4))


@dataclasses.dataclass(frozen=True)
class QuadState:
    q: Tensor  # [E, 14]
    qd: Tensor  # [E, 14]
    touch: Tensor  # [E, 8] largest normal force of each contact over the last step
    t: Tensor  # [E] int32
    act: Tensor  # [E, 8] the actuator filter's state (filtered servo commands)


@dataclasses.dataclass(frozen=True)
class EscapeState(QuadState):
    terrain: Tensor  # [E, 101, 101] world heights


@dataclasses.dataclass(frozen=True)
class FetchState(QuadState):
    ball_pos: Tensor  # [E, 3]
    ball_vel: Tensor  # [E, 3]
    ball_angvel: Tensor  # [E, 3]


def quad_features(model: p3d.Model3D, physics: Tensor) -> Tensor:
    """[up, 0, x, y, z, vx, vy, vz]: the torso's z axis against the world's,
    the root position, and the torso's linear velocity in its own frame (so
    vx is its forward speed), batched over leading axes."""
    ndof = model.ndof
    q, qd = physics[..., :ndof], physics[..., ndof:2 * ndof]
    rot = p3d.euler_rot(q[..., 3:6])
    v_body = (rot.mT @ qd[..., 0:3, None]).squeeze(-1)
    return torch.cat([rot[..., 2, 2:3], torch.zeros_like(q[..., :1]), q[..., 0:3], v_body], -1)


def _upright(features: Tensor, deviation_deg: float = 0.0) -> Tensor:
    """The upright reward, full within ``deviation_deg`` of vertical."""
    dev = float(np.cos(np.deg2rad(deviation_deg)))
    return tolerance(features[..., 0], (dev, float("inf")), margin=1.0 + dev,
                     value_at_margin=0.0, sigmoid="linear")


def generate_terrain(bumps: Tensor) -> Tensor:
    """Sinusoidal bowl x smooth random bumps: ``bumps`` [..., 30, 30] in
    [0.15, 1) resized to the 101 x 101 heightfield by bilinear interpolation
    (JAX's ``jax.image.resize(..., "linear")``), times the bowl."""
    grid = torch.linspace(-1.0, 1.0, _TERRAIN_RES, dtype=bumps.dtype, device=bumps.device)
    radius = torch.sqrt(grid[None, :] ** 2 + grid[:, None] ** 2).clamp(0.04, 1.0)
    bowl = 0.5 - torch.cos(2 * math.pi * radius) / 2.0
    flat = bumps.reshape(-1, 1, *bumps.shape[-2:])
    smooth = F.interpolate(flat, size=(_TERRAIN_RES, _TERRAIN_RES), mode="bilinear",
                           align_corners=False).reshape(*bumps.shape[:-2], _TERRAIN_RES,
                                                        _TERRAIN_RES)
    return bowl * smooth * _TERRAIN_ZMAX


class _Constants(tp.NamedTuple):
    """An environment's constant tensors on one device."""

    stance: Tensor  # [14] q at reset before the joint noise
    ray_dirs: Tensor  # [R, 3] the rangefinder's rays in the torso frame
    ray_steps: Tensor  # [S] distances sampled along each ray
    ray_origin: Tensor  # [3] the rays' origin in the torso frame
    workspace: Tensor  # [3] fetch's workspace in the torso frame


class QuadrupedEnv(Environment):
    def __init__(self, task: str, episode_length: int = 1000) -> None:
        if task not in TASKS:
            raise ValueError(f"Unknown quadruped task {task!r}")
        self.task = task
        self.model = quadruped_model()
        self.episode_length = episode_length
        self.control_dt, self.n_substeps = 0.02, 8
        # the exact discrete step of d(act)/dt = (ctrl - act) / tau over control_dt
        self._act_decay = float(np.exp(-self.control_dt / _ACT_TAU))
        self.spec = EnvSpec(obs_dim=37, action_dim=8, physics_dim=2 * self.model.ndof,
                            goal_dim=0, episode_length=episode_length)
        self._constants: tp.Dict[tp.Tuple[torch.device, torch.dtype], _Constants] = {}

    def constants(self, device: torch.device, dtype: torch.dtype) -> _Constants:
        key = (torch.device(device), dtype)
        if key not in self._constants:
            az = np.linspace(-0.7, 0.7, _N_RANGEFINDERS)
            pitch = -np.pi / 6
            rays = np.stack([np.cos(az) * np.cos(pitch), np.sin(az) * np.cos(pitch),
                             np.full_like(az, np.sin(pitch))], 1)

            def on(x: tp.Any) -> Tensor:
                return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype).to(device)

            self._constants[key] = _Constants(
                stance=on([0.0, 0.0, _INIT_Z, 0.0, 0.0, 0.0] + list(_STANCE) * 4),
                ray_dirs=on(rays), ray_steps=on(np.linspace(0.25, 4.0, _RAY_SAMPLES)),
                ray_origin=on([_TORSO_HALF[0], 0.0, 0.0]), workspace=on(_WORKSPACE_OFFSET))
        return self._constants[key]

    # -- observables -----------------------------------------------------
    def _obs(self, state: QuadState) -> Tensor:
        q, qd = state.q, state.qd
        rot = p3d.euler_rot(q[..., 3:6])
        return torch.cat([q[..., 6:], qd[..., 6:], rot[..., 0, :], rot[..., 2, :], q[..., 2:3],
                          qd[..., 0:3], qd[..., 3:6], state.act], -1)

    def _physics(self, state: QuadState) -> Tensor:
        return torch.cat([state.q, state.qd], -1)

    def goal_features(self, physics: Tensor) -> Tensor:
        """[up, 0, x, y, z, vx, vy, vz], batched over leading axes."""
        return quad_features(self.model, torch.as_tensor(physics))

    # -- rewards -----------------------------------------------------------
    def reward_from_physics(self, physics: Tensor) -> Tensor:
        return self.reward_from_features(quad_features(self.model, torch.as_tensor(physics)))

    def reward_from_features(self, feats: Tensor) -> Tensor:
        """The task's reward as a function of the goal features, batched over
        leading axes (also the relabeling path of foreign quadruped states,
        ``data/exorl.py:mujoco_quadruped_features``)."""
        feats = torch.as_tensor(feats)
        up, z, v = feats[..., 0], feats[..., 4], feats[..., 5:8]
        inf = float("inf")
        upright = tolerance(up, (1.0, inf), margin=2.0, value_at_margin=0.0, sigmoid="linear")
        if self.task == "stand":
            return upright
        if self.task == "jump":
            return upright * tolerance(z, (_JUMP_HEIGHT, inf), margin=_JUMP_HEIGHT,
                                       value_at_margin=0.5, sigmoid="linear")
        speed = _WALK_SPEED if self.task in ("walk", "roll") else _RUN_SPEED
        moving = (torch.linalg.vector_norm(v, dim=-1) if self.task in ("roll", "roll_fast")
                  else v[..., 0])
        return upright * tolerance(moving, (speed, inf), margin=speed, value_at_margin=0.5,
                                   sigmoid="linear")

    # -- API -------------------------------------------------------------
    def reset(self, generator: torch.Generator, num_envs: int) -> tp.Tuple[QuadState, TimeStep]:
        return self.reset_from_uniform(
            torch.rand((num_envs, 8), generator=generator, device=generator.device))

    def _base_state(self, u: Tensor) -> QuadState:
        """The crouched stance with joint noise u * 0.2 - 0.1 (``u`` [E, 8] in
        [0, 1)), at rest."""
        c = self.constants(u.device, u.dtype)
        q = c.stance + F.pad(u * 0.2 - 0.1, (6, 0))
        return QuadState(q=q, qd=torch.zeros_like(q),
                         touch=torch.zeros_like(q[:, :len(self.model.contact_body)]),
                         t=torch.zeros(u.shape[0], dtype=torch.int32, device=u.device),
                         act=torch.zeros_like(u))

    def reset_from_uniform(self, u: Tensor) -> tp.Tuple[QuadState, TimeStep]:
        """``reset`` with its uniform draw ``u`` [E, 8] handed in."""
        state = self._base_state(u)
        return state, self._first(state)

    def _first(self, state: QuadState) -> TimeStep:
        return TimeStep(
            step_type=torch.full_like(state.t, StepType.FIRST),
            reward=torch.zeros_like(state.q[:, 0]), discount=torch.ones_like(state.q[:, 0]),
            observation=self._obs(state), action=torch.zeros_like(state.act),
            physics=self._physics(state))

    def _filter_act(self, act: Tensor, action: Tensor) -> Tensor:
        return action + (act - action) * self._act_decay

    def _timestep(self, state: QuadState, action: Tensor) -> TimeStep:
        physics = self._physics(state)
        return TimeStep(
            step_type=torch.where(state.t >= self.episode_length, StepType.LAST,
                                  StepType.MID).to(torch.int32),
            reward=self.reward_from_physics(physics).float(),
            discount=torch.ones_like(state.q[:, 0]), observation=self._obs(state),
            action=action, physics=physics)

    def step(self, state: QuadState, action: Tensor) -> tp.Tuple[QuadState, TimeStep]:
        action = action.float().clamp(-1.0, 1.0)
        act = self._filter_act(state.act, action)
        q, qd, touch = p3d.step(self.model, state.q, state.qd, act, self.control_dt,
                                self.n_substeps)
        new = QuadState(q=q, qd=qd, touch=touch, t=state.t + 1, act=act)
        return new, self._timestep(new, action)


class QuadrupedEscapeEnv(QuadrupedEnv):
    """Escape a bowl-shaped terrain."""

    def __init__(self, episode_length: int = 1000) -> None:
        super().__init__("stand", episode_length=episode_length)
        self.task = "escape"
        self.spec = self.spec.replace(obs_dim=37 + 3 + _N_RANGEFINDERS)

    def _hfield(self, terrain: Tensor) -> p3d.Heightfield:
        return p3d.Heightfield(data=terrain, half_size=_TERRAIN_HALF)

    def _obs(self, state: QuadState) -> Tensor:
        assert isinstance(state, EscapeState)
        c = self.constants(state.q.device, state.q.dtype)
        rot = p3d.euler_rot(state.q[..., 3:6])
        pos = state.q[..., 0:3]
        origin = (-pos.unsqueeze(-2) @ rot).squeeze(-2)  # the origin in the torso frame
        # the rangefinder marches each ray in fixed steps against the
        # heightfield: 1 without a hit within range, else tanh(distance)
        ray_o = pos + (rot @ c.ray_origin[:, None]).squeeze(-1)
        dirs = c.ray_dirs @ rot.mT  # [E, R, 3] in the world frame
        pts = ray_o[:, None, None, :] + c.ray_steps[:, None] * dirs[:, :, None, :]
        ground = p3d.hf_height(self._hfield(state.terrain), pts[..., :2])
        below = (pts[..., 2] <= ground).to(pts.dtype)  # argmax takes no bool on CUDA
        first = torch.argmax(below, dim=-1)
        readings = torch.where(below.amax(-1) > 0, torch.tanh(c.ray_steps[first]), 1.0)
        return torch.cat([super()._obs(state), origin, readings], -1)

    def reward_from_physics(self, physics: Tensor) -> Tensor:
        feats = quad_features(self.model, torch.as_tensor(physics))
        escaped = tolerance(torch.linalg.vector_norm(feats[..., 2:5], dim=-1),
                            (_TERRAIN_HALF, float("inf")), margin=_TERRAIN_HALF,
                            value_at_margin=0.0, sigmoid="linear")
        return _upright(feats, deviation_deg=20.0) * escaped

    def reset(self, generator: torch.Generator, num_envs: int) -> tp.Tuple[QuadState, TimeStep]:
        device = generator.device
        bumps = torch.rand((num_envs, BUMP_RES, BUMP_RES), generator=generator, device=device)
        u = torch.rand((num_envs, 8), generator=generator, device=device)
        return self.reset_from_uniform(u, bumps)

    def reset_from_uniform(self, u: Tensor, bumps_u: tp.Optional[Tensor] = None
                           ) -> tp.Tuple[QuadState, TimeStep]:
        """``reset`` with its draws handed in: the joint noise ``u`` [E, 8]
        and the terrain's bumps ``bumps_u`` [E, 30, 30], both in [0, 1). The
        robot starts on the terrain's height at the origin."""
        assert bumps_u is not None, "escape draws its terrain's bumps"
        terrain = generate_terrain(bumps_u * (1.0 - _TERRAIN_SMOOTHNESS) + _TERRAIN_SMOOTHNESS)
        base = self._base_state(u)
        z0 = p3d.hf_height(self._hfield(terrain), torch.zeros_like(u[:, None, :2]))
        q = base.q + F.pad(z0, (2, base.q.shape[-1] - 3))
        state = EscapeState(q=q, qd=base.qd, touch=base.touch, t=base.t, act=base.act,
                            terrain=terrain)
        return state, self._first(state)

    def step(self, state: QuadState, action: Tensor) -> tp.Tuple[QuadState, TimeStep]:
        assert isinstance(state, EscapeState)
        action = action.float().clamp(-1.0, 1.0)
        act = self._filter_act(state.act, action)
        q, qd, touch = p3d.step(self.model, state.q, state.qd, act, self.control_dt,
                                self.n_substeps, hfield=self._hfield(state.terrain))
        # the same terrain tensor: a caller that copies the state into held
        # tensors copies nothing for it
        new = EscapeState(q=q, qd=qd, touch=touch, t=state.t + 1, act=act,
                          terrain=state.terrain)
        return new, self._timestep(new, action)


class QuadrupedFetchEnv(QuadrupedEnv):
    """Bring a ball to the target at the origin."""

    def __init__(self, episode_length: int = 1000) -> None:
        super().__init__("stand", episode_length=episode_length)
        self.task = "fetch"
        self.spec = self.spec.replace(obs_dim=37 + 9 + 3, physics_dim=2 * self.model.ndof + 9)

    def _ball_substep(self, pos: Tensor, vel: Tensor, angvel: Tensor, robot_pts: Tensor,
                      robot_vels: Tensor, robot_r: Tensor, h: float
                      ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        k, d = 4.0e3, 20.0
        inertia = 0.4 * _BALL_MASS * _BALL_RADIUS ** 2
        # the ground: a spring-damper, and slip friction that drives the spin
        phi = _BALL_RADIUS - pos[..., 2]
        fn = torch.where(phi > 0, (k * phi - d * vel[..., 2]).clamp_min(0.0), 0.0)
        # the slip velocity at the contact point v + w x (0, 0, -R)
        contact_v = vel[..., :2] + torch.stack([-angvel[..., 1], angvel[..., 0]], -1) * _BALL_RADIUS
        ft = -0.7 * fn.unsqueeze(-1) * (contact_v / 0.1).clamp(-1.0, 1.0)
        ground = torch.cat([ft, fn.unsqueeze(-1)], -1)
        # the torque (0, 0, -R) x ground
        torque = F.pad(torch.stack([ft[..., 1], -ft[..., 0]], -1) * _BALL_RADIUS, (0, 1))
        force = ground + F.pad(torch.full_like(fn, -p3d.GRAVITY * _BALL_MASS).unsqueeze(-1),
                               (2, 0))
        # the arena's walls at +-_FLOOR_HALF
        over = (pos[..., :2].abs() - (_FLOOR_HALF - _BALL_RADIUS)).clamp_min(0.0)
        walls = -k * over * torch.sign(pos[..., :2]) - d * (over > 0) * vel[..., :2]
        force = force + F.pad(walls, (0, 1))
        # the robot's collision spheres push the ball (one-way coupling)
        delta = pos.unsqueeze(-2) - robot_pts
        dist = torch.linalg.vector_norm(delta, dim=-1) + 1e-8
        pen = (robot_r + _BALL_RADIUS - dist).clamp_min(0.0)
        n = delta / dist.unsqueeze(-1)
        rel_v = ((vel.unsqueeze(-2) - robot_vels) * n).sum(-1)
        pressed = pen > 0
        f_c = (k * pen - d * rel_v * pressed).clamp_min(0.0) * pressed
        force = force + (f_c.unsqueeze(-1) * n).sum(-2)
        vel = vel + h * force / _BALL_MASS
        angvel = angvel + h * torque / inertia
        return pos + h * vel, vel, angvel

    def goal_features(self, physics: Tensor) -> Tensor:
        """The quadruped's features (8) and the ball's position (3): the ball
        columns feed the ``quadruped_positions`` goal space."""
        physics = torch.as_tensor(physics)
        ndof = self.model.ndof
        return torch.cat([quad_features(self.model, physics),
                          physics[..., 2 * ndof:2 * ndof + 3]], -1)

    def _obs(self, state: QuadState) -> Tensor:
        assert isinstance(state, FetchState)
        rot = p3d.euler_rot(state.q[..., 3:6])
        pos = state.q[..., 0:3]
        # ball position, velocity and spin, and the target, in the torso frame
        rows = torch.stack([state.ball_pos - pos, state.ball_vel - state.qd[..., 0:3],
                            state.ball_angvel, -pos], -2)
        return torch.cat([super()._obs(state), (rows @ rot).flatten(-2)], -1)

    def _physics(self, state: QuadState) -> Tensor:
        assert isinstance(state, FetchState)
        return torch.cat([state.q, state.qd, state.ball_pos, state.ball_vel,
                          state.ball_angvel], -1)

    def reward_from_physics(self, physics: Tensor) -> Tensor:
        physics = torch.as_tensor(physics)
        ndof = self.model.ndof
        feats = quad_features(self.model, physics)
        ball = physics[..., 2 * ndof:2 * ndof + 3]
        rot = p3d.euler_rot(physics[..., 3:6])
        c = self.constants(physics.device, physics.dtype)
        workspace = physics[..., 0:3] + (rot @ c.workspace[:, None]).squeeze(-1)
        arena_radius = _FLOOR_HALF * float(np.sqrt(2.0))
        reach = tolerance(torch.linalg.vector_norm((workspace - ball)[..., :2], dim=-1),
                          (0.0, _WORKSPACE_RADIUS + _BALL_RADIUS), margin=arena_radius,
                          value_at_margin=0.0, sigmoid="linear")
        fetch = tolerance(torch.linalg.vector_norm(ball[..., :2], dim=-1), (0.0, _TARGET_RADIUS),
                          margin=arena_radius, value_at_margin=0.0, sigmoid="linear")
        return _upright(feats) * reach * (0.5 + 0.5 * fetch)

    def reset(self, generator: torch.Generator, num_envs: int) -> tp.Tuple[QuadState, TimeStep]:
        device = generator.device
        u = torch.rand((num_envs, 8), generator=generator, device=device)
        spawn = torch.rand((num_envs, 5), generator=generator, device=device)
        normal = torch.randn((num_envs, 2), generator=generator, device=device)
        return self.reset_from_uniform(u, spawn, normal)

    def reset_from_uniform(self, u: Tensor, spawn_u: tp.Optional[Tensor] = None,
                           ball_normal: tp.Optional[Tensor] = None
                           ) -> tp.Tuple[QuadState, TimeStep]:
        """``reset`` with its draws handed in: the joint noise ``u`` [E, 8];
        ``spawn_u`` [E, 5] in [0, 1) for the robot's yaw, its (x, y) and the
        ball's (x, y) in the arena's inner 90%; ``ball_normal`` [E, 2]
        standard normal for the ball's horizontal velocity (5 m/s each). The
        ball drops from 2 m."""
        assert spawn_u is not None and ball_normal is not None, "fetch draws its spawn"
        base = self._base_state(u)
        spawn = 0.9 * _FLOOR_HALF
        yaw = spawn_u[:, 0] * (2 * np.pi)
        xy = spawn_u[:, 1:3] * (2 * spawn) - spawn
        q = torch.cat([xy, base.q[:, 2:5], yaw[:, None], base.q[:, 6:]], -1)
        ball_xy = spawn_u[:, 3:5] * (2 * spawn) - spawn
        state = FetchState(q=q, qd=base.qd, touch=base.touch, t=base.t, act=base.act,
                           ball_pos=torch.cat([ball_xy, torch.full_like(yaw[:, None], 2.0)], -1),
                           ball_vel=F.pad(5.0 * ball_normal, (0, 1)),
                           ball_angvel=torch.zeros_like(base.q[:, :3]))
        return state, self._first(state)

    def step(self, state: QuadState, action: Tensor) -> tp.Tuple[QuadState, TimeStep]:
        assert isinstance(state, FetchState)
        action = action.float().clamp(-1.0, 1.0)
        act = self._filter_act(state.act, action)
        q, qd, touch = p3d.step(self.model, state.q, state.qd, act, self.control_dt,
                                self.n_substeps)
        # the ball moves against the robot's collision spheres after the step
        # (a control step of lag in the coupling)
        pts, pt_vels = p3d.contact_motion(self.model, q, qd)
        radius = self.model.tensors(q.device, q.dtype).contact_radius
        h = self.control_dt / self.n_substeps
        pos, vel, angvel = state.ball_pos, state.ball_vel, state.ball_angvel
        for _ in range(self.n_substeps):
            pos, vel, angvel = self._ball_substep(pos, vel, angvel, pts, pt_vels, radius, h)
        new = FetchState(q=q, qd=qd, touch=touch, t=state.t + 1, act=act, ball_pos=pos,
                         ball_vel=vel, ball_angvel=angvel)
        return new, self._timestep(new, action)


def make(name: str, episode_length: int = 1000) -> QuadrupedEnv:
    domain, task = name.split("_", 1)
    assert domain == "quadruped"
    if task == "escape":
        return QuadrupedEscapeEnv(episode_length=episode_length)
    if task == "fetch":
        return QuadrupedFetchEnv(episode_length=episode_length)
    return QuadrupedEnv(task, episode_length=episode_length)
