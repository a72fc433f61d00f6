"""Walker / Cheetah / Hopper: planar locomotion on ``physics2d`` (mirror of
``controllable_agent_tpu/envs/locomotion.py``).

The physics vector is [q, qd]; observations, goal features and rewards are
batched functions of it over any leading dimensions, on the tensor's device,
so relabeling a buffer is one pass where the buffer lives. ``reset`` and
``step`` advance ``[E]`` instances at once. The models' geometry, the task
set, the observation layouts and the reward shapes are the JAX package's:

  walker: orientations (cos/sin per body, 14) + torso height + qvel  -> 24
  cheetah: qpos[1:] (8) + qvel (9)                                   -> 17
  hopper: qpos[1:] (6) + qvel (7) + log1p(touch toe/heel) (2)        -> 15
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from ..ops.tolerance import tolerance
from ..utils.graphs import CapturedProgram
from . import physics2d as p2d
from .base import Environment, EnvSpec, StepType, TimeStep

Tensor = torch.Tensor


# ================================================================ models

def _build_model(parent: tp.List[int], anchor: tp.List[tp.Tuple[float, float]],
                 com: tp.List[tp.Tuple[float, float]],
                 mass: tp.List[float], inertia: tp.List[float],
                 contacts: tp.List[tp.Tuple[int, tp.Tuple[float, float], float]],
                 gear: tp.List[float], damping: tp.List[float],
                 limits: tp.List[tp.Tuple[float, float]],
                 armature: tp.List[float], **kwargs: tp.Any) -> p2d.PlanarModel:
    def f32(values: tp.Any) -> np.ndarray:
        return np.asarray(values, np.float32)

    return p2d.PlanarModel(
        parent=tuple(parent), anchor=f32(anchor), com=f32(com), mass=f32(mass),
        inertia=f32(inertia),
        contact_body=tuple(c[0] for c in contacts),
        contact_point=f32([c[1] for c in contacts]),
        contact_radius=f32([c[2] for c in contacts]),
        gear=f32(gear), damping=f32(damping),
        limit_lo=f32([lim[0] for lim in limits]),
        limit_hi=f32([lim[1] for lim in limits]),
        armature=f32(armature), **kwargs)


def _deg(lo: float, hi: float) -> tp.Tuple[float, float]:
    return (float(np.deg2rad(lo)), float(np.deg2rad(hi)))


def walker_model() -> p2d.PlanarModel:
    """7 bodies: torso, R thigh/leg/foot, L thigh/leg/foot. 9 dof."""
    r_t, l_t = 0.07, 0.6  # torso radius / length (vertical capsule)
    r_th, l_th = 0.05, 0.45
    r_lg, l_lg = 0.04, 0.5
    r_ft, l_ft = 0.05, 0.2  # foot points forward
    m = [p2d.capsule_mass(r_t, l_t), ]
    inertia = [p2d.capsule_inertia(r_t, l_t)]
    for (r, length) in [(r_th, l_th), (r_lg, l_lg), (r_ft, l_ft)] * 2:
        m.append(p2d.capsule_mass(r, length))
        inertia.append(p2d.capsule_inertia(r, length))
    hip = (0.0, -l_t / 2)
    # foot COM sits 0.06 ahead of the ankle (dm_control walker.xml: foot
    # body pos x=.06 with the ankle at x=-.06 in the foot frame), so the
    # capsule spans x in [-0.04, 0.16] relative to the ankle
    ft_com = 0.06
    return _build_model(
        parent=[-1, 0, 1, 2, 0, 4, 5],
        anchor=[(0, 0), hip, (0.0, -l_th), (0.0, -l_lg),
                hip, (0.0, -l_th), (0.0, -l_lg)],
        com=[(0, 0), (0, -l_th / 2), (0, -l_lg / 2), (ft_com, 0)] +
            [(0, -l_th / 2), (0, -l_lg / 2), (ft_com, 0)],
        mass=m, inertia=inertia,
        contacts=[(0, (0.0, l_t / 2), r_t), (0, (0.0, -l_t / 2), r_t),
                  (3, (ft_com - l_ft / 2, 0.0), r_ft),
                  (3, (ft_com + l_ft / 2, 0.0), r_ft),
                  (6, (ft_com - l_ft / 2, 0.0), r_ft),
                  (6, (ft_com + l_ft / 2, 0.0), r_ft)],
        gear=[100, 50, 20, 100, 50, 20],
        damping=[0.1] * 6,
        limits=[_deg(-20, 100), _deg(-150, 0), _deg(-45, 45)] * 2,
        armature=[0.01] * 6,
    )


WALKER_INIT_Z = 1.3  # torso-center height with straight legs
WALKER_STAND_HEIGHT = 1.2


def cheetah_model() -> p2d.PlanarModel:
    """7 bodies: torso (horizontal), back thigh/shin/foot, front
    thigh/shin/foot. 9 dof. The zero pose is the bent stance encoded by the
    MJCF body offsets, and each joint is spring-loaded toward it."""
    r = 0.046
    # per-leg geoms: (com in body frame, capsule axis angle about y in
    # deg, capsule half-length) straight from the MJCF
    leg_geoms = [((0.1, -0.13), -218.0, 0.145),    # bthigh
                 ((-0.14, -0.07), -116.0, 0.15),   # bshin
                 ((0.03, -0.097), -15.0, 0.094),   # bfoot
                 ((-0.07, -0.12), 30.0, 0.133),    # fthigh
                 ((0.065, -0.09), -34.0, 0.106),   # fshin
                 ((0.045, -0.07), -34.0, 0.07)]    # ffoot
    # torso = main capsule (l=1) + head capsule folded in (parallel axis)
    m_t = p2d.capsule_mass(r, 1.0)
    m_h = p2d.capsule_mass(r, 0.3)
    head_com = np.asarray([0.6, 0.1])
    com0 = (m_h * head_com) / (m_t + m_h)
    i0 = (p2d.capsule_inertia(r, 1.0) + m_t * float((com0 ** 2).sum())
          + p2d.capsule_inertia(r, 0.3)
          + m_h * float(((head_com - com0) ** 2).sum()))
    mass = [m_t + m_h]
    inertia = [i0]
    com = [tuple(com0)]
    for (c, _, hl) in leg_geoms:
        mass.append(p2d.capsule_mass(r, 2 * hl))
        inertia.append(p2d.capsule_inertia(r, 2 * hl))
        com.append(c)
    scale = 14.0 / sum(mass)  # MJCF compiler settotalmass="14"
    mass = [m * scale for m in mass]
    inertia = [i * scale for i in inertia]

    def ends(gi: int) -> tp.List[tp.Tuple[float, float]]:
        (cx, cz), a, hl = leg_geoms[gi]
        d = np.asarray([np.sin(np.deg2rad(a)), np.cos(np.deg2rad(a))])
        return [(cx + hl * d[0], cz + hl * d[1]),
                (cx - hl * d[0], cz - hl * d[1])]

    bshin_lo = min(ends(1), key=lambda e: e[1])
    fshin_lo = min(ends(4), key=lambda e: e[1])
    head_tip = (0.6 + 0.15 * np.sin(np.deg2rad(50)),
                0.1 + 0.15 * np.cos(np.deg2rad(50)))
    contacts = ([(0, (-0.5, 0.0), r), (0, (0.5, 0.0), r),
                 (0, head_tip, r), (2, bshin_lo, r), (5, fshin_lo, r)]
                + [(3, e, r) for e in ends(2)]
                + [(6, e, r) for e in ends(5)])
    return _build_model(
        parent=[-1, 0, 1, 2, 0, 4, 5],
        anchor=[(0, 0), (-0.5, 0), (0.16, -0.25), (-0.28, -0.14),
                (0.5, 0), (-0.14, -0.24), (0.13, -0.18)],
        com=com, mass=mass, inertia=inertia,
        contacts=contacts,
        gear=[120, 90, 60, 90, 60, 30],
        damping=[6.0, 4.5, 3.0, 4.5, 3.0, 1.5],
        # MJCF ranges are about the +y hinge axis; this engine's positive
        # hinge rotation is the opposite physical direction (CCW x->z), so
        # each range maps to (-hi, -lo)
        limits=[_deg(-60, 30), _deg(-50, 50), _deg(-50, 230),
                _deg(-0.4, 57), _deg(-50, 70), _deg(-28, 28)],
        armature=[0.1] * 6,
        stiffness=np.asarray([240.0, 180.0, 120.0, 180.0, 120.0, 60.0], np.float32),
        friction=0.4,
    )


CHEETAH_INIT_Z = 0.7


def hopper_model() -> p2d.PlanarModel:
    """5 bodies: torso(root), pelvis, thigh, calf, foot. 7 dof."""
    # (radius, length, com in body frame)
    geoms = [(0.0653, 0.25, (0.0, 0.075)),    # torso
             (0.065, 0.15, (0.0, -0.075)),    # pelvis
             (0.04, 0.33, (0.0, -0.165)),     # thigh
             (0.03, 0.32, (0.0, -0.16)),      # calf
             (0.04, 0.25, (0.045, 0.0))]      # foot (forward)
    m = []
    inertia = []
    for (r, length, _) in geoms:
        m.append(p2d.capsule_mass(r, length))
        inertia.append(p2d.capsule_inertia(r, length))
    # torso also carries the nose geom: the real model's torso mass / COM /
    # inertia (dm_control hopper body_mass[torso]=4.828,
    # body_ipos=(0.0075, 0.0789), body_inertia_y=0.0497)
    m[0], inertia[0] = 4.828, 0.0497
    com = [g[2] for g in geoms]
    com[0] = (0.0075, 0.0789)
    return _build_model(
        parent=[-1, 0, 1, 2, 3],
        anchor=[(0, 0), (0.0, -0.05), (0.0, -0.2), (0.0, -0.33),
                (0.0, -0.32)],
        com=com,
        mass=m, inertia=inertia,
        # toe and heel contacts (touch sensors), plus torso top for falls
        contacts=[(0, (0.0, 0.2), geoms[0][0]),
                  (4, (0.17, 0.0), 0.04),    # toe
                  (4, (-0.08, 0.0), 0.04)],  # heel
        gear=[30, 40, 30, 10],
        damping=[0.05] * 4,
        # (-hi, -lo) of the MJCF ranges, as for the cheetah
        limits=[_deg(-30, 30), _deg(-10, 170), _deg(-150, -5), _deg(-45, 45)],
        armature=[0.2] * 4,
    )


HOPPER_INIT_Z = 1.0  # root (torso-origin) height
HOPPER_STAND_HEIGHT = 0.6

_MODELS: tp.Dict[str, tp.Callable[[], p2d.PlanarModel]] = {
    "walker": walker_model, "cheetah": cheetah_model, "hopper": hopper_model}
_INIT_Z = {"walker": WALKER_INIT_Z, "cheetah": CHEETAH_INIT_Z,
           "hopper": HOPPER_INIT_Z}
_CONTROL = {"walker": (0.025, 10), "cheetah": (0.01, 4), "hopper": (0.02, 8)}

_SPIN_SPEED = 5.0
_SPEEDS = {
    ("walker", "stand"): 0.0, ("walker", "walk"): 1.0, ("walker", "run"): 8.0,
    ("cheetah", "walk"): 2.0, ("cheetah", "run"): 10.0,
    ("cheetah", "walk_backward"): 2.0, ("cheetah", "run_backward"): 10.0,
    ("hopper", "stand"): 0.0, ("hopper", "hop"): 2.0,
    ("hopper", "hop_backward"): 2.0,
}

TASKS = {
    "walker": ["stand", "walk", "run", "flip"],
    "cheetah": ["walk", "run", "walk_backward", "run_backward", "flip",
                "flip_backward"],
    "hopper": ["stand", "hop", "hop_backward", "flip", "flip_backward"],
}


# ==================================================== physics observables

def _split_qqd(model: p2d.PlanarModel, physics: Tensor) -> tp.Tuple[Tensor, Tensor]:
    ndof = model.ndof
    return physics[..., :ndof], physics[..., ndof:2 * ndof]


def walker_features(model: p2d.PlanarModel, physics: Tensor) -> Tensor:
    """[x, z, up, vx, vz, am]: the goal-feature layout consumed by
    goals/spaces.py (the JAX ``walker_features_single``, batched over
    leading dimensions)."""
    q, qd = _split_qqd(model, physics)
    v_com, l_y, _ = p2d.subtree_momentum(model, q, qd)
    return torch.stack([q[..., 0], q[..., 1], torch.cos(q[..., 2]),
                        v_com[..., 0], v_com[..., 1], l_y], -1)


@dataclasses.dataclass(frozen=True)
class LocoState:
    q: Tensor  # [E, ndof]
    qd: Tensor  # [E, ndof]
    touch: Tensor  # [E, nc] largest normal force of each contact over the last step
    t: Tensor  # [E] int32


class LocomotionEnv(Environment):
    """Planar locomotion environment over ``physics2d``."""

    def __init__(self, domain: str, task: str, episode_length: int = 1000) -> None:
        if task not in TASKS[domain]:
            raise ValueError(f"Unknown {domain} task {task!r}")
        self.domain = domain
        self.task = task
        self.model = _MODELS[domain]()
        self.init_z = _INIT_Z[domain]
        self.control_dt, self.n_substeps = _CONTROL[domain]
        self.episode_length = episode_length
        ndof = self.model.ndof
        obs_dim = {"walker": 2 * self.model.nb + 1 + ndof,
                   "cheetah": (ndof - 1) + ndof,
                   "hopper": (ndof - 1) + ndof + 2}[domain]
        self.spec = EnvSpec(obs_dim=obs_dim, action_dim=ndof - 3,
                            physics_dim=2 * ndof, goal_dim=0,
                            episode_length=episode_length)
        # captured settling steps by (device, dtype, shape): see ``settle``
        self._settlers: tp.Dict[tp.Tuple, tp.Tuple[tp.Any, Tensor, Tensor]] = {}

    # -- observables -----------------------------------------------------
    def _obs(self, q: Tensor, qd: Tensor, touch: tp.Optional[Tensor]) -> Tensor:
        if self.domain == "walker":
            angles = q[..., 2:] @ self.model.tensors(q.device, q.dtype).body_frames.T
            orient = torch.stack([torch.cos(angles), torch.sin(angles)], -1)
            return torch.cat([orient.flatten(-2), q[..., 1:2], qd], -1)
        if self.domain == "cheetah":
            return torch.cat([q[..., 1:], qd], -1)
        # hopper: qpos[1:] + qvel + log1p(touch toe/heel)
        sensed = (torch.zeros_like(q[..., :2]) if touch is None
                  else torch.log1p(touch[..., 1:3]))
        return torch.cat([q[..., 1:], qd, sensed], -1)

    def obs_from_physics(self, physics: Tensor) -> Tensor:
        """Observation as a function of [q, qd], batched over leading dims.
        Used to recompute the observation column of foreign-engine episodes
        (data/exorl.py physics adapters), whose stored observations follow
        MuJoCo's hinge sign convention. Hopper's touch sensors are not part
        of [q, qd]; they read 0."""
        q, qd = _split_qqd(self.model, torch.as_tensor(physics))
        return self._obs(q, qd, None)

    def goal_features(self, physics: Tensor) -> Tensor:
        """Domain goal-feature extraction, batched over leading dims."""
        return walker_features(self.model, torch.as_tensor(physics))

    def reward_from_physics(self, physics: Tensor) -> Tensor:
        """Task reward as a function of [q, qd], batched over leading dims."""
        physics = torch.as_tensor(physics)
        feats = walker_features(self.model, physics)
        z, up, vx, am = feats[..., 1], feats[..., 2], feats[..., 3], feats[..., 5]
        q, _ = _split_qqd(self.model, physics)
        domain, task = self.domain, self.task
        forward = -1.0 if task.endswith("backward") else 1.0
        base = task.replace("_backward", "")
        inf = float("inf")
        if domain == "walker":
            standing = tolerance(z, (WALKER_STAND_HEIGHT, inf),
                                 margin=WALKER_STAND_HEIGHT / 2)
            upright = (1 + up) / 2
            stand_reward = (3 * standing + upright) / 4
            if base == "flip":
                move = tolerance(forward * am, (_SPIN_SPEED, inf),
                                 margin=_SPIN_SPEED, value_at_margin=0,
                                 sigmoid="linear")
            else:
                speed = _SPEEDS[(domain, base)]
                if speed == 0:
                    return stand_reward
                move = tolerance(forward * vx, (speed, inf),
                                 margin=speed / 2, value_at_margin=0.5,
                                 sigmoid="linear")
            return stand_reward * (5 * move + 1) / 6
        if domain == "cheetah":
            if base == "flip":
                return tolerance(forward * am, (_SPIN_SPEED, inf),
                                 margin=_SPIN_SPEED, value_at_margin=0,
                                 sigmoid="linear")
            speed = _SPEEDS[(domain, base)]
            return tolerance(forward * vx, (speed, inf),
                             margin=speed, value_at_margin=0,
                             sigmoid="linear")
        # hopper: height of torso COM over foot COM
        coms, _ = p2d.com_world(self.model, q)
        height = coms[..., 0, 1] - coms[..., -1, 1]
        standing = tolerance(height, (HOPPER_STAND_HEIGHT, 2.0))
        if base == "stand":
            return standing
        if base == "flip":
            hopping = tolerance(forward * am, (_SPIN_SPEED, inf),
                                margin=_SPIN_SPEED, value_at_margin=0,
                                sigmoid="linear")
        else:
            speed = _SPEEDS[(domain, "hop")]
            hopping = tolerance(forward * vx, (speed, inf),
                                margin=speed / 2, value_at_margin=0.5,
                                sigmoid="linear")
        return standing * hopping

    # -- API -------------------------------------------------------------
    def reset(self, generator: torch.Generator, num_envs: int) -> tp.Tuple[LocoState, TimeStep]:
        nj = self.model.ndof - 3
        return self.reset_from_uniform(
            torch.rand((num_envs, nj), generator=generator, device=generator.device))

    def reset_from_uniform(self, u: Tensor) -> tp.Tuple[LocoState, TimeStep]:
        """``reset`` with its uniform draw ``u`` [E, nj] handed in: the joints
        at ``u`` of the way through their limits, the root at ``init_z``, at
        rest."""
        c = self.model.tensors(u.device, u.dtype)
        qj = c.limit_lo + u * (c.limit_hi - c.limit_lo)
        root = torch.tensor([0.0, self.init_z, 0.0], dtype=u.dtype, device=u.device)
        q = torch.cat([root.expand(u.shape[0], 3), qj], -1)
        qd = torch.zeros_like(q)
        if self.domain == "cheetah":
            q, qd = self.settle(q, qd)
        state = LocoState(q=q, qd=qd, touch=torch.zeros_like(c.contact_radius.expand(u.shape[0], -1)),
                          t=torch.zeros(u.shape[0], dtype=torch.int32, device=u.device))
        physics = torch.cat([q, qd], -1)
        ts = TimeStep(
            step_type=torch.full_like(state.t, StepType.FIRST),
            reward=torch.zeros_like(q[:, 0]), discount=torch.ones_like(q[:, 0]),
            observation=self._obs(q, qd, state.touch), action=torch.zeros_like(qj),
            physics=physics)
        return state, ts

    def settle(self, q: Tensor, qd: Tensor, capture: tp.Optional[bool] = None
               ) -> tp.Tuple[Tensor, Tensor]:
        """2 s of simulated time at rest (zero action), the cheetah's start
        before an episode. ``capture`` (default: whether ``q`` is on a CUDA
        device) runs it as replays of one captured control step, kept per
        batch shape, instead of as launches from the host: the same kernels
        in the same order, so the same states to the bit."""
        steps = int(round(2.0 / self.control_dt))
        capture = q.device.type == "cuda" if capture is None else capture
        if not capture:
            rest = torch.zeros_like(q[:, 3:])
            for _ in range(steps):
                q, qd, _ = p2d.step(self.model, q, qd, rest, self.control_dt, self.n_substeps)
            return q, qd
        key = (q.device, q.dtype, tuple(q.shape))
        if key not in self._settlers:
            held_q, held_qd, rest = q.clone(), qd.clone(), torch.zeros_like(q[:, 3:])

            def one_step() -> None:
                new_q, new_qd, _ = p2d.step(self.model, held_q, held_qd, rest,
                                            self.control_dt, self.n_substeps)
                held_q.copy_(new_q)
                held_qd.copy_(new_qd)

            self._settlers[key] = (CapturedProgram(one_step, q.device, [held_q, held_qd],
                                                   name="settle"), held_q, held_qd)
        program, held_q, held_qd = self._settlers[key]
        held_q.copy_(q)
        held_qd.copy_(qd)
        program.replay(steps)
        return held_q.clone(), held_qd.clone()

    def step(self, state: LocoState, action: Tensor) -> tp.Tuple[LocoState, TimeStep]:
        action = action.float().clamp(-1.0, 1.0)
        q, qd, touch = p2d.step(self.model, state.q, state.qd, action,
                                self.control_dt, self.n_substeps)
        t = state.t + 1
        physics = torch.cat([q, qd], -1)
        ts = TimeStep(
            step_type=torch.where(t >= self.episode_length, StepType.LAST,
                                  StepType.MID).to(torch.int32),
            reward=self.reward_from_physics(physics).float(),
            discount=torch.ones_like(q[:, 0]),
            observation=self._obs(q, qd, touch), action=action, physics=physics)
        return LocoState(q=q, qd=qd, touch=touch, t=t), ts


def make(name: str, episode_length: int = 1000) -> LocomotionEnv:
    """'walker_walk' -> LocomotionEnv('walker', 'walk')."""
    domain, task = name.split("_", 1)
    return LocomotionEnv(domain, task, episode_length=episode_length)
