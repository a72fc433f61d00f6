"""Planar articulated rigid-body physics, a frozen copy of the port's plain
dynamics (``controllable_agent_torch/envs/physics2d.py`` as of the
benchmark's first version), kept here so that the reference imports
nothing of the program. Batched over leading dimensions; the derivatives
are written by hand (see the port's module for the derivation).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

GRAVITY = 9.81


@dataclasses.dataclass(frozen=True)
class PlanarModel:
    """Static model description, held on the host.

    nb bodies; body 0 is the root (free planar joint: q[0]=x, q[1]=z,
    q[2]=pitch). Every body b >= 1 adds one hinge dof q[2+b] at its origin.
    ndof = nb + 2.
    """

    parent: tp.Tuple[int, ...]  # parent[0] = -1
    anchor: np.ndarray  # [nb, 2] joint position in the parent's frame
    com: np.ndarray  # [nb, 2] center of mass in the body frame
    mass: np.ndarray  # [nb]
    inertia: np.ndarray  # [nb] rotational inertia about the COM (y-axis)
    # contact spheres: world-collision points
    contact_body: tp.Tuple[int, ...]
    contact_point: np.ndarray  # [nc, 2] in body frame
    contact_radius: np.ndarray  # [nc]
    # per-hinge-joint (bodies 1..nb-1) parameters
    gear: np.ndarray  # [nj] actuator gear (torque = gear * ctrl)
    damping: np.ndarray  # [nj]
    limit_lo: np.ndarray  # [nj] radians
    limit_hi: np.ndarray  # [nj]
    armature: np.ndarray  # [nj]
    stiffness: tp.Optional[np.ndarray] = None  # [nj] spring toward the zero pose
    # contact material
    contact_stiffness: float = 3.0e4
    contact_damping: float = 300.0
    friction: float = 1.0
    # solver
    limit_stiffness: float = 300.0
    limit_damping: float = 10.0
    _tensors: tp.Dict[tp.Tuple[torch.device, torch.dtype], "ModelTensors"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def ndof(self) -> int:
        return self.nb + 2

    def tensors(self, device: torch.device, dtype: torch.dtype) -> "ModelTensors":
        """The model's constants on ``device``, built once for each device
        and dtype."""
        key = (torch.device(device), dtype)
        if key not in self._tensors:
            self._tensors[key] = ModelTensors.build(self, *key)
        return self._tensors[key]


# -------------------------------------------------------------- constants

@dataclasses.dataclass(frozen=True)
class ModelTensors:
    """A model's constants as tensors on one device, laid out for the
    kinematics and the dynamics.

    The tree is flattened into ``no = 2 nb + nc`` rotating offsets (each
    body's anchor in its parent's frame, each body's COM and each contact
    point in their body's frame) and ``nr = 2 nb + nc`` points relative to
    the root (the body origins, the COMs, the contact points). The
    Jacobians are taken at the ``np = nb + nc`` COMs and contact points.
    """

    frames: Tensor  # [no, nb] 1 where rotation dof j (pitch, hinges) turns the offset's frame
    offsets: Tensor  # [no, 4] (ox, oz, -oz, ox): the offset and its perp at angle 0
    offsets_quarter: Tensor  # [no, 4] the same a quarter turn on: (-oz, ox, -ox, -oz)
    place: Tensor  # [nr, no] 1 where the offset lies on the chain from the root to the point
    chain: Tensor  # [nb, np, 1] 1 where body j is the point's body or an ancestor of it
    root_jacobian: Tensor  # [2, 2 np] d(point)/d(x, z)
    mass: Tensor  # [nb]
    inertia: Tensor  # [nb]
    mass_share: Tensor  # [nb] each body's share of the total mass
    mass2: Tensor  # [2 nb] each body's mass, for both coordinates of its COM
    weight2: Tensor  # [2 nb] gravity on each COM coordinate: (0, -g m_b)
    constant_inertia: Tensor  # [ndof, ndof] sum_b I_b w_b w_b^T + diag(armature)
    solve_shift: Tensor  # [ndof, ndof] 1e-9 I, added to M before the solve
    contact_radius: Tensor  # [nc]
    gear: Tensor  # [nj]
    damping: Tensor
    limit_lo: Tensor
    limit_hi: Tensor
    stiffness: tp.Optional[Tensor]

    @property
    def body_frames(self) -> Tensor:
        """[nb, nb]: body angles = q[..., 2:] @ body_frames.T (each COM
        offset turns with its own body)."""
        nb = self.frames.shape[1]
        return self.frames[nb:2 * nb]

    @classmethod
    def build(cls, model: PlanarModel, device: torch.device,
              dtype: torch.dtype) -> "ModelTensors":
        nb, nc, ndof = model.nb, len(model.contact_body), model.ndof
        chain = np.zeros((nb, nb))  # chain[b, j]: j is b or an ancestor of b
        for b in range(nb):
            chain[b, b] = 1.0
            if b > 0:
                chain[b] += chain[model.parent[b]]
        point_body = list(range(nb)) + list(model.contact_body)
        frame_body = [model.parent[b] for b in range(nb)] + point_body
        offsets = np.concatenate([np.asarray(model.anchor, np.float64),
                                  np.asarray(model.com, np.float64),
                                  np.asarray(model.contact_point, np.float64).reshape(nc, 2)])
        offsets[0] = 0.0  # the root has no anchor
        frames = np.stack([chain[b] if b >= 0 else np.zeros(nb) for b in frame_body])
        ox, oz = offsets[:, 0], offsets[:, 1]
        place = np.zeros((2 * nb + nc, 2 * nb + nc))
        for row, b in enumerate(list(range(nb)) + point_body):
            place[row, :nb] = chain[b]
            if row >= nb:
                place[row, row] = 1.0  # the point's own offset on its body
        inertia = np.zeros((ndof, ndof))
        inertia[2:, 2:] = np.einsum("b,bj,bk->jk", np.asarray(model.inertia, np.float64),
                                    chain, chain)
        inertia[3:, 3:] += np.diag(np.asarray(model.armature, np.float64))
        mass2 = np.repeat(np.asarray(model.mass, np.float64), 2)

        def on(x: tp.Any) -> Tensor:
            return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

        return cls(
            frames=on(frames), offsets=on(np.stack([ox, oz, -oz, ox], -1)),
            offsets_quarter=on(np.stack([-oz, ox, -ox, -oz], -1)), place=on(place),
            chain=on(chain[point_body].T[:, :, None]),
            root_jacobian=on(np.tile(np.eye(2), (1, nb + nc))),
            mass=on(model.mass), inertia=on(model.inertia),
            mass_share=on(mass2[::2] / mass2[::2].sum()), mass2=on(mass2),
            weight2=on(mass2 * np.tile([0.0, -GRAVITY], nb)),
            constant_inertia=on(inertia), solve_shift=on(1e-9 * np.eye(ndof)),
            contact_radius=on(model.contact_radius), gear=on(model.gear),
            damping=on(model.damping), limit_lo=on(model.limit_lo),
            limit_hi=on(model.limit_hi),
            stiffness=None if model.stiffness is None else on(model.stiffness))


class _Pose(tp.NamedTuple):
    """A pose's offsets and points, all relative to the root position."""

    rotated: Tensor  # [..., no, 4] every offset in the world frame, and its perp
    points: Tensor  # [..., nr, 4] origins, COMs and contact points, and their perps


def _pose(c: ModelTensors, q: Tensor) -> _Pose:
    angles = q[..., 2:] @ c.frames.T  # [..., no] the angle of each offset's frame
    rotated = torch.addcmul(torch.cos(angles).unsqueeze(-1) * c.offsets,
                            torch.sin(angles).unsqueeze(-1), c.offsets_quarter)
    return _Pose(rotated, c.place @ rotated)


def _constants_and_pose(model: PlanarModel, q: Tensor) -> tp.Tuple[ModelTensors, _Pose]:
    c = model.tensors(q.device, q.dtype)
    return c, _pose(c, q)


# -------------------------------------------------------------- kinematics

def _com_velocities(c: ModelTensors, pose: _Pose, qd: Tensor) -> tp.Tuple[Tensor, Tensor]:
    nb = c.frames.shape[1]
    rates = qd[..., 2:] @ c.frames.T  # [..., no] the rate of each offset's frame
    # an offset turning at its frame's rate moves its tip at rate x perp(offset)
    swept = rates.unsqueeze(-1) * pose.rotated[..., 2:]
    return (c.place[nb:2 * nb] @ swept + qd[..., None, :2], qd[..., 2:] @ c.body_frames.T)


def subtree_momentum(model: PlanarModel, q: Tensor, qd: Tensor
                     ) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """(linear COM velocity [..., 2], angular momentum about the total COM
    [...], total COM position [..., 2]): the planar analogues of MuJoCo's
    subtree_linvel / subtree_angmom used by the goal spaces."""
    c, pose = _constants_and_pose(model, q)
    coms = pose.points[..., model.nb:2 * model.nb, :2] + q[..., None, :2]
    v, w = _com_velocities(c, pose, qd)
    com = c.mass_share @ coms
    v_com = c.mass_share @ v
    rel = coms - com[..., None, :]
    relv = v - v_com[..., None, :]
    # angular momentum about MuJoCo's y-axis (x forward, z up, y left):
    # (r x v)_y = z_rel*vx - x_rel*vz; the planar angle is counterclockwise
    # in the x-z plane, i.e. w_y = -theta_dot, hence the -I*w spin term
    l_y = (-c.inertia * w + c.mass * (rel[..., 1] * relv[..., 0]
                                      - rel[..., 0] * relv[..., 1])).sum(-1)
    return v_com, l_y, com


# --------------------------------------------------------------- dynamics

class _Kinematics(tp.NamedTuple):
    """What the dynamics need of a pose."""

    rotated: Tensor  # as in _Pose
    points: Tensor
    jacobian_t: Tensor  # [..., ndof, 2 np] transposed Jacobians of the COMs and contact points


def _kinematics(c: ModelTensors, q: Tensor) -> _Kinematics:
    nb = c.frames.shape[1]
    rotated, points = _pose(c, q)
    # d(point i)/d(rotation dof j) = perp(point i - origin j) along i's chain
    perp = points[..., 2:]
    turn = (perp[..., None, nb:, :] - perp[..., :nb, None, :]) * c.chain
    root = c.root_jacobian.expand(*q.shape[:-1], *c.root_jacobian.shape)
    return _Kinematics(rotated, points, torch.cat([root, turn.flatten(-2)], -2))


def _com_jacobian_t(c: ModelTensors, kin: _Kinematics) -> Tensor:
    return kin.jacobian_t[..., :c.mass2.shape[0]]


def _mass_matrix(c: ModelTensors, kin: _Kinematics) -> Tensor:
    jac_t = _com_jacobian_t(c, kin)
    return (jac_t * c.mass2) @ jac_t.mT + c.constant_inertia


def _com_wrench(c: ModelTensors, kin: _Kinematics, forces: Tensor) -> Tensor:
    """Generalized force of ``forces`` [..., 2 nb] applied at the COMs."""
    return (_com_jacobian_t(c, kin) @ forces.unsqueeze(-1)).squeeze(-1)


def _com_inertial_forces(c: ModelTensors, kin: _Kinematics, qd: Tensor) -> Tensor:
    """m_b a_b [..., 2 nb], with a_b the acceleration of body b's COM at
    zero joint acceleration: every offset on its chain turns at its frame's
    constant rate, which pulls the COM towards the offset's base."""
    nb = c.frames.shape[1]
    rates = qd[..., 2:] @ c.frames.T
    centripetal = -(rates * rates).unsqueeze(-1) * kin.rotated[..., :2]
    return (c.place[nb:2 * nb] @ centripetal).flatten(-2) * c.mass2


def _contact_forces(model: PlanarModel, c: ModelTensors, kin: _Kinematics,
                    q: Tensor, qd: Tensor) -> tp.Tuple[Tensor, Tensor]:
    first = c.mass2.shape[0]  # COM columns come first
    jac_t = kin.jacobian_t[..., first:]
    vel = (qd.unsqueeze(-2) @ jac_t).squeeze(-2).unflatten(-1, (-1, 2))
    phi = c.contact_radius - (kin.points[..., first:, 1] + q[..., 1:2])
    fn = torch.where(phi > 0, (model.contact_stiffness * phi
                               - model.contact_damping * vel[..., 1]).clamp_min(0.0), 0.0)
    v_slip = 0.1
    ft = -model.friction * fn * (vel[..., 0] / v_slip).clamp(-1.0, 1.0)
    forces = torch.stack([ft, fn], -1).flatten(-2)
    return (jac_t @ forces.unsqueeze(-1)).squeeze(-1), fn


def _joint_torques(model: PlanarModel, c: ModelTensors, q: Tensor, qd: Tensor,
                   action: Tensor) -> Tensor:
    qj, qdj = q[..., 3:], qd[..., 3:]
    tau = c.gear * action - c.damping * qdj
    if c.stiffness is not None:
        tau = tau - c.stiffness * qj
    # soft limits: a spring on the excursion beyond [lo, hi], a damper while beyond
    excess = qj - torch.clamp(qj, c.limit_lo, c.limit_hi)
    return tau - model.limit_stiffness * excess - model.limit_damping * qdj * (excess != 0)


def _constants_and_kinematics(model: PlanarModel, q: Tensor
                              ) -> tp.Tuple[ModelTensors, _Kinematics]:
    c = model.tensors(q.device, q.dtype)
    return c, _kinematics(c, q)


def forward_dynamics(model: PlanarModel, q: Tensor, qd: Tensor, action: Tensor
                     ) -> tp.Tuple[Tensor, Tensor]:
    """qdd = M^-1 (tau + J_c^T f_contact - h - dV/dq); also returns the
    contact normal forces (for touch sensing)."""
    c, kin = _constants_and_kinematics(model, q)
    qf_contact, fn = _contact_forces(model, c, kin, q, qd)
    rhs = (F.pad(_joint_torques(model, c, q, qd, action), (3, 0)) + qf_contact
           + _com_wrench(c, kin, c.weight2 - _com_inertial_forces(c, kin, qd)))
    # no error check: it would wait for the device, and M is positive definite
    qdd = torch.linalg.solve_ex(_mass_matrix(c, kin) + c.solve_shift, rhs)[0]
    return qdd, fn


def step(model: PlanarModel, q: Tensor, qd: Tensor, action: Tensor, dt: float,
         n_substeps: int) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Semi-implicit Euler with substeps. Returns (q, qd, touch) where touch
    is the max per-contact normal force over the substeps."""
    h = dt / n_substeps
    touch = torch.zeros((), dtype=q.dtype, device=q.device)
    for _ in range(n_substeps):
        qdd, fn = forward_dynamics(model, q, qd, action)
        # clamp runaway velocities (keeps the explicit integrator sane under
        # deep penetration)
        qd = torch.add(qd, qdd, alpha=h).clamp(-100.0, 100.0)
        q = torch.add(q, qd, alpha=h)
        touch = torch.maximum(touch, fn)
    return q, qd, touch


# ---------------------------------------------------------------- helpers

def capsule_mass(radius: float, length: float, density: float = 1000.0) -> float:
    """Mass of a capsule (cylinder + sphere caps)."""
    cyl = np.pi * radius ** 2 * length
    caps = 4.0 / 3.0 * np.pi * radius ** 3
    return float(density * (cyl + caps))


def capsule_inertia(radius: float, length: float, density: float = 1000.0) -> float:
    """Exact capsule inertia about its COM, perpendicular axis: cylinder +
    two hemispherical caps with parallel-axis terms (MuJoCo's capsule
    inertia)."""
    r, L = radius, length
    m_cyl = density * np.pi * r ** 2 * L
    m_hemi = density * (2.0 / 3.0) * np.pi * r ** 3  # each cap
    i_cyl = m_cyl * (L ** 2 / 12.0 + r ** 2 / 4.0)
    # hemisphere about its own COM (83/320 m r^2), COM at 3r/8 above the
    # flat face which sits at +-L/2
    i_hemi_com = (83.0 / 320.0) * m_hemi * r ** 2
    d = L / 2.0 + 3.0 * r / 8.0
    return float(i_cyl + 2.0 * (i_hemi_com + m_hemi * d ** 2))
