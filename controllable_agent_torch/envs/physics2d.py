"""Planar articulated rigid-body kinematics (mirror of the kinematic half of
``controllable_agent_tpu/envs/physics2d.py``).

Models are kinematic trees of capsule links with hinge joints in the x-z
plane; the root has a free planar joint (x, z, pitch). Every function here
is batched: ``q`` and ``qd`` are ``[..., ndof]`` tensors on any device, and
the loop over the (static, small) body count is unrolled in Python with the
model's constants as Python floats, so the model needs no device.

``subtree_momentum`` needs each body's COM velocity. The JAX package takes
the Jacobian of ``com_world`` with ``jax.jacfwd``; here the velocities come
from the same recursion as the positions, differentiated by hand (a hinge
adds its rate to the angular velocity, an offset rotates with its parent).

The dynamics (``mass_matrix`` ... ``step``) are not ported yet (ROADMAP
Queue A item 9).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

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

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def ndof(self) -> int:
        return self.nb + 2


def _rotate(angle: Tensor, point: tp.Sequence[float]) -> Tensor:
    """R(angle) @ point for a constant 2-vector: [..., 2]."""
    c, s = torch.cos(angle), torch.sin(angle)
    px, pz = float(point[0]), float(point[1])
    return torch.stack([c * px - s * pz, s * px + c * pz], -1)


def _rotate_rate(angle: Tensor, rate: Tensor, point: tp.Sequence[float]) -> Tensor:
    """d/dt of ``_rotate(angle, point)`` when the angle moves at ``rate``."""
    c, s = torch.cos(angle), torch.sin(angle)
    px, pz = float(point[0]), float(point[1])
    return torch.stack([(-s * px - c * pz) * rate, (c * px - s * pz) * rate], -1)


def fk(model: PlanarModel, q: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Forward kinematics: body origins [..., nb, 2] and angles [..., nb]."""
    origins = [q[..., 0:2]]
    angles = [q[..., 2]]
    for b in range(1, model.nb):
        p = model.parent[b]
        origins.append(origins[p] + _rotate(angles[p], model.anchor[b]))
        angles.append(angles[p] + q[..., 2 + b])
    return torch.stack(origins, -2), torch.stack(angles, -1)


def com_world(model: PlanarModel, q: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Body COM positions [..., nb, 2] and angles [..., nb]."""
    origins, angles = fk(model, q)
    offsets = torch.stack([_rotate(angles[..., b], model.com[b])
                           for b in range(model.nb)], -2)
    return origins + offsets, angles


def contact_world(model: PlanarModel, q: Tensor) -> Tensor:
    """Contact points in the world frame, [..., nc, 2]."""
    origins, angles = fk(model, q)
    return torch.stack([origins[..., b, :] + _rotate(angles[..., b], point)
                        for b, point in zip(model.contact_body, model.contact_point)], -2)


def com_velocities(model: PlanarModel, q: Tensor, qd: Tensor
                   ) -> tp.Tuple[Tensor, Tensor]:
    """Per-body COM velocity [..., nb, 2] and angular velocity [..., nb]."""
    angles = [q[..., 2]]
    rates = [qd[..., 2]]
    origin_vels = [qd[..., 0:2]]
    for b in range(1, model.nb):
        p = model.parent[b]
        origin_vels.append(origin_vels[p]
                           + _rotate_rate(angles[p], rates[p], model.anchor[b]))
        angles.append(angles[p] + q[..., 2 + b])
        rates.append(rates[p] + qd[..., 2 + b])
    vels = [origin_vels[b] + _rotate_rate(angles[b], rates[b], model.com[b])
            for b in range(model.nb)]
    return torch.stack(vels, -2), torch.stack(rates, -1)


def subtree_momentum(model: PlanarModel, q: Tensor, qd: Tensor
                     ) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """(linear COM velocity [..., 2], angular momentum about the total COM
    [...], total COM position [..., 2]): the planar analogues of MuJoCo's
    subtree_linvel / subtree_angmom used by the goal spaces."""
    coms, _ = com_world(model, q)
    v, w = com_velocities(model, q, qd)
    mass = torch.as_tensor(model.mass, dtype=q.dtype, device=q.device)
    inertia = torch.as_tensor(model.inertia, dtype=q.dtype, device=q.device)
    total_mass = mass.sum()
    com = (mass[:, None] * coms).sum(-2) / total_mass
    v_com = (mass[:, None] * v).sum(-2) / total_mass
    rel = coms - com[..., None, :]
    relv = v - v_com[..., None, :]
    # angular momentum about MuJoCo's y-axis (x forward, z up, y left):
    # (r x v)_y = z_rel*vx - x_rel*vz; the planar angle is counterclockwise
    # in the x-z plane, i.e. w_y = -theta_dot, hence the -I*w spin term
    l_y = (-inertia * w + mass * (rel[..., 1] * relv[..., 0]
                                  - rel[..., 0] * relv[..., 1])).sum(-1)
    return v_com, l_y, com


# ---------------------------------------------------------------- helpers

def capsule_mass(radius: float, length: float, density: float = 1000.0) -> float:
    """Mass of a capsule (cylinder + sphere caps)."""
    cyl = np.pi * radius ** 2 * length
    caps = 4.0 / 3.0 * np.pi * radius ** 3
    return float(density * (cyl + caps))


def rod_inertia(mass: float, length: float, radius: float) -> float:
    """Inertia of a capsule about its COM, perpendicular axis (cylinder
    approximation)."""
    return float(mass * (length ** 2 / 12.0 + radius ** 2 / 4.0))


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
