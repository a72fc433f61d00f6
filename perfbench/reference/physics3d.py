"""3-D articulated rigid-body physics in plain PyTorch, every derivative
taken by autodiff (``torch.func``), in the dtype of its inputs (the check
steps it in float64).

The model is the one the port's 3-D engine states in its docstring: the
root is a free joint ``q[0:6] = [x, y, z, roll, pitch, yaw]`` with
R = Rz(yaw) Ry(pitch) Rx(roll); every other body b adds one hinge ``q[6 + b
- 1]`` about a fixed axis in its parent's frame (``ndof = nb + 5``); soft
sphere contacts against the flat ground, fn = (k phi - d v_z)+ gated on
penetration phi > 0, friction -mu fn sat(v_t / v_slip); position servos
with joint damping; soft joint limits (a spring beyond [lo, hi], a damper
while beyond); armature on the hinges; semi-implicit Euler with substeps,
the velocities clipped to +-100.

It is a second derivation, not a copy of the program: the program writes
its Jacobians, mass matrix and Coriolis forces out by hand, while here the
Lagrangian is differentiated as the JAX package does it. For one state:

  * the COMs' and contact points' Jacobians are ``jacfwd`` of their world
    positions; each body's angular velocity is w = unskew(dR/dt R^T) with
    dR/dt a ``jvp`` of the rotations along qd, and its Jacobian ``jacfwd``
    of w in qd;
  * M = sum_b m_b Jc^T Jc + Jw^T (R I R^T) Jw + diag(0_6, armature);
  * the Coriolis and centrifugal forces h = Mdot qd - 1/2 d(qd^T M qd)/dq,
    Mdot qd a ``jvp`` of M(q) qd along qd and the second term a ``grad``;
  * gravity is -grad of g sum_b m_b z_com;
  * qdd = (M + 1e-8 I)^-1 (tau + J_c^T f + gravity - h).

``step`` maps the one-state dynamics over a batch (``torch.func.vmap``) in
chunks of ``CHUNK`` states.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
from torch import func

Tensor = torch.Tensor

GRAVITY = 9.81
V_SLIP = 0.1
# states per vmap call: the nested derivatives hold ~0.25 MB a state in float64,
# and a call's time is its operations' dispatch, not its batch
CHUNK = 16384


@dataclasses.dataclass(frozen=True)
class Model3D:
    """Static model description (host arrays). Body 0 is the root; every
    hinge is a position servo commanding ``servo_center + action *
    servo_half``."""

    parent: tp.Tuple[int, ...]
    anchor: np.ndarray  # [nb, 3] joint position in the parent's frame
    axis: np.ndarray  # [nb, 3] hinge axis in the parent's frame
    com: np.ndarray  # [nb, 3] centre of mass in the body frame
    mass: np.ndarray  # [nb]
    inertia: np.ndarray  # [nb, 3] diagonal inertia in the body frame
    contact_body: tp.Tuple[int, ...]
    contact_point: np.ndarray  # [nc, 3] in the body frame
    contact_radius: np.ndarray  # [nc]
    damping: np.ndarray  # [nj]
    limit_lo: np.ndarray  # [nj]
    limit_hi: np.ndarray  # [nj]
    armature: np.ndarray  # [nj]
    servo_gain: np.ndarray  # [nj]
    servo_center: np.ndarray  # [nj]
    servo_half: np.ndarray  # [nj]
    contact_stiffness: float = 3.0e4
    contact_damping: float = 300.0
    friction: float = 1.0
    limit_stiffness: float = 300.0
    limit_damping: float = 10.0

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def ndof(self) -> int:
        return self.nb + 5


class _Consts(tp.NamedTuple):
    anchor: Tensor
    axis: Tensor
    com: Tensor
    mass: Tensor
    inertia: Tensor
    contact_point: Tensor
    contact_radius: Tensor
    damping: Tensor
    limit_lo: Tensor
    limit_hi: Tensor
    armature: Tensor  # [ndof] 0 on the root's six
    servo: tp.Tuple[Tensor, Tensor, Tensor]


def _consts(m: Model3D, like: Tensor) -> _Consts:
    def on(x: np.ndarray) -> Tensor:
        return torch.as_tensor(np.asarray(x, np.float64), dtype=like.dtype, device=like.device)

    return _Consts(on(m.anchor), on(m.axis), on(m.com), on(m.mass), on(m.inertia),
                   on(m.contact_point), on(m.contact_radius), on(m.damping), on(m.limit_lo),
                   on(m.limit_hi), on(np.concatenate([np.zeros(6), m.armature])),
                   (on(m.servo_gain), on(m.servo_center), on(m.servo_half)))


def _matrix(*rows: tp.Sequence[Tensor]) -> Tensor:
    return torch.stack([torch.stack(list(r)) for r in rows])


def euler_rot(rpy: Tensor) -> Tensor:
    """Rz(yaw) @ Ry(pitch) @ Rx(roll) of one ``rpy`` [3]."""
    c, s = torch.cos(rpy), torch.sin(rpy)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])
    rx = _matrix((one, zero, zero), (zero, c[0], -s[0]), (zero, s[0], c[0]))
    ry = _matrix((c[1], zero, s[1]), (zero, one, zero), (-s[1], zero, c[1]))
    rz = _matrix((c[2], -s[2], zero), (s[2], c[2], zero), (zero, zero, one))
    return rz @ ry @ rx


def _axis_rot(k: Tensor, angle: Tensor) -> Tensor:
    """Rodrigues' rotation by ``angle`` about the unit axis ``k``."""
    zero = torch.zeros_like(k[0])
    skew = _matrix((zero, -k[2], k[1]), (k[2], zero, -k[0]), (-k[1], k[0], zero))
    return (torch.eye(3, dtype=k.dtype, device=k.device) * torch.cos(angle)
            + torch.sin(angle) * skew + (1 - torch.cos(angle)) * torch.outer(k, k))


def fk(m: Model3D, c: _Consts, q: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Body origins [nb, 3] and rotations [nb, 3, 3] of one state."""
    origins, rots = [q[0:3]], [euler_rot(q[3:6])]
    for b in range(1, m.nb):
        p = m.parent[b]
        origins.append(origins[p] + rots[p] @ c.anchor[b])
        rots.append(rots[p] @ _axis_rot(c.axis[b], q[6 + b - 1]))
    return torch.stack(origins), torch.stack(rots)


def com_world(m: Model3D, c: _Consts, q: Tensor) -> Tensor:
    origins, rots = fk(m, c, q)
    return origins + (rots @ c.com.unsqueeze(-1)).squeeze(-1)


def contact_world(m: Model3D, c: _Consts, q: Tensor) -> Tensor:
    origins, rots = fk(m, c, q)
    idx = list(m.contact_body)
    return origins[idx] + (rots[idx] @ c.contact_point.unsqueeze(-1)).squeeze(-1)


def body_omegas(m: Model3D, c: _Consts, q: Tensor, qd: Tensor) -> Tensor:
    """World angular velocities [nb, 3]: unskew(dR/dt R^T)."""
    rots, rdots = func.jvp(lambda x: fk(m, c, x)[1], (q,), (qd,))
    w = rdots @ rots.mT
    return torch.stack([w[:, 2, 1], w[:, 0, 2], w[:, 1, 0]], -1)


def mass_matrix(m: Model3D, c: _Consts, q: Tensor) -> Tensor:
    jac_c = func.jacfwd(lambda x: com_world(m, c, x))(q)  # [nb, 3, ndof]
    jac_w = func.jacfwd(lambda v: body_omegas(m, c, q, v))(torch.zeros_like(q))
    rots = fk(m, c, q)[1]
    i_world = rots @ torch.diag_embed(c.inertia) @ rots.mT
    mm = torch.einsum("b,bid,bie->de", c.mass, jac_c, jac_c)
    mm = mm + torch.einsum("bid,bij,bje->de", jac_w, i_world, jac_w)
    return mm + torch.diag(c.armature)


def bias_forces(m: Model3D, c: _Consts, q: Tensor, qd: Tensor) -> Tensor:
    """Mdot qd - 1/2 d(qd^T M qd)/dq."""
    mdot_qd = func.jvp(lambda x: mass_matrix(m, c, x) @ qd, (q,), (qd,))[1]
    kinetic = func.grad(lambda x: 0.5 * qd @ mass_matrix(m, c, x) @ qd)(q)
    return mdot_qd - kinetic


def gravity_forces(m: Model3D, c: _Consts, q: Tensor) -> Tensor:
    return -func.grad(lambda x: GRAVITY * (c.mass * com_world(m, c, x)[:, 2]).sum())(q)


def contact_forces(m: Model3D, c: _Consts, q: Tensor, qd: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Generalized contact force [ndof] and the normal forces [nc]."""
    jac = func.jacfwd(lambda x: contact_world(m, c, x))(q)  # [nc, 3, ndof]
    pts, vel = contact_world(m, c, q), jac @ qd
    phi = c.contact_radius - pts[:, 2]
    fn = torch.where(phi > 0, torch.clamp(m.contact_stiffness * phi
                                          - m.contact_damping * vel[:, 2], min=0.0), 0.0)
    ft = -m.friction * fn.unsqueeze(-1) * torch.clamp(vel[:, :2] / V_SLIP, -1.0, 1.0)
    forces = torch.cat([ft, fn.unsqueeze(-1)], -1)
    return torch.einsum("cid,ci->d", jac, forces), fn


def joint_forces(m: Model3D, c: _Consts, q: Tensor, qd: Tensor, action: Tensor) -> Tensor:
    qj, qdj = q[6:], qd[6:]
    gain, center, half = c.servo
    tau = gain * (center + action * half - qj) - c.damping * qdj
    below, above = qj < c.limit_lo, qj > c.limit_hi
    tau = tau + torch.where(below, m.limit_stiffness * (c.limit_lo - qj)
                            - m.limit_damping * qdj, 0.0)
    tau = tau + torch.where(above, m.limit_stiffness * (c.limit_hi - qj)
                            - m.limit_damping * qdj, 0.0)
    return torch.cat([torch.zeros_like(q[:6]), tau])


def forward_dynamics(m: Model3D, c: _Consts, q: Tensor, qd: Tensor, action: Tensor) -> Tensor:
    """qdd of one state."""
    mm = mass_matrix(m, c, q)
    contact, _ = contact_forces(m, c, q, qd)
    rhs = (joint_forces(m, c, q, qd, action) + contact + gravity_forces(m, c, q)
           - bias_forces(m, c, q, qd))
    return torch.linalg.solve(mm + 1e-8 * torch.eye(m.ndof, dtype=q.dtype, device=q.device),
                              rhs)


def step(m: Model3D, q: Tensor, qd: Tensor, action: Tensor, dt: float, n_substeps: int
         ) -> tp.Tuple[Tensor, Tensor]:
    """(q, qd) after one control step of ``n_substeps`` semi-implicit Euler
    substeps, for states [B, ndof] under actions [B, nj]."""
    c = _consts(m, q)
    h = dt / n_substeps
    batched = func.vmap(lambda x, v, a: forward_dynamics(m, c, x, v, a))
    out_q, out_qd = [], []
    for at in range(0, q.shape[0], CHUNK):
        x, v, a = (t[at:at + CHUNK] for t in (q, qd, action))
        for _ in range(n_substeps):
            v = torch.clamp(v + h * batched(x, v, a), -100.0, 100.0)
            x = x + h * v
        out_q.append(x)
        out_qd.append(v)
    return torch.cat(out_q), torch.cat(out_qd)
