"""3-D articulated rigid-body physics (mirror of
``controllable_agent_tpu/envs/physics3d.py``), for the quadruped and jaco.

The root is a free joint ``q[0:6] = [x, y, z, roll, pitch, yaw]`` with
R = Rz(yaw) Ry(pitch) Rx(roll); every other body b adds one hinge dof
``q[6 + b - 1]`` about a fixed axis in its parent's frame. ``ndof = nb + 5``.
Euler angles keep the plain Lagrangian formulation, and with it the JAX
package's documented gimbal singularity at pitch = +-90 degrees.
``fixed_base`` pins the root: the joint block of M is solved alone (jaco).

Every function is batched over leading ``[..., ndof]`` axes and runs on the
tensors' device. The model's constants are built once per device and dtype
(``Model3D.tensors``), so nothing is copied from the host while a step runs
and one captured control step can hold it. Positions are kept relative to the
root's origin inside the functions (a point far from the world's origin loses
no float32 digits to the differences below).

The JAX package takes every derivative by autodiff (``jvp``, ``jacfwd``,
``grad``); here they are written out. The rotation dofs are ``k = 0 ..
nb + 1`` (q[3 + k]: roll, pitch, yaw, then the hinges), each with a world
axis s_k and an origin o_k:

  * the root's Euler rates turn about s_roll = Rz Ry e_x, s_pitch = Rz e_y
    and s_yaw = e_z, at the root's origin; hinge j turns about
    R_parent(j) axis_j at body j's origin;
  * a point p on body b moves at dp/dq = e_x, e_y, e_z for the root's
    translation and s_k x (p - o_k) for every rotation k that reaches b;
    body b turns at dw/dq_k = s_k for those k;
  * M = sum_b m_b Jc^T Jc + Jw^T (R I R^T) Jw + diag(0_6, armature), the
    rotational part taken in the body frame (Jw^T R I R^T Jw = (R^T Jw)^T I
    (R^T Jw));
  * gravity is sum_b Jc^T (0, 0, -m_b g);
  * the Coriolis and centrifugal forces (JAX's Mdot qd - 1/2 d(qd^T M qd)/dq)
    are sum_b m_b Jc^T a_b + Jw^T (I_w alpha_b + w_b x I_w w_b), with a_b and
    alpha_b the COM's and the body's accelerations at zero qdd. Both need the
    axes' rates ds_k/dt = w_f x s_k, w_f the angular velocity of the frame
    s_k is fixed in: for a hinge its parent body, for the root's roll axis
    the frame Rz Ry (w_f = yaw' s_yaw + pitch' s_pitch), for pitch Rz
    (yaw' s_yaw); yaw's axis is constant. So w_f of axis k is the sum of
    qd_i s_i over the axes i before k on its chain, and
    a = sum_k [qd_k ds_k x (p - o_k) + qd_k s_k x (v_p - v_{o_k})];
  * the contact Jacobian is the point Jacobian at the contact points;
  * a heightfield's normal comes from the slope of its bilinear patch, zero
    where the query was clamped to the grid (the gradient ``jnp.clip`` gives,
    a half on the border itself).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import trace

Tensor = torch.Tensor

GRAVITY = 9.81
V_SLIP = 0.1  # the slip speed at which friction saturates


# -------------------------------------------------------------- heightfield

@dataclasses.dataclass(frozen=True)
class Heightfield:
    """Square terrain centred on the origin: ``data[..., iy, ix]`` is the
    height at x = (ix / (res - 1) * 2 - 1) * half_size, y likewise, and the
    leading axes of ``data`` (one terrain per environment) lead the queries
    too. Heights are bilinear; queries outside the grid clamp to its border."""

    data: Tensor  # [..., res, res]
    half_size: float

    @property
    def res(self) -> int:
        return self.data.shape[-1]


def _cells(hf: Heightfield, xy: Tensor) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """The grid coordinates before clamping [..., 2], the fractions inside
    the cell [..., 2] and the cell's corner heights (h00, h01, h10, h11)
    [..., 4] of each query ``xy`` [*data.shape[:-2], ..., 2]."""
    res = hf.res
    raw = (xy / hf.half_size + 1.0) * 0.5 * (res - 1)
    uv = raw.clamp(0.0, res - 1.0)
    cell = torch.floor(uv).clamp(0.0, res - 2.0)
    batch = hf.data.shape[:-2]
    corner = torch.arange(4, device=xy.device)  # made on the device: (0, 1, res, res + 1)
    corner = corner + (corner >= 2) * (res - 2)
    index = (cell[..., 1] * res + cell[..., 0]).long().unsqueeze(-1) + corner
    flat = hf.data.reshape(*batch, res * res)
    heights = flat.gather(-1, index.reshape(*batch, -1)).reshape(index.shape)
    return raw, uv - cell, heights


def hf_height(hf: Heightfield, xy: Tensor) -> Tensor:
    """Bilinear terrain height at world (x, y): [...]."""
    _, frac, h = _cells(hf, xy)
    fu, fv = frac[..., 0], frac[..., 1]
    return ((1 - fv) * ((1 - fu) * h[..., 0] + fu * h[..., 1])
            + fv * ((1 - fu) * h[..., 2] + fu * h[..., 3]))


def hf_normal(hf: Heightfield, xy: Tensor) -> Tensor:
    """Unit surface normal [..., 3] at world (x, y), from the height's slope."""
    raw, frac, h = _cells(hf, xy)
    fu, fv = frac[..., 0], frac[..., 1]
    dh_du = (1 - fv) * (h[..., 1] - h[..., 0]) + fv * (h[..., 3] - h[..., 2])
    dh_dv = ((1 - fu) * h[..., 2] + fu * h[..., 3]) - ((1 - fu) * h[..., 0] + fu * h[..., 1])
    # the clamp passes the slope inside the grid, half of it on the border
    hi = hf.res - 1.0
    passed = 0.25 * (((raw >= 0.0).to(raw.dtype) + (raw > 0.0).to(raw.dtype))
                     * ((raw <= hi).to(raw.dtype) + (raw < hi).to(raw.dtype)))
    grad = torch.stack([dh_du, dh_dv], -1) * passed * (hf.res - 1) * 0.5 / hf.half_size
    n = torch.cat([-grad, torch.ones_like(grad[..., :1])], -1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


# -------------------------------------------------------------------- model

@dataclasses.dataclass(frozen=True)
class Model3D:
    """Static model description, held on the host. nb bodies; body 0 is the
    root (6 dof), body b >= 1 adds hinge dof 6 + b - 1. With ``servo_gain``
    set, an action in [-1, 1] commands the target angle ``servo_center +
    action * servo_half`` of a position servo and ``gear`` is unused."""

    parent: tp.Tuple[int, ...]  # parent[0] = -1
    anchor: np.ndarray  # [nb, 3] joint position in the parent's frame
    axis: np.ndarray  # [nb, 3] hinge axis in the parent's frame (unused for the root)
    com: np.ndarray  # [nb, 3] centre of mass in the body frame
    mass: np.ndarray  # [nb]
    inertia: np.ndarray  # [nb, 3] diagonal inertia in the body frame
    contact_body: tp.Tuple[int, ...]
    contact_point: np.ndarray  # [nc, 3] in the body frame
    contact_radius: np.ndarray  # [nc]
    gear: np.ndarray  # [nj]
    damping: np.ndarray  # [nj]
    limit_lo: np.ndarray  # [nj]
    limit_hi: np.ndarray  # [nj]
    armature: np.ndarray  # [nj]
    contact_stiffness: float = 3.0e4
    contact_damping: float = 300.0
    friction: float = 1.0
    limit_stiffness: float = 300.0
    limit_damping: float = 10.0
    fixed_base: bool = False
    servo_gain: tp.Optional[np.ndarray] = None  # [nj]
    servo_center: tp.Optional[np.ndarray] = None  # [nj]
    servo_half: tp.Optional[np.ndarray] = None  # [nj]
    _tensors: tp.Dict[tp.Tuple[torch.device, torch.dtype], "ModelTensors"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def ndof(self) -> int:
        return self.nb + 5

    def tensors(self, device: torch.device, dtype: torch.dtype) -> "ModelTensors":
        """The model's constants on ``device``, built once for each device
        and dtype."""
        key = (torch.device(device), dtype)
        if key not in self._tensors:
            self._tensors[key] = ModelTensors.build(self, *key)
        return self._tensors[key]


class _Level(tp.NamedTuple):
    """The bodies at one depth of the tree, in the order the kinematics
    visits them (all bodies of a depth at once)."""

    dofs: Tensor  # [n] the bodies' hinge dofs, as indices into q
    parents: Tensor  # [n] the parents' positions in the visiting order
    turn: Tensor  # [3, n, 3, 3] (I - k k^T, [k]x, k k^T) of each hinge axis k
    anchor_axis: Tensor  # [n, 3, 2] each body's anchor and hinge axis


@dataclasses.dataclass(frozen=True)
class ModelTensors:
    """A model's constants on one device, laid out for batched kinematics.

    The points whose motion the dynamics need are the body origins, the
    COMs and the contact points (``npts = 2 nb + nc``, in that order); the
    rotation dofs are ``nr = nb + 2``. The generalized Jacobian ``G``
    [..., ndof, 3 (nb + nc) + 3 nb] has the linear Jacobians of the COMs and
    the contact points, then the body-frame angular Jacobians."""

    levels: tp.Tuple[_Level, ...]
    to_body_order: tp.Optional[Tensor]  # [nb] visiting position of each body (None: the same)
    hinge_order: tp.Optional[Tensor]  # [nb - 1] the same for the hinges' axes
    point_body: Tensor  # [npts] the body each point is fixed on
    point_offset: Tensor  # [npts, 3, 1] the point in its body's frame
    axis_body: Tensor  # [nr] the body whose origin each rotation turns about
    reach: Tensor  # [nr, npts, 1] 1 where rotation k moves the point
    reach_body_t: Tensor  # [nb, nr] 1 where rotation k turns body b
    before_t: Tensor  # [nr, nr] [k, i] = 1 where axis i comes before axis k on its chain
    root_rows: Tensor  # [3, 3 (nb + nc) + 3 nb] G's rows of the root's translation
    inertias: Tensor  # [3 (nb + nc) + 3 nb] masses on the COM columns, inertias on the angular
    gravity: Tensor  # [3 (nb + nc) + 3 nb] gravity's force on the COM columns
    mass: Tensor  # [nb, 1]
    inertia: Tensor  # [nb, 3]
    armature: Tensor  # [ndof, ndof] diag(0_6, armature)
    solve_shift: Tensor  # [n, n] the armature + 1e-8 I over the solved block
    contact_radius: Tensor
    gear: Tensor
    damping: Tensor
    limit_lo: Tensor
    limit_hi: Tensor
    servo: tp.Optional[tp.Tuple[Tensor, Tensor, Tensor]]  # gain, centre, half range

    @classmethod
    def build(cls, model: Model3D, device: torch.device, dtype: torch.dtype) -> "ModelTensors":
        nb, nc, ndof, nr = model.nb, len(model.contact_body), model.ndof, model.nb + 2

        def on(x: tp.Any, kind: torch.dtype = dtype) -> Tensor:
            return torch.as_tensor(np.asarray(x), dtype=kind).to(device)

        depth = [0] * nb
        for b in range(1, nb):
            depth[b] = depth[model.parent[b]] + 1
        order = sorted(range(nb), key=lambda b: (depth[b], b))
        position = {b: i for i, b in enumerate(order)}
        levels = []
        for d in range(1, max(depth) + 1):
            bodies = [b for b in order if depth[b] == d]
            k = np.asarray(model.axis, np.float64)[bodies]
            outer = np.einsum("ni,nj->nij", k, k)
            cross = np.zeros((len(bodies), 3, 3))
            cross[:, 0, 1], cross[:, 0, 2], cross[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
            cross -= cross.transpose(0, 2, 1)
            levels.append(_Level(
                dofs=on([6 + b - 1 for b in bodies], torch.long),
                parents=on([position[model.parent[b]] for b in bodies], torch.long),
                turn=on(np.stack([np.eye(3) - outer, cross, outer])),
                anchor_axis=on(np.stack([np.asarray(model.anchor, np.float64)[bodies], k], -1))))

        # chain[b, j]: j is b or an ancestor of b
        chain = np.zeros((nb, nb))
        for b in range(nb):
            chain[b, b] = 1.0
            if b > 0:
                chain[b] += chain[model.parent[b]]
        # rotation k reaches body b: the root's three reach every body, rotation
        # k >= 3 is body k - 2's hinge and reaches that body's subtree
        reach_body = np.zeros((nr, nb))
        reach_body[:3] = 1.0
        reach_body[3:] = chain[:, 1:].T
        point_body = list(range(nb)) * 2 + list(model.contact_body)
        before = np.zeros((nr, nr))  # before[i, k]
        before[2, :2] = before[1, 0] = 1.0  # yaw before pitch and roll, pitch before roll
        for b in range(1, nb):
            before[:, 3 + b - 1] = reach_body[:, model.parent[b]]
        offsets = np.concatenate([np.zeros((nb, 3)), np.asarray(model.com, np.float64),
                                  np.asarray(model.contact_point, np.float64).reshape(nc, 3)])
        lin = nb + nc  # points with a linear Jacobian column in G: COMs, contacts
        root_rows = np.zeros((3, 3 * lin + 3 * nb))
        root_rows[:, :3 * lin] = np.tile(np.eye(3), lin)
        mass = np.asarray(model.mass, np.float64)
        inertias = np.concatenate([np.repeat(mass, 3), np.zeros(3 * nc),
                                   np.asarray(model.inertia, np.float64).reshape(-1)])
        gravity = np.zeros(3 * lin + 3 * nb)
        gravity[2:3 * nb:3] = -GRAVITY * mass
        solved = ndof - 6 if model.fixed_base else ndof
        armature = np.diag(np.concatenate([np.zeros(6), np.asarray(model.armature, np.float64)]))
        shift = armature[ndof - solved:, ndof - solved:] + 1e-8 * np.eye(solved)
        servo = None
        if model.servo_gain is not None:
            servo = (on(model.servo_gain), on(model.servo_center), on(model.servo_half))
        reordered = order != list(range(nb))
        return cls(
            levels=tuple(levels),
            to_body_order=on([position[b] for b in range(nb)], torch.long) if reordered else None,
            hinge_order=(on([position[b] - 1 for b in range(1, nb)], torch.long)
                         if reordered else None),
            point_body=on(point_body, torch.long), point_offset=on(offsets[:, :, None]),
            axis_body=on([0, 0, 0] + list(range(1, nb)), torch.long),
            reach=on(reach_body[:, point_body][:, :, None]), reach_body_t=on(reach_body.T),
            before_t=on(before.T), root_rows=on(root_rows), inertias=on(inertias),
            gravity=on(gravity), mass=on(mass[:, None]), inertia=on(model.inertia),
            armature=on(armature), solve_shift=on(shift), contact_radius=on(model.contact_radius),
            gear=on(model.gear), damping=on(model.damping), limit_lo=on(model.limit_lo),
            limit_hi=on(model.limit_hi), servo=servo)


# -------------------------------------------------------------- kinematics

def euler_rot(rpy: Tensor) -> Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll) of ``rpy`` [..., 3]: [..., 3, 3]."""
    c, s = torch.cos(rpy), torch.sin(rpy)
    cr, cp, cy = c.unbind(-1)
    sr, sp, sy = s.unbind(-1)
    return torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                        -sp, cp * sr, cp * cr], -1).unflatten(-1, (3, 3))


class _Pose(tp.NamedTuple):
    """A pose, relative to the root's origin."""

    rots: Tensor  # [..., nb, 3, 3] body rotations
    origins: Tensor  # [..., nb, 3] body origins
    axes: Tensor  # [..., nr, 3] world axes of the rotation dofs
    points: Tensor  # [..., npts, 3] body origins, COMs, contact points


def _pose(c: ModelTensors, q: Tensor) -> _Pose:
    rot = euler_rot(q[..., 3:6])
    rots, origins, hinge_axes = rot.unsqueeze(-3), torch.zeros_like(q[..., None, :3]), []
    for level in c.levels:
        parent = rots.index_select(-3, level.parents)
        angle = q.index_select(-1, level.dofs)[..., None, None]
        turn = level.turn[0] * torch.cos(angle) + level.turn[1] * torch.sin(angle) + level.turn[2]
        placed = parent @ level.anchor_axis  # [..., n, 3, 2] anchor and axis in the world frame
        rots = torch.cat([rots, parent @ turn], -3)
        origins = torch.cat([origins, origins.index_select(-2, level.parents)
                             + placed[..., 0]], -2)
        hinge_axes.append(placed[..., 1])
    hinge = torch.cat(hinge_axes, -2)
    if c.to_body_order is not None:
        rots = rots.index_select(-3, c.to_body_order)
        origins = origins.index_select(-2, c.to_body_order)
        hinge = hinge.index_select(-2, c.hinge_order)
    # roll turns about Rz Ry e_x (R's first column), pitch about Rz e_y, yaw about e_z
    cy, sy = torch.cos(q[..., 5]), torch.sin(q[..., 5])
    zero = torch.zeros_like(cy)
    root_axes = torch.stack([rot[..., :, 0], torch.stack([-sy, cy, zero], -1),
                             torch.stack([zero, zero, zero + 1.0], -1)], -2)
    points = (origins.index_select(-2, c.point_body)
              + (rots.index_select(-3, c.point_body) @ c.point_offset).squeeze(-1))
    return _Pose(rots, origins, torch.cat([root_axes, hinge], -2), points)


def fk(model: Model3D, q: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Body origins [..., nb, 3] and rotations [..., nb, 3, 3]."""
    pose = _pose(model.tensors(q.device, q.dtype), q)
    return pose.origins + q[..., None, :3], pose.rots


def com_world(model: Model3D, q: Tensor) -> Tensor:
    """Body COMs in the world frame, [..., nb, 3]."""
    pose = _pose(model.tensors(q.device, q.dtype), q)
    return pose.points[..., model.nb:2 * model.nb, :] + q[..., None, :3]


def contact_world(model: Model3D, q: Tensor) -> Tensor:
    """Contact points in the world frame, [..., nc, 3]."""
    pose = _pose(model.tensors(q.device, q.dtype), q)
    return pose.points[..., 2 * model.nb:, :] + q[..., None, :3]


class _Kinematics(tp.NamedTuple):
    """What the dynamics need of a pose."""

    pose: _Pose
    offsets: Tensor  # [..., nr, npts, 3] p - o_k: each point from each rotation's origin
    turned: Tensor  # [..., nr, npts, 3] s_k x (p - o_k), 0 where rotation k does not move p
    jacobian: Tensor  # [..., ndof, 3 (nb + nc) + 3 nb] G (ModelTensors)


def _kinematics(c: ModelTensors, q: Tensor) -> _Kinematics:
    pose = _pose(c, q)
    nb = pose.rots.shape[-3]
    offsets = pose.points.unsqueeze(-3) - pose.origins.index_select(-2, c.axis_body).unsqueeze(-2)
    turned = torch.linalg.cross(pose.axes.unsqueeze(-2), offsets) * c.reach
    # the body-frame angular Jacobian: R_b^T s_k where rotation k turns body b
    angular = (pose.axes.unsqueeze(-3) @ pose.rots).transpose(-3, -2) * c.reach[:, :nb]
    rotation_rows = torch.cat([turned[..., nb:, :].flatten(-2), angular.flatten(-2)], -1)
    root = c.root_rows.expand(*q.shape[:-1], *c.root_rows.shape)
    return _Kinematics(pose, offsets, turned, torch.cat([root, rotation_rows], -2))


def _mass_matrix(c: ModelTensors, kin: _Kinematics) -> Tensor:
    """M without its armature: G diag(inertias) G^T."""
    g = kin.jacobian
    return (g * c.inertias) @ g.mT


def _generalized(kin: _Kinematics, forces: Tensor) -> Tensor:
    """G f of column forces ``forces`` [..., 3 (nb + nc) + 3 nb]."""
    return (kin.jacobian @ forces.unsqueeze(-1)).squeeze(-1)


def _point_velocities(kin: _Kinematics, qd: Tensor) -> Tensor:
    """Each point's velocity relative to the root's translation, [..., npts, 3]."""
    turned = kin.turned
    return (qd[..., None, 3:] @ turned.flatten(-2)).squeeze(-2).unflatten(-1, turned.shape[-2:])


def _inertial_forces(c: ModelTensors, kin: _Kinematics, qd: Tensor) -> Tensor:
    """The column forces of the Coriolis and centrifugal terms: m_b a_b on
    the COM columns and I alpha_b + w_b x I w_b (body frame) on the angular
    ones, a_b and alpha_b the accelerations at zero joint acceleration."""
    pose = kin.pose
    nb = pose.rots.shape[-3]
    rates = qd[..., 3:, None]
    spin = rates * pose.axes  # [..., nr, 3] qd_k s_k
    axis_rates = torch.linalg.cross(c.before_t @ spin, pose.axes)  # ds_k/dt
    spin_rate = rates * axis_rates
    velocity = _point_velocities(kin, qd)
    origin_velocity = velocity.index_select(-2, c.axis_body)
    com = slice(nb, 2 * nb)
    relative = velocity[..., None, com, :] - origin_velocity.unsqueeze(-2)
    accel = (torch.linalg.cross(spin_rate.unsqueeze(-2), kin.offsets[..., com, :])
             + torch.linalg.cross(spin.unsqueeze(-2), relative)) * c.reach[:, com]
    linear = accel.sum(-3) * c.mass  # [..., nb, 3]
    # each body's angular velocity and acceleration, in its own frame
    turning = pose.rots.mT @ torch.stack([c.reach_body_t @ spin, c.reach_body_t @ spin_rate], -1)
    omega, alpha = turning.unbind(-1)
    angular = c.inertia * alpha + torch.linalg.cross(omega, c.inertia * omega)
    nc = kin.offsets.shape[-2] - 2 * nb
    return torch.cat([linear.flatten(-2), linear.new_zeros(linear.shape[:-2] + (3 * nc,)),
                      angular.flatten(-2)], -1)


def _contact_state(model: Model3D, kin: _Kinematics, q: Tensor, qd: Tensor
                   ) -> tp.Tuple[Tensor, Tensor]:
    """Contact points [..., nc, 3] and their velocities in the world frame."""
    first = 2 * model.nb
    points = kin.pose.points[..., first:, :] + q[..., None, :3]
    velocity = _point_velocities(kin, qd)[..., first:, :] + qd[..., None, :3]
    return points, velocity


def _contact_forces(model: Model3D, c: ModelTensors, kin: _Kinematics, q: Tensor, qd: Tensor,
                    hfield: tp.Optional[Heightfield]) -> tp.Tuple[Tensor, Tensor]:
    """Contact forces as column forces [..., 3 nc] and their normal parts."""
    points, vel = _contact_state(model, kin, q, qd)
    if hfield is None:
        phi = c.contact_radius - points[..., 2]
        fn = torch.where(phi > 0, (model.contact_stiffness * phi
                                   - model.contact_damping * vel[..., 2]).clamp_min(0.0), 0.0)
        ft = -model.friction * fn.unsqueeze(-1) * (vel[..., :2] / V_SLIP).clamp(-1.0, 1.0)
        forces = torch.cat([ft, fn.unsqueeze(-1)], -1)
    else:
        # the gap above the interpolated height, the force along the local
        # normal, friction in the tangent plane
        xy = points[..., :2]
        n = hf_normal(hfield, xy)
        phi = c.contact_radius - (points[..., 2] - hf_height(hfield, xy))
        v_n = (vel * n).sum(-1)
        fn = torch.where(phi > 0, (model.contact_stiffness * phi
                                   - model.contact_damping * v_n).clamp_min(0.0), 0.0)
        v_t = vel - v_n.unsqueeze(-1) * n
        forces = fn.unsqueeze(-1) * n - model.friction * fn.unsqueeze(-1) * (
            v_t / V_SLIP).clamp(-1.0, 1.0)
    return forces.flatten(-2), fn


def _column_forces(nb: int, contact: Tensor) -> Tensor:
    """Contact column forces [..., 3 nc] placed among G's columns."""
    return F.pad(contact, (3 * nb, 3 * nb))


def _joint_torques(model: Model3D, c: ModelTensors, q: Tensor, qd: Tensor,
                   action: Tensor) -> Tensor:
    qj, qdj = q[..., 6:], qd[..., 6:]
    if c.servo is not None:
        gain, center, half = c.servo
        tau = gain * (center + action * half - qj) - c.damping * qdj
    else:
        tau = c.gear * action - c.damping * qdj
    # soft limits: a spring on the excursion beyond [lo, hi], a damper while beyond
    excess = qj - torch.clamp(qj, c.limit_lo, c.limit_hi)
    return tau - model.limit_stiffness * excess - model.limit_damping * qdj * (excess != 0)


def _constants_and_kinematics(model: Model3D, q: Tensor
                              ) -> tp.Tuple[ModelTensors, _Kinematics]:
    c = model.tensors(q.device, q.dtype)
    return c, _kinematics(c, q)


def body_omegas(model: Model3D, q: Tensor, qd: Tensor) -> Tensor:
    """World angular velocities [..., nb, 3]."""
    c = model.tensors(q.device, q.dtype)
    return c.reach_body_t @ (qd[..., 3:, None] * _pose(c, q).axes)


def contact_motion(model: Model3D, q: Tensor, qd: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Contact points and their velocities J qd in the world frame, [..., nc, 3] each."""
    _, kin = _constants_and_kinematics(model, q)
    return _contact_state(model, kin, q, qd)


def mass_matrix(model: Model3D, q: Tensor) -> Tensor:
    """M(q), [..., ndof, ndof]."""
    c, kin = _constants_and_kinematics(model, q)
    return _mass_matrix(c, kin) + c.armature


def bias_forces(model: Model3D, q: Tensor, qd: Tensor) -> Tensor:
    """Coriolis/centrifugal h(q, qd) = Mdot qd - 1/2 d/dq (qd^T M qd)."""
    c, kin = _constants_and_kinematics(model, q)
    return _generalized(kin, _inertial_forces(c, kin, qd))


def gravity_forces(model: Model3D, q: Tensor) -> Tensor:
    """-dV/dq with V = g sum_b m_b z_com."""
    c, kin = _constants_and_kinematics(model, q)
    return _generalized(kin, c.gravity)


def contact_forces(model: Model3D, q: Tensor, qd: Tensor,
                   hfield: tp.Optional[Heightfield] = None) -> tp.Tuple[Tensor, Tensor]:
    """Generalized contact force [..., ndof] and normal forces [..., nc]:
    fn = (k phi - d v_n)+ gated on penetration phi > 0 (against the ground,
    or the heightfield along its normal); friction -mu fn sat(v_t / v_slip)."""
    c, kin = _constants_and_kinematics(model, q)
    forces, fn = _contact_forces(model, c, kin, q, qd, hfield)
    return _generalized(kin, _column_forces(model.nb, forces)), fn


def joint_forces(model: Model3D, q: Tensor, qd: Tensor, action: Tensor) -> Tensor:
    """Actuation (servo or gear) + joint damping + soft joint limits."""
    c = model.tensors(q.device, q.dtype)
    return F.pad(_joint_torques(model, c, q, qd, action), (6, 0))


def _solve(model: Model3D, c: ModelTensors, kin: _Kinematics, m: Tensor, inertial: Tensor,
           contact: Tensor, tau: Tensor) -> Tensor:
    """qdd from the mass matrix without its armature ``m``, the inertial
    column forces, the contact forces and the joint torques."""
    columns = c.gravity + _column_forces(model.nb, contact) - inertial
    if model.fixed_base:
        rhs = _generalized(kin, columns)[..., 6:] + tau
        # no error check: it would wait for the device, and M is positive definite
        return F.pad(torch.linalg.solve_ex(m[..., 6:, 6:] + c.solve_shift, rhs)[0], (6, 0))
    rhs = _generalized(kin, columns) + F.pad(tau, (6, 0))
    return torch.linalg.solve_ex(m + c.solve_shift, rhs)[0]


def forward_dynamics(model: Model3D, q: Tensor, qd: Tensor, action: Tensor,
                     hfield: tp.Optional[Heightfield] = None) -> tp.Tuple[Tensor, Tensor]:
    """qdd = M^-1 (tau + J_c^T f_contact + gravity - h), and the contact
    normal forces. A fixed base solves the joint block alone (qdd = 0 for the
    root)."""
    c, kin = _constants_and_kinematics(model, q)
    contact, fn = _contact_forces(model, c, kin, q, qd, hfield)
    tau = _joint_torques(model, c, q, qd, action)
    return _solve(model, c, kin, _mass_matrix(c, kin), _inertial_forces(c, kin, qd), contact,
                  tau), fn


def step(model: Model3D, q: Tensor, qd: Tensor, action: Tensor, dt: float, n_substeps: int,
         hfield: tp.Optional[Heightfield] = None) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Semi-implicit Euler with substeps; returns (q, qd, touch), touch the
    largest normal force of each contact over the substeps.

    Each substep is three device spans (``utils/trace.py``), which together
    hold every operation of the step: ``p3d_kinematics`` (pose, Jacobians,
    mass matrix, inertial forces), ``p3d_contacts`` (contact state and
    forces) and ``p3d_solve`` (joint torques, the generalized forces,
    ``solve_ex`` and the Euler update). The counter ``physics3d.substeps``
    advances by ``n_substeps``."""
    h = dt / n_substeps
    touch: tp.Optional[Tensor] = None
    for _ in range(n_substeps):
        with trace.device_span("p3d_kinematics", q.device):
            c, kin = _constants_and_kinematics(model, q)
            m = _mass_matrix(c, kin)
            inertial = _inertial_forces(c, kin, qd)
        with trace.device_span("p3d_contacts", q.device):
            contact, fn = _contact_forces(model, c, kin, q, qd, hfield)
            # the normal forces are >= 0: the first substep's are the running maximum
            touch = fn if touch is None else torch.maximum(touch, fn)
        with trace.device_span("p3d_solve", q.device):
            tau = _joint_torques(model, c, q, qd, action)
            qdd = _solve(model, c, kin, m, inertial, contact, tau)
            qd = torch.add(qd, qdd, alpha=h).clamp(-100.0, 100.0)
            q = torch.add(q, qd, alpha=h)
    trace.count("physics3d.substeps", n_substeps)
    assert touch is not None, "a step has at least one substep"
    return q, qd, touch


# ---------------------------------------------------------------- helpers

def box_inertia(mass: float, hx: float, hy: float, hz: float) -> tp.Tuple[float, float, float]:
    """Diagonal inertia of a solid box with half-extents (hx, hy, hz)."""
    return (mass * (hy ** 2 + hz ** 2) / 3.0,
            mass * (hx ** 2 + hz ** 2) / 3.0,
            mass * (hx ** 2 + hy ** 2) / 3.0)


def rod_inertia3(mass: float, length: float, radius: float,
                 axis: int) -> tp.Tuple[float, float, float]:
    """Capsule-as-cylinder inertia; ``axis`` is the capsule's long axis."""
    long_i = mass * radius ** 2 / 2.0
    perp_i = mass * (length ** 2 / 12.0 + radius ** 2 / 4.0)
    out = [perp_i, perp_i, perp_i]
    out[axis] = long_i
    return tuple(out)  # type: ignore[return-value]
