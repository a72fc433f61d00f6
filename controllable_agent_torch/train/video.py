"""Videos of evaluation rollouts (mirror of ``controllable_agent_tpu/train/video.py``).

Frames are drawn from the physics vector by a small numpy rasterizer per
domain: the gridworld's walls, goal and agent, the point-mass maze's walls
and mass, the planar skeletons of walker, cheetah and hopper, and an oblique
projection of the quadruped's and jaco's 3-D trees (jaco's target beside
it), from forward kinematics over the model's numpy constants
(``envs/physics2d.PlanarModel``, ``envs/physics3d.Model3D``). The drawing is
the JAX module's, line for line, so both give the same frames to the byte.
Nothing here runs on the device.

``VideoRecorder.save`` writes an animated PNG with the port's own encoder
(below), which needs nothing beyond numpy and zlib. The JAX module writes an
mp4 through imageio where an ffmpeg backend is present, else a GIF; this
one needs neither imageio nor ffmpeg.
"""

from __future__ import annotations

import struct
import typing as tp
import zlib
from pathlib import Path

import numpy as np


def _blank(h: int = 256, w: int = 256) -> np.ndarray:
    return np.full((h, w, 3), 245, np.uint8)


def _draw_disk(img: np.ndarray, cy: float, cx: float, r: float,
               color: tp.Tuple[int, int, int]) -> None:
    h, w, _ = img.shape
    ylo, yhi = max(0, int(cy - r) - 1), min(h, int(cy + r) + 2)
    xlo, xhi = max(0, int(cx - r) - 1), min(w, int(cx + r) + 2)
    if ylo >= yhi or xlo >= xhi:
        return
    y, x = np.ogrid[ylo:yhi, xlo:xhi]
    mask = (y - cy) ** 2 + (x - cx) ** 2 <= r ** 2
    img[ylo:yhi, xlo:xhi][mask] = color


def _draw_line(img: np.ndarray, y0: float, x0: float, y1: float, x1: float,
               color: tp.Tuple[int, int, int], width: int = 3) -> None:
    """A capsule (thick segment): one vectorised point-to-segment distance
    over the segment's bounding box."""
    h, w, _ = img.shape
    ylo = max(0, int(min(y0, y1) - width) - 1)
    yhi = min(h, int(max(y0, y1) + width) + 2)
    xlo = max(0, int(min(x0, x1) - width) - 1)
    xhi = min(w, int(max(x0, x1) + width) + 2)
    if ylo >= yhi or xlo >= xhi:
        return
    y, x = np.ogrid[ylo:yhi, xlo:xhi]
    dy, dx = y1 - y0, x1 - x0
    denom = dy * dy + dx * dx
    t = 0.0 if denom == 0 else np.clip(
        ((y - y0) * dy + (x - x0) * dx) / denom, 0.0, 1.0)
    dist2 = (y - (y0 + t * dy)) ** 2 + (x - (x0 + t * dx)) ** 2
    img[ylo:yhi, xlo:xhi][dist2 <= width ** 2] = color


def _fk2d(model: tp.Any, q: np.ndarray) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Planar forward kinematics in float64: body origins and angles."""
    q = np.asarray(q, np.float64)
    anchor = model.anchor
    nb = len(model.parent)
    origins = np.zeros((nb, 2))
    angles = np.zeros(nb)
    origins[0] = q[0:2]
    angles[0] = q[2]
    for b in range(1, nb):
        p = model.parent[b]
        c, s = np.cos(angles[p]), np.sin(angles[p])
        ax, az = anchor[b]
        origins[b] = origins[p] + (c * ax - s * az, s * ax + c * az)
        angles[b] = angles[p] + q[3 + b - 1]
    return origins, angles


def _fk3d(model: tp.Any, q: np.ndarray) -> np.ndarray:
    """3-D forward kinematics in float64: body origins."""
    q = np.asarray(q, np.float64)
    anchor = model.anchor
    axis = model.axis
    nb = len(model.parent)

    def euler_rot(e: np.ndarray) -> np.ndarray:
        cx, sx = np.cos(e[0]), np.sin(e[0])
        cy, sy = np.cos(e[1]), np.sin(e[1])
        cz, sz = np.cos(e[2]), np.sin(e[2])
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return rz @ ry @ rx

    def axis_rot(k: np.ndarray, a: float) -> np.ndarray:
        c, s = np.cos(a), np.sin(a)
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) * c + s * kx + (1 - c) * np.outer(k, k)

    origins = np.zeros((nb, 3))
    rots = np.zeros((nb, 3, 3))
    origins[0] = q[0:3]
    rots[0] = euler_rot(q[3:6])
    for b in range(1, nb):
        p = model.parent[b]
        origins[b] = origins[p] + rots[p] @ anchor[b]
        rots[b] = rots[p] @ axis_rot(axis[b], q[6 + b - 1])
    return origins


class _NpModel:
    """The kinematic constants of an environment's model, in numpy."""

    def __init__(self, model: tp.Any) -> None:
        self.parent = tuple(model.parent)
        self.ndof = model.ndof
        self.anchor = np.asarray(model.anchor)
        self.com = np.asarray(model.com)
        self.axis = np.asarray(model.axis) if hasattr(model, "axis") else None


class Renderer:
    """physics vector -> RGB frame [256, 256, 3] uint8, per domain."""

    def __init__(self, domain: str, env: tp.Any = None) -> None:
        self.domain = domain
        self.model: tp.Optional[_NpModel] = None
        if env is not None and hasattr(env, "model"):
            self.model = _NpModel(env.model)
        # the gridworld's walls
        self.layout = np.asarray(env.layout) if hasattr(env, "layout") else None

    def __call__(self, physics: np.ndarray) -> np.ndarray:
        physics = np.asarray(physics)
        if self.domain == "grid":
            return self._grid(physics)
        if self.domain == "point_mass_maze":
            return self._maze(physics)
        if self.domain in ("quadruped", "jaco"):
            return self._body3d(physics)
        if self.model is None:  # no kinematic model
            return _blank()
        return self._locomotion(physics)

    def _grid(self, physics: np.ndarray) -> np.ndarray:
        img = _blank()
        cell = 256 // 10
        if self.layout is not None:
            for (y, x) in np.argwhere(self.layout == -1):
                img[y * cell:(y + 1) * cell, x * cell:(x + 1) * cell] = (120, 125, 130)
        ay, ax, gy, gx = physics[:4]
        img[int(gy) * cell:int(gy + 1) * cell,
            int(gx) * cell:int(gx + 1) * cell] = (90, 180, 90)
        _draw_disk(img, (ay + 0.5) * cell, (ax + 0.5) * cell, cell // 3, (230, 120, 40))
        return img

    def _maze(self, physics: np.ndarray) -> np.ndarray:
        img = _blank()
        scale = 256 / 0.6  # the arena is ±0.3

        def to_px(x: float, y: float) -> tp.Tuple[float, float]:
            return (128 - y * scale, 128 + x * scale)

        # the cross walls (half-length 0.18)
        for (x0, y0, x1, y1) in [(-0.18, 0, 0.18, 0), (0, -0.18, 0, 0.18)]:
            py0, px0 = to_px(x0, y0)
            py1, px1 = to_px(x1, y1)
            _draw_line(img, py0, px0, py1, px1, (120, 125, 130), 4)
        py, px = to_px(physics[0], physics[1])
        _draw_disk(img, py, px, 6, (230, 120, 40))
        return img

    def _locomotion(self, physics: np.ndarray) -> np.ndarray:
        img = _blank()
        model = self.model
        assert model is not None
        origins, angles = _fk2d(model, physics[:model.ndof])
        scale = 80.0
        cx = 128 - origins[0, 0] * scale  # the camera follows the root
        ground_y = 220.0

        def to_px(x: float, z: float) -> tp.Tuple[float, float]:
            return (ground_y - z * scale, cx + x * scale)

        img[int(ground_y):, :] = (210, 205, 195)
        # each body as a segment from its origin through twice its COM offset
        coms = np.asarray(origins) + np.stack(
            [np.cos(angles) * model.com[:, 0]
             - np.sin(angles) * model.com[:, 1],
             np.sin(angles) * model.com[:, 0]
             + np.cos(angles) * model.com[:, 1]], axis=1)
        for b in range(len(origins)):
            end = origins[b] + 2 * (coms[b] - origins[b])
            y0, x0 = to_px(*origins[b])
            y1, x1 = to_px(*end)
            _draw_line(img, y0, x0, y1, x1, (60, 90, 160), 4)
        return img

    def _body3d(self, physics: np.ndarray) -> np.ndarray:
        """The quadruped and jaco: an oblique projection of the 3-D tree (x
        to the right, y into the screen with a shear of 0.4, z up)."""
        img = _blank()
        model = self.model
        assert model is not None
        origins = _fk3d(model, physics[:model.ndof])
        scale = 120.0 if self.domain == "quadruped" else 220.0
        shear = 0.4
        root = origins[0]
        ground_y = 220.0

        def to_px(p: np.ndarray) -> tp.Tuple[float, float]:
            sx = (p[0] - root[0]) + shear * (p[1] - root[1])
            sz = p[2] + shear * 0.5 * (p[1] - root[1])
            return (ground_y - sz * scale, 128 + sx * scale)

        img[int(ground_y):, :] = (210, 205, 195)
        for b in range(1, len(origins)):
            y0, x0 = to_px(origins[model.parent[b]])
            y1, x1 = to_px(origins[b])
            _draw_line(img, y0, x0, y1, x1, (60, 90, 160), 4)
        _draw_disk(img, *to_px(origins[0]), 7, (40, 60, 120))
        if self.domain == "jaco":
            # the target, from the physics vector's tail
            target = physics[2 * model.ndof:2 * model.ndof + 3]
            if target.size == 3:
                _draw_disk(img, *to_px(target), 5, (200, 60, 60))
        return img


def _indexed(frames: tp.Sequence[np.ndarray]) -> tp.Tuple[np.ndarray, np.ndarray]:
    """RGB uint8 frames of one size, of at most 256 colours in all (the
    renderer draws a handful) -> palette indices [F, H, W] and the palette
    [colours, 3]."""
    rgb = np.stack([np.asarray(f, np.uint8) for f in frames]).astype(np.int32)
    packed = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    del rgb
    present = np.zeros(1 << 24, bool)
    present[packed] = True
    colours = np.flatnonzero(present)
    if len(colours) > 256:
        raise ValueError(f"{len(colours)} colours do not fit a palette of 256")
    lookup = np.zeros(1 << 24, np.uint8)
    lookup[colours] = np.arange(len(colours))
    palette = ((colours[:, None] >> np.array([16, 8, 0])) & 0xFF).astype(np.uint8)
    return lookup[packed], palette


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: tp.Union[str, Path], frames: tp.Sequence[np.ndarray], fps: int) -> None:
    """An animated PNG (APNG) of RGB uint8 frames of one size, of at most
    256 colours in all, looping: one palette, each frame's rows deflated by
    zlib (a 250-frame walker video is a few hundred kB)."""
    indices, palette = _indexed(frames)
    count, h, w = indices.shape
    out = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)),
           _chunk(b"PLTE", palette.tobytes()), _chunk(b"acTL", struct.pack(">II", count, 0))]
    sequence = 0
    for i, frame in enumerate(indices):
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", sequence, w, h, 0, 0, 1, fps, 0, 0)))
        sequence += 1
        # every row starts with its filter type, 0 (none)
        data = zlib.compress(np.concatenate([np.zeros((h, 1), np.uint8), frame], 1).tobytes())
        if i == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", sequence) + data))
            sequence += 1
    out.append(_chunk(b"IEND", b""))
    Path(path).write_bytes(b"".join(out))


class VideoRecorder:
    """Frames of a trajectory, saved under ``root_dir/eval_video``."""

    def __init__(self, root_dir: tp.Optional[tp.Union[str, Path]],
                 renderer: Renderer, enabled: bool = True, fps: int = 20) -> None:
        self.save_dir: tp.Optional[Path] = None
        if root_dir is not None:
            self.save_dir = Path(root_dir) / "eval_video"
            self.save_dir.mkdir(exist_ok=True, parents=True)
        self.renderer = renderer
        self.enabled = enabled and self.save_dir is not None
        self.fps = fps
        self.frames: tp.List[np.ndarray] = []

    def record_trajectory(self, physics_traj: np.ndarray) -> None:
        """Record a whole [T, physics_dim] trajectory."""
        if self.enabled:
            for row in np.asarray(physics_traj):
                self.frames.append(self.renderer(row))

    def save(self, file_name: str) -> tp.Optional[Path]:
        """Write the frames as ``file_name`` with its suffix made ``.png``."""
        if not (self.enabled and self.frames):
            return None
        assert self.save_dir is not None
        path = (self.save_dir / file_name).with_suffix(".png")
        write_png(path, self.frames, self.fps)
        return path
