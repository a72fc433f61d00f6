"""Pixel observations rendered from the physics state (mirror of
``controllable_agent_tpu/envs/pixels.py``).

Frames are rasterized on the device as a function of the physics vector,
batched over the ``[E]`` environments like every environment of the port:
the point-mass maze as walls, a disk and a background; the planar walker,
cheetah and hopper as a capsule stick figure from forward kinematics, the
camera following the root's x at height 0.65. The JAX package renders no
other body, and neither does the port: any other task raises ``ValueError``.

Observations stay flat, ``H * W * stack * 3`` uint8 columns in the JAX
order (height, width, then the stacked frames' channels); ``spec.obs_shape``
is ``(H, W, stack * 3)`` and ``spec.obs_dtype`` uint8, so the replay stores
uint8 as the JAX replay does.

``PixelWrapper`` holds the stack as uint8 in that observation layout,
``[E, H, W, stack, 3]``: the JAX wrapper keeps float frames and truncates
their concatenation to uint8, which gives the same bytes, since each frame
is truncated on its own either way. The observation is then a reshape of
the state, and a stack is a quarter of the float one. A step reads nothing
from the host, and the constants (the pixel grid, the bodies' pairs) are
built once per device, so a captured control step holds the render.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from .base import Environment, TimeStep

Tensor = torch.Tensor
FrameFn = tp.Callable[[Tensor], Tensor]

# the point-mass maze's view: a square of this half-width around the origin
MAZE_HALF_EXTENT = 0.32
# the planar bodies' view: this half-width around (root x, CAMERA_HEIGHT)
LOCOMOTION_HALF_EXTENT, CAMERA_HEIGHT = 1.0, 0.65


# linspace(-half, half, size) per (size, half, device), built once: in float64
# on the host and rounded to float32, so every device renders from the same
# pixel coordinates
_LINSPACES: tp.Dict[tp.Tuple[int, float, torch.device], Tensor] = {}


def _linspace(size: int, half_extent: float, device: torch.device) -> Tensor:
    key = (size, half_extent, torch.device(device))
    if key not in _LINSPACES:
        lin = torch.linspace(-half_extent, half_extent, size, dtype=torch.float64)
        _LINSPACES[key] = lin.float().to(device)
    return _LINSPACES[key]


def _pixel_grid(size: int, half_extent: float, center: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """World (x, y) of each pixel, [E, size, size] each for centers [E, 2];
    row 0 is the top (+y)."""
    lin = _linspace(size, half_extent, center.device)
    xs = center[:, 0, None, None] + lin[None, None, :]
    ys = center[:, 1, None, None] - lin[None, :, None]
    shape = (center.shape[0], size, size)
    return xs.expand(shape), ys.expand(shape)


def _splat_disks(px: Tensor, py: Tensor, centers: Tensor, radii: Tensor) -> Tensor:
    """Soft coverage in [0, 1] of disks: centers [E, K, 2], radii [K];
    pixels [E, H, W]."""
    d = torch.sqrt((px[..., None] - centers[:, None, None, :, 0]) ** 2
                   + (py[..., None] - centers[:, None, None, :, 1]) ** 2)
    # a soft edge of ~2 pixels, scaled to the radius
    cov = torch.sigmoid((radii - d) / (0.15 * radii + 1e-8))
    return cov.amax(-1)


def _splat_segments(px: Tensor, py: Tensor, a: Tensor, b: Tensor, radius: float) -> Tensor:
    """Soft coverage of capsule segments a -> b, [E, S, 2] each."""
    ab = b - a  # [E, S, 2]
    ab_x, ab_y = ab[:, None, None, :, 0], ab[:, None, None, :, 1]
    ap_x = px[..., None] - a[:, None, None, :, 0]
    ap_y = py[..., None] - a[:, None, None, :, 1]
    denom = (ab * ab).sum(-1)[:, None, None, :] + 1e-8
    t = ((ap_x * ab_x + ap_y * ab_y) / denom).clamp(0.0, 1.0)
    dx = ap_x - t * ab_x
    dy = ap_y - t * ab_y
    d = torch.sqrt(dx * dx + dy * dy)
    cov = torch.sigmoid((radius - d) / (0.15 * radius))
    return cov.amax(-1)


def pointmass_frame(physics: Tensor, size: int = 84) -> Tensor:
    """[E, size, size, 3] float frames in [0, 255] of the point-mass maze:
    the outer border and the cross walls with their door gaps
    (``envs/pointmass.py``'s arena) and the mass as a disk. The target
    comes from the task, not the physics, so frames are task-agnostic."""
    center = physics.new_zeros((physics.shape[0], 2))
    px, py = _pixel_grid(size, MAZE_HALF_EXTENT, center)
    border = (px.abs() > 0.3) | (py.abs() > 0.3)
    cross_x = (px.abs() < 0.02) & (py.abs() < 0.18)
    cross_y = (py.abs() < 0.02) & (px.abs() < 0.18)
    walls = (border | cross_x | cross_y).float()
    mass = _splat_disks(px, py, physics[:, None, 0:2], physics.new_full((1,), 0.02))
    r = (0.25 * walls + mass).clamp(0.0, 1.0)
    g = (0.25 * walls + 0.3 * mass).clamp(0.0, 1.0)
    bkg = 0.08
    frame = torch.stack([r.clamp_min(bkg), g.clamp_min(bkg), (0.25 * walls).clamp_min(bkg)], -1)
    return frame * 255.0


def make_locomotion_frame_fn(model: tp.Any, size: int = 84) -> FrameFn:
    """Stick-figure renderer of a planar model (walker, cheetah, hopper):
    capsules from each body's parent's origin to its own (forward
    kinematics), a disk at the root, the ground below z = 0 and the camera
    on the root's x. Returns physics [E, P] -> [E, size, size, 3] frames."""
    from . import physics2d as p2d

    parents = [model.parent[b] for b in range(1, model.nb)]
    children = list(range(1, model.nb))
    pairs: tp.Dict[torch.device, tp.Tuple[Tensor, Tensor]] = {}

    def frame_fn(physics: Tensor) -> Tensor:
        device = physics.device
        if device not in pairs:
            pairs[device] = (torch.tensor(parents, device=device),
                             torch.tensor(children, device=device))
        parent_idx, child_idx = pairs[device]
        q = physics[:, :model.ndof]
        origins, _ = p2d.fk(model, q)  # [E, nb, 2]
        center = torch.stack([q[:, 0], torch.full_like(q[:, 0], CAMERA_HEIGHT)], -1)
        px, pz = _pixel_grid(size, LOCOMOTION_HALF_EXTENT, center)
        body = _splat_segments(px, pz, origins[:, parent_idx], origins[:, child_idx], 0.06)
        torso = _splat_disks(px, pz, origins[:, :1], physics.new_full((1,), 0.09))
        fig = (body + torso).clamp(0.0, 1.0)
        ground = (pz < 0.0).float() * 0.35
        bkg = 0.08
        r = torch.maximum(fig, ground * 0.8).clamp_min(bkg)
        g = torch.maximum(0.8 * fig, ground).clamp_min(bkg)
        bl = torch.maximum(0.6 * fig, ground * 0.5).clamp_min(bkg)
        return torch.stack([r, g, bl], -1) * 255.0

    return frame_fn


@dataclasses.dataclass(frozen=True)
class PixelState:
    inner: tp.Any
    frames: Tensor  # [E, H, W, stack, C] uint8, the newest frame last


class PixelWrapper(Environment):
    """A state environment with rendered pixel observations and a frame
    stack. ``frame_fn``: physics [E, P] -> [E, H, W, C] float frames in [0,
    255]. Reset fills the stack with the first frame; each step drops the
    oldest frame and appends the new one. The task's reward, the physics and
    the goal features pass through."""

    def __init__(self, env: Environment, frame_fn: FrameFn, size: int = 84,
                 frame_stack: int = 3) -> None:
        self.env = env
        self.frame_fn = frame_fn
        self.size = size
        self.frame_stack = frame_stack
        shape = (size, size, 3 * frame_stack)
        self.spec = env.spec.replace(obs_dim=shape[0] * shape[1] * shape[2], obs_shape=shape,
                                     obs_dtype=torch.uint8)

    # relabeling still reads the physics (the point-mass rewards take the
    # action too, hence *args)
    def reward_from_physics(self, physics: Tensor, *args: Tensor) -> Tensor:
        return self.env.reward_from_physics(physics, *args)  # type: ignore[attr-defined]

    def goal_features(self, physics: Tensor) -> Tensor:
        return self.env.goal_features(physics)  # type: ignore[attr-defined]

    def _frame(self, physics: Tensor) -> Tensor:
        # float -> uint8 truncates toward zero, as astype(jnp.uint8) does
        return self.frame_fn(physics).to(torch.uint8)

    @staticmethod
    def _obs(frames: Tensor) -> Tensor:
        return frames.reshape(frames.shape[0], -1)

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> tp.Tuple[PixelState, TimeStep]:
        inner, ts = self.env.reset(generator, num_envs)
        frame = self._frame(ts.physics)
        frames = frame.unsqueeze(3).repeat(1, 1, 1, self.frame_stack, 1).contiguous()
        return PixelState(inner=inner, frames=frames), ts.replace(observation=self._obs(frames))

    def step(self, state: PixelState, action: Tensor) -> tp.Tuple[PixelState, TimeStep]:
        inner, ts = self.env.step(state.inner, action)
        frame = self._frame(ts.physics)
        frames = torch.cat([state.frames[:, :, :, 1:], frame.unsqueeze(3)], 3)
        return PixelState(inner=inner, frames=frames), ts.replace(observation=self._obs(frames))


def make_pixel_env(task: str, size: int = 84, frame_stack: int = 3,
                   episode_length: tp.Optional[int] = None) -> PixelWrapper:
    """The pixel variant of a state environment by task name: the
    point-mass maze and the planar walker, cheetah and hopper."""
    from ..train.workspace import make_env
    env = make_env(task, episode_length)
    domain = task.split("_", 1)[0]
    if task.startswith("point_mass_maze_"):
        frame_fn: FrameFn = lambda p: pointmass_frame(p, size)  # noqa: E731
    elif domain in ("walker", "cheetah", "hopper"):
        frame_fn = make_locomotion_frame_fn(env.model, size)  # type: ignore[attr-defined]
    else:
        raise ValueError(f"No pixel renderer for task {task!r}")
    return PixelWrapper(env, frame_fn, size=size, frame_stack=frame_stack)
