"""Random-shift image augmentation, DrQ's (mirror of
``controllable_agent_tpu/ops/augment.py``).

Each image is edge-padded by ``pad`` and cropped back to its size at an
integer offset in [0, 2 pad]: an exact translation, no interpolation. Both
steps are one gather here: the crop of the padded image at offset s reads
row ``clamp(r + s - pad, 0, H - 1)`` of the image itself, and so for the
columns. The shifts are an explicit ``[B, 2]`` int64 tensor that the caller
draws (``DDPGNoise``), so a captured update draws fresh ones on every replay
and a parity test hands in the JAX update's own.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def draw_shifts(n: int, pad: int, generator: torch.Generator,
                device: torch.device) -> Tensor:
    """[n, 2] int64 offsets (row, column) uniform in [0, 2 pad], as
    ``jax.random.randint(key, (n, 2), 0, 2 * pad + 1)`` draws them."""
    return torch.randint(0, 2 * pad + 1, (n, 2), generator=generator, device=device)


def random_shift_aug(imgs: Tensor, shifts: Tensor, pad: int = 4) -> Tensor:
    """Translate each image of ``imgs`` [B, H, W, C] by ``shifts`` [B, 2] -
    ``pad`` pixels, edges repeated. Any dtype; the result keeps it."""
    b, h, w, _ = imgs.shape
    rows = (shifts[:, 0, None] - pad + torch.arange(h, device=imgs.device)).clamp(0, h - 1)
    cols = (shifts[:, 1, None] - pad + torch.arange(w, device=imgs.device)).clamp(0, w - 1)
    batch = torch.arange(b, device=imgs.device)
    return imgs[batch[:, None, None], rows[:, :, None], cols[:, None, :]]
