"""The online collector's random draws, made again from the collector's
seed.

The program's collector draws from one ``torch.Generator`` on the device,
call after call: each environment's z, the reset, then at each control step
the z resample's and the policy's draws. The reference makes the same
calls, with the same shapes and dtypes and in the same order, on a
generator seeded alike, so it gets the same numbers. (The updates' rows and
noise are not made again: the check takes them from the program and holds
them to the data and to their distributions, ``check.py``.)
"""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor


def collector_start(gen: torch.Generator, n: int, z_dim: int, joints: int,
                    device: torch.device) -> tp.Tuple[Tensor, Tensor]:
    """A collection's first draws: each environment's z normal, one at a
    time, then the reset's uniform over the joints' ranges."""
    normals = torch.cat([torch.randn((1, z_dim), generator=gen, device=device)
                         for _ in range(n)])
    return normals, torch.rand((n, joints), generator=gen, device=device)


def collector_step(gen: torch.Generator, n: int, z_dim: int, action_dim: int,
                   device: torch.device) -> tp.Dict[str, Tensor]:
    """One collector step's draws: the z resample's uniform and normal, the
    policy's normal and its uniform (exploration)."""
    return {"meta_uniform": torch.rand((n, 1), generator=gen, device=device),
            "z_normal": torch.randn((n, z_dim), generator=gen, device=device),
            "act_normal": torch.randn((n, action_dim), generator=gen, device=device),
            "act_uniform": torch.rand((n, action_dim), generator=gen, device=device)}
