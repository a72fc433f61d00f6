"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A missing
card is an error, never a silent switch to the CPU: a run that measures or
trains on the wrong device must not look like one that did not.
"""

from __future__ import annotations

import subprocess
import typing as tp

import torch

DeviceLike = tp.Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def card_name_and_power_limit() -> str:
    """The first card as ``nvidia-smi`` names it, e.g. "NVIDIA H100 80GB
    HBM3, 700.00 W": every measurement is reported beside it, because a
    card set below its maximum power runs slower under load."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
