"""The inputs the benchmark makes from ``--seed``: the agent's weights and
a replay of synthetic episodes, both on the device, in a few large calls. Program and reference each get them from these functions; neither
takes them from the other.

Sub-seeds keep the streams apart: ``seed * 8 + k`` for the weights (1), the
replay (2), the trainer's generator (3) and the collector's (4).
"""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor
Leaves = tp.Sequence[tp.Tuple[str, tp.Tuple[int, ...]]]

WEIGHTS, REPLAY, TRAINER, COLLECTOR = 1, 2, 3, 4


def sub_seed(seed: int, stream: int) -> int:
    return seed * 8 + stream


def weights(leaves: Leaves, targets: tp.Mapping[str, str], seed: int,
            device: torch.device) -> tp.Dict[str, Tensor]:
    """Dense weights N(0, 1/fan_in), biases 0, LayerNorm scales 1, every
    target network equal to its online one. One normal draw for all dense
    weights, in the order of their names."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    online = sorted((k, s) for k, s in leaves
                    if not any(k.startswith(t + ".") for t in targets))
    dense = [(k, s) for k, s in online if len(s) == 2]
    flat = torch.randn(sum(a * b for _, (a, b) in dense), generator=gen, device=device)
    out: tp.Dict[str, Tensor] = {}
    at = 0
    for k, (rows, cols) in dense:
        out[k] = flat[at:at + rows * cols].view(rows, cols) / cols ** 0.5
        at += rows * cols
    for k, s in online:
        if k not in out:
            fill = 1.0 if ".LayerNorm_" in k and k.endswith(".weight") else 0.0
            out[k] = torch.full(s, fill, device=device)
    for k, _ in leaves:
        for target, src in targets.items():
            if k.startswith(target + "."):
                out[k] = out[src + k[len(target):]].clone()
    return out


def replay(episodes: int, length: int, widths: tp.Mapping[str, int], seed: int,
           device: torch.device,
           physics: tp.Optional[tp.Callable[..., Tensor]] = None) -> tp.Dict[str, Tensor]:
    """``episodes`` synthetic episodes of ``length`` steps in the
    environment's layout ([E, T+1, width] each): normal observations,
    uniform actions in [-1, 1], uniform rewards, discount 1, the physics
    columns (``physics(uniform, normal, width)`` where the environment gives
    them, normal values otherwise) and, where ``widths`` has a goal, normal
    goal columns."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, REPLAY))
    shape = (episodes, length + 1)

    def uniform(lo: float, hi: float, width: int) -> Tensor:
        return torch.rand(shape + (width,), generator=gen, device=device) * (hi - lo) + lo

    def normal(width: int) -> Tensor:
        return torch.randn(shape + (width,), generator=gen, device=device)

    columns = (physics(uniform, normal, widths["physics"]) if physics is not None
               else normal(widths["physics"]))
    out = {"observation": normal(widths["observation"]),
           "action": uniform(-1.0, 1.0, widths["action"]),
           "reward": uniform(0.0, 1.0, 1),
           "discount": torch.ones(shape + (1,), device=device),
           "physics": columns}
    if widths.get("goal"):
        out["goal"] = normal(widths["goal"])
    return out
