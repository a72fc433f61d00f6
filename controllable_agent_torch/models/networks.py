"""Neural network modules (mirror of ``controllable_agent_tpu/models/networks.py``).

The string-spec ``MLP`` language, the two-tower ``Actor`` and twin-head
``ForwardMap``, the sqrt(d)-L2-normalized ``BackwardMap``, the
``DiagGaussianActor`` and ``IdentityMap``.

Conventions kept from the JAX package:
  * orthogonal weight init and zero bias; LayerNorm eps 1e-5;
  * parameters stay float32 while ``dtype=torch.bfloat16`` runs the layers
    under ``torch.autocast``, so the matmuls run in bf16 and the networks
    return bf16;
  * submodule names follow flax's creation-order names (each network keeps
    its MLPs in ``mlps[i]`` for flax's ``MLP_i``; an MLP registers its
    layers as ``Dense_k`` / ``LayerNorm_k``), so ``convert.py`` maps a flax
    param tree onto a state dict by name alone.
"""

from __future__ import annotations

import contextlib
import math
import typing as tp

import torch
from torch import nn

Layer = tp.Union[int, str]


def l2_normalize(x: torch.Tensor, scale_sqrt_dim: bool = True, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics (norm clamped at eps), optionally scaled by
    sqrt(dim)."""
    y = x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
    if scale_sqrt_dim:
        y = math.sqrt(x.shape[dim]) * y
    return y


def _autocast(dtype: torch.dtype, device: torch.device) -> tp.ContextManager:
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype)


class MLP(nn.Module):
    """String-spec MLP: layers like (512, "ntanh", 512, "irelu", 50).

    ints are Linear layers; "relu"/"irelu" ReLU, "ntanh" LayerNorm+Tanh,
    "layernorm", "tanh", and "L2" (sqrt(d)-scaled L2 normalization).
    """

    def __init__(self, in_dim: int, layers: tp.Sequence[Layer]) -> None:
        super().__init__()
        self._plan: tp.List[tp.Tuple[str, tp.Optional[str]]] = []
        dim, n_dense, n_norm = in_dim, 0, 0
        for layer in layers:
            if isinstance(layer, str):
                if layer in ("ntanh", "layernorm"):
                    name = f"LayerNorm_{n_norm}"
                    self.add_module(name, nn.LayerNorm(dim, eps=1e-5))
                    n_norm += 1
                    self._plan.append((layer, name))
                elif layer in ("relu", "irelu", "tanh", "L2"):
                    self._plan.append((layer, None))
                else:
                    raise ValueError(f"Unknown non-linearity {layer}")
            else:
                name = f"Dense_{n_dense}"
                linear = nn.Linear(dim, int(layer))
                nn.init.orthogonal_(linear.weight)
                nn.init.zeros_(linear.bias)
                self.add_module(name, linear)
                n_dense += 1
                dim = int(layer)
                self._plan.append(("dense", name))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for kind, name in self._plan:
            if kind in ("dense", "layernorm"):
                x = self.get_submodule(name)(x)
            elif kind == "ntanh":
                x = torch.tanh(self.get_submodule(name)(x))
            elif kind in ("relu", "irelu"):
                x = torch.relu(x)
            elif kind == "tanh":
                x = torch.tanh(x)
            else:  # "L2"
                x = l2_normalize(x)
        return x


class _Net(nn.Module):
    """Base of the networks: holds the MLPs in flax creation order and the
    compute dtype."""

    def __init__(self, mlps: tp.Sequence[MLP], dtype: torch.dtype) -> None:
        super().__init__()
        self.mlps = nn.ModuleList(mlps)
        self.dtype = dtype

    def _compute(self, x: torch.Tensor) -> tp.ContextManager:
        return _autocast(self.dtype, x.device)


class Actor(_Net):
    """Deterministic-mean actor; returns tanh(mu)."""

    def __init__(self, obs_dim: int, z_dim: int, action_dim: int,
                 feature_dim: int, hidden_dim: int, preprocess: bool = False,
                 add_trunk: bool = True, dtype: torch.dtype = torch.float32) -> None:
        if preprocess:
            mlps = [MLP(obs_dim + z_dim, (hidden_dim, "ntanh", feature_dim, "irelu")),
                    MLP(obs_dim, (hidden_dim, "ntanh", feature_dim, "irelu"))]
            h_dim = 2 * feature_dim
            if add_trunk:
                mlps.append(MLP(h_dim, (hidden_dim, "irelu")))
                h_dim = hidden_dim
        else:
            mlps = [MLP(obs_dim + z_dim, (hidden_dim, "ntanh", hidden_dim, "irelu",
                                          hidden_dim, "irelu"))]
            h_dim = hidden_dim
        mlps.append(MLP(h_dim, (hidden_dim, "irelu", action_dim)))
        super().__init__(mlps, dtype)
        self.z_dim, self.preprocess, self.add_trunk = z_dim, preprocess, add_trunk

    def forward(self, obs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        assert z.shape[-1] == self.z_dim
        with self._compute(obs):
            obs_z = torch.cat([obs, z], dim=-1)
            if self.preprocess:
                h = torch.cat([self.mlps[1](obs), self.mlps[0](obs_z)], dim=-1)
                if self.add_trunk:
                    h = self.mlps[2](h)
            else:
                h = self.mlps[0](obs_z)
            return torch.tanh(self.mlps[-1](h))


class DiagGaussianActor(_Net):
    """Gaussian actor head returning (mu, std) for a SquashedNormal."""

    def __init__(self, obs_dim: int, z_dim: int, action_dim: int, hidden_dim: int,
                 log_std_bounds: tp.Tuple[float, float] = (-5.0, 2.0),
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__([MLP(obs_dim + z_dim, (hidden_dim, "ntanh", hidden_dim,
                                                "relu", 2 * action_dim))], dtype)
        self.z_dim = z_dim
        self.log_std_bounds = tuple(log_std_bounds)

    def forward(self, obs: torch.Tensor, z: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        assert z.shape[-1] == self.z_dim
        with self._compute(obs):
            out = self.mlps[0](torch.cat([obs, z], dim=-1))
            mu, log_std = out.chunk(2, dim=-1)
            log_std = torch.tanh(log_std)
            lo, hi = self.log_std_bounds
            log_std = lo + 0.5 * (hi - lo) * (log_std + 1.0)
            return mu, log_std.exp()


class ForwardMap(_Net):
    """Twin forward maps F1, F2: (obs, z, action) -> two [B, z_dim] embeddings."""

    def __init__(self, obs_dim: int, z_dim: int, action_dim: int,
                 feature_dim: int, hidden_dim: int, preprocess: bool = False,
                 add_trunk: bool = True, dtype: torch.dtype = torch.float32) -> None:
        if preprocess:
            mlps = [MLP(obs_dim + action_dim, (hidden_dim, "ntanh", feature_dim, "irelu")),
                    MLP(obs_dim + z_dim, (hidden_dim, "ntanh", feature_dim, "irelu"))]
            h_dim = 2 * feature_dim
            if add_trunk:
                mlps.append(MLP(h_dim, (hidden_dim, "irelu")))
                h_dim = hidden_dim
        else:
            mlps = [MLP(obs_dim + z_dim + action_dim,
                        (hidden_dim, "ntanh", hidden_dim, "irelu", hidden_dim, "irelu"))]
            h_dim = hidden_dim
        mlps += [MLP(h_dim, (hidden_dim, "irelu", z_dim)),
                 MLP(h_dim, (hidden_dim, "irelu", z_dim))]
        super().__init__(mlps, dtype)
        self.z_dim, self.preprocess, self.add_trunk = z_dim, preprocess, add_trunk

    def forward(self, obs: torch.Tensor, z: torch.Tensor, action: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        assert z.shape[-1] == self.z_dim
        with self._compute(obs):
            if self.preprocess:
                h = torch.cat([self.mlps[0](torch.cat([obs, action], dim=-1)),
                               self.mlps[1](torch.cat([obs, z], dim=-1))], dim=-1)
                if self.add_trunk:
                    h = self.mlps[2](h)
            else:
                h = self.mlps[0](torch.cat([obs, z, action], dim=-1))
            return self.mlps[-2](h), self.mlps[-1](h)


class BackwardMap(_Net):
    """Backward map B: goal -> [B, z_dim], optionally sqrt(d)-L2-normalized."""

    def __init__(self, goal_dim: int, z_dim: int, hidden_dim: int,
                 norm_z: bool = True, dtype: torch.dtype = torch.float32) -> None:
        super().__init__([MLP(goal_dim, (hidden_dim, "ntanh", hidden_dim, "relu",
                                         z_dim))], dtype)
        self.norm_z = norm_z

    def forward(self, goal: torch.Tensor) -> torch.Tensor:
        with self._compute(goal):
            b = self.mlps[0](goal)
            if self.norm_z:
                b = l2_normalize(b)
            return b


class IdentityMap(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
