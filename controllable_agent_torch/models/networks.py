"""Neural network modules (mirror of ``controllable_agent_tpu/models/networks.py``).

The string-spec ``MLP`` language, the two-tower ``Actor`` and twin-head
``ForwardMap``, the sqrt(d)-L2-normalized ``BackwardMap``, the
``DiagGaussianActor``, ``IdentityMap`` and the convolutional
``PixelEncoder``.

Conventions kept from the JAX package:
  * orthogonal weight init and zero bias; LayerNorm eps 1e-5;
  * parameters stay float32 while ``dtype=torch.bfloat16`` runs the layers
    under ``torch.autocast``, so the matmuls run in bf16 and the networks
    return bf16;
  * such a network's ``Dense`` layers keep bf16 compute copies of their
    weight and bias (``optim.Bf16Copy``) and run ``F.linear`` on them, so
    autocast finds both already bf16 and casts neither at a use; the copies
    take the layers' gradients (bf16), which ``optim.Adam`` reads, and Adam
    and the soft-update write them with the parameters. They are not
    parameters or buffers: not in ``parameters()`` or ``state_dict()``.
    Activations are cast and LayerNorm runs in float32 as autocast does;
    a float32 network keeps no copy;
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
import torch.nn.functional as F
from torch import nn

from .. import optim

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


class Dense(nn.Linear):
    """``nn.Linear`` that, in a network computing in bfloat16 with float32
    parameters, holds bfloat16 compute copies of its weight and bias
    (``bf16``, an ``optim.Bf16Copy`` each) and computes ``F.linear`` on them.
    The copies follow the parameters: after a move (``.to``) each copy is
    the same ``Bf16Copy``, its tensor allocated anew only where the device
    changed, stale until the next use refreshes it; a parameter written in
    place makes its copy stale too (``Bf16Copy.stale``). Every use checks,
    and refreshes what is stale."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__(in_features, out_features)
        self.compute_dtype = torch.float32
        self.bf16: tp.Optional[tp.List[optim.Bf16Copy]] = None

    def compute_in(self, dtype: torch.dtype) -> None:
        """Run in ``dtype``: with copies where it is bfloat16 and the
        parameters are float32, without where not."""
        self.compute_dtype = dtype
        params = [p for p in (self.weight, self.bias) if p is not None]
        keep = dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in params)
        if not keep:
            self.bf16 = None
        elif self.bf16 is None:
            self.bf16 = [optim.Bf16Copy(p) for p in params]
        else:
            for c, p in zip(self.bf16, params):
                c.follow(p)

    def _apply(self, fn: tp.Any, recurse: bool = True) -> "Dense":
        super()._apply(fn, recurse)
        self.compute_in(self.compute_dtype)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bf16 is None:
            return super().forward(x)
        weight, *bias = optim.use_copies(self.bf16)
        return F.linear(x, weight, bias[0] if bias else None)


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
                linear = Dense(dim, int(layer))
                nn.init.orthogonal_(linear.weight)
                nn.init.zeros_(linear.bias)
                self.add_module(name, linear)
                n_dense += 1
                dim = int(layer)
                self._plan.append(("dense", name))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_floating_point():  # uint8 frames, as flax's Dense promotes them
            x = x.float()
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
    compute dtype, which its ``Dense`` layers take (with bf16 copies of
    their weights where it is bfloat16)."""

    def __init__(self, mlps: tp.Sequence[MLP], dtype: torch.dtype) -> None:
        super().__init__()
        self.mlps = nn.ModuleList(mlps)
        self.dtype = dtype
        for m in self.modules():
            if isinstance(m, Dense):
                m.compute_in(dtype)

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


class DiscreteForwardMap(_Net):
    """Twin forward maps for discrete actions: (obs, z) -> two [B, z_dim,
    n_actions] tensors, one F per action."""

    def __init__(self, obs_dim: int, z_dim: int, n_actions: int, feature_dim: int,
                 hidden_dim: int, preprocess: bool = False, add_trunk: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        if preprocess:
            mlps = [MLP(obs_dim, (hidden_dim, "ntanh", feature_dim, "irelu")),
                    MLP(feature_dim + z_dim, (hidden_dim, "ntanh", feature_dim, "irelu"))]
            h_dim = 2 * feature_dim
            if add_trunk:
                mlps.append(MLP(h_dim, (hidden_dim, "irelu")))
                h_dim = hidden_dim
        else:
            mlps = [MLP(obs_dim + z_dim,
                        (hidden_dim, "ntanh", hidden_dim, "irelu", hidden_dim, "irelu"))]
            h_dim = hidden_dim
        mlps += [MLP(h_dim, (hidden_dim, "irelu", z_dim * n_actions)),
                 MLP(h_dim, (hidden_dim, "irelu", z_dim * n_actions))]
        super().__init__(mlps, dtype)
        self.z_dim, self.n_actions = z_dim, n_actions
        self.preprocess, self.add_trunk = preprocess, add_trunk

    def forward(self, obs: torch.Tensor, z: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        assert z.shape[-1] == self.z_dim
        with self._compute(obs):
            if self.preprocess:
                obs_emb = self.mlps[0](obs)
                h = torch.cat([obs_emb, self.mlps[1](torch.cat([obs_emb, z], dim=-1))], dim=-1)
                if self.add_trunk:
                    h = self.mlps[2](h)
            else:
                h = self.mlps[0](torch.cat([obs, z], dim=-1))
            shape = h.shape[:-1] + (self.z_dim, self.n_actions)
            return self.mlps[-2](h).reshape(shape), self.mlps[-1](h).reshape(shape)


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


def conv_repr_dim(h: int, w: int) -> int:
    """Width of ``PixelEncoder``'s output for h x w frames (3x3 VALID
    convolutions, strides 2, 1, 1, 1): 39,200 for 84 x 84."""
    oh, ow = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    return 32 * (oh - 6) * (ow - 6)


class PixelEncoder(nn.Module):
    """Four 3x3 VALID convolutions of 32 channels, strides 2, 1, 1, 1, a
    ReLU after each, on raw pixels scaled to ``x / 255 - 0.5``; returns
    float32 features.

    The JAX encoder is NHWC and flattens height, width, channels in that
    order, and the trunk after it is indexed in that order. Here the
    convolutions run NCHW (cuDNN's layout), and the output is permuted back
    to NHWC before it is flattened, so the features come in the JAX order
    and the trunk's weights convert unchanged. The layers are named
    ``Conv_k`` as flax names them; ``convert.py`` turns a flax kernel [3, 3,
    in, out] into a weight [out, in, 3, 3].
    """

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.strides = (2, 1, 1, 1)
        channels = in_channels
        for k, stride in enumerate(self.strides):
            conv = nn.Conv2d(channels, 32, 3, stride=stride)
            nn.init.orthogonal_(conv.weight)
            nn.init.zeros_(conv.bias)
            self.add_module(f"Conv_{k}", conv)
            channels = 32

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs: [B, H, W, C] (uint8 or float, in [0, 255]) -> [B, D]."""
        x = imgs.permute(0, 3, 1, 2).to(self.dtype) / 255.0 - 0.5
        with _autocast(self.dtype, x.device):
            for k in range(len(self.strides)):
                x = torch.relu(self.get_submodule(f"Conv_{k}")(x))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
