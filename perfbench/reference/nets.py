"""Plain PyTorch networks of the benchmark's reference: the MLPs, actor,
twin forward (successor) map and backward (feature) map of the FB and SF
agents, as functions of a dict of named float32 tensors.

The names are the port's checkpoint names (``actor.mlps.0.Dense_0.weight``,
...), so the harness can load one set of weights into the program and hand
the same to the reference. Every product goes through ``Products``, which
computes it in float32 with TF32 off (the reference), or in a lower
precision for the control: TF32, or float8 (one scale per tensor).
Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import math
import typing as tp

import torch

Tensor = torch.Tensor
Params = tp.Dict[str, Tensor]
Layer = tp.Union[int, str]

# the largest values of float8 e4m3 (products' inputs) and e5m2 (gradients)
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _fp8(x: Tensor, dtype: torch.dtype = torch.float8_e4m3fn) -> Tensor:
    """``x`` rounded to a float8 type with one scale for the tensor (its
    largest magnitude onto the type's largest value), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX[dtype]
    return (x / scale).to(dtype).float() * scale


@contextlib.contextmanager
def _tf32(on: bool) -> tp.Iterator[None]:
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class _Lowered(torch.autograd.Function):
    """a @ b in a lower precision, forward and backward: TF32; or float8,
    the inputs in e4m3 and the incoming gradient in e5m2, as float8
    training rounds them."""

    @staticmethod
    def forward(ctx: tp.Any, a: Tensor, b: Tensor, mode: str) -> Tensor:
        if mode == "fp8":
            a, b = _fp8(a.detach()), _fp8(b.detach())
        ctx.mode = mode
        ctx.save_for_backward(a, b)
        with _tf32(mode == "tf32"):
            return a @ b

    @staticmethod
    def backward(ctx: tp.Any, grad: Tensor) -> tp.Tuple[Tensor, Tensor, None]:
        a, b = ctx.saved_tensors
        if ctx.mode == "fp8":
            grad = _fp8(grad, torch.float8_e5m2)
        with _tf32(ctx.mode == "tf32"):
            return grad @ b.T, a.T @ grad, None


class Products:
    """How the reference multiplies: ``nets`` for the networks' layers,
    ``loss`` for the products of the losses. Each is ``"f32"`` (float32,
    TF32 off), ``"tf32"`` or ``"fp8"``, in the forward and the backward
    pass alike."""

    def __init__(self, nets: str = "f32", loss: str = "f32") -> None:
        for p in (nets, loss):
            if p not in ("f32", "tf32", "fp8"):
                raise ValueError(f"unknown precision {p!r}")
        self.nets, self.loss = nets, loss

    def mm(self, a: Tensor, b: Tensor, kind: str = "loss") -> Tensor:
        precision = self.nets if kind == "nets" else self.loss
        if precision == "f32":
            return a @ b
        return _Lowered.apply(a, b, precision)

    def linear(self, x: Tensor, weight: Tensor, bias: Tensor) -> Tensor:
        return self.mm(x, weight.T, "nets") + bias


F32 = Products()


def l2_normalize(x: Tensor) -> Tensor:
    """sqrt(d) · x / max(|x|, 1e-12) over the last axis."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    return math.sqrt(x.shape[-1]) * x / norm


def mlp_shapes(prefix: str, in_dim: int, layers: tp.Sequence[Layer]
               ) -> tp.List[tp.Tuple[str, tp.Tuple[int, ...]]]:
    """The parameters of one MLP of the layer language ``(1024, "ntanh",
    512, "irelu", ...)``: ints are dense layers, ``ntanh`` LayerNorm and
    tanh, ``relu``/``irelu`` ReLU, ``L2`` the sqrt(d)-scaled normalization."""
    out, dim, dense, norm = [], in_dim, 0, 0
    for layer in layers:
        if isinstance(layer, str):
            if layer == "ntanh":
                out += [(f"{prefix}.LayerNorm_{norm}.weight", (dim,)),
                        (f"{prefix}.LayerNorm_{norm}.bias", (dim,))]
                norm += 1
        else:
            out += [(f"{prefix}.Dense_{dense}.weight", (int(layer), dim)),
                    (f"{prefix}.Dense_{dense}.bias", (int(layer),))]
            dense += 1
            dim = int(layer)
    return out


def mlp(p: Params, prefix: str, x: Tensor, layers: tp.Sequence[Layer],
        prod: Products = F32) -> Tensor:
    dense = norm = 0
    for layer in layers:
        if layer == "ntanh":
            x = torch.tanh(torch.nn.functional.layer_norm(
                x, x.shape[-1:], p[f"{prefix}.LayerNorm_{norm}.weight"],
                p[f"{prefix}.LayerNorm_{norm}.bias"], eps=1e-5))
            norm += 1
        elif layer in ("relu", "irelu"):
            x = torch.relu(x)
        elif layer == "L2":
            x = l2_normalize(x)
        elif isinstance(layer, str):
            raise ValueError(f"unknown layer {layer!r}")
        else:
            x = prod.linear(x, p[f"{prefix}.Dense_{dense}.weight"],
                            p[f"{prefix}.Dense_{dense}.bias"])
            dense += 1
    return x


class Shapes(tp.NamedTuple):
    """The widths the networks are built from."""

    obs: int
    action: int
    goal: int
    z: int
    hidden: int
    feature: int
    backward_hidden: int


def _tower(s: Shapes) -> tp.Tuple[Layer, ...]:
    return (s.hidden, "ntanh", s.feature, "irelu")


def _head(s: Shapes, out: int) -> tp.Tuple[Layer, ...]:
    return (s.hidden, "irelu", out)


def actor_shapes(s: Shapes, prefix: str = "actor") -> tp.List[tp.Tuple[str, tp.Tuple[int, ...]]]:
    """The two-tower actor (``preprocess``, no trunk)."""
    return (mlp_shapes(f"{prefix}.mlps.0", s.obs + s.z, _tower(s))
            + mlp_shapes(f"{prefix}.mlps.1", s.obs, _tower(s))
            + mlp_shapes(f"{prefix}.mlps.2", 2 * s.feature, _head(s, s.action)))


def actor(p: Params, s: Shapes, obs: Tensor, z: Tensor, prod: Products = F32,
          prefix: str = "actor") -> Tensor:
    h = torch.cat([mlp(p, f"{prefix}.mlps.1", obs, _tower(s), prod),
                   mlp(p, f"{prefix}.mlps.0", torch.cat([obs, z], -1), _tower(s), prod)], -1)
    return torch.tanh(mlp(p, f"{prefix}.mlps.2", h, _head(s, s.action), prod))


def forward_shapes(s: Shapes, prefix: str) -> tp.List[tp.Tuple[str, tp.Tuple[int, ...]]]:
    """The twin forward map (FB's F, SF's successor features)."""
    return (mlp_shapes(f"{prefix}.mlps.0", s.obs + s.action, _tower(s))
            + mlp_shapes(f"{prefix}.mlps.1", s.obs + s.z, _tower(s))
            + mlp_shapes(f"{prefix}.mlps.2", 2 * s.feature, _head(s, s.z))
            + mlp_shapes(f"{prefix}.mlps.3", 2 * s.feature, _head(s, s.z)))


def forward_map(p: Params, s: Shapes, prefix: str, obs: Tensor, z: Tensor, action: Tensor,
                prod: Products = F32) -> tp.Tuple[Tensor, Tensor]:
    h = torch.cat([mlp(p, f"{prefix}.mlps.0", torch.cat([obs, action], -1), _tower(s), prod),
                   mlp(p, f"{prefix}.mlps.1", torch.cat([obs, z], -1), _tower(s), prod)], -1)
    return (mlp(p, f"{prefix}.mlps.2", h, _head(s, s.z), prod),
            mlp(p, f"{prefix}.mlps.3", h, _head(s, s.z), prod))


def backward_layers(s: Shapes, l2: bool = False) -> tp.Tuple[Layer, ...]:
    """FB's B (normalized by the caller) and SF's φ (``L2`` inside)."""
    return (s.backward_hidden, "ntanh", s.backward_hidden, "relu", s.z) + (("L2",) if l2 else ())


def backward_shapes(s: Shapes, prefix: str) -> tp.List[tp.Tuple[str, tp.Tuple[int, ...]]]:
    return mlp_shapes(prefix, s.goal, backward_layers(s))


def backward_map(p: Params, s: Shapes, prefix: str, goal: Tensor,
                 prod: Products = F32) -> Tensor:
    """FB's B: the MLP, then sqrt(z)-scaled L2 normalization."""
    return l2_normalize(mlp(p, prefix, goal, backward_layers(s), prod))


def dot(x: Tensor, z: Tensor) -> Tensor:
    """Row-wise x·z."""
    return (x * z).sum(-1)


def truncated_sample(mu: Tensor, normal: Tensor, std: float,
                     clip: tp.Optional[float]) -> Tensor:
    """mu + clip(std·normal), clamped into (-1, 1) by 1e-6 with the
    gradient passed straight through the clamp."""
    eps = normal * std
    if clip is not None:
        eps = eps.clamp(-clip, clip)
    x = mu + eps
    return x + (x.clamp(-1.0 + 1e-6, 1.0 - 1e-6) - x).detach()
