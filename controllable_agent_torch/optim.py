"""Adam matching ``optax.adam(lr, mu_dtype=...)``, the optimizer of the JAX
agents, and the multi-tensor soft-update of target networks.

Stock ``torch.optim.Adam`` keeps its moments in the parameters' dtype; the
JAX agents keep the first moment in bfloat16 (``adam_mu_dtype``: the update
is bound by memory traffic and momentum tolerates bf16). This Adam follows
optax's arithmetic step for step:

    mu  = (1 - b1) * g + b1 * mu          # b1 * mu rounds in mu's dtype
    nu  = (1 - b2) * g**2 + b2 * nu       # float32
    mu_hat = mu / (1 - b1**t);  nu_hat = nu / (1 - b2**t)
    p  += -lr * mu_hat / (sqrt(nu_hat) + eps)
    mu is stored in mu_dtype after the step (optax casts after using the
    float32 value for the update)

The step count and both moments live in fixed device tensors that ``step``
updates in place, and the bias corrections are computed on the device from
the count: a step captured in a CUDA graph advances them on every replay.

Two versions of a step, chosen by the device the tensors are on:

- ``adam_plain``: each line above as ``torch._foreach_*`` calls over the
  parameter list (~23 launches a step on a card). It is the CPU's.
- On a CUDA device: one launch of ``adam_multi_tensor_apply_kernel``
  (``csrc/fused_optim.cu``, loaded with ctypes by ``_build.py``), which
  reads each element once, computes what ``adam_plain`` computes to the bit,
  and advances the count itself. It takes float32 parameters, gradients and
  second moments, a float32 or bfloat16 first moment, all contiguous (a
  gradient in another layout, as cuDNN leaves a convolution's, is copied
  first); for other tensors on a card the wrapper raises ``ValueError``
  naming what it found. A list longer than one launch's argument block takes several
  launches (``plan``).

``lerp_`` is the soft-update's step: ``torch._foreach_lerp_`` (``lerp_plain``)
on the CPU, one launch of ``lerp_multi_tensor_apply_kernel`` for float32
CUDA tensors.

``launches[name]`` counts the kernels' launches (``adam``, ``lerp``), so a run
can show that its optimizer steps went through them. Inside a CUDA graph
capture a launch is recorded and not run: ``CapturedProgram`` holds those
out of the counts and adds them back at each replay (``utils/graphs.py``),
as it does ``ops/fused_fb.py``'s.

The moments are keyed by parameter name, so ``convert.py`` can load optax's
``ScaleByAdamState`` into them.
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch
from torch import nn

from . import _build
from .utils import graphs, trace

Tensor = torch.Tensor

launches: tp.Dict[str, int] = graphs.counted({"adam": 0, "lerp": 0})


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def plan(count: int, max_tensors: int) -> tp.List[slice]:
    """The launches for a list of ``count`` tensors: at most ``max_tensors``
    tensors each (what the kernel's argument block holds), whole tensors,
    in order; none for an empty list."""
    return [slice(i, min(i + max_tensors, count)) for i in range(0, count, max_tensors)]


# -- plain versions -----------------------------------------------------------
def adam_plain(params: tp.Sequence[Tensor], grads: tp.Sequence[Tensor],
               mus: tp.Sequence[Tensor], nus: tp.Sequence[Tensor], count_t: Tensor,
               lr: float, b1: float, b2: float, eps: float) -> None:
    """One step by ``torch._foreach_*``, one call per line of the module's
    docstring; advances ``count_t`` first."""
    params, grads, mus, nus = list(params), list(grads), list(mus), list(nus)
    count_t += 1
    count = count_t.float()
    bc1 = 1.0 - torch.pow(b1, count)
    bc2 = 1.0 - torch.pow(b2, count)

    decayed = torch._foreach_mul(mus, b1)  # rounds in mu's dtype
    if decayed[0].dtype != torch.float32:
        widened = [torch.empty_like(g) for g in grads]
        torch._foreach_copy_(widened, decayed)
        decayed = widened
    mu = torch._foreach_mul(grads, 1.0 - b1)
    torch._foreach_add_(mu, decayed)
    squares = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(squares, 1.0 - b2)
    torch._foreach_mul_(nus, b2)
    torch._foreach_add_(nus, squares)

    denom = torch._foreach_div(nus, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(mu, bc1)
    torch._foreach_div_(update, denom)
    torch._foreach_add_(params, update, alpha=-lr)
    torch._foreach_copy_(mus, mu)


def lerp_plain(targets: tp.Sequence[Tensor], sources: tp.Sequence[Tensor],
               weight: float) -> None:
    torch._foreach_lerp_(list(targets), list(sources), weight)


# -- kernel wrappers ----------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_LL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "optim_max_tensors": [_I],
    "optim_adam": [_I, _I, _PP, _PP, _PP, _PP, _LL] + [_F] * 6 + [_P, _P, _I, _P],
    "optim_lerp": [_I, _PP, _PP, _LL, _F, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with argtypes declared."""
    lib = _build.load("fused_optim")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.cache
def _max_tensors(kernel: str) -> int:
    """The most tensors one launch of a kernel takes."""
    return _lib().optim_max_tensors(0 if kernel == "adam" else 1)


def _check(kernel: str, lists: tp.Mapping[str, tp.Sequence[Tensor]],
           dtypes: tp.Mapping[str, tp.Tuple[torch.dtype, ...]]) -> None:
    """Raise ``ValueError``, naming the condition that failed, unless the
    kernel takes these lists: as many tensors in each, all on the first
    one's device, each list of one of its dtypes, contiguous, and each
    position's tensors of one size."""
    first_name, first = next(iter(lists.items()))
    device = first[0].device
    for name, xs in lists.items():
        if len(xs) != len(first):
            raise ValueError(f"{kernel}: {len(xs)} {name} for {len(first)} {first_name}")
        for i, (x, ref) in enumerate(zip(xs, first)):
            at = f"{kernel}: {name}[{i}]"
            if x.device != device:
                raise ValueError(f"{at} is on {x.device}, {first_name}[0] on {device}")
            if x.dtype not in dtypes[name] or x.dtype != xs[0].dtype:
                raise ValueError(f"{at} is {x.dtype}; the kernel takes {name} of one dtype, "
                                 + " or ".join(str(d) for d in dtypes[name]))
            if not x.is_contiguous():
                raise ValueError(f"{at} is not contiguous")
            if x.numel() != ref.numel():
                raise ValueError(f"{at} has {x.numel()} elements, {first_name}[{i}] "
                                 f"{ref.numel()}")


def _on_card(kernel: str, x: Tensor) -> bool:
    """Whether a list whose first tensor is ``x`` takes the kernel: on the
    CPU the plain version runs; on a card the kernel; elsewhere neither."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {x.device}; the kernel runs on CUDA devices")
    return True


def _dense(xs: tp.List[Tensor]) -> tp.List[Tensor]:
    """A list the kernel only reads, each tensor contiguous: one copy for a
    tensor in another layout, such as cuDNN's channels-last weight gradient
    of a convolution (exact; the tensors it writes must be contiguous)."""
    return [x if x.is_contiguous() else x.contiguous() for x in xs]


def _ptrs(xs: tp.Sequence[Tensor]) -> tp.Any:
    return (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])


def _sizes(xs: tp.Sequence[Tensor]) -> tp.Any:
    return (ctypes.c_longlong * len(xs))(*[x.numel() for x in xs])


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"fused optimizer kernel {name} failed to launch: CUDA error {rc}")
    launches[name] += 1


_F32 = (torch.float32,)
_ADAM_DTYPES = {"params": _F32, "grads": _F32, "mus": (torch.float32, torch.bfloat16),
                "nus": _F32}


def adam(params: tp.Sequence[Tensor], grads: tp.Sequence[Tensor], mus: tp.Sequence[Tensor],
         nus: tp.Sequence[Tensor], count_t: Tensor, ticket: Tensor, lr: float, b1: float,
         b2: float, eps: float) -> None:
    """One Adam step over the lists: ``adam_plain`` on the CPU, the kernel
    on a card (``ticket``: an int32 device scalar, 0 between steps)."""
    params, grads, mus, nus = list(params), list(grads), list(mus), list(nus)
    if not params or not _on_card("adam", params[0]):
        adam_plain(params, grads, mus, nus, count_t, lr, b1, b2, eps)
        return
    grads = _dense(grads)
    _check("adam", {"params": params, "grads": grads, "mus": mus, "nus": nus}, _ADAM_DTYPES)
    for name, t in (("count_t", count_t), ("ticket", ticket)):
        if t.device != params[0].device or t.dtype != torch.int32 or t.numel() != 1:
            raise ValueError(f"adam: {name} is {t.dtype} of {t.numel()} elements on "
                             f"{t.device}; the kernel takes one int32 on {params[0].device}")
    stream = torch.cuda.current_stream(params[0].device).cuda_stream
    mu_bf16 = int(mus[0].dtype == torch.bfloat16)
    parts = plan(len(params), _max_tensors("adam"))
    for i, at in enumerate(parts):
        rc = _lib().optim_adam(
            mu_bf16, at.stop - at.start, _ptrs(params[at]), _ptrs(grads[at]), _ptrs(mus[at]),
            _ptrs(nus[at]), _sizes(params[at]), -lr, b1, b2, 1.0 - b1, 1.0 - b2, eps,
            count_t.data_ptr(), ticket.data_ptr(), int(i == len(parts) - 1), stream)
        _launched("adam", rc)


def lerp_(targets: tp.Sequence[Tensor], sources: tp.Sequence[Tensor], weight: float) -> None:
    """targets <- targets + weight * (sources - targets), in place, as
    ``torch._foreach_lerp_`` computes it: ``lerp_plain`` on the CPU, the
    kernel on a card."""
    targets, sources = list(targets), list(sources)
    if not targets or not _on_card("lerp", targets[0]):
        lerp_plain(targets, sources, weight)
        return
    sources = _dense(sources)
    _check("lerp", {"targets": targets, "sources": sources}, {"targets": _F32, "sources": _F32})
    stream = torch.cuda.current_stream(targets[0].device).cuda_stream
    for at in plan(len(targets), _max_tensors("lerp")):
        rc = _lib().optim_lerp(at.stop - at.start, _ptrs(targets[at]), _ptrs(sources[at]),
                               _sizes(targets[at]), weight, stream)
        _launched("lerp", rc)


class Adam:
    """Adam over a module's parameters, or over named parameters (a
    feature learner's, its target networks left out)."""

    def __init__(self, module: tp.Union[nn.Module, tp.Mapping[str, nn.Parameter]], lr: float,
                 mu_dtype: torch.dtype = torch.float32, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.params: tp.Dict[str, nn.Parameter] = dict(
            module.named_parameters() if isinstance(module, nn.Module) else module)
        self.mu = {k: torch.zeros_like(p, dtype=mu_dtype) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        device = next(iter(self.params.values())).device
        self.count_t = torch.zeros((), dtype=torch.int32, device=device)
        # the kernel's ticket: its blocks count themselves done, the last advances count_t
        self._ticket = torch.zeros((), dtype=torch.int32, device=device)

    @property
    def count(self) -> int:
        """The number of steps taken (reading it waits for the device)."""
        return int(self.count_t)

    @count.setter
    def count(self, value: int) -> None:
        self.count_t.fill_(value)

    def state(self) -> tp.Dict[str, torch.Tensor]:
        """The optimizer's own tensors by name (not copies): ``mu.<param>``,
        ``nu.<param>`` and ``count``."""
        out = {f"mu.{k}": v for k, v in self.mu.items()}
        out.update({f"nu.{k}": v for k, v in self.nu.items()})
        out["count"] = self.count_t
        return out

    @torch.no_grad()
    def step(self, grads: tp.Sequence[torch.Tensor]) -> None:
        """Apply one update; ``grads`` are in ``self.params`` order. The
        step is the device span ``optimizer`` (``utils/trace.py``)."""
        with trace.device_span("optimizer", self.count_t.device):
            adam(list(self.params.values()), list(grads), list(self.mu.values()),
                 list(self.nu.values()), self.count_t, self._ticket, self.lr, self.b1,
                 self.b2, self.eps)
