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
  and advances the count itself. It takes float32 parameters and second
  moments, a float32 or bfloat16 first moment, float32 or bfloat16
  gradients, all contiguous (a gradient in another layout, as cuDNN leaves a
  convolution's, is copied first); for other tensors on a card the wrapper
  raises ``ValueError`` naming what it found. A list longer than one
  launch's argument block takes several launches (``plan``).

The bfloat16 compute copies (``Bf16Copy``). A network that computes in
bfloat16 keeps a bfloat16 copy of each float32 ``Linear`` weight and bias
(``models/networks.py:Dense``), which its layers read in place of the
parameter, so autocast casts no weight at a use; the gradient of such a
parameter is taken with respect to its copy, and is bfloat16. ``adam`` takes
the copies beside the parameters: it widens a bfloat16 gradient (exactly
``.float()``, what autocast's cast did in the backward pass) and writes each
copy from the new parameter (``.to(torch.bfloat16)``), in the kernel's one
pass on a card, after ``adam_plain`` on the CPU. A bfloat16 gradient whose
parameter has no copy is refused. ``lerp_`` writes the targets' copies the
same way. A parameter written by anything else (a checkpoint loaded, a
``copy_``, a move) leaves its copy stale: ``Bf16Copy.stale`` sees it by the
parameter's version counter and address, which the two kernels do not
change, and ``Bf16Copy.refresh`` casts the stale ones anew,
one launch of ``bf16_copy_refresh_kernel`` on a card. Each layer checks
its own before each eager use, and a captured program all it read before
its capture and before each replay (``utils/graphs.py``). ``trace.counters``
counts the layers' uses of a copy (``bf16_copy.uses``) and the refresh
kernel's launches (``bf16_copy.refreshes``; on the CPU, ``cast_plain``'s
calls).

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


def cast_plain(copies: tp.Sequence[Tensor], sources: tp.Sequence[Tensor]) -> None:
    """copies[i] <- sources[i].to(copies[i].dtype), in place."""
    with torch.no_grad():
        for copy, source in zip(copies, sources):
            copy.copy_(source)


# -- kernel wrappers ----------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_LL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "optim_max_tensors": [_I],
    "optim_adam": [_I, _I, _PP, _PP, _PP, _PP, _PP, _P, _LL] + [_F] * 6 + [_P, _P, _I, _P],
    "optim_lerp": [_I, _PP, _PP, _PP, _LL, _F, _P],
    "optim_cast": [_I, _PP, _PP, _LL, _P],
}
_KERNELS = {"adam": 0, "lerp": 1, "cast": 2}


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
    return _lib().optim_max_tensors(_KERNELS[kernel])


def _check(kernel: str, lists: tp.Mapping[str, tp.Sequence[tp.Optional[Tensor]]],
           dtypes: tp.Mapping[str, tp.Tuple[torch.dtype, ...]]) -> None:
    """Raise ``ValueError``, naming the condition that failed, unless the
    kernel takes these lists: as many tensors in each, all on the first
    one's device, each list of one of its dtypes (``grads`` and ``copies``:
    each tensor of one of them), contiguous, and each position's tensors of
    one size. A copy may be None: that tensor has none."""
    first_name, first = next(iter(lists.items()))
    device = first[0].device
    for name, xs in lists.items():
        if len(xs) != len(first):
            raise ValueError(f"{kernel}: {len(xs)} {name} for {len(first)} {first_name}")
        for i, (x, ref) in enumerate(zip(xs, first)):
            at = f"{kernel}: {name}[{i}]"
            if x is None and name == "copies":
                continue
            if x.device != device:
                raise ValueError(f"{at} is on {x.device}, {first_name}[0] on {device}")
            if name in _PER_TENSOR:
                if x.dtype not in dtypes[name]:
                    raise ValueError(f"{at} is {x.dtype}; the kernel takes {name} of "
                                     + " or ".join(str(d) for d in dtypes[name]))
            elif x.dtype not in dtypes[name] or x.dtype != xs[0].dtype:
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
_BF16 = (torch.bfloat16,)
_ADAM_DTYPES = {"params": _F32, "grads": (torch.float32, torch.bfloat16),
                "mus": (torch.float32, torch.bfloat16), "nus": _F32, "copies": _BF16}
_LERP_DTYPES = {"targets": _F32, "sources": _F32, "copies": _BF16}
# the lists whose tensors may differ in dtype: a step's gradients are bfloat16
# where the parameter has a copy, float32 where not (a LayerNorm's)
_PER_TENSOR = ("grads", "copies")


def _copy_ptrs(copies: tp.Sequence[tp.Optional[Tensor]]) -> tp.Any:
    return (ctypes.c_void_p * len(copies))(*[None if c is None else c.data_ptr()
                                             for c in copies])


def _check_copies(kernel: str, grads: tp.Sequence[Tensor],
                  copies: tp.Sequence[tp.Optional[Tensor]]) -> None:
    """A bfloat16 gradient is the gradient of a copy: refuse one whose
    parameter has none."""
    for i, (g, c) in enumerate(zip(grads, copies)):
        if g.dtype == torch.bfloat16 and c is None:
            raise ValueError(f"{kernel}: grads[{i}] is torch.bfloat16 and params[{i}] has no "
                             "bfloat16 copy; the kernel takes a bfloat16 gradient only for a "
                             "parameter with a copy")


def adam(params: tp.Sequence[Tensor], grads: tp.Sequence[Tensor], mus: tp.Sequence[Tensor],
         nus: tp.Sequence[Tensor], count_t: Tensor, ticket: Tensor, lr: float, b1: float,
         b2: float, eps: float, copies: tp.Optional[tp.Sequence[tp.Optional[Tensor]]] = None
         ) -> None:
    """One Adam step over the lists: ``adam_plain`` on the CPU, the kernel
    on a card (``ticket``: an int32 device scalar, 0 between steps).
    ``copies[i]``, where not None, is the bfloat16 compute copy of
    ``params[i]``, written from the new parameter; ``grads[i]`` may then be
    bfloat16, the gradient with respect to the copy."""
    params, grads, mus, nus = list(params), list(grads), list(mus), list(nus)
    copies = [None] * len(params) if copies is None else list(copies)
    if not params or not _on_card("adam", params[0]):
        _check_copies("adam", grads, copies)
        adam_plain(params, [g.float() for g in grads], mus, nus, count_t, lr, b1, b2, eps)
        written = [i for i, c in enumerate(copies) if c is not None]
        cast_plain([copies[i] for i in written], [params[i] for i in written])
        return
    grads = _dense(grads)
    _check("adam", {"params": params, "grads": grads, "mus": mus, "nus": nus,
                    "copies": copies}, _ADAM_DTYPES)
    _check_copies("adam", grads, copies)
    for name, t in (("count_t", count_t), ("ticket", ticket)):
        if t.device != params[0].device or t.dtype != torch.int32 or t.numel() != 1:
            raise ValueError(f"adam: {name} is {t.dtype} of {t.numel()} elements on "
                             f"{t.device}; the kernel takes one int32 on {params[0].device}")
    stream = torch.cuda.current_stream(params[0].device).cuda_stream
    mu_bf16 = int(mus[0].dtype == torch.bfloat16)
    parts = plan(len(params), _max_tensors("adam"))
    for i, at in enumerate(parts):
        g_bf16 = (ctypes.c_ubyte * (at.stop - at.start))(
            *[int(g.dtype == torch.bfloat16) for g in grads[at]])
        rc = _lib().optim_adam(
            mu_bf16, at.stop - at.start, _ptrs(params[at]), _ptrs(grads[at]), _ptrs(mus[at]),
            _ptrs(nus[at]), _copy_ptrs(copies[at]), g_bf16, _sizes(params[at]), -lr, b1, b2,
            1.0 - b1, 1.0 - b2, eps, count_t.data_ptr(), ticket.data_ptr(),
            int(i == len(parts) - 1), stream)
        _launched("adam", rc)


def lerp_(targets: tp.Sequence[Tensor], sources: tp.Sequence[Tensor], weight: float,
          copies: tp.Optional[tp.Sequence[tp.Optional[Tensor]]] = None) -> None:
    """targets <- targets + weight * (sources - targets), in place, as
    ``torch._foreach_lerp_`` computes it: ``lerp_plain`` on the CPU, the
    kernel on a card. ``copies[i]``, where not None, is the bfloat16 compute
    copy of ``targets[i]``, written from the new target."""
    targets, sources = list(targets), list(sources)
    copies = [None] * len(targets) if copies is None else list(copies)
    if not targets or not _on_card("lerp", targets[0]):
        lerp_plain(targets, sources, weight)
        written = [i for i, c in enumerate(copies) if c is not None]
        cast_plain([copies[i] for i in written], [targets[i] for i in written])
        return
    sources = _dense(sources)
    _check("lerp", {"targets": targets, "sources": sources, "copies": copies}, _LERP_DTYPES)
    stream = torch.cuda.current_stream(targets[0].device).cuda_stream
    for at in plan(len(targets), _max_tensors("lerp")):
        rc = _lib().optim_lerp(at.stop - at.start, _ptrs(targets[at]), _ptrs(sources[at]),
                               _copy_ptrs(copies[at]), _sizes(targets[at]), weight, stream)
        _launched("lerp", rc)


def cast_(copies: tp.Sequence[Tensor], sources: tp.Sequence[Tensor]) -> None:
    """copies[i] (bfloat16) <- sources[i] (float32) rounded to nearest even,
    in place: ``cast_plain`` on the CPU, ``bf16_copy_refresh_kernel`` on a
    card (one launch a ``plan`` part). Each launch, and each call of the
    plain version, counts one ``bf16_copy.refreshes``."""
    copies, sources = list(copies), list(sources)
    if not copies:
        return
    if not _on_card("cast", copies[0]):
        cast_plain(copies, sources)
        trace.count("bf16_copy.refreshes")
        return
    _check("cast", {"copies": copies, "sources": sources}, {"copies": _BF16, "sources": _F32})
    stream = torch.cuda.current_stream(copies[0].device).cuda_stream
    for at in plan(len(copies), _max_tensors("cast")):
        rc = _lib().optim_cast(at.stop - at.start, _ptrs(copies[at]), _ptrs(sources[at]),
                               _sizes(copies[at]), stream)
        if rc != 0:
            raise RuntimeError(f"bf16_copy_refresh_kernel failed to launch: CUDA error {rc}")
        trace.count("bf16_copy.refreshes")


class Bf16Copy:
    """The bfloat16 compute copy of a float32 parameter (a ``Dense`` layer's
    weight or bias in a network that computes in bfloat16): ``copy`` holds
    ``param.to(torch.bfloat16)``, a tensor allocated once on the parameter's
    device and written only in place, at the address a captured program
    reads. It takes gradients where its parameter does.

    ``stale()`` is whether the parameter was written since its copy was: the
    copy remembers the parameter's version counter and address when it was
    written (``written``). Adam's and the soft-update's kernels write
    parameter and copy together and bump no version; anything else that
    writes a parameter in place (``copy_``, ``load_state_dict``, an
    optimizer step on the CPU) bumps it, and a move or a deep copy changes
    the address. A write the counter does not see (through ``.data``, or a
    collective such as ``dist.broadcast`` into a parameter) owes it a bump,
    ``torch.autograd.graph.increment_version``; the port makes none, and
    ``tests/test_torch_optim.py`` fails on one added to its sources.
    ``refresh(copies)`` casts the stale ones of a list anew (``cast_``)."""

    def __init__(self, param: Tensor) -> None:
        self.param = param
        self.copy = torch.empty(param.shape, dtype=torch.bfloat16, device=param.device,
                                requires_grad=param.requires_grad)
        self._seen: tp.Optional[tp.Tuple[int, int]] = None

    def follow(self, param: Tensor) -> None:
        """Become the copy of ``param`` (its layer's parameter after a move):
        the same object, so whoever holds it keeps writing the copy the layer
        reads; ``copy`` allocated anew only where the device or the shape
        changed (stale then). A move that changes nothing changes nothing."""
        self.param = param
        if self.copy.device != param.device or self.copy.shape != param.shape:
            self.copy = torch.empty(param.shape, dtype=torch.bfloat16, device=param.device,
                                    requires_grad=param.requires_grad)
            self._seen = None

    def stale(self) -> bool:
        return self._seen != (self.param._version, self.param.data_ptr())

    def written(self) -> None:
        """Record that ``copy`` was written from ``param`` as it is now."""
        self._seen = (self.param._version, self.param.data_ptr())

    @staticmethod
    def refresh(copies: tp.Sequence["Bf16Copy"]) -> None:
        """Write every stale copy of ``copies`` from its parameter, one cast
        launch for up to ``plan``'s limit of them; nothing when none is
        stale."""
        stale = [c for c in copies if c.stale()]
        cast_([c.copy for c in stale], [c.param for c in stale])
        for c in stale:
            c.written()


def use_copies(copies: tp.Sequence[Bf16Copy]) -> tp.List[Tensor]:
    """A layer's copies for one use: refreshed first where stale, handed to
    the program being captured to keep fresh at each replay, taking
    gradients where their parameters do; counts one ``bf16_copy.uses``."""
    Bf16Copy.refresh(copies)
    for c in copies:
        graphs.keep_fresh(c)
        if c.copy.requires_grad != c.param.requires_grad:
            c.copy.requires_grad_(c.param.requires_grad)
    trace.count("bf16_copy.uses")
    return [c.copy for c in copies]


def copies_of(module: tp.Optional[nn.Module], params: tp.Sequence[Tensor]
              ) -> tp.List[tp.Optional[Bf16Copy]]:
    """For each of ``params``, its ``Bf16Copy`` among ``module``'s layers, or
    None: a layer holds its copies as a list ``bf16``
    (``models/networks.py:Dense``)."""
    held = {id(c.param): c for m in (module.modules() if module is not None else ())
            for c in getattr(m, "bf16", None) or () if isinstance(c, Bf16Copy)}
    return [held.get(id(p)) for p in params]


def step_copies(copies: tp.Sequence[tp.Optional[Bf16Copy]]) -> tp.List[tp.Optional[Tensor]]:
    """The copy tensors a kernel writes beside its parameters (None where a
    parameter has no copy)."""
    return [None if c is None else c.copy for c in copies]


def mark_written(copies: tp.Sequence[tp.Optional[Bf16Copy]]) -> None:
    """Record that each of ``copies`` was written with its parameter."""
    for c in copies:
        if c is not None:
            c.written()


class Adam:
    """Adam over a module's parameters, or over named parameters (a
    feature learner's, its target networks left out)."""

    def __init__(self, module: tp.Union[nn.Module, tp.Mapping[str, nn.Parameter]], lr: float,
                 mu_dtype: torch.dtype = torch.float32, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.params: tp.Dict[str, nn.Parameter] = dict(
            module.named_parameters() if isinstance(module, nn.Module) else module)
        self._module = module if isinstance(module, nn.Module) else None
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

    @property
    def leaves(self) -> tp.List[Tensor]:
        """What to differentiate a loss by for ``step``, in ``self.params``
        order: each parameter's bfloat16 compute copy where it has one (its
        network runs on the copy), else the parameter."""
        return [p if c is None else c.copy for p, c in zip(self.params.values(), self._copies())]

    def _copies(self) -> tp.List[tp.Optional[Bf16Copy]]:
        """Each parameter's bfloat16 compute copy, where its layer keeps one,
        looked up at each use as the layer holds it now."""
        return copies_of(self._module, list(self.params.values()))

    @torch.no_grad()
    def step(self, grads: tp.Sequence[torch.Tensor]) -> None:
        """Apply one update; ``grads`` are in ``self.params`` order, the
        gradients with respect to ``leaves`` (or float32 ones). The
        parameters' copies are written with them. The step is the device
        span ``optimizer`` (``utils/trace.py``)."""
        copies = self._copies()
        with trace.device_span("optimizer", self.count_t.device):
            adam(list(self.params.values()), list(grads), list(self.mu.values()),
                 list(self.nu.values()), self.count_t, self._ticket, self.lr, self.b1,
                 self.b2, self.eps, step_copies(copies))
        mark_written(copies)
