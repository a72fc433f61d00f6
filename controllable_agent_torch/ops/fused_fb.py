"""Fused Forward-Backward loss (port of ``controllable_agent_tpu/ops/pallas_fb.py``).

``fb_loss_terms_fused(f1, f2, b, tf1, tf2, tb, discount)`` returns the four
UNnormalized sums (fb_offdiag_sum, fb_diag_sum, orth_offdiag_sum,
orth_diag_sum) like the JAX ``fb_loss_terms_fused``; the caller applies the
1/(n(n-1)) and 1/n factors. Its gradient flows to f1, f2 and b; the targets
and the discount get none.

Four kernels carry it, in ``csrc/fused_fb.cu`` (CUDA C++ for sm_90a, loaded
with ctypes by ``_build.py``); the note at the top of that file says what
bounds them on the H100 and what the design does about it:

  wrapper     kernel               replaces (controllable_agent_tpu/ops/pallas_fb.py)
  fwd_sums    fb_fwd_tile_kernel   _fwd_kernel     :61   Σ_off resid², Σ_diag M
  cov_sums    fb_gram_kernel       _cov_kernel     :91   Σ_off cov², Σ_diag cov
  bwd_df      fb_bwd_df_kernel     _bwd_kernel     :184  dF1, dF2
  bwd_db      fb_bwd_db_kernel     _bwd_db_kernel  :219  dB (FB part)

Beside each wrapper sits its plain PyTorch version (``*_plain``). A wrapper
takes the plain version only for tensors on the CPU (the tests); for CUDA
tensors it checks device, dtype, shape and contiguity, launches the kernel,
and raises if the launch fails. ``launches[name]`` counts kernel launches,
so a run can show that its main path went through the kernels.

The orthonormality gradient 4·g_covoff·(cov⊙off)·B + 2·g_covdiag·B is
computed outside the kernels with ``torch.matmul``. The JAX package forms
the full n×n cov for it (pallas_fb.py:328-336); the port uses the d×d Gram
matrix G = BᵀB instead, (cov⊙off)·B = B·G − diag(|b_i|²)·B, which is
O(n·d²) work rather than O(n²·d).
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch

from .. import _build

Tensor = torch.Tensor

launches: tp.Dict[str, int] = {"fwd_sums": 0, "cov_sums": 0, "bwd_df": 0,
                               "bwd_db": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# -- plain versions -----------------------------------------------------------
def _measures(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor, tf2: Tensor,
              tb: Tensor) -> tp.Tuple[Tensor, Tensor, Tensor]:
    return f1 @ b.T, f2 @ b.T, torch.minimum(tf1 @ tb.T, tf2 @ tb.T)


def fwd_sums_plain(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor, tf2: Tensor,
                   tb: Tensor, disc: Tensor) -> Tensor:
    """[Σ_off (resid1² + resid2²), Σ_diag (M1 + M2)]."""
    m1, m2, tm = _measures(f1, f2, b, tf1, tf2, tb)
    off = ~torch.eye(f1.shape[0], dtype=torch.bool, device=f1.device)
    r1, r2 = m1 - disc * tm, m2 - disc * tm
    off_sum = torch.where(off, r1 * r1 + r2 * r2, 0.0).sum()
    return torch.stack([off_sum, torch.trace(m1) + torch.trace(m2)])


def cov_sums_plain(b: Tensor) -> Tensor:
    """[Σ_off cov², Σ_diag cov] with cov = B·Bᵀ."""
    cov = b @ b.T
    off = ~torch.eye(b.shape[0], dtype=torch.bool, device=b.device)
    return torch.stack([torch.where(off, cov * cov, 0.0).sum(), torch.trace(cov)])


def _weights(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor, tf2: Tensor,
             tb: Tensor, disc: Tensor, g: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """w = 2·g_off·off·resid + g_diag·diag, for both forward heads."""
    m1, m2, tm = _measures(f1, f2, b, tf1, tf2, tb)
    diag = torch.eye(f1.shape[0], dtype=torch.bool, device=f1.device)
    w1 = torch.where(diag, g[1], 2.0 * g[0] * (m1 - disc * tm))
    w2 = torch.where(diag, g[1], 2.0 * g[0] * (m2 - disc * tm))
    return w1, w2


def bwd_df_plain(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor, tf2: Tensor,
                 tb: Tensor, disc: Tensor, g: Tensor) -> tp.Tuple[Tensor, Tensor]:
    w1, w2 = _weights(f1, f2, b, tf1, tf2, tb, disc, g)
    return w1 @ b, w2 @ b


def bwd_db_plain(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor, tf2: Tensor,
                 tb: Tensor, disc: Tensor, g: Tensor) -> Tensor:
    w1, w2 = _weights(f1, f2, b, tf1, tf2, tb, disc, g)
    return w1.T @ f1 + w2.T @ f2


# -- kernel wrappers ----------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fb_max_d": [],
    "fb_fwd_partials": [_I],
    "fb_cov_partials": [_I, _I],
    "fb_fwd_sums": [_P] * 9 + [_I, _I, _P],
    "fb_cov_sums": [_P] * 3 + [_I, _I, _P],
    "fb_bwd_df": [_P] * 10 + [_I, _I, _P],
    "fb_bwd_db": [_P] * 9 + [_I, _I, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with argtypes declared."""
    lib = _build.load("fused_fb")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.cache
def _max_d() -> int:
    return _lib().fb_max_d()


@functools.cache
def _scratch_floats(kernel: str, n: int, d: int) -> int:
    """Floats of scratch that ``fb_fwd_sums`` or ``fb_cov_sums`` needs."""
    lib = _lib()
    return lib.fb_fwd_partials(n) if kernel == "fwd" else lib.fb_cov_partials(n, d)


def _on_cpu(*xs: Tensor) -> bool:
    devices = {x.device.type for x in xs}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"}:
        raise ValueError(f"fused FB loss: tensors on {sorted(devices)}; "
                         "expected all on the CPU or all on one CUDA device")
    return False


def _check(rows: tp.Sequence[Tensor], disc: tp.Optional[Tensor],
           g: tp.Optional[Tensor]) -> tp.Tuple[int, int]:
    n, d = rows[0].shape
    if not 2 <= n or not 1 <= d <= _max_d():
        raise ValueError(f"fused FB loss: need n >= 2 and 1 <= d <= "
                         f"{_max_d()}, got [{n}, {d}]")
    shaped = [(x, (n, d)) for x in rows]
    if disc is not None:
        shaped.append((disc, (n, 1)))
    if g is not None:
        shaped.append((g, (4,)))
    device = rows[0].device
    for x, shape in shaped:
        if x.device != device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"fused FB loss: expected a contiguous float32 {list(shape)} "
                f"tensor on {device}, got {x.dtype} {list(x.shape)} on "
                f"{x.device} (contiguous={x.is_contiguous()})")
    return n, d


def _ptrs(*xs: Tensor) -> tp.List[int]:
    return [x.data_ptr() for x in xs]


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"fused FB kernel {name} failed to launch: CUDA "
                           f"error {rc}")
    launches[name] += 1


def fwd_sums(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor, tf2: Tensor,
             tb: Tensor, disc: Tensor) -> Tensor:
    """Kernel 1 (replaces ``_fwd_kernel``): float32 [2] sums."""
    if _on_cpu(f1, f2, b, tf1, tf2, tb, disc):
        return fwd_sums_plain(f1, f2, b, tf1, tf2, tb, disc)
    n, d = _check((f1, f2, b, tf1, tf2, tb), disc, None)
    partials = torch.empty(_scratch_floats("fwd", n, d), device=f1.device)
    out = torch.empty(2, device=f1.device)
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    rc = _lib().fb_fwd_sums(*_ptrs(f1, f2, b, tf1, tf2, tb, disc, partials, out),
                         n, d, stream)
    _launched("fwd_sums", rc)
    return out


def cov_sums(b: Tensor) -> Tensor:
    """Kernel 2 (replaces ``_cov_kernel``): float32 [2] sums."""
    if _on_cpu(b):
        return cov_sums_plain(b)
    n, d = _check((b,), None, None)
    partials = torch.empty(_scratch_floats("cov", n, d), device=b.device)
    out = torch.empty(2, device=b.device)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    rc = _lib().fb_cov_sums(*_ptrs(b, partials, out), n, d, stream)
    _launched("cov_sums", rc)
    return out


def bwd_df(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor, tf2: Tensor,
           tb: Tensor, disc: Tensor, g: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Kernel 3 (replaces ``_bwd_kernel``): dF1, dF2 of the FB sums."""
    if _on_cpu(f1, f2, b, tf1, tf2, tb, disc, g):
        return bwd_df_plain(f1, f2, b, tf1, tf2, tb, disc, g)
    n, d = _check((f1, f2, b, tf1, tf2, tb), disc, g)
    df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    rc = _lib().fb_bwd_df(*_ptrs(f1, f2, b, tf1, tf2, tb, disc, g, df1, df2),
                       n, d, stream)
    _launched("bwd_df", rc)
    return df1, df2


def bwd_db(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor, tf2: Tensor,
           tb: Tensor, disc: Tensor, g: Tensor) -> Tensor:
    """Kernel 4 (replaces ``_bwd_db_kernel``): dB of the FB sums."""
    if _on_cpu(f1, f2, b, tf1, tf2, tb, disc, g):
        return bwd_db_plain(f1, f2, b, tf1, tf2, tb, disc, g)
    n, d = _check((f1, f2, b, tf1, tf2, tb), disc, g)
    db = torch.empty_like(b)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    rc = _lib().fb_bwd_db(*_ptrs(f1, f2, b, tf1, tf2, tb, disc, g, db), n, d, stream)
    _launched("bwd_db", rc)
    return db


# -- the autograd function ----------------------------------------------------
class FBLossTermsFused(torch.autograd.Function):
    """The four sums as one float32 [4] tensor; backward through kernels 3
    and 4 plus the orthonormality term."""

    @staticmethod
    def forward(ctx: tp.Any, f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor,
                tf2: Tensor, tb: Tensor, discount: Tensor) -> Tensor:
        ctx.save_for_backward(f1, f2, b, tf1, tf2, tb, discount)
        return torch.cat([fwd_sums(f1, f2, b, tf1, tf2, tb, discount), cov_sums(b)])

    @staticmethod
    def backward(ctx: tp.Any, grad: Tensor) -> tp.Tuple[tp.Optional[Tensor], ...]:
        f1, f2, b, tf1, tf2, tb, discount = ctx.saved_tensors
        g = grad.float().contiguous()
        df1, df2 = bwd_df(f1, f2, b, tf1, tf2, tb, discount, g)
        db = bwd_db(f1, f2, b, tf1, tf2, tb, discount, g)
        # orthonormality: d/dB [g_covoff Σ_off cov² + g_covdiag Σ_diag cov],
        # with (cov⊙off)·B = B·(BᵀB) − diag(|b_i|²)·B
        cov_off_b = b @ (b.T @ b) - (b * b).sum(1, keepdim=True) * b
        db = db + 4.0 * g[2] * cov_off_b + 2.0 * g[3] * b
        # targets and discount are constants (stop-gradient in the caller)
        return df1, df2, db, None, None, None, None


def fb_loss_terms_fused(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor,
                        tf2: Tensor, tb: Tensor, discount: Tensor
                        ) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns (fb_offdiag_sum, fb_diag_sum, orth_offdiag_sum, orth_diag_sum)
    — UNnormalized sums. Every input is float32 [n, d] (discount [n, 1])."""
    args = [x.contiguous() for x in (f1, f2, b, tf1, tf2, tb, discount)]
    sums = FBLossTermsFused.apply(*args)
    return sums[0], sums[1], sums[2], sums[3]
