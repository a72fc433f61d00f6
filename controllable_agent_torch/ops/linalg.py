"""Least squares and the pseudo-inverse with the JAX package's cutoffs.

The successor-feature agents infer a task z by least squares of their
features on rewards (``jnp.linalg.lstsq``) and whiten features by the
pseudo-inverse of their covariance (``jnp.linalg.pinv``). Both JAX functions
go through an SVD and drop small singular values; PyTorch's own differ:
``torch.linalg.lstsq`` on CUDA has only the ``gels`` routine, which assumes
full rank, and ``torch.linalg.pinv`` cuts at ``max(M, N) * eps`` where JAX
cuts at ten times that. So the port writes both once, as SVD solves with
JAX's cutoffs, and runs the same code on every device. A feature matrix of
deficient rank (duplicated or always-zero columns, or fewer samples than
features) gets the minimum-norm solution, as in JAX.
"""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor


def lstsq(a: Tensor, b: Tensor, rcond: tp.Optional[float] = None) -> Tensor:
    """The minimum-norm x minimising |a x - b| for a [M, N] and b [M, K]
    (``jnp.linalg.lstsq(a, b)[0]``): singular values below ``rcond`` times
    the largest are dropped; ``rcond`` defaults to JAX's ``eps * max(M, N)``
    of ``a``'s dtype (a float64 reference of a float32 solve passes the
    float32 value)."""
    m, n = a.shape
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vh.mT @ (s_inv[:, None] * (u.mT @ b))


def pinv(a: Tensor, rtol: tp.Optional[float] = None) -> Tensor:
    """``jnp.linalg.pinv(a)``: singular values at or below ``rtol`` times the
    largest are dropped; ``rtol`` defaults to JAX's ``10 * max(M, N) * eps``
    of ``a``'s dtype (a float64 reference passes the float32 value)."""
    if rtol is None:
        rtol = 10 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rtol)
