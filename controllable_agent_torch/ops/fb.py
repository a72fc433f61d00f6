"""Forward-Backward representation math, eager (mirror of
``controllable_agent_tpu/ops/fb.py``).

M = F · Bᵀ over a batch; the FB Bellman residual penalizes off-diagonal
entries against the discounted target measure and maximizes the diagonal.
This is the unfused path (``use_pallas_loss=False``); ``ops/fused_fb.py``
computes the same sums through the CUDA kernels.

Inputs are upcast to float32 at the loss boundary: squared residuals
amplify matmul noise. On the card the caller keeps
``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default) so these
products run in full float32.
"""

from __future__ import annotations

import math
import typing as tp

import torch


def sample_z(normal: torch.Tensor, uniform: tp.Optional[torch.Tensor] = None,
             norm_z: bool = True) -> torch.Tensor:
    """Scaled-normalized Gaussian z from a standard-normal draw [size, z_dim]
    (and, when ``norm_z`` is False, a uniform draw of the same shape)."""
    z_dim = normal.shape[-1]
    gaussian = normal / torch.linalg.vector_norm(
        normal, dim=-1, keepdim=True).clamp_min(1e-12)
    if norm_z:
        return math.sqrt(z_dim) * gaussian
    assert uniform is not None, "norm_z=False needs a uniform draw"
    return math.sqrt(z_dim) * uniform * gaussian


def off_diagonal_mask(n: int, device: torch.device) -> torch.Tensor:
    return ~torch.eye(n, dtype=torch.bool, device=device)


def fb_loss_terms(f1: torch.Tensor, f2: torch.Tensor, b: torch.Tensor,
                  target_m: torch.Tensor, discount: torch.Tensor
                  ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (fb_loss, fb_diag, fb_offdiag).

    loss = 0.5 Σ_i mean_offdiag (M_i − γ·target_M)² − Σ_i mean diag(M_i);
    ``discount`` is [batch, 1] and broadcasts row-wise.
    """
    f1, f2, b = (x.float() for x in (f1, f2, b))
    target_m = target_m.float()
    n = f1.shape[0]
    m1 = f1 @ b.T
    m2 = f2 @ b.T
    off = off_diagonal_mask(n, f1.device)
    denom = n * (n - 1)
    resid1 = torch.where(off, m1 - discount * target_m, 0.0)
    resid2 = torch.where(off, m2 - discount * target_m, 0.0)
    fb_offdiag = 0.5 * (resid1.square().sum() + resid2.square().sum()) / denom
    fb_diag = -(torch.trace(m1) + torch.trace(m2)) / n
    return fb_offdiag + fb_diag, fb_diag, fb_offdiag


def orthonormality_loss(b: torch.Tensor
                        ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cov = B·Bᵀ; loss = mean_offdiag Cov² − 2·mean diag(Cov).
    Returns (orth_loss, diag_term, offdiag_term)."""
    b = b.float()
    n = b.shape[0]
    cov = b @ b.T
    off = off_diagonal_mask(n, b.device)
    diag_term = -2.0 * torch.trace(cov) / n
    offdiag_term = torch.where(off, cov.square(), 0.0).sum() / (n * (n - 1))
    return offdiag_term + diag_term, diag_term, offdiag_term
