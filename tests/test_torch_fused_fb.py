"""Parity of the port's fused FB loss (controllable_agent_torch/ops/fused_fb.py)
with the JAX ``fb_loss_terms_fused`` (Pallas, interpret mode on the CPU).

On the CPU each wrapper runs its kernel's plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.ops.pallas_fb import fb_loss_terms_fused as jax_fused
from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig, UpdateNoise
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.ops import fused_fb as ff


def _inputs(n: int, d: int, seed: int):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(n, d).astype(np.float32) for _ in range(6)]
    xs.append(rng.uniform(0.9, 1.0, (n, 1)).astype(np.float32))
    return xs


def _normalized(sums, n):
    off, diag, cov_off, cov_diag = sums
    return (0.5 * off / (n * (n - 1)), -diag / n, cov_off / (n * (n - 1)),
            -2.0 * cov_diag / n)


def _port(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("n,d,seed", [(64, 16, 0), (300, 8, 1)],
                         ids=["n64", "ragged_n300"])
def test_forward_parity(n, d, seed) -> None:
    """Forward sums, rtol 2e-4 as tests/test_pallas_fb.py (f32 sums over n²
    in another order); n=300 is not a multiple of the JAX tile."""
    xs = _inputs(n, d, seed)
    want = _normalized([float(v) for v in jax_fused(*map(jnp.asarray, xs))], n)
    got = _normalized([float(v) for v in ff.fb_loss_terms_fused(*_port(xs))], n)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_gradient_parity() -> None:
    """Gradients of the normalized loss w.r.t. F1, F2, B (rtol 1e-3, atol
    1e-5 as tests/test_pallas_fb.py); targets and discount get none."""
    n = 48
    xs = _inputs(n, 8, 2)

    def loss_jax(f1, f2, b):
        o = _normalized(jax_fused(f1, f2, b, *map(jnp.asarray, xs[3:])), n)
        return o[0] + o[1] + o[2] + o[3]

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(*map(jnp.asarray, xs[:3]))
    args = _port(xs)
    for a in args:
        a.requires_grad_(True)
    o = _normalized(ff.fb_loss_terms_fused(*args), n)
    (o[0] + o[1] + o[2] + o[3]).backward()
    for a, w in zip(args[:3], want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-3, atol=1e-5)
    assert all(a.grad is None for a in args[3:])


def _jax_pieces(xs, g):
    """The JAX fused loss' sums and its VJP for cotangent g."""
    sums, vjp = jax.vjp(jax_fused, *map(jnp.asarray, xs))
    grads = vjp(tuple(jnp.float32(v) for v in g))
    return np.asarray(jnp.stack(sums)), [np.asarray(x) for x in grads[:3]]


@pytest.mark.parametrize("name", ["fwd_sums", "cov_sums", "bwd_df", "bwd_db"])
def test_each_kernel_plain_version(name) -> None:
    """Each wrapper's CPU path (its kernel's plain version) at the slice's
    z_dim d=50 against the piece of the JAX custom VJP it replaces. The
    backward cotangent has zero orthonormality parts, so the JAX VJP's dB
    is the FB part that kernel 4 computes (rtol 1e-4, atol 1e-6: f32
    products of O(1) entries summed over n=64)."""
    n = 64
    xs = _inputs(n, 50, 3)
    g = np.array([0.5 / (n * (n - 1)), -1.0 / n, 0.0, 0.0], np.float32)
    sums, (df1, df2, db) = _jax_pieces(xs, g)
    args, gt = _port(xs), torch.from_numpy(g)
    got, want = {
        "fwd_sums": (lambda: ff.fwd_sums(*args), sums[:2]),
        "cov_sums": (lambda: ff.cov_sums(args[2]), sums[2:]),
        "bwd_df": (lambda: torch.stack(ff.bwd_df(*args, gt)), np.stack([df1, df2])),
        "bwd_db": (lambda: ff.bwd_db(*args, gt), db),
    }[name]
    before = dict(ff.launches)
    np.testing.assert_allclose(got().numpy(), want, rtol=1e-4, atol=1e-6)
    assert ff.launches == before  # the CPU path launches no kernel


def test_orthonormality_gradient() -> None:
    """The orthonormality part of dB (computed outside the kernels)."""
    n = 32
    xs = _inputs(n, 50, 4)
    g = np.array([0.0, 0.0, 1.0 / (n * (n - 1)), -2.0 / n], np.float32)
    _, (_, _, db) = _jax_pieces(xs, g)
    args = _port(xs)
    args[2].requires_grad_(True)
    torch.autograd.backward(ff.FBLossTermsFused.apply(*args), torch.from_numpy(g))
    np.testing.assert_allclose(args[2].grad.numpy(), db, rtol=1e-4, atol=1e-6)


def test_wrapper_rejects_mixed_devices() -> None:
    xs = _port(_inputs(8, 4, 5))
    with pytest.raises(ValueError, match="expected all on the CPU"):
        ff.cov_sums(xs[2].to("meta"))
    with pytest.raises(ValueError, match="expected all on the CPU"):
        ff.fwd_sums(*xs[:6], xs[6].to("meta"))


def _small_cfg(**kw) -> FBDDPGConfig:
    return FBDDPGConfig(hidden_dim=32, backward_hidden_dim=32, feature_dim=16,
                        z_dim=8, batch_size=16, **kw)


def test_agent_update_fused_vs_unfused() -> None:
    """One update of the port with and without the fused loss, same state
    and noise: same fb_loss (rtol 5e-4, as tests/test_pallas_fb.py) and the
    same parameters afterwards."""
    rng = np.random.RandomState(0)
    n = 16
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    batch = EpisodeBatch(obs=t(n, 6), action=t(n, 3).clamp(-1, 1), reward=t(n, 1),
                         next_obs=t(n, 6), discount=torch.full((n, 1), 0.98))
    fused = FBDDPGAgent(_small_cfg(use_pallas_loss=True), 6, 3, device="cpu")
    plain = FBDDPGAgent(_small_cfg(), 6, 3, device="cpu")
    plain.load_state_dict(fused.state_dict())
    noise = UpdateNoise.draw(fused.cfg, n, 3, torch.Generator().manual_seed(1),
                             torch.device("cpu"))
    m_f, m_p = fused._update(batch, noise), plain._update(batch, noise)
    np.testing.assert_allclose(float(m_f["fb_loss"]), float(m_p["fb_loss"]), rtol=5e-4)
    assert set(m_f) == set(m_p) - {"target_M", "orth_linf", "orth_l2"}
    for (name, a), b in zip(fused.named_parameters(), plain.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=name)
