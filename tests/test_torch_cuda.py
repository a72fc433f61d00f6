"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card. This file imports nothing of JAX, so that it runs
on a machine that has PyTorch for CUDA and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from controllable_agent_torch.ops import fused_fb as ff


@pytest.fixture
def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


def _inputs(n: int, d: int, seed: int, device: torch.device):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(n, d).astype(np.float32) for _ in range(6)]
    xs.append(rng.uniform(0.9, 1.0, (n, 1)).astype(np.float32))
    return [torch.from_numpy(x).to(device) for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 300, 2], ids=["batch", "ragged", "smallest"])
def test_kernels_match_plain(cuda_device, n) -> None:
    """Sums at rtol 2e-4 (f32 sums in another order) and gradients at 1e-4 of
    their largest entry; each wrapper counts exactly one launch."""
    args = _inputs(n, 50, n, cuda_device)
    g = torch.tensor([0.5 / (n * (n - 1)), -1.0 / n, 1.0 / (n * (n - 1)), -2.0 / n],
                     device=cuda_device)
    before = dict(ff.launches)
    torch.testing.assert_close(ff.fwd_sums(*args), ff.fwd_sums_plain(*args),
                               rtol=2e-4, atol=1e-3)
    torch.testing.assert_close(ff.cov_sums(args[2]), ff.cov_sums_plain(args[2]),
                               rtol=2e-4, atol=1e-3)
    pairs = list(zip(ff.bwd_df(*args, g), ff.bwd_df_plain(*args, g)))
    pairs.append((ff.bwd_db(*args, g), ff.bwd_db_plain(*args, g)))
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    torch.cuda.synchronize()
    assert all(ff.launches[k] == before[k] + 1 for k in before)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device) -> None:
    args = _inputs(16, 50, 0, cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        ff.fwd_sums(*[x.double() for x in args])
    with pytest.raises(ValueError, match="contiguous float32"):
        ff.cov_sums(args[2].T.contiguous().T)
    with pytest.raises(ValueError, match="d <= 64"):
        ff.cov_sums(torch.zeros(16, 65, device=cuda_device))
