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


def _cotangent(n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([0.5 / (n * (n - 1)), -1.0 / n, 1.0 / (n * (n - 1)), -2.0 / n],
                        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1024, 50), (300, 50), (2, 50), (4096, 50), (300, 13),
                                 (300, 64)],
                         ids=["batch", "ragged", "smallest", "large", "odd_width", "widest"])
def test_kernels_match_plain(cuda_device, n, d) -> None:
    """Sums at rtol 2e-4 (f32 sums in another order) and gradients at 1e-4 of
    their largest entry; each wrapper counts exactly one launch. An odd width
    takes the backward's 4-byte staging path; 64 its widest instance."""
    args = _inputs(n, d, n, cuda_device)
    g = _cotangent(n, cuda_device)
    before = dict(ff.launches)
    torch.testing.assert_close(ff.fwd_sums(*args), ff.fwd_sums_plain(*args),
                               rtol=2e-4, atol=1e-3)
    torch.testing.assert_close(ff.cov_sums(args[2]), ff.cov_sums_plain(args[2]),
                               rtol=2e-4, atol=1e-3)
    for got, want in zip(ff.bwd(*args, g), ff.bwd_plain(*args, g)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    torch.cuda.synchronize()
    assert all(ff.launches[k] == before[k] + 1 for k in before)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 300], ids=["batch", "ragged"])
def test_backward_is_bitwise_repeatable(cuda_device, n) -> None:
    """The backward sums its per-tile partials in a fixed order, so two calls
    on the same inputs give the same bits."""
    args = _inputs(n, 50, n + 1, cuda_device)
    g = _cotangent(n, cuda_device)
    first, second = ff.bwd(*args, g), ff.bwd(*args, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_backward_takes_rows_that_are_not_8_byte_aligned(cuda_device) -> None:
    """Contiguous views at an odd float offset take the 4-byte staging path."""
    n, d = 300, 50
    args = _inputs(n, d, 7, cuda_device)
    shifted = []
    for x in args[:6]:
        buf = torch.empty(x.numel() + 1, device=cuda_device)
        view = buf[1:].view(n, d)
        view.copy_(x)
        shifted.append(view)
    assert all(x.data_ptr() % 8 == 4 for x in shifted)
    g = _cotangent(n, cuda_device)
    for got, want in zip(ff.bwd(*shifted, args[6], g), ff.bwd_plain(*args, g)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device) -> None:
    args = _inputs(16, 50, 0, cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        ff.fwd_sums(*[x.double() for x in args])
    with pytest.raises(ValueError, match="contiguous float32"):
        ff.cov_sums(args[2].T.contiguous().T)
    with pytest.raises(ValueError, match="d <= 64"):
        ff.cov_sums(torch.zeros(16, 65, device=cuda_device))
