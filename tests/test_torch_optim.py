"""The optimizer layer's host side on the CPU (``controllable_agent_torch/optim.py``).

The kernels (``csrc/fused_optim.cu``) run only on a card and are held to the
_foreach versions there (``tests/test_torch_cuda.py``), where each element of
each tensor is covered once by a launch's blocks; here: how tensor lists are
split into launches, what the wrappers refuse and how they say it, that the
CPU takes the plain versions and counts no launch, the capture accounting
of the counts, and that the kernels' argument blocks fit the launch's 4 KiB.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from controllable_agent_torch import optim
from controllable_agent_torch.ops import fused_fb
from controllable_agent_torch.utils import graphs

from torch_threads import one_thread  # noqa: F401

SOURCE = Path(optim.__file__).resolve().parent / "csrc" / "fused_optim.cu"


def _random_sizes(count: int, most: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    sizes = rng.randint(0, most + 1, count)
    sizes[rng.rand(count) < 0.1] = 0  # empty tensors among them
    return [int(n) for n in sizes]


SIZE_LISTS = {
    "none": [],
    "one_element": [1],
    "one_empty": [0],
    "fb_shapes": [6, 50, 526, 276_676, 1_048_576, 1024, 512, 0],
    "chunk_edges": [2047, 2048, 2049, 4096, 1, 0, 4095],
    "random_30": _random_sizes(30, 9_000, 0),
    "random_2000": _random_sizes(2000, 5_000, 1),
}


@pytest.mark.parametrize("max_tensors", [64, 128, 3])
@pytest.mark.parametrize("name", list(SIZE_LISTS))
def test_plan_takes_every_tensor_once(name, max_tensors) -> None:
    """Every tensor, and so every element, in exactly one launch: whole
    tensors, in order, at most ``max_tensors`` a launch and none empty."""
    sizes = SIZE_LISTS[name]
    taken = []
    for at in optim.plan(len(sizes), max_tensors):
        assert 1 <= at.stop - at.start <= max_tensors and at.step is None
        taken.extend(range(len(sizes))[at])
    assert taken == list(range(len(sizes)))


def test_plan_splits_only_past_the_argument_block() -> None:
    count = len(SIZE_LISTS["random_2000"])
    assert [at.stop - at.start for at in optim.plan(count, 64)] == [64] * 31 + [16]
    assert len(optim.plan(64, 64)) == 1
    assert len(optim.plan(65, 64)) == 2
    assert optim.plan(0, 64) == []
    # the optimizers of the FB agent: 20, 8 and 16 tensors, one launch each
    assert [len(optim.plan(n, 64)) for n in (20, 8, 16)] == [1, 1, 1]


def _adam_lists(mu_dtype=torch.bfloat16):
    sizes = (6, 50, 526)
    return {"params": [torch.zeros(n) for n in sizes], "grads": [torch.zeros(n) for n in sizes],
            "mus": [torch.zeros(n, dtype=mu_dtype) for n in sizes],
            "nus": [torch.zeros(n) for n in sizes]}


def _one_bf16_param(lists):
    lists["params"][1] = lists["params"][1].bfloat16()


def _strided_nu(lists):
    lists["nus"][2] = torch.zeros(2 * 526)[::2]


def _half_mu(lists):
    lists["mus"] = [m.half() for m in lists["mus"]]


def _mixed_mu(lists):
    lists["mus"][0] = lists["mus"][0].float()


def _short_nus(lists):
    lists["nus"] = lists["nus"][:2]


def _grad_of_another_size(lists):
    lists["grads"][0] = torch.zeros(7)


def _transposed_param(lists):
    lists["params"][2] = torch.zeros(2, 263).t()


REFUSED = {
    "bf16_param": (_one_bf16_param, r"adam: params\[1\] is torch.bfloat16; the kernel takes "
                                    r"params of one dtype, torch.float32"),
    "strided_nu": (_strided_nu, r"adam: nus\[2\] is not contiguous"),
    "transposed_param": (_transposed_param, r"adam: params\[2\] is not contiguous"),
    "float16_mu": (_half_mu, r"adam: mus\[0\] is torch.float16; the kernel takes mus of one "
                             r"dtype, torch.float32 or torch.bfloat16"),
    "mixed_mu": (_mixed_mu, r"adam: mus\[1\] is torch.bfloat16; the kernel takes mus of one"),
    "short_list": (_short_nus, r"adam: 2 nus for 3 params"),
    "size": (_grad_of_another_size, r"adam: grads\[0\] has 7 elements, params\[0\] 6"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_check_names_what_the_kernel_does_not_take(case) -> None:
    """The check a card's tensors pass before a launch (on the CPU here: it
    reads only what the tensors are): each refusal a ``ValueError`` that
    names the tensor and the condition."""
    lists = _adam_lists()
    change, message = REFUSED[case]
    change(lists)
    with pytest.raises(ValueError, match=message):
        optim._check("adam", lists, optim._ADAM_DTYPES)


def test_lists_the_kernels_only_read_are_made_contiguous() -> None:
    """Gradients and a soft-update's sources in another layout (cuDNN's
    channels-last convolution weight gradients) are copied, values equal;
    contiguous ones are passed as they are."""
    dense = torch.randn(8, 3, 5, 5)
    channels_last = dense.to(memory_format=torch.channels_last)
    out = optim._dense([dense, channels_last, dense[:, 1]])
    assert out[0] is dense
    assert all(x.is_contiguous() for x in out)
    assert torch.equal(out[1], dense) and torch.equal(out[2], dense[:, 1])


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_check_takes_float32_lists_with_either_mu(mu_dtype) -> None:
    optim._check("adam", _adam_lists(mu_dtype), optim._ADAM_DTYPES)
    targets = [torch.zeros(4, 3), torch.zeros(6)]
    optim._check("lerp", {"targets": targets, "sources": [t.clone() for t in targets]},
                 {"targets": (torch.float32,), "sources": (torch.float32,)})


def test_a_device_neither_cpu_nor_cuda_raises() -> None:
    """Only the CPU takes the plain versions: on a device without the
    kernels the wrappers refuse rather than run a path no card takes."""
    params = [torch.zeros(3, device="meta")]
    count = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="adam: tensors on meta; the kernel runs on CUDA"):
        optim.adam(params, params, params, params, count, count, 1e-3, 0.9, 0.999, 1e-8)
    with pytest.raises(ValueError, match="lerp: tensors on meta; the kernel runs on CUDA"):
        optim.lerp_(params, params, 0.01)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_cpu_takes_the_plain_path(mu_dtype) -> None:
    """On the CPU ``Adam.step`` is ``adam_plain`` and ``lerp_`` is
    ``_foreach_lerp_``, to the bit, and no kernel launch is counted."""
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Linear(7, 3))
    opt = optim.Adam(module, 1e-2, mu_dtype)
    params = [p.detach().clone() for p in opt.params.values()]
    mus = [m.clone() for m in opt.mu.values()]
    nus = [n.clone() for n in opt.nu.values()]
    count = opt.count_t.clone()
    before = dict(optim.launches)
    for _ in range(3):
        grads = [torch.randn_like(p) for p in params]
        opt.step(grads)
        optim.adam_plain(params, grads, mus, nus, count, 1e-2, 0.9, 0.999, 1e-8)
    for a, b in zip(list(opt.params.values()) + list(opt.mu.values()) + list(opt.nu.values()),
                    params + mus + nus):
        assert torch.equal(a, b)
    assert opt.count == int(count) == 3
    targets = [torch.randn(4, 3), torch.randn(6)]
    twin = [t.clone() for t in targets]
    sources = [torch.randn(4, 3), torch.randn(6)]
    optim.lerp_(targets, sources, 0.01)
    torch._foreach_lerp_(twin, sources, 0.01)
    assert all(torch.equal(a, b) for a, b in zip(targets, twin))
    assert optim.launches == before
    assert not optim._on_card("adam", params[0])


def test_launches_held_by_a_capture_are_counted_at_each_replay() -> None:
    """``CapturedProgram``'s accounting, as it applies it to ``optim.launches``."""
    optim.reset_launches()
    optim.launches["adam"] = 5
    with graphs.held_by_capture(optim.launches) as held:
        optim.launches["adam"] += 3
        optim.launches["lerp"] += 2
    assert held == {"adam": 3, "lerp": 2} and optim.launches == {"adam": 5, "lerp": 0}
    graphs.count_replay(optim.launches, held, 4)
    assert optim.launches == {"adam": 17, "lerp": 8}
    optim.reset_launches()


def test_every_capture_holds_both_wrappers_counts() -> None:
    """``CapturedProgram`` holds back and replays every counted wrapper's
    launches: the fused FB loss's and the optimizer's, each its own dict."""
    assert any(c is fused_fb.launches for c in graphs._counted)
    assert any(c is optim.launches for c in graphs._counted)
    assert fused_fb.launches is not optim.launches


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def test_argument_blocks_fit_the_launch() -> None:
    """Each launch passes its table by value: four (Adam) or two (lerp)
    pointers, a size and a prefix entry a tensor, under the 4 KiB a kernel's
    parameters may take on every CUDA version; the kernels keep the name a
    trace finds the optimizer layer by."""
    adam, lerp = _constant("kAdamMaxTensors"), _constant("kLerpMaxTensors")
    adam_bytes = adam * (4 * 8 + 8 + 4) + 8 + 48  # + tensors, padding; AdamArgs
    lerp_bytes = lerp * (2 * 8 + 8 + 4) + 8 + 4
    assert adam_bytes <= 4096 and lerp_bytes <= 4096
    assert _constant("kChunk") % (_constant("kThreads") * _constant("kVec")) == 0
    text = SOURCE.read_text()
    for kernel in ("adam_multi_tensor_apply_kernel", "lerp_multi_tensor_apply_kernel"):
        assert re.search(rf"__global__ void __launch_bounds__\(kThreads\)\n{kernel}\(", text)
