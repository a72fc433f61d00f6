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
    """Each launch passes its table by value: five (Adam: p, g, mu, nu, the
    copy) or three (lerp: target, source, copy) pointers, a size, a prefix
    entry and a gradient-dtype byte a tensor, under the 4 KiB a kernel's
    parameters may take on every CUDA version; the refresh's table is the
    lerp's with two pointers. The kernels keep the name a trace finds the
    optimizer layer by; the refresh's is another."""
    adam, lerp = _constant("kAdamMaxTensors"), _constant("kLerpMaxTensors")
    adam_bytes = adam * (5 * 8 + 8 + 4 + 1) + 8 + 48  # + tensors, padding; AdamArgs
    lerp_bytes = lerp * (3 * 8 + 8 + 4 + 1) + 8 + 4
    assert adam_bytes <= 4096 and lerp_bytes <= 4096
    assert _constant("kChunk") % (_constant("kThreads") * _constant("kVec")) == 0
    text = SOURCE.read_text()
    for kernel in ("adam_multi_tensor_apply_kernel", "lerp_multi_tensor_apply_kernel",
                   "bf16_copy_refresh_kernel"):
        assert re.search(rf"__global__ void __launch_bounds__\(kThreads\)\n{kernel}\(", text)
    assert "multi_tensor_apply_kernel" not in "bf16_copy_refresh_kernel"


def _with_copies(seed=0, mu_dtype=torch.bfloat16):
    """Adam's lists over five tensors, three with a bf16 copy and a bf16
    gradient (a Linear weight and bias), two without (a LayerNorm's)."""
    gen = torch.Generator().manual_seed(seed)
    sizes = (6, 50, 526, 7, 2049)
    params = [torch.randn(n, generator=gen) for n in sizes]
    has_copy = (True, True, False, False, True)
    copies = [p.bfloat16() if c else None for p, c in zip(params, has_copy)]
    grads = [torch.randn(n, generator=gen) for n in sizes]
    grads = [g.bfloat16() if c else g for g, c in zip(grads, has_copy)]
    mus = [torch.zeros(n, dtype=mu_dtype) for n in sizes]
    nus = [torch.zeros(n) for n in sizes]
    return params, grads, mus, nus, copies


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_adam_with_bf16_gradients_equals_plain_on_the_widened_ones(mu_dtype) -> None:
    """(c) ``adam`` with bf16 gradients of the copies equals ``adam_plain``
    on the gradients widened by ``.float()`` to the bit, over three steps,
    and writes each copy as ``.to(torch.bfloat16)`` of its new parameter;
    a parameter without a copy keeps none."""
    params, grads, mus, nus, copies = _with_copies(mu_dtype=mu_dtype)
    twin = [[x.clone() for x in xs] for xs in (params, mus, nus)]
    count, twin_count = (torch.zeros((), dtype=torch.int32) for _ in range(2))
    ticket = torch.zeros((), dtype=torch.int32)
    for step in range(3):
        step_grads = [(g.float() * (step + 1)).to(g.dtype) for g in grads]
        optim.adam(params, step_grads, mus, nus, count, ticket, 1e-2, 0.9, 0.999, 1e-8, copies)
        optim.adam_plain(twin[0], [g.float() for g in step_grads], twin[1], twin[2],
                         twin_count, 1e-2, 0.9, 0.999, 1e-8)
    for name, got, want in zip(("p", "mu", "nu"), (params, mus, nus), twin):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    assert int(count) == int(twin_count) == 3
    for p, c in zip(params, copies):
        assert c is None or (c.dtype == torch.bfloat16 and torch.equal(c, p.bfloat16()))


@pytest.mark.parametrize("tau", [0.01, 0.7])
def test_lerp_writes_the_targets_copies(tau) -> None:
    """(c) ``lerp_`` with copies equals ``torch._foreach_lerp_`` to the bit
    and writes each copy as ``.to(torch.bfloat16)`` of its new target."""
    targets, _, _, _, copies = _with_copies(seed=1)
    sources = [torch.randn_like(t) for t in targets]
    twin = [t.clone() for t in targets]
    optim.lerp_(targets, sources, tau, copies)
    torch._foreach_lerp_(twin, sources, tau)
    assert all(torch.equal(a, b) for a, b in zip(targets, twin))
    for t, c in zip(targets, copies):
        assert c is None or torch.equal(c, t.bfloat16())


def test_a_bf16_gradient_without_a_copy_is_refused() -> None:
    """(c) A bf16 gradient is the gradient of a copy: without one, ``adam``
    raises on the CPU as on a card, naming the tensor, and changes nothing;
    the card's check takes mixed gradients and absent copies, and refuses a
    copy of another dtype."""
    params, grads, mus, nus, copies = _with_copies()
    copies[1] = None
    before = [p.clone() for p in params]
    count, ticket = (torch.zeros((), dtype=torch.int32) for _ in range(2))
    with pytest.raises(ValueError, match=r"adam: grads\[1\] is torch.bfloat16 and params\[1\] "
                                         r"has no bfloat16 copy"):
        optim.adam(params, grads, mus, nus, count, ticket, 1e-2, 0.9, 0.999, 1e-8, copies)
    assert all(torch.equal(a, b) for a, b in zip(params, before)) and int(count) == 0
    lists = {"params": params, "grads": grads, "mus": mus, "nus": nus, "copies": copies}
    optim._check("adam", lists, optim._ADAM_DTYPES)
    lists["copies"] = [None, None, None, None, params[4].clone()]
    with pytest.raises(ValueError, match=r"adam: copies\[4\] is torch.float32; the kernel "
                                         r"takes copies of torch.bfloat16"):
        optim._check("adam", lists, optim._ADAM_DTYPES)


def test_adam_over_a_bf16_network_steps_its_copies() -> None:
    """``Adam.leaves`` of a bf16 network are its Dense copies and its
    LayerNorm parameters; a step with their gradients writes the copies and
    leaves them fresh: the next forward refreshes nothing."""
    from controllable_agent_torch.models.networks import BackwardMap, Dense
    from controllable_agent_torch.utils import trace
    torch.manual_seed(0)
    net = BackwardMap(5, 4, 16, dtype=torch.bfloat16)
    opt = optim.Adam(net, 1e-2, torch.bfloat16)
    dense = [m for m in net.modules() if isinstance(m, Dense)]
    copies = {id(c.copy) for m in dense for c in m.bf16}
    assert [id(x) in copies for x in opt.leaves] == [
        "Dense" in k for k in opt.params]
    x = torch.randn(8, 5)
    net(x)
    grads = torch.autograd.grad(net(x).float().square().sum(), opt.leaves)
    opt.step(grads)
    assert not any(c.stale() for m in dense for c in m.bf16)
    for m in dense:
        assert torch.equal(m.bf16[0].copy, m.weight.bfloat16())
    refreshes = trace.counters["bf16_copy.refreshes"]
    net(x)
    assert trace.counters["bf16_copy.refreshes"] == refreshes


def test_adam_steps_the_copies_a_moved_network_reads() -> None:
    """Adam built before a move steps the copies the layers read after it:
    a move that changes nothing keeps each ``Bf16Copy`` and its tensor, a
    round trip through float64 gives the layers new copies, and in both
    cases ``Adam.leaves`` are the copies the forward reads, the step writes
    them and the next forward refreshes nothing."""
    from controllable_agent_torch.models.networks import BackwardMap, Dense
    from controllable_agent_torch.utils import trace
    torch.manual_seed(0)
    net = BackwardMap(5, 4, 16, dtype=torch.bfloat16)
    opt = optim.Adam(net, 1e-2, torch.bfloat16)
    x = torch.randn(8, 5)
    net(x)
    dense = [m for m in net.modules() if isinstance(m, Dense)]
    held = [(c, c.copy) for m in dense for c in m.bf16]
    for move in (lambda: net.to("cpu"), lambda: net.to(torch.float64).to(torch.float32)):
        move()
        read = [c.copy for m in dense for c in m.bf16]
        assert {id(x) for x in opt.leaves} >= {id(x) for x in read}
        grads = torch.autograd.grad(net(x).float().square().sum(), opt.leaves)
        opt.step(grads)
        for m in dense:
            assert not any(c.stale() for c in m.bf16)
            assert torch.equal(m.bf16[0].copy, m.weight.bfloat16())
        refreshes = trace.counters["bf16_copy.refreshes"]
        net(x)
        assert trace.counters["bf16_copy.refreshes"] == refreshes
        if held:  # the move that changed nothing kept every copy where it was
            assert [(c, c.copy) for m in dense for c in m.bf16] == held
            held = []


# the collectives that write their operand in place, and where the port may call them
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_single",
                "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "reduce", "broadcast", "broadcast_object_list", "scatter", "recv", "irecv")
_COLLECTIVES_AT = {"utils/dist.py": {"all_reduce", "all_gather_into_tensor",
                                     "all_gather_single"}}


def _writes_past_the_version_counter(path: Path) -> list:
    """The places in ``path`` that write a tensor without its version
    counter seeing it: through ``.data`` (assigned, written in place,
    iterated, or handed to a function that writes in place; ``self.data``
    is a field of the class, not a tensor's), and the collectives named in
    ``_COLLECTIVES`` (called, or named as a string)."""
    import ast
    tree = ast.parse(path.read_text())
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "data" \
                and not (isinstance(node.value, ast.Name) and node.value.id == "self"):
            up = parents.get(node)
            target = node
            while isinstance(up, ast.Subscript) and up.value is target:
                target, up = up, parents.get(up)
            writes = (
                isinstance(target.ctx, ast.Store)
                or (isinstance(up, ast.Attribute) and up.attr.endswith("_")
                    and not up.attr.startswith("_"))
                or (isinstance(up, ast.For) and up.iter is target)
                or (isinstance(up, ast.Call) and target in up.args
                    and getattr(up.func, "attr", getattr(up.func, "id", "")).endswith("_")))
            if writes:
                found.append(f"{path.name}:{node.lineno} .data")
        name = None
        if isinstance(node, ast.Call):
            name = getattr(node.func, "attr", getattr(node.func, "id", None))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            name = node.value
        if name in _COLLECTIVES:
            found.append(f"{path.name}:{node.lineno} {name}")
    return found


def test_the_port_writes_no_parameter_past_its_version_counter() -> None:
    """A bf16 compute copy is stale when its parameter's version counter or
    address moved (``optim.Bf16Copy.stale``); a write the counter does not
    see would leave it stale unseen. The port makes none: no write through
    ``.data``, and no collective but the all-reduces and gathers of
    ``utils/dist.py`` (into gradients, statistics and gathered rows). A new
    one fails here; it owes the parameter
    ``torch.autograd.graph.increment_version``."""
    root = Path(optim.__file__).resolve().parent
    found = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        allowed = _COLLECTIVES_AT.get(rel, set())
        hits = [h for h in _writes_past_the_version_counter(path)
                if h.split()[-1] not in allowed]
        if hits:
            found[rel] = hits
    assert not found, found


@pytest.mark.parametrize("source", [
    "p.data = q", "p.data.copy_(q)", "p.data[0] = 1", "p.data[0].mul_(2)",
    "for w in p.data: pass", "nn.init.orthogonal_(p.data)", "dist.broadcast(p, 0)",
    "getattr(dist, 'broadcast')(p, 0)", "dist.all_reduce(p)"])
def test_the_guard_finds_each_kind_of_unseen_write(source, tmp_path) -> None:
    """What ``_writes_past_the_version_counter`` finds, and what it lets be:
    reading ``.data``'s shape, a field named ``data``, or setting a class's
    own ``self.data`` is no write."""
    path = tmp_path / "m.py"
    path.write_text(source + "\n")
    assert _writes_past_the_version_counter(path)
    path.write_text("n = p.data.shape[-1]\nflat = hf.data.reshape(2, 3)\nx = p.data_ptr()\n"
                    "self.data = memoryview(b'')\n")
    assert not _writes_past_the_version_counter(path)
