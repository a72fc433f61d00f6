"""Variants of the backward tile kernel against the committed one (NVIDIA
GPU with nvcc only).

    python -m controllable_agent_torch.tools.bwd_variants

Builds ``csrc/fused_fb.cu`` four ways: as it is (the depth loops of the
products and of dB rolled, the dF loop unrolled), with every loop unrolled,
with every loop rolled, and with single-pass TF32 products (hi * hi only)
in place of 3xTF32. For each, at n=1024, d=50, it prints the largest error
of dF1, dF2, dB against the plain PyTorch version (float32) over the largest
plain entry, and ``fb_bwd_tile_kernel``'s device time from ``torch.profiler``
in three settings: calls back to back; each call after a pass over 256 MB
(evicts L2); each call after seven 1024x1024 GEMM + tanh layers and that
pass, as in a training update. Times are medians of 30 calls. The card's
name and power limit come first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import typing as tp

import numpy as np
import torch

from controllable_agent_torch import _build
from controllable_agent_torch.ops import fused_fb as ff
from controllable_agent_torch.utils.device import card_name_and_power_limit

N, D, CALLS = 1024, 50, 30
ROLLED = "#pragma unroll 1\n"
DF_LOOP = "#pragma unroll\n  for (int kk = 0; kk < 4; ++kk) {"
CROSS_TERMS = "  mma_tf32(c, a.lo, b.hi);\n  mma_tf32(c, a.hi, b.lo);\n"


def variants(source: str) -> tp.Dict[str, str]:
    if source.count(ROLLED) != 3 or source.count(DF_LOOP) != 1 \
            or source.count(CROSS_TERMS) != 1:
        raise RuntimeError("csrc/fused_fb.cu no longer has the code this study edits")
    return {"as committed": source,
            "all unrolled": source.replace(ROLLED, "#pragma unroll\n"),
            "all rolled": source.replace(DF_LOOP, DF_LOOP.replace("unroll", "unroll 1")),
            "single-pass TF32": source.replace(CROSS_TERMS, "")}


def build(name: str, source: str) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name.replace(' ', '_')}.cu"
    src.write_text(source)
    lib_path = src.with_suffix(".so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.fb_bwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.fb_bwd_partials.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def tile_kernel_us(call: tp.Callable[[], tp.Any], before: tp.Callable[[], None]) -> float:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            before()
            call()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "fb_bwd_tile" in e.name]
    if len(times) != CALLS:
        raise AssertionError(f"expected {CALLS} tile kernels in the trace, got {len(times)}")
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA device is available", file=sys.stderr)
        return 1
    libs = {name: build(name, src)
            for name, src in variants((_build.CSRC / "fused_fb.cu").read_text()).items()}
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.randn(N, D).astype(np.float32)).cuda() for _ in range(6)]
    disc = torch.from_numpy(rng.uniform(0.9, 1.0, (N, 1)).astype(np.float32)).cuda()
    g = torch.tensor([0.5 / (N * (N - 1)), -1.0 / N, 0.0, 0.0], device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    want = torch.stack(ff.bwd_plain(*xs, disc, g))
    junk = torch.zeros(64 << 20, device="cuda")
    layers = [torch.randn(N, N, device="cuda") for _ in range(8)]

    def gemms_then_evict() -> None:
        h = layers[0]
        for w in layers[1:]:
            h = torch.tanh(h @ w)
        junk.add_(1.0)

    settings = {"back to back": lambda: None, "after L2 eviction": lambda: junk.add_(1.0),
                "after GEMMs + L2 eviction": gemms_then_evict}
    stream = torch.cuda.current_stream().cuda_stream
    print(f"card: {card_name_and_power_limit()}")
    for name, lib in libs.items():
        partials = torch.empty(lib.fb_bwd_partials(N, D), device="cuda")
        outs = [torch.empty(N, D, device="cuda") for _ in range(3)]
        ptrs = [x.data_ptr() for x in (*xs, disc, g, partials, *outs)]

        def call() -> None:
            if lib.fb_bwd(*ptrs, N, D, stream) != 0:
                raise RuntimeError("fb_bwd failed to launch")

        for _ in range(3):
            call()
        err = float((torch.stack(outs) - want).abs().max() / want.abs().max())
        print(f"{name}: max abs error / max |plain| {err:.3e}; fb_bwd_tile_kernel median " + ", ".join(
            f"{setting} {tile_kernel_us(call, before):.2f} us"
            for setting, before in settings.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
