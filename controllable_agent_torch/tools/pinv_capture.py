"""Which of the SF update's linear-algebra and permutation steps a CUDA
graph can hold, and what the pseudo-inverse costs between two graphs.

    python -m controllable_agent_torch.tools.pinv_capture

SF with ``mix_ratio`` > 0 whitens φ of permuted replay goals by the
pseudo-inverse of their [z, z] covariance (z = 100) inside every update.
This tool captures, each alone in a graph and in a process of its own (a
failed capture leaves its generator and the allocator unusable),
``torch.linalg.pinv``, ``torch.linalg.svd``, ``torch.linalg.eigh`` (each
checks its result on the host), ``torch.randperm`` with a generator and an
argsort of uniforms (the same distribution), and prints whether the capture
held. Then it times, at the update's sizes (1,024 x 100 features), a
program of two graphs with the pseudo-inverse run eagerly between them
(``utils/graphs.py:eager_step``, the design the SF update takes) against
the same work eagerly, and the pseudo-inverse of that covariance by each
of cuSOLVER's SVD algorithms, by an eigensolver and on the host, against
float64. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time
import typing as tp

import torch

from controllable_agent_torch.ops.linalg import pinv
from controllable_agent_torch.utils.device import card_name_and_power_limit
from controllable_agent_torch.utils.graphs import CapturedProgram, eager_step

N, Z = 1024, 100
REPLAYS = 200


def _steps(cov: torch.Tensor, gen: torch.Generator) -> tp.Dict[str, tp.Callable[[], tp.Any]]:
    return {
        "linalg.pinv": lambda: torch.linalg.pinv(cov),
        "linalg.svd": lambda: torch.linalg.svd(cov),
        "linalg.eigh": lambda: torch.linalg.eigh(cov),
        "randperm(generator)": lambda: torch.randperm(N, generator=gen, device="cuda"),
        "argsort(rand(generator))": lambda: torch.argsort(
            torch.rand(N, generator=gen, device="cuda")),
    }


def _inputs() -> tp.Tuple[torch.Tensor, torch.Generator]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    phi = torch.randn(N, Z, generator=gen, device="cuda")
    return phi.T @ phi / N, gen


def try_one(name: str) -> None:
    """Capture one step alone and say whether the capture held."""
    cov, gen = _inputs()
    try:
        CapturedProgram(_steps(cov, gen)[name], torch.device("cuda"), generators=[gen])
        print(f"{name}: captured")
    except RuntimeError as err:
        print(f"{name}: capture FAILED: {str(err).splitlines()[0][:160]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pinv_capture needs a CUDA device")
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        try_one(sys.argv[2])
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_name_and_power_limit()}")
    cov, gen = _inputs()
    for name in _steps(cov, gen):
        out = subprocess.run([sys.executable, "-m", __spec__.name, "--one", name],
                             capture_output=True, text=True, check=False)
        print(out.stdout.strip() or f"{name}: the process failed: {out.stderr[-300:]}")

    def mixed() -> torch.Tensor:
        x = torch.randn(N, Z, generator=gen, device="cuda")
        c = x.T @ x / N
        inv = eager_step(lambda: pinv(c))
        return x @ inv

    program = CapturedProgram(mixed, torch.device("cuda"), generators=[gen])
    for label, run in (("two graphs, pinv eager between", program.replay),
                       ("eager", mixed)):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPLAYS):
            run()
        torch.cuda.synchronize()
        print(f"{label}: {1e3 * (time.perf_counter() - t0) / REPLAYS:.4f} ms per run "
              f"(the program: {len(program.graphs)} graphs, {len(program.steps)} eager step)")
    rtol = 10 * Z * torch.finfo(torch.float32).eps
    want = pinv(cov.double().cpu(), rtol=rtol)

    def by_svd(algorithm: str) -> tp.Callable[[], torch.Tensor]:
        def run() -> torch.Tensor:
            u, s, vh = torch.linalg.svd(cov, driver=algorithm)
            s_inv = torch.where(s > rtol * s[0], 1.0 / s, torch.zeros_like(s))
            return (vh.mT * s_inv) @ u.mT
        return run

    def by_eigh() -> torch.Tensor:
        w, v = torch.linalg.eigh(cov)
        s_inv = torch.where(w.abs() > rtol * w.abs().max(), 1.0 / w, torch.zeros_like(w))
        return (v * s_inv) @ v.mT

    ways = {"pinv (ops/linalg.py)": lambda: pinv(cov), "svd gesvd": by_svd("gesvd"),
            "svd gesvdj": by_svd("gesvdj"), "svd gesvda": by_svd("gesvda"),
            "eigh": by_eigh, "host LAPACK": lambda: pinv(cov.cpu()).to("cuda")}
    for name, fn in ways.items():
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPLAYS // 4):
            fn()
        torch.cuda.synchronize()
        err = float((out.double().cpu() - want).norm() / want.norm())
        print(f"pseudo-inverse of the [{Z}, {Z}] covariance by {name}: "
              f"{4e3 * (time.perf_counter() - t0) / REPLAYS:.4f} ms per call (host clock "
              f"around synchronized calls), relative error {err:.2e} against float64")


if __name__ == "__main__":
    main()
