"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` into ``build/torch_kernels/lib<name>-<hash>.so`` at the root
of the checkout (``/build/`` is git-ignored), then loaded with ``ctypes``.
The hash covers the source and the flags, so an edited source is rebuilt
and an unchanged one is reused. A failed build raises; there is no fallback.

    python -m controllable_agent_torch._build    # build every source now
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import typing as tp
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    found = str(candidate) if candidate.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels of controllable_agent_torch are built on the machine "
            "with the card")
    return found


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> tp.Tuple[Path, Path, subprocess.Popen]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish_build(name: str, out: Path, tmp: Path,
                  proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build(names: tp.Optional[tp.Sequence[str]] = None
          ) -> tp.Tuple[float, tp.Dict[str, str]]:
    """Compile the given sources (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` per source, all started together. Returns the
    wall-clock seconds spent and each compiled source's ``nvcc`` output
    (ptxas' registers, shared memory and spills per kernel)."""
    t0 = time.perf_counter()
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = [(name, *_start_build(name)) for name in names
            if not library_path(name).exists()]
    logs = {name: _finish_build(name, out, tmp, proc)
            for name, out, tmp, proc in jobs}
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it first if needed;
    the caller keeps the handle."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


if __name__ == "__main__":
    seconds, logs = build()
    for log in logs.values():
        print(log)
    print(f"built in {seconds:.1f} s into {BUILD_DIR}")
