"""What every driver shares: finding a cell's files by name, the caches
inside the checkout, the device's description, host spans, the guard
against JAX, and the result's last line.

A cell is ``workloads/<name>.json``: its configuration (``configs/<name>.json``),
its driver (``drivers/<driver>.py``) and the driver's parameters. A
per-layer metric is ``metrics/<metric name>.py``, whose ``read(record)``
returns a number or None.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import typing as tp
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "controllable_agent_tpu")

# widths and sizes of a rehearsal on the CPU: the layers and the control
# flow of a cell, at sizes a test can hold
REHEARSAL = {
    "agent_config": {"hidden_dim": 32, "feature_dim": 16, "backward_hidden_dim": 16,
                     "z_dim": 8, "batch_size": 32},
    "replay": {"episodes": 6, "episode_length": 40},
    "workload": {"steps_per_call": 4, "profile_steps": 4, "num_envs": 2,
                 "episode_length": 30, "replay_episodes": 12},
}


def load_json(path: Path) -> tp.Dict[str, tp.Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> tp.Dict[str, tp.Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, rehearse: bool = False
         ) -> tp.Tuple[tp.Dict[str, tp.Any], tp.Dict[str, tp.Any]]:
    """The workload's and its configuration's files, with a rehearsal's
    sizes laid over them."""
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    if rehearse:
        config = {**config,
                  "agent_config": {**config["agent_config"], **REHEARSAL["agent_config"]},
                  "replay": {**config["replay"], **REHEARSAL["replay"]}}
        workload = {**workload, **{k: v for k, v in REHEARSAL["workload"].items()
                                   if k in workload}}
    return workload, config


def load_module(path: Path) -> tp.Any:
    """A module from its file (metric files have dots in their names)."""
    name = "perfbench_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    assert spec is not None and spec.loader is not None
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def per_layer(bench: tp.Mapping[str, tp.Any], workload: str) -> tp.List[tp.Dict[str, tp.Any]]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    mine = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def end_to_end(bench: tp.Mapping[str, tp.Any], workload: str) -> tp.List[tp.Dict[str, tp.Any]]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only the first run of a cell there builds (the port's own nvcc
    build is ``build/torch_kernels`` already)."""
    cache = ROOT / "build" / "perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_loaded() -> tp.List[str]:
    """The modules of JAX or of the JAX package in this process, compared by
    their whole top-level names."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@contextlib.contextmanager
def span(name: str) -> tp.Iterator[None]:
    """A host span that the profiler records (a no-op when it is off)."""
    import torch
    with torch.profiler.record_function(name):
        yield


def device_info(torch: tp.Any, device: tp.Any, count: int) -> tp.Dict[str, tp.Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def emit(result: tp.Dict[str, tp.Any], checks: tp.Mapping[str, tp.Tuple[float, float]]) -> None:
    """Each number compared beside its limit, as the last lines on standard
    error and as the last key of the result, then the result as the last
    line of standard output."""
    result = dict(result)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


class Context:
    """What a driver is handed: the cell's files, the device, the run's
    arguments, and the checks it shares with the other drivers."""

    def __init__(self, workload: tp.Dict[str, tp.Any], config: tp.Dict[str, tp.Any],
                 device: tp.Any, chips: int, seed: int, seconds: float, trace: bool,
                 started: float) -> None:
        import torch

        from perfbench.reference.nets import Products
        self.workload, self.config, self.device, self.chips = workload, config, device, chips
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.started, self.log = started, sys.stderr
        self.reference = importlib.import_module(f"perfbench.reference.{config['reference']}")
        self.environment = (importlib.import_module(f"perfbench.reference.{config['environment']}")
                            if config.get("environment") else None)
        self.products = Products()
        self._torch = torch

    def sync(self) -> None:
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)

    def device_info(self) -> tp.Dict[str, tp.Any]:
        return device_info(self._torch, self.device, self.chips)

    def launches_before(self) -> None:
        if self.device.type == "cuda":
            from controllable_agent_torch.ops import fused_fb
            fused_fb.reset_launches()

    def launches_after(self, expected: int) -> tp.Dict[str, float]:
        """How far the fused FB loss's launches, by the wrappers' count and
        by the kernels' own, are from one of each per update (a
        configuration with the fused loss), or how many there were (one
        without it)."""
        if self.device.type != "cuda":
            return {}
        from controllable_agent_torch.ops import fused_fb
        if not self.config.get("fused_loss"):
            return {"fused_launches": float(sum(fused_fb.launches.values()))}
        ran = fused_fb.device_runs()
        print(f"fused launches {dict(fused_fb.launches)} by the wrappers, {ran} by the kernels, "
              f"{expected} expected of each", file=self.log)
        return {"fused_miscount": float(max(abs(fused_fb.launches[k] - expected)
                                            + abs(ran[k] - expected) for k in ran))}


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi gave nothing)"
