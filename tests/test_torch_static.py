"""Static checks of the PyTorch/CUDA port (``controllable_agent_torch/`` and
``chip_smoke.py``), read with ``ast``; nothing here runs the port.

  * the port imports nothing of JAX, no msgpack package (the card's machine
    has none), nothing of the JAX package and nothing of the root ``tools``
    package (the port keeps its own copies);
  * in ``ops/fused_fb.py`` every kernel's plain version has its wrapper
    beside it, and the wrapper takes that plain version for CPU tensors and
    counts its launches.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "controllable_agent_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "controllable_agent_tpu", "tools"}
FUSED = PORT / "ops" / "fused_fb.py"


def _imported_modules(tree: ast.AST) -> set:
    """Top-level names of every module imported anywhere in the tree
    (function bodies included); relative imports stay inside the port."""
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module.split(".")[0])
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path) -> None:
    modules = _imported_modules(ast.parse(path.read_text()))
    assert not modules & FORBIDDEN, f"{path} imports {sorted(modules & FORBIDDEN)}"


def test_port_has_modules_to_check() -> None:
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"controllable_agent_torch/ops/fused_fb.py", "controllable_agent_torch/_build.py",
            "controllable_agent_torch/train_offline.py", "chip_smoke.py",
            "controllable_agent_torch/envs/gridworld.py",
            "controllable_agent_torch/agents/discrete_fb.py",
            "controllable_agent_torch/agents/discrete_sf.py",
            "controllable_agent_torch/envs/physics3d.py",
            "controllable_agent_torch/envs/quadruped.py",
            "controllable_agent_torch/envs/jaco.py",
            "controllable_agent_torch/envs/pixels.py",
            "controllable_agent_torch/ops/augment.py",
            "controllable_agent_torch/ops/pbe.py",
            "controllable_agent_torch/agents/exploration.py",
            "controllable_agent_torch/agents/aps.py", "controllable_agent_torch/agents/smm.py",
            "controllable_agent_torch/agents/proto.py", "controllable_agent_torch/agents/uvf.py",
            "controllable_agent_torch/agents/goal_agents.py",
            "controllable_agent_torch/data/d4rl.py", "controllable_agent_torch/envs/benchmark.py",
            "controllable_agent_torch/envs/d4rl_replay.py",
            "controllable_agent_torch/parallel/mesh.py",
            "controllable_agent_torch/parallel/multihost.py",
            "controllable_agent_torch/utils/dist.py",
            "controllable_agent_torch/train_multihost.py",
            "controllable_agent_torch/tools/dryrun_multichip.py",
            "controllable_agent_torch/tools/online_curve.py",
            "controllable_agent_torch/demo/core.py", "controllable_agent_torch/demo/serve.py",
            "controllable_agent_torch/play_behaviors.py",
            "controllable_agent_torch/export_replay.py",
            "controllable_agent_torch/orchestration/runner.py",
            "controllable_agent_torch/orchestration/executor.py",
            "controllable_agent_torch/train/hiplogs.py",
            "controllable_agent_torch/tools/z_study.py",
            "controllable_agent_torch/tools/replay_stats.py",
            "controllable_agent_torch/tools/buffer_stats.py",
            "controllable_agent_torch/tools/mujoco_bridge.py",
            "controllable_agent_torch/tools/eval_mujoco.py",
            "controllable_agent_torch/tools/collect_mujoco_buffer.py",
            "controllable_agent_torch/tools/gen_parity_report.py",
            "controllable_agent_torch/tools/bench.py",
            "controllable_agent_torch/tools/bench_roofline.py",
            "controllable_agent_torch/tools/bench_breakdown.py",
            "controllable_agent_torch/tools/bench_scaling.py",
            "controllable_agent_torch/tools/gen_scaling_record.py"} <= names
    # the harness's shell recipe has no imports to check, only a place
    assert (PORT / "tools" / "run_pod_scaling.sh").is_file()


def test_engine_differentiates_by_hand() -> None:
    """The 3-D engine and its environments take no derivative by autodiff:
    ``torch.func`` and ``torch.autograd`` are for the tests only."""
    for name in ("physics3d.py", "quadruped.py", "jaco.py"):
        text = (PORT / "envs" / name).read_text()
        assert "torch.func" not in text and "autograd" not in text, name


def _functions() -> dict:
    tree = ast.parse(FUSED.read_text())
    return {node.name: node for node in tree.body if isinstance(node, ast.FunctionDef)}


def _called(fn: ast.FunctionDef) -> set:
    return {node.func.id for node in ast.walk(fn)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}


def _plain_names() -> list:
    return sorted(name for name in _functions() if name.endswith("_plain"))


def test_fused_fb_has_plain_versions() -> None:
    assert {"fwd_plain", "bwd_plain"} <= set(_plain_names())


@pytest.mark.parametrize("plain", _plain_names())
def test_every_plain_version_has_its_wrapper(plain) -> None:
    """``x_plain`` sits beside a wrapper ``x``, or is a part of a plain
    version that does (``fwd_plain`` composes two parts, ``bwd_plain`` two)."""
    fns = _functions()
    wrapped = {name for name in fns if name + "_plain" in fns}
    if plain[:-len("_plain")] in wrapped:
        return
    composers = [name for name in wrapped if plain in _called(fns[name + "_plain"])]
    assert composers, f"{plain} has no wrapper and is part of no wrapped plain version"


@pytest.mark.parametrize("wrapper", ["fwd", "bwd"])
def test_wrapper_dispatches_and_counts(wrapper) -> None:
    """A wrapper decides by the tensors' device alone (``_on_cpu``), takes its
    own plain version there, and counts a launch through ``_launched`` with
    its own name; ``launches`` has exactly the wrappers' counters."""
    fns = _functions()
    calls = _called(fns[wrapper])
    assert {"_on_cpu", f"{wrapper}_plain", "_check", "_launched"} <= calls
    counted = [node.args[0].value for node in ast.walk(fns[wrapper])
               if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
               and node.func.id == "_launched"]
    assert counted == [wrapper]
    assert not any(isinstance(node, ast.Try) for node in ast.walk(fns[wrapper]))
    from controllable_agent_torch.ops import fused_fb
    assert set(fused_fb.launches) == {"fwd", "bwd"}
