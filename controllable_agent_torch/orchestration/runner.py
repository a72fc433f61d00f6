"""Experiment entry-point wrapper (mirror of
``controllable_agent_tpu/orchestration/runner.py``).

The reference's HydraEntryPoint/CopiedBenchmark (controllable_agent/
runner.py:40-186): compose a config with programmatic overrides without
going through the CLI, build the workspace, create the experiment folder
(saving config.json), run training, and return **−mean(last 12 eval
rewards)** for minimization by a sweeper (reference :163-166).
``CopiedBenchmark`` snapshots the package source into the experiment folder
so results stay tied to the exact code version (reference :172-186).

The workspace runs on the card unless the overrides hold ``device="cpu"``.
An offline run trains on the replay of the folder's checkpoint
(``models/latest``), as the JAX one does.
"""

from __future__ import annotations

import datetime
import shutil
import traceback
import typing as tp
import uuid
from pathlib import Path

import numpy as np


class EntryPoint:
    """Callable experiment: EntryPoint(mode)(folder=..., **overrides)."""

    def __init__(self, mode: str = "online") -> None:
        if mode not in ("online", "offline"):
            raise ValueError(f"mode is 'online' or 'offline', not {mode!r}")
        self.mode = mode

    def config(self, **overrides: tp.Any) -> tp.Any:
        from ..config import apply_overrides
        from ..pretrain import split_overrides
        from ..train.workspace import WorkspaceConfig
        args = [f"{k}={v}" for k, v in overrides.items()]
        agent_name, ws_overrides, _ = split_overrides(args)
        return apply_overrides(WorkspaceConfig(agent_name=agent_name), ws_overrides)

    def workspace(self, **overrides: tp.Any) -> tp.Any:
        from ..pretrain import build_workspace
        from ..train.workspace import OfflineWorkspace, OnlineWorkspace
        args = [f"{k}={v}" for k, v in overrides.items()]
        return build_workspace(args, OfflineWorkspace if self.mode == "offline"
                               else OnlineWorkspace)

    def main(self, **overrides: tp.Any) -> float:
        return self(**overrides)

    def __call__(self, folder: tp.Optional[str] = None, **overrides: tp.Any) -> float:
        """Create the xp folder, train, return −mean(last 12 eval rewards)
        (reference runner.py:127-166). Exceptions are tolerated when some
        eval history exists (reference :157-162)."""
        if folder is None:
            name = datetime.date.today().isoformat() + "_" + uuid.uuid4().hex[:8]
            folder = str(Path("exp_local") / name)
        overrides["folder"] = folder
        ws = self.workspace(**overrides)
        try:
            ws.train()
        except Exception:  # noqa: BLE001 — run-level tolerance
            if not ws.eval_rewards_history:
                raise
            traceback.print_exc()
        history = ws.eval_rewards_history[-12:]
        if not history:
            return float("inf")
        return -float(np.mean(history))


class CopiedBenchmark(EntryPoint):
    """Snapshot the package source into the xp folder (reference
    CopiedBenchmark, runner.py:172-186). The snapshot is a record of the
    code: the run itself uses the package already imported, so nothing is
    imported or built from the copy, and the CUDA kernels stay in the
    checkout's ``build/torch_kernels`` (``_build.py``). Built files and
    caches are not copied."""

    def __init__(self, folder: tp.Union[str, Path], mode: str = "online") -> None:
        super().__init__(mode)
        self.folder = Path(folder)
        package_dir = Path(__file__).resolve().parents[1]
        self.code_dir = self.folder / "code" / package_dir.name
        if not self.code_dir.exists():
            self.code_dir.parent.mkdir(parents=True, exist_ok=True)
            shutil.copytree(package_dir, self.code_dir,
                            ignore=shutil.ignore_patterns("__pycache__", "*.so", "build"))

    def __call__(self, **overrides: tp.Any) -> float:  # type: ignore[override]
        overrides.setdefault("folder", str(self.folder / "run"))
        return super().__call__(**overrides)


def on_exception_enter_postmortem(f: tp.Callable) -> tp.Callable:
    """Decorator: drop into pdb post-mortem on any exception (reference
    on_exception_enter_postmortem, controllable_agent/runner.py:189-205).
    Handy when iterating on a workspace interactively."""
    import functools

    @functools.wraps(f)
    def wrapper(*args: tp.Any, **kwargs: tp.Any) -> tp.Any:
        try:
            return f(*args, **kwargs)
        except Exception:
            import pdb
            import sys
            traceback.print_exc()
            pdb.post_mortem(sys.exc_info()[2])
            raise

    return wrapper
