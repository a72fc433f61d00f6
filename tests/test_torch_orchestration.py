"""The port's executor and runner (``controllable_agent_torch/orchestration``):
the eight cases of ``tests/test_orchestration.py`` against the port, one
``EntryPoint("offline")`` run on the CPU whose return is −mean of its
evaluations, and ``CopiedBenchmark``'s snapshot."""

import csv
import json
import time

import numpy as np
import pytest
import torch

from controllable_agent_torch import _build
from controllable_agent_torch.orchestration import (
    CopiedBenchmark,
    DelayedExecutor,
    EntryPoint,
    LocalExecutor,
    wait_for_jobs,
)
from torch_small_run import SMALL, small_run


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _func(fail: bool = False) -> int:
    if fail:
        raise ValueError("boom")
    return 12


def test_batching_by_count() -> None:
    ex: DelayedExecutor = DelayedExecutor(LocalExecutor(), default=0,
                                          batch_size=2, max_delay=1000)
    job1 = ex.submit(_func)
    assert job1._job is None  # queued, not submitted
    job2 = ex.submit(_func)
    assert job1._job is not None  # batch size reached -> submitted
    assert job1.result() == 12 and job2.result() == 12


def test_batching_by_delay() -> None:
    ex: DelayedExecutor = DelayedExecutor(LocalExecutor(), default=0,
                                          batch_size=10, max_delay=0.05)
    job = ex.submit(_func)
    assert job._job is None
    time.sleep(0.1)
    assert job.done() or job._job is not None  # delay elapsed -> submitted
    assert job.result() == 12


def test_default_on_failure() -> None:
    ex: DelayedExecutor = DelayedExecutor(LocalExecutor(), default=-1,
                                          batch_size=1, max_failure_rate=1.0)
    job = ex.submit(_func, fail=True)
    assert job.result() == -1


def test_failure_rate_abort() -> None:
    ex: DelayedExecutor = DelayedExecutor(LocalExecutor(), default=-1,
                                          batch_size=1, max_failure_rate=0.3)
    for _ in range(3):
        ex.submit(_func, fail=True).result()
    with pytest.raises(RuntimeError):
        ex.submit(_func, fail=True).result()


def test_result_forces_submission() -> None:
    ex: DelayedExecutor = DelayedExecutor(LocalExecutor(), default=0,
                                          batch_size=100, max_delay=1000)
    job = ex.submit(_func)
    assert job.result() == 12  # .result() flushes the queue


def test_wait_for_jobs() -> None:
    ex = LocalExecutor()
    jobs = [ex.submit(_func) for _ in range(4)]
    wait_for_jobs(jobs, sleep=0.01, print_every=0.01)
    assert all(j.done() for j in jobs)


def test_entry_point_config_composition() -> None:
    ep = EntryPoint("online")
    cfg = ep.config(task="grid_simple", num_train_frames=100)
    assert cfg.task == "grid_simple"
    assert cfg.num_train_frames == 100
    with pytest.raises(ValueError, match="mode"):
        EntryPoint("sideways")


def test_on_exception_enter_postmortem(monkeypatch) -> None:
    import pdb

    from controllable_agent_torch.orchestration.runner import on_exception_enter_postmortem

    entered = []
    monkeypatch.setattr(pdb, "post_mortem", lambda tb: entered.append(tb))

    @on_exception_enter_postmortem
    def boom() -> None:
        raise RuntimeError("boom")

    @on_exception_enter_postmortem
    def fine() -> int:
        return 7

    assert fine() == 7
    with pytest.raises(RuntimeError):
        boom()
    assert len(entered) == 1


def _overrides(*args: str) -> dict:
    return dict(arg.split("=", 1) for arg in args)


def test_offline_entry_point_returns_minus_mean_eval(tmp_path) -> None:
    """An offline run resumes the folder's checkpoint (10 updates, its replay)
    to 20 updates with an evaluation every 5: the return is −mean of this
    run's two evaluations in eval.csv."""
    folder = tmp_path / "run"
    small_run(folder)
    got = EntryPoint("offline")(folder=str(folder), task="walker_walk", num_grad_steps=20,
                                eval_every_steps=5, num_eval_episodes=2,
                                **_overrides(*SMALL))
    with (folder / "eval.csv").open() as f:
        rows = [r for r in csv.DictReader(f) if r["step"] != "step"]
    resumed = [float(r["episode_reward"]) for r in rows if float(r["step"]) > 10]
    assert [float(r["step"]) for r in rows if float(r["step"]) > 10] == [15.0, 20.0]
    assert got == -float(np.mean(resumed)) and np.isfinite(got)
    # no evaluation at all: +inf, as in JAX
    assert EntryPoint("offline")(folder=str(folder), task="walker_walk", num_grad_steps=25,
                                 eval_every_steps=0, **_overrides(*SMALL)) == float("inf")


def test_copied_benchmark_snapshots_the_source(tmp_path) -> None:
    """The snapshot holds the package's source (kernels included) and nothing
    built; the kernels' build directory stays the checkout's."""
    build_dir = _build.BUILD_DIR
    bench = CopiedBenchmark(tmp_path / "xp", mode="offline")
    code = bench.code_dir
    assert code == tmp_path / "xp" / "code" / "controllable_agent_torch"
    assert (code / "csrc" / "fused_fb.cu").is_file()
    assert (code / "orchestration" / "runner.py").is_file()
    assert not list(code.rglob("__pycache__")) and not list(code.rglob("*.so"))
    assert not (tmp_path / "xp" / "build").exists()
    assert _build.BUILD_DIR == build_dir


def test_save_config_matches_jax(tmp_path) -> None:
    """The config file a run's folder keeps (``config.save_config``), written
    by each package from the same dataclass tree and extra keys."""
    import dataclasses

    from controllable_agent_tpu.config import save_config as jax_save_config
    from controllable_agent_torch.config import save_config

    @dataclasses.dataclass(frozen=True)
    class Inner:
        rate: float = 0.5
        dims: tuple = (1, 2)

    @dataclasses.dataclass(frozen=True)
    class Outer:
        name: str = "walker"
        inner: Inner = Inner()
        path: object = tmp_path

    extra = {"agent.z_dim": 50, "agent.goal_space": None}
    save_config(Outer(), tmp_path / "torch.json", extra=extra)
    jax_save_config(Outer(), str(tmp_path / "jax.json"), extra=extra)
    assert (tmp_path / "torch.json").read_text() == (tmp_path / "jax.json").read_text()
    assert json.loads((tmp_path / "torch.json").read_text())["inner.rate"] == 0.5
