"""Job batching executor with failure-rate tolerance (mirror of
``controllable_agent_tpu/orchestration/executor.py``, pure Python).

The reference's DelayedExecutor/wait_for_jobs (controllable_agent/
executor.py:34-145) batched submitit/SLURM submissions for cluster health.
This targets local process/thread pools (and, by duck-typing, any executor
exposing ``submit``): submissions queue until ``batch_size`` jobs or
``max_delay`` seconds accumulate, each job carries a default value returned
on failure, and the campaign ABORTS once the failure rate exceeds
``max_failure_rate`` (reference :112-123).
"""

from __future__ import annotations

import concurrent.futures
import time
import typing as tp

X = tp.TypeVar("X")


class _Job(tp.Generic[X]):
    """Future-like wrapper with a default-on-failure value."""

    def __init__(self, future: tp.Any, default: X) -> None:
        self._future = future
        self._default = default
        self.failed = False

    def done(self) -> bool:
        return self._future.done()

    def result(self) -> X:
        try:
            return self._future.result()
        except Exception:  # noqa: BLE001
            self.failed = True
            return self._default


class _DelayedJob(tp.Generic[X]):
    """Placeholder handed out before submission (reference :34-66)."""

    def __init__(self, executor: "DelayedExecutor[X]") -> None:
        self._executor = executor
        self._job: tp.Optional[_Job[X]] = None

    def done(self) -> bool:
        self._executor._maybe_submit()
        return self._job is not None and self._job.done()

    def result(self) -> X:
        self._executor._submit_now()
        assert self._job is not None
        out = self._job.result()
        if self._job.failed:
            self._executor._register_failure()
        return out


class LocalExecutor:
    """Thread-pool stand-in for a cluster executor (the reference's
    AutoExecutor(cluster="debug") testing niche,
    controllable_agent/test_executor.py:21-24)."""

    def __init__(self, max_workers: int = 2) -> None:
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers)

    def submit(self, fn: tp.Callable[..., X], *args: tp.Any,
               **kwargs: tp.Any) -> tp.Any:
        return self._pool.submit(fn, *args, **kwargs)


class DelayedExecutor(tp.Generic[X]):
    def __init__(self, executor: tp.Any, default: X, batch_size: int = 8,
                 max_delay: float = 120.0,
                 max_failure_rate: float = 0.39) -> None:
        self.executor = executor
        self.batch_size = batch_size
        self.max_delay = max_delay
        self.max_failure_rate = max_failure_rate
        assert 0 <= max_failure_rate <= 1
        self._default = default
        self._queue: tp.List[tp.Tuple[_DelayedJob[X], tp.Callable, tp.Tuple,
                                      tp.Dict]] = []
        self._last_add_time = 0.0
        self._total = 0
        self._failed = 0

    def submit(self, fn: tp.Callable[..., X], *args: tp.Any,
               **kwargs: tp.Any) -> _DelayedJob[X]:
        job: _DelayedJob[X] = _DelayedJob(self)
        self._queue.append((job, fn, args, kwargs))
        self._last_add_time = time.time()
        self._maybe_submit()
        return job

    def _maybe_submit(self) -> None:
        timeout = (time.time() - self._last_add_time) > self.max_delay
        if self._queue and (timeout or len(self._queue) >= self.batch_size):
            self._submit_now()

    def _submit_now(self) -> None:
        queue, self._queue = self._queue, []
        for job, fn, args, kwargs in queue:
            job._job = _Job(self.executor.submit(fn, *args, **kwargs),
                            self._default)
            self._total += 1

    def _register_failure(self) -> None:
        self._failed += 1
        if self._total >= 4 and self._failed / self._total > self.max_failure_rate:
            raise RuntimeError(
                f"Aborting: failure rate {self._failed}/{self._total} exceeds "
                f"{self.max_failure_rate}")


def wait_for_jobs(jobs: tp.Sequence[tp.Any], sleep: float = 2.0,
                  print_every: float = 20.0) -> None:
    """Poll until all jobs are done, printing percent complete
    (reference executor.py:126-145)."""
    last_print = 0.0
    while True:
        done = sum(1 for j in jobs if j.done())
        now = time.time()
        if now - last_print > print_every:
            print(f"{100 * done / max(1, len(jobs)):.1f}% of "
                  f"{len(jobs)} jobs done")
            last_print = now
        if done == len(jobs):
            return
        time.sleep(sleep)
