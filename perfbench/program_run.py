"""One cell with the port's own tracing: the readings that need the program's
spans and capture records, which ``run.py`` does not take yet.

    python3 perfbench/program_run.py --workload fb_walker.offline --seed 12345 --seconds 20

Set-up is the cell's own (``drivers/<kind>.py:build``), with the
capture records reset at its start and read at its end. Then, in one
process:

1. an untraced window of ``--seconds`` (the end-to-end rate, which tells
   the update's mode), and the captures made inside it (expected none);
2. the unmarked profiled sub-window, as ``run.py --trace 1`` takes it
   (``profile_steps`` updates offline, one whole cycle online);
3. ``trace.enable()``, one call or cycle that captures the programs anew
   with their device spans, and the same sub-window marked, reduced by
   ``program_trace.reduce``;
4. tracing off again, a capture anew without marks, and the same
   sub-window once more: the marked one's like, for the marks' own cost
   (a fresh capture is not set-up's: it runs a few of the first capture's
   copy kernels on the copy engine).

The last line of standard output is one JSON object: the card, set-up's
and the window's capture records, the rate, each sub-window's device
operations, kernels, device and idle milliseconds per update (the online
cell's per update of its cycle) and the idle's split, the readings, and
every metric of ``metrics/`` that reads a key of the record this run adds
(``program_trace``, ``captures``), None where it finds nothing. Exits with
2 without a card (``--rehearse`` runs on the CPU at small widths, where
nothing is marked and no metric reads).
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import typing as tp  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, program_trace  # noqa: E402
from perfbench import trace as bench_trace  # noqa: E402

# the metrics that read what this run adds to the record
METRICS = ("sample_ms.offline", "optimizer_ms.offline", "replay_gap_ms.offline",
           "between_replays_ms.offline", "env_step_share.online", "capture_s")


def _windows(ctx: tp.Any, run_window: tp.Callable[[], None], warm: tp.Callable[[], None],
             prepare: tp.Callable[[], None]) -> tp.Dict[str, tp.Any]:
    """Three profiled sub-windows, each after ``warm()`` in a window of its
    own (the profiler's start-up): the unmarked one, on set-up's capture
    (``trace``, as ``run.py --trace 1`` reads it, and ``unmarked``, its
    replays unnamed); with tracing on after ``prepare()`` (which captures
    the programs anew), the marked one (``marked``); with tracing off again
    after ``prepare()``, an unmarked one on a fresh capture (``recaptured``),
    the marked one's like."""
    from controllable_agent_torch.utils import trace

    def profiled() -> tp.List[tp.Any]:
        events: tp.List[tp.Any] = []
        with program_trace.window(ctx.device, []):
            warm()
        with program_trace.window(ctx.device, events):
            run_window()
        return events

    unmarked = profiled()
    trace.enable()
    try:
        prepare()
        marked = profiled()
        names = trace.device_span_names()
    finally:
        trace.disable()
    prepare()
    return {"trace": bench_trace.reduce(unmarked),
            "unmarked": program_trace.reduce(unmarked, {}),
            "marked": program_trace.reduce(marked, names),
            "recaptured": program_trace.reduce(profiled(), {})}


def _offline(ctx: tp.Any) -> tp.Dict[str, tp.Any]:
    from controllable_agent_torch.utils import trace
    from perfbench.drivers import offline
    trace.reset_captures()
    _, trainer, state, gen, _ = offline.build(ctx)
    ctx.sync()
    setup_s, setup = time.perf_counter() - ctx.started, trace.captures()
    loss = ctx.reference.LOSSES[0]
    calls, value, started = 0, math.nan, time.perf_counter()
    while time.perf_counter() - started < ctx.seconds:
        value = float(trainer(state, gen)[loss])
        calls += 1
    rate = calls * ctx.workload["steps_per_call"] / (time.perf_counter() - started)
    in_window = trace.captures()[len(setup):]
    steps = ctx.workload["profile_steps"]
    one = lambda: trainer(state, gen, steps=1)  # noqa: E731
    windows = _windows(ctx, lambda: float(trainer(state, gen, steps=steps)[loss]), one, one)
    return {"updates_per_s": rate, "finite": math.isfinite(value), "setup_s": setup_s,
            "setup": setup, "window": in_window, "per": steps, **windows}


def _online(ctx: tp.Any) -> tp.Dict[str, tp.Any]:
    from controllable_agent_torch.utils import trace
    from perfbench.drivers import online as online_driver
    trace.reset_captures()
    online, gen, collect_gen, _ = online_driver.build(ctx)
    ctx.sync()
    setup_s, setup = time.perf_counter() - ctx.started, trace.captures()
    frames, started = 0, time.perf_counter()
    while time.perf_counter() - started < ctx.seconds:
        online.run_cycle(gen, collect_gen)
        frames += ctx.workload["num_envs"] * ctx.workload["episode_length"]
    rate = frames / (time.perf_counter() - started)
    in_window = trace.captures()[len(setup):]
    cycle = lambda: online.run_cycle(gen, collect_gen)  # noqa: E731
    windows = _windows(ctx, cycle, lambda: online.trainer(online.buffer.state, gen, steps=1),
                       cycle)
    return {"frames_per_s": rate, "setup_s": setup_s, "setup": setup, "window": in_window,
            "per": int(online.timings["updates"]), **windows}


def _split(reading: tp.Any, per: int) -> tp.Dict[str, float]:
    """Device operations, idle milliseconds per update inside the replays,
    between them and at the window's edges, and the host's milliseconds in
    ``cudaGraphLaunch``."""
    return {"ops": reading.ops / per, "replay_gap_ms": 1e3 * reading.replay_gap_s / per,
            "between_ms": 1e3 * reading.between_replays_s / per,
            "edge_ms": 1e3 * reading.edge_idle_s / per, "replays": reading.replays,
            "launch_ms": 1e3 * reading.host_s.get(program_trace.LAUNCH, [0, 0.0])[1] / per}


def _per(kernels: int, busy_s: float, window_s: float, per: int) -> tp.Dict[str, float]:
    return {"kernels": kernels / per, "device_ms": 1e3 * busy_s / per,
            "idle_ms": 1e3 * (window_s - busy_s) / per, "window_ms": 1e3 * window_s / per}


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rehearse", action="store_true")
    args = parser.parse_args(argv)

    harness.cache_dirs()
    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    workload, config = harness.cell(args.workload, args.rehearse)
    import torch
    torch.set_num_threads(2)
    if args.rehearse:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = harness.Context(workload, config, device, entry["chips"], args.seed, args.seconds,
                          True, STARTED)
    out = _offline(ctx) if workload["driver"] == "offline" else _online(ctx)

    record = {"program_trace": out["marked"], "captures": out["setup"],
              "profile_steps": out["per"]}
    metrics = {name: harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(record)
               for name in METRICS}
    program, per = out["marked"], out["per"]
    result = {
        "cell": args.workload, "seed": args.seed,
        "card": "cpu (rehearsal)" if args.rehearse else harness.card(),
        **{k: out[k] for k in ("updates_per_s", "frames_per_s", "finite", "setup_s") if k in out},
        "setup_captures": [c._asdict() for c in out["setup"]],
        "window_captures": [c._asdict() for c in out["window"]],
        "per": per,
        "unmarked": {**_per(len(out["trace"].kernels), out["trace"].busy_s,
                             out["trace"].window_s, per), **_split(out["unmarked"], per)},
        "marked": {**_per(program.kernels, program.busy_s, program.window_s, per),
                   **_split(program, per), "marks": program.marks / per,
                   "marks_ms": 1e3 * program.marks_s / per},
        "recaptured": {**_per(out["recaptured"].kernels, out["recaptured"].busy_s,
                               out["recaptured"].window_s, per),
                       **_split(out["recaptured"], per)},
        "program": program._asdict(), "program_unmarked": out["unmarked"]._asdict(),
        "program_recaptured": out["recaptured"]._asdict(),
        "metrics": metrics,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
