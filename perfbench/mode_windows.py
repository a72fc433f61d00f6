"""The update's two modes in one process: an offline cell's untraced windows
of a few seconds alternating with profiled sub-windows, on set-up's capture.

    python3 perfbench/mode_windows.py --workload fb_walker.offline --seed 12345 --rounds 14 --seconds 4

Set-up is the cell's own (``drivers/offline.py:build``). Each round
prints one JSON line: the untraced window's updates per second and the
host's milliseconds per update inside ``graph.replay()`` (the captured
program replayed directly, ``steps_per_call`` replays a call, one loss read
a call), the card's SM clock and power draw read right after it, then a
profiled sub-window of ``profile_steps`` updates reduced by
``program_trace.reduce``: device busy, idle inside the replays, between
them and at the window's edges, and the host's milliseconds in
``cudaGraphLaunch``, each per update. Tracing stays off: the readings are
of set-up's capture, as the cells measure it. ``--rehearse`` runs on the
CPU at small widths (the updates run eagerly; no device number).
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import typing as tp  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, program_trace  # noqa: E402


def _clock() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rounds", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rehearse", action="store_true")
    args = parser.parse_args(argv)

    harness.cache_dirs()
    workload, config = harness.cell(args.workload, args.rehearse)
    if workload["driver"] != "offline":
        print(f"{args.workload} is not an offline cell", file=sys.stderr)
        return 2
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
    from perfbench.drivers import offline
    ctx = harness.Context(workload, config, device, 1, args.seed, args.seconds, False, STARTED)
    _, trainer, state, gen, _ = offline.build(ctx)
    loss, calls, steps = ctx.reference.LOSSES[0], workload["steps_per_call"], \
        workload["profile_steps"]
    float(trainer(state, gen)[loss])

    def one() -> None:  # one call's updates, as the window's calls run them
        sums = list(trainer._sums.values())
        torch._foreach_zero_(sums)
        for _ in range(calls):
            if trainer._program is None:
                trainer._run_updates(state, gen, 1)
            else:
                trainer._program.replay(1)

    for i in range(args.rounds):
        n, inside, started = 0, 0.0, time.perf_counter()
        while time.perf_counter() - started < args.seconds:
            at = time.perf_counter()
            one()
            inside += time.perf_counter() - at
            float(trainer._sums[loss])
            n += calls
        rate = n / (time.perf_counter() - started)
        clock = "cpu (rehearsal)" if args.rehearse else _clock()
        events: tp.List[tp.Any] = []
        with program_trace.window(device, []):
            trainer(state, gen, steps=1)
        with program_trace.window(device, events):
            float(trainer(state, gen, steps=steps)[loss])
        r = program_trace.reduce(events, {})
        per = 1e3 / steps
        print(json.dumps({
            "cell": args.workload, "seed": args.seed, "round": i, "updates_per_s": rate,
            "host_replay_ms": 1e3 * inside / max(n, 1), "clock_power": clock,
            "busy_ms": per * r.busy_s, "inside_ms": per * r.replay_gap_s,
            "between_ms": per * r.between_replays_s, "edge_ms": per * r.edge_idle_s,
            "launch_ms": per * r.host_s.get(program_trace.LAUNCH, [0, 0.0])[1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
