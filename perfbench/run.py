"""The benchmark of controllable_agent_torch on NVIDIA H100 cards.

    python3 perfbench/run.py --workload fb_walker.offline --seed 7 --seconds 30 --trace 0

runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; then ``checks``, each number compared beside its limit
(also the last lines of standard error). Without a card, or with fewer
cards than the cell asks for, it prints no result and exits with 2.
``--rehearse`` runs the cell's layers and control flow on the CPU at small
widths (the tests' mode); it reports no metric.

Everything is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<name>.json``) and its driver
(``drivers/<driver>.py``); each per-layer metric is ``metrics/<name>.py``.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import typing as tp  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rehearse", action="store_true",
                        help="run on the CPU at small widths; no metric is reported")
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
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        print(f"card: {harness.card()}", file=sys.stderr)
    # the configuration's float32 products run in float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ctx = harness.Context(workload, config, device, entry["chips"], args.seed, args.seconds,
                          bool(args.trace), STARTED)
    driver = importlib.import_module(f"perfbench.drivers.{workload['driver']}")
    out = driver.run(ctx)

    record = {**out["record"], "cell": args.workload, "config": config, "workload": workload}
    device_info = out["device"]
    result: tp.Dict[str, tp.Any] = {"attempted": out["attempted"], "failed": out["failed"]}
    metrics: tp.Dict[str, tp.Dict[str, tp.Any]] = {}
    if args.trace:
        for m in harness.per_layer(bench, args.workload):
            value = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py").read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        reading = record["trace"]
        device_info = {**device_info, "busy_s": reading.busy_s, "window_s": reading.window_s}
        result["breakdown"] = {"device_ops": reading.device_ops, "idle_gaps": reading.idle_gaps}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in harness.end_to_end(bench, args.workload)}
    if args.rehearse:
        for name, m in metrics.items():
            print(f"rehearsal (CPU, not a device number) {name} {m['value']!r}", file=sys.stderr)
        metrics = {}

    found = harness.forbidden_loaded()
    if found:
        print(f"JAX or the JAX package is loaded in this process: {found}", file=sys.stderr)
        return 3
    limits = workload["limits"]
    for k, v in out["numbers"].items():
        if k not in limits:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    # a number the run did not produce fails, except the card's own counts in a rehearsal
    checks = {k: (out["numbers"].get(k, math.inf), lim) for k, lim in limits.items()
              if k in out["numbers"] or not args.rehearse}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    harness.emit({"correct": correct, **result, "metrics": metrics, "device": device_info},
                 checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
