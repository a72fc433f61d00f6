"""The readings that a cell's limits are set from (see ``check.py``).

    python3 perfbench/control.py --workload fb_walker.offline --seeds 1,2,3 \
        --out chiprun_out/control.json

For each seed, in one process: the program's numbers and those of any
other sound run the driver reads (kinds named ``program*``; the lower
reading is their largest over the seeds), the control's (the plain
reference put in the program's place, computed at the precision below the
one the configuration states: its ``control`` entry) and each fault's that
the driver can plant (half of each batch left out). The upper reading is
the smallest the control or a fault gives. A state left unchanged reads 1
by the comparison's measure and needs no run. The benchmark's own runs do
not run this; ``--rehearse`` runs it on the CPU at small widths.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import typing as tp  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--out", default=None, help="also write the readings here (JSON)")
    parser.add_argument("--rehearse", action="store_true",
                        help="small widths, on the CPU unless --device says otherwise")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    harness.cache_dirs()
    workload, config = harness.cell(args.workload, args.rehearse)
    import torch
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device or ("cpu" if args.rehearse else "cuda"))
    if device.type == "cuda":
        print(f"card: {harness.card()}", flush=True)
    driver = importlib.import_module(f"perfbench.drivers.{workload['driver']}")
    by_seed: tp.Dict[str, tp.Any] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(workload, config, device, 1, seed, 0.0, False, time.perf_counter())
        by_seed[str(seed)] = driver.readings(ctx)
        print(json.dumps({"seed": seed, **by_seed[str(seed)]}), flush=True)
    kinds = next(iter(by_seed.values()))
    summary = {kind: {name: [min(r[kind][name] for r in by_seed.values()),
                             max(r[kind][name] for r in by_seed.values())]
                      for name in kinds[kind]} for kind in kinds}
    out = {"workload": args.workload, "seeds": by_seed, "min_max": summary}
    print(json.dumps({"min_max": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
