"""Write SCALING_torch.json: the port's correctness-only record of its
multi-process paths (the counterpart of the JAX package's
``tools/gen_scaling_record.py``, which writes ``SCALING_r03.json``).

    python -m controllable_agent_torch.tools.gen_scaling_record [--out SCALING_torch.json]
    python -m controllable_agent_torch.tools.gen_scaling_record --device cpu --grad-steps 4 \\
        --dryrun-processes 2 -- agent.hidden_dim=32   # a small rehearsal

Scaling over many cards needs many cards; what one machine CAN show is that
the distributed paths run. Two runs, both on the CPU over gloo and both
labelled correctness-only (processes share the machine's cores, so their
seconds are no throughput):

  * ``gloo_2process``: ``train_multihost`` in 2 processes (a file
    rendezvous), each loading its shard of 8 synthetic walker episodes of
    100 steps with physics, with the JAX tool's settings (FB, walker_walk,
    goal space simplified_walker, batch 256, ``--grad-steps`` updates, 20
    per call, no evaluation); arguments after ``--`` are appended;
  * ``virtual_mesh_dryrun``: ``tools/dryrun_multichip.py`` at
    ``--dryrun-processes`` (8) processes with ``device=cpu``.

The record names the machine it ran on, read from it (CPU cores, torch, the
cards and their power limits), and points at ``tools/run_pod_scaling.sh``,
the recipe for real hardware. It prints the JAX tool's line ``{"gloo_2process":
ok, "virtual_mesh_dryrun": ok}`` after the card's name and power limit. It
runs where a card is (the record then names it) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from controllable_agent_torch.tools import dryrun_multichip
from controllable_agent_torch.tools.bench import bench_device
from controllable_agent_torch.utils.device import query_card

REPO = Path(__file__).resolve().parents[2]
TIMEOUT = 1200.0  # seconds for either run
LABEL = ("CORRECTNESS-ONLY: the processes share one machine's CPU cores; this is "
         "not a throughput or scaling measurement")


def write_episodes(folder: Path, n: int = 8, length: int = 100, seed: int = 0) -> None:
    """``n`` walker-shaped ExORL episodes of ``length`` steps (observations
    24, actions 6, zero rewards, planar physics 18 near the standing
    height), the JAX tool's synthetic data."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    ndof = 9
    for i in range(n):
        q = rng.randn(length + 1, ndof).astype(np.float32) * 0.3
        q[:, 1] += 1.3
        np.savez(folder / f"episode_{i}.npz",
                 observation=rng.randn(length + 1, 24).astype(np.float32),
                 action=rng.uniform(-1, 1, (length + 1, 6)).astype(np.float32),
                 reward=np.zeros((length + 1, 1), np.float32),
                 discount=np.ones((length + 1, 1), np.float32),
                 physics=np.concatenate(
                     [q, rng.randn(length + 1, ndof).astype(np.float32)], axis=1))


def measure_gloo_2proc(tmp: Path, grad_steps: int, extra: tp.Sequence[str]) -> tp.Dict[str, tp.Any]:
    episodes = tmp / "episodes"
    write_episodes(episodes)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    batch_size = 256
    cmd = [sys.executable, "-m", "controllable_agent_torch.train_multihost",
           "agent=fb_ddpg", "task=walker_walk", "goal_space=simplified_walker",
           f"replay_dir={episodes}", f"coordinator=file://{tmp}/rendezvous", "num_processes=2",
           f"num_grad_steps={grad_steps}", f"steps_per_call={min(20, grad_steps)}",
           "eval_every_steps=1000000", "checkpoint_every=1000000", "episode_length=100",
           "final_tests=0", "replay_buffer_episodes=8", f"folder={tmp / 'xp'}",
           "use_console=false", f"agent.batch_size={batch_size}", "device=cpu", *extra]
    t0 = time.time()
    procs = [subprocess.Popen(cmd + [f"process_id={i}"], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    ok = all(p.returncode == 0 for p in procs)
    # process 0's train.csv: its header and last row (the step it reached)
    csv = tmp / "xp" / "train.csv"
    lines = (csv.read_text() if ok and csv.exists() else outs[0]).strip().splitlines()
    return {
        "what": "2-process torch.distributed (gloo, a file rendezvous) run of the port's "
                "train_multihost on the CPU: each process loads its shard of the episode "
                "files, data-parallel FB updates on the global batch, process 0 "
                "checkpoints",
        "ok": ok,
        "grad_steps": grad_steps,
        "batch_size": batch_size,
        "wall_seconds_including_startup": round(wall, 1),
        "label": LABEL,
        "log_tail": lines[:1] + lines[-1:] if ok else lines[-10:],
    }


def measure_dryrun(processes: int) -> tp.Dict[str, tp.Any]:
    t0 = time.time()
    try:
        report, ok = dryrun_multichip.run(processes, device="cpu", timeout=TIMEOUT), True
    except RuntimeError as err:
        report, ok = str(err).splitlines()[-10:], False
    return {
        "what": f"{processes}-process torch.distributed (gloo) dry run on the CPU, "
                "tools/dryrun_multichip.py: a data-parallel update and an OnlineTrainer "
                "cycle with the group, parameters equal on every process",
        "ok": ok,
        "process_wall_seconds": round(time.time() - t0, 1),
        "report": report,
        "label": LABEL,
    }


def environment(device: torch.device) -> str:
    """The machine, as it reports itself."""
    cards = "no card"
    if device.type == "cuda":
        count = torch.cuda.device_count()
        cards = f"{count} x {query_card('name,power.limit')}"
    return (f"{os.cpu_count()} CPU cores ({platform.machine()}), Python "
            f"{platform.python_version()}, torch {torch.__version__}, {cards}")


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, bool]:
    args = list(sys.argv[1:] if argv is None else argv)
    extra: tp.List[str] = []
    if "--" in args:
        args, extra = args[:args.index("--")], args[args.index("--") + 1:]
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--out", default="SCALING_torch.json")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--grad-steps", type=int, default=100)
    parser.add_argument("--dryrun-processes", type=int, default=8)
    opts = parser.parse_args(args)
    device = bench_device(opts.device, "gen_scaling_record")
    with tempfile.TemporaryDirectory() as tmp:
        gloo = measure_gloo_2proc(Path(tmp), opts.grad_steps, extra)
    dryrun = measure_dryrun(opts.dryrun_processes)
    record = {
        "environment": environment(device),
        "what_this_is": "correctness evidence for the port's distributed paths, NOT a "
                        "scaling measurement; updates/s against world size on cards is "
                        "tools/bench_scaling.py's",
        "records": {"gloo_2process": gloo, "virtual_mesh_dryrun": dryrun},
        "real_hardware_recipe": "controllable_agent_torch/tools/run_pod_scaling.sh (one "
                                "invocation per host; single-host updates/s, then the "
                                "multi-host run)",
    }
    Path(opts.out).write_text(json.dumps(record, indent=2) + "\n")
    oks = {k: v["ok"] for k, v in record["records"].items()}
    print(json.dumps(oks), flush=True)
    print(f"wrote {opts.out}", flush=True)
    return oks


if __name__ == "__main__":
    main()
