"""An online run through ``train_online`` or ``pretrain`` with its cycles'
timings (NVIDIA GPU), and the recipe mode that repeats a stored run.

    python -m controllable_agent_torch.tools.online_curve agent=fb_ddpg \\
        task=quadruped_stand goal_space=quad_pos_speed ... folder=DIR

    python -m controllable_agent_torch.tools.online_curve \\
        recipe=results/quad_one entry=train_online folder=DIR

``entry=`` picks the entry point (``train_online``, the default, or
``pretrain``); every other argument goes to it unchanged, so the run writes
what that entry point writes (``train.csv``, ``eval.csv``, the checkpoint,
``test_rewards.json``). Each ``eval.csv`` row is printed as it is written,
so a run that is cut still leaves its curve in the log. At the end the tool
prints the card's name and power limit, the seconds of the run, the
collection's share of a cycle (the seconds of collection, resets included,
over those of collection, commits and updates, summed over the cycles that
ran updates) and the fused FB loss's launches by both counts: the wrappers'
(``ops/fused_fb.launches``) and the kernels' own (``device_runs``), which
must be equal. ``DIR/cycle_timings.json`` keeps every cycle's seconds.

``recipe=<folder>`` repeats the run stored there: every key of its
``config.json`` (the JAX workspace's config, agent keys included) becomes an
override, and a key the port does not know raises. The agent settings that
the stored READMEs name but older ``config.json`` files do not keep are
added where the file lacks them (``RECIPE_DEFAULTS``: bf16). The keys in
``RECIPE_REPLACED`` are replaced, and the list is printed: they do not touch
learning (the output folder, checkpoints and sinks, and the fused FB loss,
which computes the plain loss's function). Arguments after ``recipe=``
still override any key. The run then writes ``DIR/check.json``: each task of
the stored ``test_rewards.json`` and the train task's late curve, port
against JAX, under ``compare``'s rule; and it removes the final checkpoint
(``DIR/models``), which is not part of the record.
"""

from __future__ import annotations

import csv
import json
import shutil
import sys
import threading
import time
import typing as tp
from pathlib import Path

import torch

from controllable_agent_torch import pretrain, train_online
from controllable_agent_torch.agents import agent_classes
from controllable_agent_torch.config import apply_overrides
from controllable_agent_torch.ops import fused_fb
from controllable_agent_torch.utils.device import card_name_and_power_limit

ENTRIES: tp.Dict[str, tp.Callable[[tp.List[str]], tp.Any]] = {
    "train_online": train_online.main, "pretrain": pretrain.main}

# stored keys the recipe mode replaces; none of them touches learning
RECIPE_REPLACED = ("folder", "checkpoint_every", "save_eval_video", "use_tb",
                   "use_wandb", "load_model", "agent.use_pallas_loss")
# settings the stored runs' READMEs name, added where config.json lacks them
RECIPE_DEFAULTS = {"agent.compute_dtype": "bfloat16"}
# the late curve: the eval rows from this frame on, the last CURVE_ROWS of them
CURVE_FROM = 1_800_000
CURVE_ROWS = 5


def _value(value: tp.Any) -> str:
    """A config.json value as ``apply_overrides`` reads it back."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (list, tuple)):
        return json.dumps(list(value))
    return str(value)


def _key(arg: str) -> str:
    if "=" not in arg:
        raise ValueError(f"Argument {arg!r} is not of the form key=value")
    return arg.split("=", 1)[0]


def recipe_args(recipe: tp.Union[str, Path], extra: tp.Sequence[str] = ()
                ) -> tp.Tuple[tp.List[str], tp.Dict[str, tp.Tuple[tp.Any, tp.Any]]]:
    """The entry point's arguments for the run stored in ``recipe`` with
    ``extra`` overrides on top, and the replaced keys as {key: (stored, new)}.
    Raises ``ValueError`` for a key that the port's workspace or agent
    config does not know."""
    recipe = Path(recipe)
    stored: tp.Dict[str, tp.Any] = json.loads((recipe / "config.json").read_text())
    settings: tp.Dict[str, str] = {}
    for key, value in stored.items():
        settings["agent" if key == "agent_name" else key] = _value(value)
    for key, value in RECIPE_DEFAULTS.items():
        settings.setdefault(key, value)
    frames = int(stored.get("num_train_frames", 0))
    new = {"folder": f"exp_local/{recipe.name}",
           # above the frames: no periodic checkpoint is written
           "checkpoint_every": str(frames + 1),
           "save_eval_video": "false", "use_tb": "false", "use_wandb": "false",
           "load_model": "null", "agent.use_pallas_loss": "true"}
    assert set(new) == set(RECIPE_REPLACED)
    replaced = {key: (stored.get(key), value) for key, value in new.items()}
    settings.update(new)
    for arg in extra:
        settings[_key(arg)] = arg.split("=", 1)[1]
    args = [f"{key}={value}" for key, value in settings.items()]
    resolve(args)
    return args, replaced


def resolve(args: tp.Sequence[str]) -> tp.Tuple[tp.Any, tp.Any]:
    """The workspace and agent configs that ``args`` give; unknown keys raise."""
    cfg, agent_overrides, _ = pretrain.build_config(args)
    agent_cfg_cls, _ = agent_classes(cfg.agent_name)
    return cfg, apply_overrides(agent_cfg_cls(), agent_overrides)


def band(jax_mean: float) -> float:
    """How far the port's mean may lie from JAX's on the 0-1000 return scale."""
    return max(50.0, 0.10 * jax_mean)


def _row(port: tp.Optional[tp.Sequence[float]], jax: tp.Optional[tp.Sequence[float]]
         ) -> tp.Dict[str, tp.Any]:
    def stats(values: tp.Optional[tp.Sequence[float]]) -> tp.Tuple[tp.Any, tp.Any]:
        if not values:
            return None, None
        t = torch.tensor([float(v) for v in values], dtype=torch.float64)
        return float(t.mean()), float(t.std(unbiased=False))

    (pm, ps), (jm, js) = stats(port), stats(jax)
    if pm is None or jm is None:
        return {"port_mean": pm, "port_std": ps, "jax_mean": jm, "jax_std": js,
                "delta": None, "band": None, "verdict": "missing"}
    delta, limit = pm - jm, band(jm)
    return {"port_mean": pm, "port_std": ps, "jax_mean": jm, "jax_std": js,
            "delta": delta, "band": limit,
            "verdict": "inside" if abs(delta) <= limit else "outside"}


def late_curve(rows: tp.Sequence[tp.Mapping[str, tp.Any]]) -> tp.List[float]:
    """The episode rewards of the last ``CURVE_ROWS`` eval rows at frames of
    ``CURVE_FROM`` or more (fewer where the run has fewer)."""
    late = [r for r in rows if float(r["frame"]) >= CURVE_FROM]
    return [float(r["episode_reward"]) for r in late[-CURVE_ROWS:]]


def compare(port_battery: tp.Mapping[str, tp.Sequence[float]],
            jax_battery: tp.Mapping[str, tp.Sequence[float]],
            port_curve: tp.Sequence[float], jax_curve: tp.Sequence[float]
            ) -> tp.Dict[str, tp.Any]:
    """The comparison rule: each battery task's mean, and the mean of the
    late curve, is inside when it lies within ``band`` of JAX's; a task or a
    curve that one side lacks (or a curve of fewer than ``CURVE_ROWS`` rows)
    is "missing". ``inside`` holds when every row is."""
    battery = {task: _row(port_battery.get(task), jax_battery.get(task))
               for task in list(jax_battery) + [t for t in port_battery
                                                if t not in jax_battery]}
    curve = _row(port_curve if len(port_curve) == CURVE_ROWS else None,
                 jax_curve if len(jax_curve) == CURVE_ROWS else None)
    curve["port"], curve["jax"] = list(port_curve), list(jax_curve)
    rows = list(battery.values()) + [curve]
    return {"battery": battery, "curve": curve,
            "inside": all(r["verdict"] == "inside" for r in rows)}


def _read_rows(path: Path) -> tp.List[tp.Dict[str, str]]:
    """The complete rows of a CSV that may be mid-write."""
    if not path.exists():
        return []
    text = path.read_text()
    return list(csv.DictReader(text[:text.rfind("\n") + 1].splitlines()))


class _EvalTail:
    """Prints each new ``eval.csv`` row, polled from a thread every
    ``period`` seconds and once more on ``stop``."""

    def __init__(self, path: Path, period: float = 5.0) -> None:
        self.path, self.period, self.seen = path, period, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def poll(self) -> None:
        rows = _read_rows(self.path)
        for row in rows[self.seen:]:
            print(f"eval frame {row['frame']}: episode_reward {row['episode_reward']}",
                  flush=True)
        self.seen = max(self.seen, len(rows))

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.poll()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        self.poll()


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if hasattr(sys.stdout, "reconfigure"):
        sys.stdout.reconfigure(line_buffering=True)  # the log of a cut run
    entry = "train_online"
    recipe: tp.Optional[Path] = None
    rest: tp.List[str] = []
    for arg in args:
        if arg.startswith("entry="):
            entry = arg.split("=", 1)[1]
        elif arg.startswith("recipe="):
            recipe = Path(arg.split("=", 1)[1])
        else:
            rest.append(arg)
    if entry not in ENTRIES:
        raise ValueError(f"entry={entry!r}: one of {sorted(ENTRIES)}")
    cpu = any(a.split("=", 1)[1] == "cpu" for a in rest if a.startswith("device="))
    if not cpu and not torch.cuda.is_available():
        print("online_curve: no CUDA device is available", file=sys.stderr)
        return 1
    if recipe is not None:
        rest, replaced = recipe_args(recipe, rest)
        print(f"recipe {recipe} through {entry}; replaced (stored -> run):")
        for key, (old, new) in replaced.items():
            print(f"  {key}: {old!r} -> {new}")
        print(f"arguments: {' '.join(rest)}", flush=True)
    work_dir = Path(resolve(rest)[0].folder)
    fused_fb.reset_launches()
    tail = _EvalTail(work_dir / "eval.csv")
    started = time.perf_counter()
    try:
        ws = ENTRIES[entry](rest)
    finally:
        tail.stop()
    seconds = time.perf_counter() - started
    if ws is None:
        return 0
    launches = dict(fused_fb.launches)
    runs = fused_fb.device_runs() if ws.device.type == "cuda" else None
    timings = ws.cycle_timings
    (ws.work_dir / "cycle_timings.json").write_text(json.dumps(timings))
    card = card_name_and_power_limit() if ws.device.type == "cuda" else "cpu"
    trained = [t for t in timings if t["updates"] > 0]
    collect = sum(t["collect"] for t in trained)
    total = collect + sum(t["update"] for t in trained)
    updates, share = sum(t["updates"] for t in timings), collect / max(total, 1e-9)
    equal = runs is None or runs == launches
    print(f"card: {card}")
    print(f"seconds of the run: {seconds:.3f}")
    print(f"frames: {ws.global_step}, updates: {updates}")
    print(f"cycles with updates: {len(trained)}, collection {collect:.3f} s of "
          f"{total:.3f} s, share {share:.4f}")
    print(f"fused FB launches: wrappers {launches}, kernels {runs}, "
          f"{'equal' if equal else 'NOT EQUAL'}")
    if recipe is not None:
        port_rows = _read_rows(ws.work_dir / "eval.csv")
        jax_rows = _read_rows(recipe / "eval.csv")
        battery_path = ws.work_dir / "test_rewards.json"
        port_battery = json.loads(battery_path.read_text()) if battery_path.exists() else {}
        jax_battery = json.loads((recipe / "test_rewards.json").read_text())
        check = compare(port_battery, jax_battery, late_curve(port_rows), late_curve(jax_rows))
        check.update({
            "recipe": str(recipe), "entry": entry, "card": card, "seconds": seconds,
            "frames": ws.global_step, "updates": updates, "collection_share": share,
            "launches": launches, "device_runs": runs, "launches_equal": equal,
            "replaced": {k: [old, new] for k, (old, new) in replaced.items()}})
        (ws.work_dir / "check.json").write_text(json.dumps(check, indent=1))
        for task, row in check["battery"].items():
            print(f"battery {task}: port {row['port_mean']} +- {row['port_std']}, "
                  f"jax {row['jax_mean']} +- {row['jax_std']}: {row['verdict']}")
        print(f"late curve: port {check['curve']['port']} jax {check['curve']['jax']}: "
              f"{check['curve']['verdict']}")
        shutil.rmtree(ws.work_dir / "models", ignore_errors=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
