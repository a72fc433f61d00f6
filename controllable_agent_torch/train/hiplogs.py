"""Experiment-log parsing and aggregation, the hiplot pipeline (mirror of
``controllable_agent_tpu/train/hiplogs.py``, pure Python).

The reference's hiplogs module (url_benchmark/hiplogs.py): the append-only
JSON-lines `hip.log` files written by the Logger (``train/logger.py``) are
discovered across experiment folder trees and assembled into a hiplot
experiment — per-step datapoints chained with `from_uid` so each run
draws as a trajectory in the parallel-coordinates view, loaded with a
process pool across experiments (reference `load`, hiplogs.py:118-148)
and styled like the reference (`_set_style`, :53-93).

`hiplot` itself is an optional dependency: when importable the functions
return real `hip.Experiment` objects (usable as a hiplot fetcher:
`python -m hiplot controllable_agent_torch.train.hiplogs.load`); otherwise
a structural stand-in with the same `datapoints`/`to_csv`/`to_json`
surface is returned, so the CLI works anywhere:

    python -m controllable_agent_torch.train.hiplogs results/

The process pool that parses a tree's logs starts its workers with
``spawn``: a process with a CUDA context or threads is not forked.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import statistics
import typing as tp
from concurrent import futures
from pathlib import Path


def _flatten(d: tp.Mapping[str, tp.Any], prefix: str = "") -> tp.Dict[str, tp.Any]:
    out: tp.Dict[str, tp.Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, prefix=f"{key}/"))
        elif isinstance(v, (list, tuple)):
            out[key] = str(v)
        else:
            out[key] = v
    return out


# ---------------------------------------------------- experiment model

@dataclasses.dataclass
class Datapoint:
    """Structural stand-in for hiplot.Datapoint."""

    uid: str
    from_uid: tp.Optional[str]
    values: tp.Dict[str, tp.Any]


class Experiment:
    """Structural stand-in for hiplot.Experiment (merge/export only)."""

    def __init__(self) -> None:
        self.datapoints: tp.List[Datapoint] = []

    @staticmethod
    def merge(experiments: tp.Mapping[str, "Experiment"]) -> "Experiment":
        merged = Experiment()
        for name, exp in experiments.items():
            for dp in exp.datapoints:
                merged.datapoints.append(Datapoint(
                    uid=f"{name}_{dp.uid}",
                    from_uid=(f"{name}_{dp.from_uid}"
                              if dp.from_uid is not None else None),
                    values=dp.values))
        return merged

    def columns(self) -> tp.List[str]:
        cols: tp.Set[str] = set()
        for dp in self.datapoints:
            cols.update(dp.values)
        return sorted(cols)

    def to_json(self) -> str:
        """hiplot's experiment JSON shape ({"datapoints": [...]})."""
        return json.dumps({"datapoints": [
            {"uid": dp.uid, "from_uid": dp.from_uid, "values": dp.values}
            for dp in self.datapoints]})

    def to_csv(self, path: tp.Union[str, Path]) -> None:
        import csv
        cols = ["uid", "from_uid"] + self.columns()
        with Path(path).open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=cols)
            writer.writeheader()
            for dp in self.datapoints:
                writer.writerow({"uid": dp.uid, "from_uid": dp.from_uid,
                                 **dp.values})


def _hip() -> tp.Any:
    try:
        import hiplot  # type: ignore
        return hiplot
    except ImportError:
        return None


def _column_kind(col: str) -> str:
    """Classify a column of THIS repo's hip.log schema (train/logger.py
    JsonlLogger rows: ``train_*``/``eval_*`` metric columns, ``eval_phys_*``
    physics aggregates, ``#``-prefixed bookkeeping, everything else config).

      headline  — the numbers a sweep is read by (returns, fps, steps)
      metric    — other per-update losses/diagnostics (noisy; hidden in
                  the parallel plot, badge-styled in the table)
      internal  — bookkeeping (#now/#reloads, uid/from_uid, workdir)
      config    — flattened run config (kept visible: these are the axes
                  a hiplot sweep pivots on)
    """
    if col in ("uid", "from_uid", "workdir") or col.startswith("#"):
        return "internal"
    if not col.startswith(("train_", "eval_")):
        return "config"
    stem = col.split("_", 1)[1]
    if stem in ("episode_reward", "episode", "step", "fps"):
        return "headline"
    return "metric"


def _set_style(exp: tp.Any) -> None:
    """Serves the reference _set_style's purpose (hiplogs.py:53-93) for
    this repo's column schema: noisy per-update metric series are hidden
    from the parallel plot, the XY view opens on the eval return curve,
    and table badges separate headline / metric / bookkeeping columns.
    No-op on the structural stand-in."""
    hip = _hip()
    if hip is None or not isinstance(exp, hip.Experiment):
        return
    cols = sorted({x for dp in exp.datapoints for x in dp.values.keys()}
                  | {"uid", "from_uid"})
    kinds = {col: _column_kind(col) for col in cols}
    exp.display_data(hip.Displays.PARALLEL_PLOT).update({
        "hide": [c for c, k in kinds.items() if k in ("metric", "internal")],
    })
    exp.display_data(hip.Displays.XY).update({
        "axis_x": "eval_step" if "eval_step" in kinds else "train_step",
        "axis_y": "eval_episode_reward",
    })
    badge_css = {
        "headline": "badge badge-pill badge-danger",
        "metric": "badge badge-pill badge-primary",
        "internal": "badge badge-pill badge-secondary",
    }
    for col, kind in kinds.items():
        css = badge_css.get(kind)
        if css is not None:
            exp.parameters_definition[col].label_css = css


# ------------------------------------------------------------- reader

class HipLog:
    """Reader/aggregator for one hip.log file (reference HipLog,
    url_benchmark/hiplogs.py:151-341; writing lives in
    train/logger.JsonlLogger)."""

    def __init__(self, filepath: tp.Union[str, Path]) -> None:
        self.filepath = Path(filepath)

    def read(self, step_key: str = "eval_step") -> tp.List[tp.Dict[str, tp.Any]]:
        out: tp.List[tp.Dict[str, tp.Any]] = []
        if not self.filepath.exists():
            return out
        with self.filepath.open() as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        return out

    def last(self) -> tp.Dict[str, tp.Any]:
        rows = self.read()
        return rows[-1] if rows else {}

    def aggregate(self, keys: tp.Optional[tp.Sequence[str]] = None
                  ) -> tp.Dict[str, float]:
        """mean/min/max/last per numeric key over all rows (the
        float-stat aggregation of reference hiplogs :249-290)."""
        rows = self.read()
        series: tp.Dict[str, tp.List[float]] = {}
        for row in rows:
            for k, v in row.items():
                if isinstance(v, (int, float)) and not k.startswith("#"):
                    if keys is None or k in keys:
                        series.setdefault(k, []).append(float(v))
        out: tp.Dict[str, float] = {}
        for k, vals in series.items():
            out[f"{k}_mean"] = statistics.fmean(vals)
            out[f"{k}_min"] = min(vals)
            out[f"{k}_max"] = max(vals)
            out[f"{k}_last"] = vals[-1]
        return out

    def to_experiment(self, step: int = 10) -> Experiment:
        """One experiment per run: every `step`-th log row becomes a
        datapoint chained to the previous one via from_uid (reference
        to_hiplot_experiment, hiplogs.py:53-93 usage in load), with the
        flattened config.json merged into every datapoint so config
        columns appear on the parallel axes."""
        hip = _hip()
        exp: tp.Any = hip.Experiment() if hip is not None else Experiment()
        xp_name = self.filepath.parent.name
        base: tp.Dict[str, tp.Any] = {"experiment": xp_name,
                                      "workdir": str(self.filepath.parent)}
        cfg_path = self.filepath.parent / "config.json"
        if cfg_path.exists():
            try:
                base.update(_flatten(json.loads(cfg_path.read_text())))
            except json.JSONDecodeError:
                pass
        rows = self.read()
        prev_uid: tp.Optional[str] = None
        for k, row in enumerate(rows):
            if step > 1 and k % step and k != len(rows) - 1:
                continue
            values = dict(base)
            values.update(row)
            uid = f"{xp_name}_{k}"
            if hip is not None:
                dp = hip.Datapoint(uid=uid, from_uid=prev_uid, values=values)
            else:
                dp = Datapoint(uid=uid, from_uid=prev_uid, values=values)
            exp.datapoints.append(dp)
            prev_uid = uid
        return exp


def create_csv_experiment(uri: tp.Union[str, Path],
                          step: int = 1) -> Experiment:
    """Experiment from a train/eval csv (reference
    create_hiplot_experiment, hiplogs.py:96-116): one chained datapoint
    per row, tagged with the xp folder and csv stem."""
    import csv
    hip = _hip()
    uri = Path(uri)
    exp: tp.Any = hip.Experiment() if hip is not None else Experiment()
    base: tp.Dict[str, tp.Any] = {"experiment": uri.parent.name,
                                  "workdir": str(uri.parent),
                                  "mode": uri.stem}
    cfg_path = uri.parent / "config.json"
    if cfg_path.exists():
        try:
            base.update(_flatten(json.loads(cfg_path.read_text())))
        except json.JSONDecodeError:
            pass
    with uri.open() as f:
        rows = list(csv.DictReader(f))
    prev_uid: tp.Optional[str] = None
    for k, row in enumerate(rows):
        if step > 1 and k % step and k != len(rows) - 1:
            continue
        values = dict(base)
        for key, val in row.items():
            try:
                values[key] = float(val)
            except (TypeError, ValueError):
                values[key] = val
        uid = f"{uri.parent.name}_{uri.stem}_{k}"
        dp_cls: tp.Any = hip.Datapoint if hip is not None else Datapoint
        exp.datapoints.append(dp_cls(uid=uid, from_uid=prev_uid,
                                     values=values))
        prev_uid = uid
    return exp


def _one_experiment(args: tp.Tuple[str, int]) -> Experiment:
    path, step = args
    if path.endswith(".csv"):
        return create_csv_experiment(path, step)
    return HipLog(path).to_experiment(step)


def load(uri: tp.Union[Path, str], step: int = 10) -> tp.Any:
    """Walk an experiment tree, parse every run's hip.log in a process
    pool, and merge into one experiment (reference load,
    url_benchmark/hiplogs.py:118-148). Usable directly as a hiplot
    fetcher: `python -m hiplot controllable_agent_torch.train.hiplogs.load`
    then paste experiment folders into the freeform."""
    uri = Path(uri)
    if str(uri).startswith("#"):  # deactivated line in the freeform
        hip = _hip()
        return hip.Experiment() if hip is not None else Experiment()
    assert uri.is_dir(), f"uri should be a valid directory, got {uri}"
    # every run folder contributes its hip.log, or its eval.csv when no
    # hip.log was kept (reference globs eval.csv, hiplogs.py:140-146)
    log_paths = []
    run_dirs = {p.parent for p in uri.rglob("hip.log")}
    run_dirs |= {p.parent for p in uri.rglob("eval.csv")}
    for d in sorted(run_dirs):
        if (d / "hip.log").exists():
            log_paths.append(str(d / "hip.log"))
        else:
            log_paths.append(str(d / "eval.csv"))
    exps: tp.List[Experiment] = []
    if _hip() is None and len(log_paths) > 1:
        # the structural stand-in pickles cleanly -> parallel tree load
        try:
            with futures.ProcessPoolExecutor(
                    max_workers=min(len(log_paths), os.cpu_count() or 1),
                    mp_context=multiprocessing.get_context("spawn")) as executor:
                exps = list(executor.map(
                    _one_experiment, [(p, step) for p in log_paths]))
        except (OSError, RuntimeError):  # no subprocess support
            exps = []
    if not exps:
        exps = [_one_experiment((p, step)) for p in log_paths]
    hip = _hip()
    cls: tp.Any = hip.Experiment if hip is not None else Experiment
    exp = cls.merge({str(k): xp for k, xp in enumerate(exps)})
    _set_style(exp)
    return exp


def aggregate_tree(folder: tp.Union[str, Path],
                   pattern: str = "**/hip.log") -> tp.List[tp.Dict[str, tp.Any]]:
    """One flat record per experiment (config + metric aggregates) — the
    summary-table view of the same tree."""
    folder = Path(folder)
    records: tp.List[tp.Dict[str, tp.Any]] = []
    for log_path in sorted(folder.glob(pattern)):
        record: tp.Dict[str, tp.Any] = {"xp": str(log_path.parent)}
        cfg_path = log_path.parent / "config.json"
        if cfg_path.exists():
            try:
                record.update(_flatten(json.loads(cfg_path.read_text())))
            except json.JSONDecodeError:
                pass
        record.update(HipLog(log_path).aggregate())
        records.append(record)
    return records


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    """CLI: merge every run under a folder tree into one hiplot-ready
    experiment (reference `python -m hiplot url_benchmark.hiplogs.load`,
    README.md:80-86). Writes <folder>/hiplot_experiment.csv + .json and
    prints a per-experiment summary table."""
    import sys
    args = list(argv if argv is not None else sys.argv[1:])
    if not args or "--help" in args or "-h" in args:
        print(__doc__)
        print("usage: python -m controllable_agent_torch.train.hiplogs FOLDER "
              "[--step N]")
        return
    step = 10
    if "--step" in args:
        i = args.index("--step")
        step = int(args[i + 1])
        del args[i:i + 2]
    folder = Path(args[0])
    exp = load(folder, step=step)
    out_csv = folder / "hiplot_experiment.csv"
    exp.to_csv(out_csv)
    (folder / "hiplot_experiment.json").write_text(exp.to_json())
    n_xp = len({dp.values.get("experiment") for dp in exp.datapoints})
    print(f"merged {n_xp} experiments, {len(exp.datapoints)} datapoints, "
          f"{len(exp.columns())} columns -> {out_csv}")
    for record in aggregate_tree(folder):
        summary = {k: record[k] for k in
                   ("xp", "episode_reward_max", "episode_reward_last",
                    "step_last") if k in record}
        print(json.dumps(summary))


if __name__ == "__main__":
    main()
