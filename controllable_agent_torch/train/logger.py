"""Logger: CSV + console + JSONL sinks behind one facade (mirror of
``controllable_agent_tpu/train/logger.py``).

  * train.csv / eval.csv with header management (the header widens when a
    new metric appears) and stale-row pruning on resume;
  * formatted console rows with AverageMeter smoothing between dumps;
  * ``hip.log``: append-only JSON-lines records with time / reload stamps.

``use_tb`` adds a TensorBoard sink (``<folder>/tb``, one scalar per logged
key at its step) and ``use_wandb`` a wandb run (``wandb.init`` into the
folder with the workspace's config), each imported only when asked for: a
sink whose package is missing raises its ``ModuleNotFoundError``.
"""

from __future__ import annotations

import csv
import datetime
import json
import typing as tp
from collections import defaultdict
from pathlib import Path

Value = tp.Union[int, float]


class AverageMeter:
    def __init__(self) -> None:
        self._sum = 0.0
        self._count = 0

    def update(self, value: float, n: int = 1) -> None:
        self._sum += value
        self._count += n

    def value(self) -> float:
        return self._sum / max(1, self._count)


class MetersGroup:
    """CSV + console sink."""

    _FORMATS = {"int": "{:,}", "float": "{:.04f}", "time": "{:.01f} s"}

    def __init__(self, csv_file_name: Path, formating: tp.Sequence[tp.Tuple[str, str, str]],
                 use_console: bool = True) -> None:
        self._csv_file_name = csv_file_name
        self._formating = formating
        self._meters: tp.DefaultDict[str, AverageMeter] = defaultdict(AverageMeter)
        self._csv_file: tp.Optional[tp.TextIO] = None
        self._csv_writer: tp.Optional[csv.DictWriter] = None
        self._use_console = use_console

    def log(self, key: str, value: float, n: int = 1) -> None:
        self._meters[key].update(value, n)

    def _prime_meters(self) -> tp.Dict[str, float]:
        data = {}
        for key, meter in self._meters.items():
            key = key.split("/", 1)[-1].replace("/", "_")
            data[key] = meter.value()
        return data

    def _remove_old_entries(self, data: tp.Dict[str, float]) -> None:
        """Prune rows at/after the current step on resume."""
        rows = []
        with self._csv_file_name.open("r") as f:
            reader = csv.DictReader(f)
            for row in reader:
                if "episode" in row and row["episode"]:
                    if float(row["episode"]) >= data["episode"]:
                        break
                rows.append(row)
        with self._csv_file_name.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=sorted(data.keys()),
                                    restval=0.0)
            writer.writeheader()
            for row in rows:
                writer.writerow(row)

    def _rewrite_with_fields(self, fieldnames: tp.List[str]) -> None:
        """Rewrite the CSV with a widened header (new metric keys can appear
        after warmup, e.g. agent metrics once updates start)."""
        rows: tp.List[tp.Dict[str, str]] = []
        if self._csv_file_name.exists():
            with self._csv_file_name.open("r") as f:
                rows = list(csv.DictReader(f))
        with self._csv_file_name.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames, restval=0.0)
            writer.writeheader()
            for row in rows:
                writer.writerow(row)

    def _dump_to_csv(self, data: tp.Dict[str, float]) -> None:
        if self._csv_writer is not None and not (
                set(data) <= set(self._csv_writer.fieldnames)):
            # widen the header to the union of old and new keys
            merged = sorted(set(self._csv_writer.fieldnames) | set(data))
            assert self._csv_file is not None
            self._csv_file.close()
            self._rewrite_with_fields(merged)
            self._csv_file = self._csv_file_name.open("a", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file,
                                              fieldnames=merged, restval=0.0)
        if self._csv_writer is None:
            should_write_header = True
            if self._csv_file_name.exists() and "episode" in data:
                self._remove_old_entries(data)
                should_write_header = False
            self._csv_file = self._csv_file_name.open("a", newline="")
            self._csv_writer = csv.DictWriter(
                self._csv_file, fieldnames=sorted(data.keys()), restval=0.0)
            if should_write_header:
                self._csv_writer.writeheader()
        assert self._csv_file is not None
        self._csv_writer.writerow(data)
        self._csv_file.flush()

    def _format(self, key: str, value: float, ty: str) -> str:
        return f"{key}: {self._FORMATS[ty].format(value)}"

    def _dump_to_console(self, data: tp.Dict[str, float], prefix: str) -> None:
        pieces = [f"| {prefix: <14}"]
        for key, disp_key, ty in self._formating:
            value = data.get(key, 0)
            pieces.append(self._format(disp_key, value, ty))
        print(" | ".join(pieces))

    def dump(self, step: int, prefix: str) -> tp.Dict[str, float]:
        if not self._meters:
            return {}
        data = self._prime_meters()
        data["frame"] = step
        self._dump_to_csv(data)
        if self._use_console:
            self._dump_to_console(data, prefix)
        self._meters.clear()
        return data


class JsonlLogger:
    """Append-only JSON-lines sink (the hiplog format)."""

    def __init__(self, filepath: Path) -> None:
        self._filepath = Path(filepath)
        self._content: tp.Dict[str, tp.Any] = {}
        self._reloads = 0
        if self._filepath.exists():
            for _ in self.read():
                self._reloads += 1

    def __call__(self, **kwargs: tp.Any) -> "JsonlLogger":
        self._content.update(kwargs)
        return self

    def write(self) -> None:
        if not self._content:
            return
        self._content.update(
            {"#now": datetime.datetime.now().isoformat(),
             "#reloads": self._reloads})
        with self._filepath.open("a") as f:
            f.write(json.dumps(self._content, default=float) + "\n")
        self._content = {}

    def read(self) -> tp.List[tp.Dict[str, tp.Any]]:
        out = []
        if self._filepath.exists():
            with self._filepath.open("r") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        return out


_TRAIN_FORMAT = [
    ("frame", "F", "int"), ("step", "S", "int"), ("episode", "E", "int"),
    ("episode_length", "L", "int"), ("episode_reward", "R", "float"),
    ("fps", "FPS", "float"), ("total_time", "T", "time"),
]
_EVAL_FORMAT = [
    ("frame", "F", "int"), ("step", "S", "int"), ("episode", "E", "int"),
    ("episode_length", "L", "int"), ("episode_reward", "R", "float"),
    ("total_time", "T", "time"),
]


class Logger:
    """Facade over train/eval MetersGroups + jsonl."""

    def __init__(self, log_dir: tp.Union[str, Path], use_console: bool = True,
                 use_jsonl: bool = True, use_tb: bool = False, use_wandb: bool = False,
                 wandb_config: tp.Optional[tp.Mapping[str, tp.Any]] = None) -> None:
        self._log_dir = Path(log_dir)
        self._log_dir.mkdir(parents=True, exist_ok=True)
        self._train_mg = MetersGroup(self._log_dir / "train.csv",
                                     _TRAIN_FORMAT, use_console)
        self._eval_mg = MetersGroup(self._log_dir / "eval.csv",
                                    _EVAL_FORMAT, use_console)
        self.hiplog: tp.Optional[JsonlLogger] = (
            JsonlLogger(self._log_dir / "hip.log") if use_jsonl else None)
        self._tb: tp.Any = None
        if use_tb:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(str(self._log_dir / "tb"))
        self._wandb: tp.Any = None
        if use_wandb:
            import wandb
            if wandb.run is None:
                wandb.init(dir=str(self._log_dir), config=dict(wandb_config or {}))
            self._wandb = wandb

    def log(self, key: str, value: Value, step: int) -> None:
        assert key.startswith("train") or key.startswith("eval"), key
        mg = self._train_mg if key.startswith("train") else self._eval_mg
        mg.log(key, float(value))
        if self.hiplog is not None:
            self.hiplog(**{key.replace("/", "_"): float(value)})
        if self._tb is not None:
            self._tb.add_scalar(key, float(value), step)
        if self._wandb is not None:
            self._wandb.log({key: float(value)}, step=step)

    def log_metrics(self, metrics: tp.Mapping[str, Value], step: int,
                    ty: str) -> None:
        for key, value in metrics.items():
            self.log(f"{ty}/{key}", value, step)

    def dump(self, step: int, ty: tp.Optional[str] = None) -> tp.Dict[str, float]:
        """Write the accumulated rows; returns the train row (the eval row
        when only that was asked for)."""
        row: tp.Dict[str, float] = {}
        if ty is None or ty == "eval":
            row = self._eval_mg.dump(step, "eval")
        if ty is None or ty == "train":
            row = self._train_mg.dump(step, "train")
        # flush the accumulated hiplog record once per dump
        if self.hiplog is not None:
            self.hiplog.write()
        return row

    def log_video(self, key: str, frames: tp.Sequence[tp.Any], step: int,
                  fps: int = 20) -> None:
        """Send an evaluation video ([T, H, W, 3] frames) to wandb when that
        sink is on; the file ``VideoRecorder`` saved is the record."""
        if self._wandb is not None:
            import numpy as np
            arr = np.asarray(frames).transpose(0, 3, 1, 2)
            self._wandb.log({key: self._wandb.Video(arr, fps=fps, format="mp4")}, step=step)

    class _LogAndDumpCtx:
        def __init__(self, logger: "Logger", step: int, ty: str) -> None:
            self._logger, self._step, self._ty = logger, step, ty
            self.row: tp.Dict[str, float] = {}  # what the dump wrote, after exit

        def __enter__(self) -> "Logger._LogAndDumpCtx":
            return self

        def __call__(self, key: str, value: Value) -> None:
            self._logger.log(f"{self._ty}/{key}", value, self._step)

        def __exit__(self, *args: tp.Any) -> None:
            self.row = self._logger.dump(self._step, self._ty)

    def log_and_dump_ctx(self, step: int, ty: str) -> "_LogAndDumpCtx":
        return self._LogAndDumpCtx(self, step, ty)
