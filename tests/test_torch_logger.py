"""The port's logger (``train/logger.py``) against the JAX package's on the
same rows: the CSV byte for byte (header widening and the pruning of stale
rows on resume included), the JSONL records apart from their time stamp, and
the console rows."""

import json

import pytest

from controllable_agent_tpu.train import logger as jlogger
from controllable_agent_torch.train import logger as tlogger

ROWS = [
    (10, {"fps": 12.5, "total_time": 1.25, "step": 10}),
    (20, {"fps": 13.0, "total_time": 2.5, "step": 20, "fb_loss": 0.75, "actor_loss": -1.5}),
    (30, {"fps": 11.0, "total_time": 3.75, "step": 30, "fb_loss": 0.5, "actor_loss": -2.0,
          "episode": 3, "episode_reward": 123.456, "episode_length": 1000}),
]


def _write(module, folder, rows=ROWS, ty="train"):
    logger = module.Logger(folder, use_console=True)
    for step, metrics in rows:
        with logger.log_and_dump_ctx(step, ty) as log:
            for k, v in metrics.items():
                log(k, v)
    return logger


def _records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "#now"}
            for line in path.read_text().splitlines()]


@pytest.mark.parametrize("ty", ["train", "eval"])
def test_csv_jsonl_and_console_match_the_jax_logger(tmp_path, capsys, ty) -> None:
    _write(jlogger, tmp_path / "jax", ty=ty)
    want_console = capsys.readouterr().out
    ours = _write(tlogger, tmp_path / "torch", ty=ty)
    got_console = capsys.readouterr().out
    assert got_console == want_console and got_console.count(f"| {ty}") == 3
    assert ((tmp_path / "torch" / f"{ty}.csv").read_text()
            == (tmp_path / "jax" / f"{ty}.csv").read_text())
    header = (tmp_path / "torch" / f"{ty}.csv").read_text().splitlines()[0].split(",")
    assert "fb_loss" in header and "episode_reward" in header  # widened twice
    assert _records(tmp_path / "torch" / "hip.log") == _records(tmp_path / "jax" / "hip.log")
    assert len(ours.hiplog.read()) == 3 and "#now" in ours.hiplog.read()[0]


def test_resume_prunes_stale_rows_like_the_jax_logger(tmp_path) -> None:
    rows = [(10 * i, {"fps": 1.0 * i, "episode": i, "step": 10 * i}) for i in range(1, 6)]
    for module, folder in ((jlogger, tmp_path / "jax"), (tlogger, tmp_path / "torch")):
        _write(module, folder, rows)
        _write(module, folder, rows[2:4])  # a resumed run starts again at episode 3
    got = (tmp_path / "torch" / "train.csv").read_text()
    assert got == (tmp_path / "jax" / "train.csv").read_text()
    assert [line.split(",")[0] for line in got.splitlines()[1:]] == ["1.0", "2.0", "3.0", "4.0"]
    records = _records(tmp_path / "torch" / "hip.log")
    assert records == _records(tmp_path / "jax" / "hip.log")
    assert [r["#reloads"] for r in records] == [0] * 5 + [5] * 2


def test_average_meter_and_row_returned(tmp_path) -> None:
    meter = tlogger.AverageMeter()
    assert meter.value() == 0.0
    meter.update(3.0)
    meter.update(5.0)
    assert meter.value() == 4.0 == _jax_meter_value([3.0, 5.0])
    logger = tlogger.Logger(tmp_path, use_console=False)
    logger.log("train/fb_loss", 1.0, 5)
    logger.log("train/fb_loss", 3.0, 5)
    logger.log_metrics({"q": 2.0}, 5, "train")
    row = logger.dump(5, "train")
    assert row == {"fb_loss": 2.0, "q": 2.0, "frame": 5}
    assert logger.dump(6, "train") == {}  # nothing logged since
    with pytest.raises(AssertionError):
        logger.log("other/x", 1.0, 0)
    with logger.log_and_dump_ctx(7, "eval") as log:
        log("episode_reward", 9.0)
    assert log.row == {"episode_reward": 9.0, "frame": 7}


def _jax_meter_value(values) -> float:
    meter = jlogger.AverageMeter()
    for v in values:
        meter.update(v)
    return meter.value()
