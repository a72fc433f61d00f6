"""The logger's TensorBoard and wandb sinks and ``profile_dir`` against the
JAX package: the same scalars under the same tags and steps in the event
files, the same error when wandb is missing, one trace of one cycle."""

import json
import struct

import numpy as np
import pytest
import torch
from tensorboardX.proto import event_pb2

from controllable_agent_tpu.train.logger import Logger as JaxLogger
from controllable_agent_torch import pretrain
from controllable_agent_torch.train.logger import Logger
from controllable_agent_torch.utils import trace


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scalars(folder) -> list:
    """(tag, step, value) of every scalar in the event files under
    ``folder``: TFRecords of length, its crc, the event, its crc."""
    out = []
    for path in sorted(folder.glob("events.out.tfevents.*")):
        data = path.read_bytes()
        pos = 0
        while pos < len(data):
            (length,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + length])
            pos += 12 + length + 4
            for value in event.summary.value:
                out.append((value.tag, event.step, value.simple_value))
    return out


def _log_calls(logger) -> None:
    rng = np.random.RandomState(0)
    for step in (10, 20, 30):
        with logger.log_and_dump_ctx(step, "train") as log:
            log("fps", float(rng.rand()))
            log("fb_loss", float(rng.randn()))
        logger.log_metrics({"episode_reward": float(rng.rand())}, step, "eval")
        logger.dump(step, "eval")


def test_tensorboard_events_equal_jax(tmp_path) -> None:
    jax_logger = JaxLogger(tmp_path / "jax", use_console=False, use_tb=True)
    logger = Logger(tmp_path / "port", use_console=False, use_tb=True)
    _log_calls(jax_logger)
    _log_calls(logger)
    jax_logger._tb.close()  # the writer's queue drains on close
    logger._tb.close()
    got, want = _scalars(tmp_path / "port" / "tb"), _scalars(tmp_path / "jax" / "tb")
    assert len(got) == 9 and got == want
    assert {tag for tag, _, _ in got} == {"train/fps", "train/fb_loss", "eval/episode_reward"}


def test_wandb_without_the_package_raises_as_jax(tmp_path) -> None:
    with pytest.raises(ModuleNotFoundError) as jax_error:
        JaxLogger(tmp_path / "jax", use_console=False, use_wandb=True)
    with pytest.raises(ModuleNotFoundError) as error:
        Logger(tmp_path / "port", use_console=False, use_wandb=True)
    assert str(error.value) == str(jax_error.value) == "No module named 'wandb'"


def test_profile_dir_traces_one_cycle(tmp_path) -> None:
    """``pretrain`` with ``profile_dir``: the first cycle after the seed
    frames (one of three cycles) is traced, into one Chrome trace that holds
    that cycle's updates and the program's spans (tracing is on for that
    cycle alone)."""
    ws = pretrain.main([
        "device=cpu", "task=point_mass_maze_reach_top_left", "episode_length=20", "num_envs=2",
        "replay_buffer_episodes=16", "agent.hidden_dim=32", "agent.backward_hidden_dim=32",
        "agent.feature_dim=16", "agent.z_dim=8", "agent.batch_size=16",
        "num_train_frames=120", "num_seed_frames=40", "eval_every_steps=0", "final_tests=0",
        f"profile_dir={tmp_path}/profiles", f"folder={tmp_path}/run"])
    assert ws.global_step == 120
    traces = list((tmp_path / "profiles").iterdir())
    assert [p.name for p in traces] == ["trace_40.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("addmm" in name or "mm" == name.split("::")[-1] for name in names)
    assert {"collect", "commit", "updates", "sample", "update", "optimizer", "act",
            "env_step"} <= names
    assert not trace.enabled()
