"""The port's benchmark harness (``controllable_agent_torch/tools/bench*.py``,
``gen_scaling_record.py``, ``run_pod_scaling.sh``) on the CPU at small
widths, against the JAX package's harness where the two can be held side by
side: the replay they time, and the FLOPs of one update.
"""

import json
import math
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents import FBDDPGAgent as JaxAgent
from controllable_agent_tpu.agents import FBDDPGConfig as JaxConfig
from controllable_agent_tpu.data import ReplayBuffer as JaxReplayBuffer
from controllable_agent_tpu.train.loops import make_offline_trainer
from controllable_agent_torch import train_multihost
from controllable_agent_torch.agents import agent_classes
from controllable_agent_torch.config import apply_overrides
from controllable_agent_torch.data.exorl import synthetic_episodes
from controllable_agent_torch.goals import get_goal_space_dim
from controllable_agent_torch.pretrain import build_config
from controllable_agent_torch.tools import (bench, bench_breakdown, bench_roofline, bench_scaling,
                                            gen_scaling_record)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SPAWN_TIMEOUT = 240  # seconds for the processes of one spawn together
TINY = ["--device", "cpu", "--rounds", "1", "--calls", "2",
        "--agent-override", "hidden_dim=32", "--agent-override", "feature_dim=16",
        "--agent-override", "backward_hidden_dim=32", "--agent-override", "z_dim=8"]
# The geometry held to XLA's count: wide enough that the products dominate.
XLA_WIDTHS = dict(hidden_dim=256, feature_dim=128, backward_hidden_dim=128, z_dim=16,
                  batch_size=64)
# XLA's cost analysis counts the products' 2·m·k·n as FlopCounterMode does,
# plus every elementwise operation (activations, LayerNorm, casts to and from
# bf16, the loss's n x n arithmetic, Adam), which FlopCounterMode leaves out.
# Measured at XLA_WIDTHS in bf16 (jax 0.9.0): XLA 277,676,928, FlopCounterMode
# 252,280,832, an elementwise share of 0.0915 (at the bench's full width:
# 63.03 against 61.99 GFLOP, 0.017). The port's count must lie below XLA's by
# no more than that share.
XLA_ELEMENTWISE_SHARE = 0.092
FULL_WIDTH_FLOPS = 61_985_792_000  # one update at batch 1024, the JAX defaults


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _last_json(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card: none (--device cpu)"
    return json.loads(lines[-1])


def test_bench_buffer_equals_the_jax_bench_buffer() -> None:
    """``bench.py:42-52``'s replay, filled the JAX bench's way at 4 x 50
    steps, equals the port's to the bit."""
    episodes, length = 4, 50
    jbuf = JaxReplayBuffer(max_episodes=episodes, discount=0.98, future=0.99)
    rng = np.random.RandomState(0)
    obs_dim, action_dim = 24, 6
    for _ in range(episodes):
        jbuf.add_episode({
            "observation": rng.randn(length + 1, obs_dim).astype(np.float32),
            "action": rng.uniform(-1, 1, (length + 1, action_dim)).astype(np.float32),
            "reward": rng.rand(length + 1, 1).astype(np.float32),
            "discount": np.ones((length + 1, 1), np.float32),
        })
    buf = bench.bench_buffer(CPU, episodes, length)
    assert (buf.cfg.discount, buf.cfg.future) == (jbuf.cfg.discount, jbuf.cfg.future)
    assert sorted(buf.state.storage) == sorted(jbuf.state.storage)
    for k, v in buf.state.storage.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbuf.state.storage[k]), err_msg=k)
    np.testing.assert_array_equal(buf.state.ep_lengths.numpy(),
                                  np.asarray(jbuf.state.ep_lengths))


@pytest.mark.parametrize("widths", [
    dict(hidden_dim=32, feature_dim=16, backward_hidden_dim=32, z_dim=8, batch_size=16),
    dict(hidden_dim=48, feature_dim=24, backward_hidden_dim=20, z_dim=6, batch_size=10)])
def test_flop_count_is_the_products_of_the_networks(widths) -> None:
    """FlopCounterMode's count of one eager step equals 2·m·k·n summed over
    the update's products, worked out from the networks' shapes."""
    cfg = bench.bench_config(**widths)
    agent = bench.bench_agent(cfg, CPU)
    buf = bench.bench_buffer(CPU, 4, 50)
    gen = torch.Generator().manual_seed(1)
    flops, moved = bench_roofline.count_update(agent, buf, gen, cfg.batch_size)
    assert flops == bench_roofline.plain_update_flops(agent, cfg.batch_size)
    assert moved > 0


def test_full_width_update_is_61_99_gflop() -> None:
    agent = bench.bench_agent(bench.bench_config(), CPU)
    assert bench_roofline.plain_update_flops(agent, 1024) == FULL_WIDTH_FLOPS


def test_flop_count_is_within_the_elementwise_share_of_xla() -> None:
    """XLA's ``cost_analysis()["flops"]`` of the JAX ``make_offline_trainer``
    at ``steps_per_call=1`` (one update) at the same geometry."""
    cfg = bench.bench_config(**XLA_WIDTHS)
    agent = bench.bench_agent(cfg, CPU)
    buf = bench.bench_buffer(CPU, 4, 50)
    flops, _ = bench_roofline.count_update(agent, buf, torch.Generator().manual_seed(1),
                                           cfg.batch_size)

    jagent = JaxAgent(JaxConfig(compute_dtype="bfloat16", **XLA_WIDTHS), obs_dim=24,
                      action_dim=6)
    jbuf = JaxReplayBuffer(max_episodes=4, discount=0.98, future=0.99)
    for ep in synthetic_episodes(4, 50, 24, 6, 0):
        jbuf.add_episode(ep)
    trainer = make_offline_trainer(jagent, jbuf.cfg, cfg.batch_size, 1)
    cost = trainer.lower(jagent.init(jax.random.key(0)), jbuf.state,
                         jax.random.key(1)).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    xla = float(cost["flops"])
    share = (xla - flops) / xla
    assert 0 <= share <= XLA_ELEMENTWISE_SHARE, (flops, xla, share)


def test_roofline_counts_one_update_whatever_the_steps_per_call(capsys) -> None:
    outs = [bench_roofline.main(["16", str(steps)] + TINY) for steps in (1, 3)]
    assert outs[0]["flops_per_update"] == outs[1]["flops_per_update"]
    assert outs[0]["bytes_per_update"] == outs[1]["bytes_per_update"]
    assert [o["steps_per_call"] for o in outs] == [1, 3]


@pytest.mark.parametrize("tool,argv,keys", [
    (bench, [], ["metric", "value", "unit", "vs_baseline"]),
    (bench_roofline, ["16", "2"], ["batch_size", "steps_per_call", "updates_per_s",
                                   "flops_per_update", "bytes_per_update", "achieved_tflops",
                                   "achieved_gbps", "op_intensity_flop_per_byte"]),
    (bench_breakdown, ["--steps", "2"], ["full_us", "fwdbwd_us", "opt_us",
                                         "implied_opt_share"]),
], ids=["bench", "bench_roofline", "bench_breakdown"])
def test_tools_print_their_jax_keys(tool, argv, keys, capsys, monkeypatch) -> None:
    monkeypatch.setenv("BENCH_STEPS_PER_CALL", "2")
    returned = tool.main(argv + TINY + ["--agent-override", "batch_size=16"])
    printed = _last_json(capsys)
    assert printed == returned and list(printed) == keys
    numbers = [v for v in printed.values() if not isinstance(v, str)]
    assert all(math.isfinite(v) for v in numbers), printed
    if tool is bench:
        assert printed["metric"] == "fb_gradient_updates_per_s" and printed["value"] > 0


def test_bench_scaling_over_gloo(capsys) -> None:
    """World sizes 1 and 2: two spawns of gloo processes, each within 240 s."""
    assert bench_scaling.TIMEOUT == SPAWN_TIMEOUT
    lines = bench_scaling.main(["--device", "cpu", "--world", "2", "--batch", "16", "--steps",
                                "2", "--repeats", "1"] + TINY[6:])
    assert [line["devices"] for line in lines] == [1, 2]
    assert all(line["metric"] == "fb_updates_per_s" and line["value"] > 0 for line in lines)
    assert lines[0]["efficiency"] == 1.0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "card: none (--device cpu)"
    assert [json.loads(line) for line in out[1:]] == lines


def test_gen_scaling_record_writes_both_runs(tmp_path, capsys, monkeypatch) -> None:
    monkeypatch.setattr(gen_scaling_record, "TIMEOUT", SPAWN_TIMEOUT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "SCALING_torch.json"
    oks = gen_scaling_record.main([
        "--device", "cpu", "--out", str(out), "--grad-steps", "4", "--dryrun-processes", "2",
        "--", "agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
        "agent.z_dim=8"])
    assert oks == {"gloo_2process": True, "virtual_mesh_dryrun": True}
    record = json.loads(out.read_text())
    gloo, dryrun = record["records"]["gloo_2process"], record["records"]["virtual_mesh_dryrun"]
    assert gloo["ok"] and dryrun["ok"]
    assert all(r["label"].startswith("CORRECTNESS-ONLY") for r in (gloo, dryrun))
    header, last = gloo["log_tail"]
    assert float(dict(zip(header.split(","), last.split(",")))["step"]) == 4
    assert len(dryrun["report"]) == 2 and all(r.endswith("ok") for r in dryrun["report"])
    assert f"{torch.__version__}" in record["environment"]
    assert capsys.readouterr().out.splitlines()[-2] == json.dumps(oks)


def test_run_pod_scaling_script() -> None:
    """The script parses, and the overrides of its multi-host run parse with
    the port's ``train_multihost`` parser and the workspace's config."""
    script = REPO / "controllable_agent_torch" / "tools" / "run_pod_scaling.sh"
    subprocess.run(["bash", "-n", str(script)], check=True, timeout=60)
    text = script.read_text()
    block = text.split("python -m controllable_agent_torch.train_multihost \\\n", 1)[1]
    block = block.split("\n\n", 1)[0]
    # bash expands the variables as the script would, on host 1 of 2
    argv = subprocess.run(
        ["bash", "-c", "COORD=10.0.0.2:1234 NHOSTS=2 HOSTID=1 BATCH=1024 "
                       "EXORL_DIR=/data/rnd_walker; printf '%s\\n' " + block],
        check=True, capture_output=True, text=True, timeout=60).stdout.splitlines()
    args = train_multihost.parse_args(argv)
    assert (args.coordinator, args.num_processes, args.process_id) == ("10.0.0.2:1234", 2, 1)
    assert args.replay_dir == "/data/rnd_walker"
    cfg, agent_overrides, _ = build_config(args.rest)
    assert (cfg.agent_name, cfg.task, cfg.num_grad_steps) == ("fb_ddpg", "walker_walk", 2000)
    assert get_goal_space_dim(cfg.goal_space) > 0
    agent_cfg = apply_overrides(agent_classes(cfg.agent_name)[0](), agent_overrides)
    assert agent_cfg.batch_size == 1024
    assert "controllable_agent_torch.tools.bench_scaling" in text


@pytest.mark.parametrize("tool", [bench, bench_roofline, bench_breakdown, bench_scaling,
                                  gen_scaling_record],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tools_need_a_card_unless_told(tool, monkeypatch, tmp_path) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out", str(tmp_path / "x.json")] if tool is gen_scaling_record else []
    with pytest.raises(SystemExit, match="no CUDA device") as exited:
        tool.main(argv)
    assert exited.value.code != 0
    assert not (tmp_path / "x.json").exists()
