"""The port's tracing (``utils/trace.py``) on the CPU: the switch, the host
spans at the layers' boundaries, the capture records, and the captured
programs taken anew when the switch flips.

A CUDA graph cannot be built here, so the capture tests run the real
``CapturedProgram`` over stand-ins for ``torch.cuda``'s streams and graphs
(``fake_graphs``): its warm-up runs and its capture run ``fn`` eagerly, and
a replay does nothing. The device spans' marks need a card
(``tests/test_torch_cuda.py``); on the CPU a device span is its host span.
"""

import contextlib
import itertools

import pytest
import torch

from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import synthetic_episodes
from controllable_agent_torch.envs import pointmass as tpm
from controllable_agent_torch.train.loops import (EpisodeCollector, OfflineTrainer,
                                                  OnlineTrainer, Rollout, init_meta_batched)
from controllable_agent_torch.utils import graphs, trace
from torch_threads import one_thread  # noqa: F401

FB_SMALL = dict(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8, batch_size=16)
PROGRAM_SPANS = {"sample", "update", "optimizer", "act", "env_step", "collect", "commit",
                 "updates", "graph_replay"}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no capture recorded."""
    trace.disable()
    trace.reset_captures()
    yield
    trace.disable()
    trace.reset_captures()


class _Graph:
    def register_generator_state(self, generator) -> None:
        pass

    def capture_begin(self, pool=None) -> None:
        pass

    def capture_end(self) -> None:
        pass

    def pool(self) -> int:
        return 0

    def replay(self) -> None:
        pass


class _Stream:
    def __init__(self, device=None) -> None:
        pass

    def wait_stream(self, other) -> None:
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    reserved = itertools.count(0, 2 ** 20)  # each reading 1 MiB above the last
    monkeypatch.setattr(graphs, "_side_streams", {})
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: next(reserved))


def _agent(obs: int = 5, action: int = 2) -> FBDDPGAgent:
    return FBDDPGAgent(FBDDPGConfig(**FB_SMALL), obs, action, device="cpu", seed=1)


def _offline():
    buf = ReplayBuffer(3, discount=0.98, future=0.99, device="cpu")
    buf.load_episodes(synthetic_episodes(3, 20, 5, 2, seed=2))
    agent = _agent()
    return OfflineTrainer(agent, buf.cfg, 16, steps_per_call=2), buf, agent


def _online(horizon: int = 10):
    env = tpm.PointMassMaze("reach_top_left", horizon)
    agent = _agent(4, 2)
    buf = ReplayBuffer(8, discount=0.98, future=0.99, max_episode_length=horizon, device="cpu")
    return OnlineTrainer(env, agent, buf, num_envs=2, updates_per_step=0.2,
                         max_steps_per_call=3)


def _profiled(fn):
    """The host events of ``fn()`` under a CPU ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _spans(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events if e.name == name]


def _inside(inner, outer) -> bool:
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner)


def test_off_adds_no_span_and_builds_nothing() -> None:
    trainer, buf, _ = _offline()
    online = _online()
    gen, collect_gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)
    events = _profiled(lambda: (trainer(buf.state, gen), online.run_cycle(gen, collect_gen)))
    assert not trace.enabled()
    assert {e.name for e in events} & PROGRAM_SPANS == set()
    assert trace.span("x") is trace.device_span("y", torch.device("cpu")) is trace.span("z")


def test_offline_spans_nest() -> None:
    """``sample`` and ``update`` once per update, apart; ``optimizer`` (FB's
    three Adam steps and two soft-updates) inside ``update``."""
    trainer, buf, _ = _offline()
    gen = torch.Generator().manual_seed(3)
    trace.enable()
    events = _profiled(lambda: trainer(buf.state, gen))
    sample, update = _spans(events, "sample"), _spans(events, "update")
    optimizer = _spans(events, "optimizer")
    assert len(sample) == len(update) == 2 and len(optimizer) == 2 * 5
    assert _inside(optimizer, update) and not _inside(optimizer, sample)
    assert all(s_end <= u_start for (_, s_end), (u_start, _) in zip(sample, update))


def test_online_spans_nest() -> None:
    """A cycle: ``collect`` holds each control step's ``act`` and
    ``env_step``, ``updates`` the updates' spans, ``commit`` between."""
    online = _online(horizon=10)
    gen, collect_gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)
    with trace.traced():
        events = _profiled(lambda: online.run_cycle(gen, collect_gen))
    assert not trace.enabled()  # as it was before the block
    collect, commit, updates = (_spans(events, n) for n in ("collect", "commit", "updates"))
    act, env_step = _spans(events, "act"), _spans(events, "env_step")
    assert len(collect) == len(commit) == len(updates) == 1
    assert len(act) == len(env_step) == 10
    assert _inside(act, collect) and _inside(env_step, collect)
    assert all(a_end <= e_start for (_, a_end), (e_start, _) in zip(act, env_step))
    assert collect[0][1] <= commit[0][0] and commit[0][1] <= updates[0][0]
    assert _inside(_spans(events, "update"), updates) and _spans(events, "optimizer")


def test_online_timings_split_the_commit() -> None:
    """``timings`` has the commit's seconds, and ``update`` is still commit
    plus updates: the host spans ``commit`` and ``updates`` to 1%."""
    online = _online()
    gen, collect_gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)
    online.run_cycle(gen, collect_gen)
    with trace.traced():
        events = _profiled(lambda: online.run_cycle(gen, collect_gen))
    t = online.timings
    assert set(t) == {"collect", "commit", "update", "updates"} and t["updates"] == 4
    assert 0 < t["commit"] < t["update"]
    (c0, c1), (u0, u1) = _spans(events, "commit")[0], _spans(events, "updates")[0]
    assert 1e-6 * ((c1 - c0) + (u1 - u0)) == pytest.approx(t["update"], rel=0.01)


def test_captures_one_record_per_build(fake_graphs) -> None:
    held = torch.zeros(3)

    def step() -> None:
        held.add_(1.0)

    first = graphs.CapturedProgram(step, torch.device("cpu"), [held], name="a")
    assert float(held[0]) == 1.0  # the warm-up runs put back; the stand-in capture ran once
    graphs.CapturedProgram(step, torch.device("cpu"), name="b")
    records = trace.captures()
    assert [r.name for r in records] == ["a", "b"]
    assert all(r.seconds > 0 and r.pool_bytes == 2 ** 20 and r.marks == 0 for r in records)
    assert first.record == records[0] and not first.traced
    trace.reset_captures()
    assert trace.captures() == []


def test_rollout_capture_seconds_is_its_record(fake_graphs) -> None:
    env = tpm.PointMassMaze("reach_top_left", 5)
    agent = _agent(4, 2)
    rollout = Rollout(env, agent, 2, capture=False)
    assert rollout.capture_seconds is None
    rollout.capture = True
    state, ts = env.reset(torch.Generator().manual_seed(0), 2)
    rollout(torch.zeros(8), state, ts)
    (record,) = trace.captures()
    assert record.name == "rollout" and rollout.capture_seconds == record.seconds > 0


def _trainer_call(_fake):
    trainer, buf, _ = _offline()
    trainer.capture = True
    gen = torch.Generator().manual_seed(3)
    return lambda: trainer(buf.state, gen), lambda: trainer.captures


def _collector_call(_fake):
    env = tpm.PointMassMaze("reach_top_left", 5)
    agent = _agent(4, 2)
    gen = torch.Generator().manual_seed(3)
    collector = EpisodeCollector(env, agent, 2, gen)
    collector.capture = True

    def call() -> None:
        state, ts = env.reset(gen, 2)
        collector(init_meta_batched(agent, gen, 2), state, ts, 0)

    return call, lambda: sum(r.name == "collector" for r in trace.captures())


def _rollout_call(_fake):
    env = tpm.PointMassMaze("reach_top_left", 5)
    rollout = Rollout(env, _agent(4, 2), 2, capture=False)
    rollout.capture = True
    gen = torch.Generator().manual_seed(3)

    def call() -> None:
        state, ts = env.reset(gen, 2)
        rollout(torch.zeros(8), state, ts)

    return call, lambda: sum(r.name == "rollout" for r in trace.captures())


@pytest.mark.parametrize("make", [_trainer_call, _collector_call, _rollout_call],
                         ids=["trainer", "collector", "rollout"])
def test_switch_flips_capture_anew(fake_graphs, make) -> None:
    """The trainer, the collector and the rollout each capture once, again
    when tracing goes on, and again when it goes off; not otherwise."""
    call, count = make(fake_graphs)
    call()
    call()
    assert count() == 1
    trace.enable()
    call()
    call()
    assert count() == 2
    trace.disable()
    call()
    assert count() == 3
    assert [r.marks for r in trace.captures()] == [0, 0, 0]  # no mark on the CPU
