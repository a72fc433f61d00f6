"""Online training as ``train_online`` runs a recipe: the port's
``OnlineTrainer.run_cycle`` on the environment that
``train/workspace.py:make_env`` makes for the recipe's task, at the
recipe's numbers (the workload's file).

A cycle collects one episode in each of ``num_envs`` environments (the
collector's one captured control step, replayed ``episode_length`` times),
commits them into the replay on the device, then runs ``episode_length *
num_envs / update_every_steps`` updates in calls of ``steps_per_call``.
Set-up loads the benchmark's weights, then fills the replay to
``fill_share`` of its episodes with synthetic ones (the environment's
layout, drawn on the device from the seed, committed through
``ReplayBuffer.add_trajectory``) less the seed cycles' episodes, runs the
seed cycles (collection only), takes the first three updates through the
cycle's own trainer (the capture), and one whole cycle to warm the rest.
The window runs whole cycles until ``--seconds`` have passed:
``frames_per_s`` is all their frames over all their time. The traced run
profiles one more whole cycle (``trace``; the collector's kernels per
replay, ``control_step_kernels``), then turns the program's tracing on,
captures anew and profiles a marked cycle of one update (``program_trace``).

``correct`` is as in ``online.py``, with two differences. An environment
whose state holds more than its physics columns names those columns of
the observation (``CARRIED``): the reference steps and observes the
physics with the written observation's carried columns appended. And the
program's count of the engine's substeps (``physics3d.substeps``, which a
capture holds back and each replay adds) must be the window's control
steps times the environment's substeps (``substep_miscount``, exact). The
updates are followed on the whole replay the program sampled from, the
fill with the collected episodes.
"""

from __future__ import annotations

import gc
import math
import time
import typing as tp

import torch

from .. import check, data, program, program_trace
from .. import trace as bench_trace
from ..reference import draws
from ..reference.nets import Products
from . import offline
from .online import Spanned, _rel, follow, quantiles, step_gaps, update_numbers

Tensor = torch.Tensor

FILL = 5  # the data's sub-seed stream of the fill's meta columns (``data.sub_seed``)
SUBSTEPS = "physics3d.substeps"  # the program's counter the window is held to


class Built(tp.NamedTuple):
    """What the check needs of set-up, none of the program's state."""

    first: program.FirstSteps
    collected: tp.Dict[str, Tensor]  # the replay's episodes after the seed cycles, on the host
    seed_cycle: int  # the first of the seed cycle's episodes among them


def counters() -> tp.Dict[str, int]:
    """The program's counters; a program without the substep counter cannot
    run this cell, and says so at once."""
    from controllable_agent_torch.utils import trace
    held = getattr(trace, "counters", None)
    if held is None or SUBSTEPS not in held:
        raise SystemExit(f"this cell holds the window to the program's counter {SUBSTEPS!r} "
                         "(controllable_agent_torch/utils/trace.py), which this program lacks")
    return held


def fill(ctx: tp.Any, buffer: tp.Any, agent: tp.Any) -> int:
    """Commit the synthetic episodes; returns how many."""
    wl, config = ctx.workload, ctx.config
    episodes = int(wl["replay_episodes"] * wl["fill_share"]) - wl["num_envs"] * wl["seed_cycles"]
    columns = data.replay(episodes, wl["episode_length"], config["env"], ctx.seed, ctx.device,
                          getattr(ctx.environment, "replay_physics", None))
    gen = torch.Generator(device=ctx.device).manual_seed(data.sub_seed(ctx.seed, FILL))
    for key, width in getattr(agent, "meta_dims", {}).items():
        normal = torch.randn(episodes, wl["episode_length"] + 1, width, generator=gen,
                             device=ctx.device)
        columns[key] = width ** 0.5 * normal / torch.linalg.vector_norm(normal, dim=-1,
                                                                         keepdim=True)
    buffer.add_trajectory({k: v.transpose(0, 1) for k, v in columns.items()},
                          wl["episode_length"])
    return episodes


def build(ctx: tp.Any, warm: bool = True
          ) -> tp.Tuple[tp.Any, torch.Generator, torch.Generator, Built]:
    """The online trainer with the benchmark's weights after the fill, the
    seed cycles, the three checked updates and (``warm``) one warm cycle;
    its two generators; what the check needs."""
    from controllable_agent_torch.data import ReplayBuffer
    from controllable_agent_torch.goals import spaces
    from controllable_agent_torch.train.loops import OnlineTrainer
    from controllable_agent_torch.train.workspace import make_env
    config, wl, device, ref = ctx.config, ctx.workload, ctx.device, ctx.reference
    shapes, replay = program.shapes(config), config["replay"]
    env = make_env(wl["task"], episode_length=wl["episode_length"])
    _, space = spaces.goal_spaces.lookup(config["agent_config"]["goal_space"])
    agent = program.agent(config, device)
    weights = data.weights(ref.leaves(shapes), ref.TARGETS, ctx.seed, device)
    program.load_weights(agent, weights)
    buffer = ReplayBuffer(wl["replay_episodes"], discount=replay["discount"],
                          future=replay["future"], max_episode_length=wl["episode_length"],
                          device=device)
    filled = fill(ctx, buffer, agent)
    online = OnlineTrainer(env, agent, buffer, num_envs=wl["num_envs"],
                           goal_fn=lambda phys: space(env.goal_features(phys)),
                           updates_per_step=0.0, max_steps_per_call=wl["steps_per_call"])
    gen = torch.Generator(device=device).manual_seed(data.sub_seed(ctx.seed, data.TRAINER))
    collect_gen = torch.Generator(device=device).manual_seed(
        data.sub_seed(ctx.seed, data.COLLECTOR))
    for i in range(wl["seed_cycles"]):
        online.run_cycle(gen, collect_gen)
        if i == 0:
            online.collector = Spanned(online.collector, "collect")
    state = buffer.state
    collected = {k: v[:state.n_episodes].to("cpu", copy=True) for k, v in state.storage.items()}
    trainer = online.trainer
    online.trainer = Spanned(trainer, "trainer_call")
    first = program.first_steps(lambda: online.trainer(buffer.state, gen, steps=1), trainer,
                                agent, config, ref, weights)
    buffer.add_trajectory = Spanned(buffer.add_trajectory, "commit")
    online._sync = Spanned(online._sync, "sync")
    online.updates_per_step = 1.0 / config["agent_config"]["update_every_steps"]
    if warm:
        online.run_cycle(gen, collect_gen)
    return online, gen, collect_gen, Built(first, collected, filled)


def control_step_kernels(events: tp.Sequence[tp.Any]) -> tp.Optional[float]:
    """Kernels per collector replay in a profiled cycle: the device
    operations from the benchmark's ``collect`` span to the end of the
    ``sync`` after it (which waits for the collection), grouped by the graph
    launch that issued them (a correlation id that more than one operation
    shares is a replay); the most common count over the replays."""
    spans, device = [], []
    for e in events:  # one pass: a cycle holds millions of operations
        kind = bench_trace._kind(e)
        if kind in bench_trace.DEVICE_ACTIVITIES:
            device.append((e.start_ns(), kind == "kernel", e))
        elif kind == "user_annotation" and e.name() in ("collect", "sync"):
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    spans.sort()
    start = next((s for s, _, name in spans if name == "collect"), None)
    end = next((t for s, t, name in spans if name == "sync" and start is not None
                and s >= start), None)
    if start is None or end is None:
        return None
    ops: tp.Dict[int, int] = {}
    kernels: tp.Dict[int, int] = {}
    for at, kernel, e in device:
        if start <= at < end and e.name() not in program_trace.HOST_SPANS:
            corr = program_trace._correlation(e)
            ops[corr] = ops.get(corr, 0) + 1
            kernels[corr] = kernels.get(corr, 0) + kernel
    counts = [kernels[c] for c, n in ops.items() if n > 1]
    if not counts:
        return None
    # the count of a whole replay, the most common: a replay some of whose records
    # the profiler dropped counts fewer
    return float(max(set(counts), key=lambda k: (counts.count(k), k)))


def _one_update(online: tp.Any, gen: torch.Generator, collect_gen: torch.Generator) -> None:
    """A whole collection and its commit, then one update: after the tracing
    switch flipped, the collector and the trainer capture anew in it."""
    rate = online.updates_per_step
    online.updates_per_step = 1.5 / (online.collector.horizon * online.num_envs)
    try:
        online.run_cycle(gen, collect_gen)
    finally:
        online.updates_per_step = rate


def replay_spans(events: tp.Sequence[tp.Any], names: tp.Mapping[int, str]
                 ) -> tp.Tuple[tp.Dict[str, float], tp.Dict[str, tp.Dict[str, float]], int]:
    """Each device span's busy time and each program's replays and busy
    time, as ``program_trace.reduce`` gives them, read one replay at a time:
    a replay's operations (those of one graph launch) in the order of their
    starts, its marks nested as a stack that must close within it. A replay
    whose marks do not is left out, and counted. ``reduce`` keeps one stack
    over the whole window, so there a mark the profiler drops, or two
    replays whose timestamps overlap, leave a span open into every replay
    after them; here they cost the one replay."""
    replays: tp.Dict[int, tp.List[tp.Tuple[int, int, str]]] = {}
    for e in events:
        if bench_trace._kind(e) in bench_trace.DEVICE_ACTIVITIES \
                and e.name() not in program_trace.HOST_SPANS:
            replays.setdefault(program_trace._correlation(e), []).append(
                (e.start_ns(), e.end_ns(), e.name()))
    busy: tp.Dict[str, float] = {}
    programs: tp.Dict[str, tp.Dict[str, float]] = {}
    broken = 0
    for ops in replays.values():
        if len(ops) < 2:
            continue
        ops.sort()
        stack: tp.List[str] = []
        outer: tp.List[str] = []
        spans: tp.Dict[str, program_trace._Union] = {}
        whole = program_trace._Union()
        for start, end, name in ops:
            mark = program_trace.MARK.match(name)
            if mark is None:
                whole.add(start, end)
                for span in set(stack):
                    spans.setdefault(span, program_trace._Union()).add(start, end)
                continue
            span = names.get(int(mark.group(2)), f"span_{mark.group(2)}")
            if mark.group(1) == "begin":
                outer += [] if stack else [span]
                stack.append(span)
            elif stack and stack[-1] == span:
                stack.pop()
            else:
                stack.append("")  # an end out of order: the replay does not close
                break
        if stack:
            broken += 1
            continue
        for span, union in spans.items():
            busy[span] = busy.get(span, 0.0) + union.total * 1e-9
        entry = programs.setdefault("+".join(dict.fromkeys(outer)) or "unmarked",
                                    {"replays": 0, "busy_s": 0.0})
        entry["replays"] += 1
        entry["busy_s"] += whole.total * 1e-9
    return busy, programs, broken


def marked_cycle(ctx: tp.Any, online: tp.Any, gen: torch.Generator,
                 collect_gen: torch.Generator) -> program_trace.ProgramReading:
    """A cycle of one update with the program's tracing on, captured anew,
    its device spans marked (``program_trace.reduce``, with the spans and
    programs read replay by replay, ``replay_spans``); tracing off after it.
    Its metrics read the collection, whole in it; the 5,000 updates of a
    whole cycle would add millions of operations to the trace and nothing to
    them."""
    from controllable_agent_torch.utils import trace
    events: tp.List[tp.Any] = []
    trace.enable()
    try:
        _one_update(online, gen, collect_gen)
        with program_trace.window(ctx.device, []):  # the profiler's own start-up, left out
            online.trainer(online.buffer.state, gen, steps=1)
        with program_trace.window(ctx.device, events):
            _one_update(online, gen, collect_gen)
        names = trace.device_span_names()
    finally:
        trace.disable()
    reading = program_trace.reduce(events, names)
    busy, programs, broken = replay_spans(events, names)
    print(f"marked cycle: {reading.unmatched} marks unmatched over the window, {broken} "
          f"replays left out, their marks not closing", file=ctx.log)
    return reading._replace(span_busy_s=busy, programs=programs,
                            replay_busy_s=sum(v["busy_s"] for v in programs.values()))


def run(ctx: tp.Any) -> tp.Dict[str, tp.Any]:
    wl, device = ctx.workload, ctx.device
    counts = counters()
    online, gen, collect_gen, built = build(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.started
    print(f"set-up {setup_s:.1f} s", file=ctx.log)
    ctx.launches_before()
    counted = counts[SUBSTEPS]

    cycles, failed, timings = 0, 0, []
    started = time.perf_counter()
    while True:
        metrics = online.run_cycle(gen, collect_gen)
        timings.append(dict(online.timings))
        cycles += 1
        failed += 0 if all(math.isfinite(v) for v in metrics.values()) else 1
        if time.perf_counter() - started >= ctx.seconds:
            break
    window_s = time.perf_counter() - started
    print(f"window {window_s:.1f} s, {cycles} cycles", file=ctx.log)
    steps = cycles * wl["episode_length"]
    counted, expected = counts[SUBSTEPS] - counted, steps * ctx.environment.SUBSTEPS
    substeps = {"substep_miscount": float(abs(counted - expected))}
    print(f"substeps {counted} counted, {expected} expected", file=ctx.log)
    frames = steps * wl["num_envs"]
    updates = sum(int(t["updates"]) for t in timings)
    record: tp.Dict[str, tp.Any] = {"cycles": timings, "frames": frames, "window_s": window_s,
                                    "updates": updates}
    extra = 0
    if ctx.trace:
        events: tp.List[tp.Any] = []
        with program_trace.window(device, []):  # the profiler's own start-up, left out
            online.trainer(online.buffer.state, gen, steps=1)
        with program_trace.window(device, events):
            online.run_cycle(gen, collect_gen)
        print(f"profiled cycle: {len(events)} events at {time.perf_counter() - ctx.started:.1f} s",
              file=ctx.log)
        record["trace"] = bench_trace.reduce(events)
        record["control_step_kernels"] = control_step_kernels(events)
        del events
        print(f"profiled cycle read at {time.perf_counter() - ctx.started:.1f} s", file=ctx.log)
        extra = 1 + int(online.timings["updates"])
    launches = ctx.launches_after(updates + extra)
    if ctx.trace:
        marked = record["program_trace"] = marked_cycle(ctx, online, gen, collect_gen)
        print(f"marked cycle read at {time.perf_counter() - ctx.started:.1f} s: "
              f"{marked.replays} replays {marked.programs}, {marked.marks} marks, "
              f"{marked.unmatched} unmatched, spans {marked.span_busy_s}", file=ctx.log)
    device_info = ctx.device_info()

    del online, metrics
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = collector_numbers(ctx, built, ctx.products)
    print(f"collector checked at {time.perf_counter() - ctx.started:.1f} s", file=ctx.log)
    numbers.update(update_numbers(ctx, built))
    print(f"updates checked at {time.perf_counter() - ctx.started:.1f} s", file=ctx.log)
    for k, v in numbers.items():
        print(f"{k} {v!r}", file=ctx.log)
    return {"attempted": cycles, "failed": failed, "device": device_info,
            "e2e": {"frames_per_s": frames / window_s, "setup_s": setup_s},
            "record": record, "numbers": {**numbers, **launches, **substeps}}


def _seed_cycle(ctx: tp.Any, collected: tp.Mapping[str, Tensor], first: int
                ) -> tp.Tuple[tp.Dict[str, Tensor], Tensor]:
    """The seed cycle's episodes on the device, and their states: the
    physics with the written observation's carried columns appended."""
    n = ctx.workload["num_envs"]
    cols = {k: v[first:first + n].to(ctx.device) for k, v in collected.items()}
    carried = list(getattr(ctx.environment, "CARRIED", ()))
    return cols, torch.cat([cols["physics"], cols["observation"][..., carried]], -1)


@torch.no_grad()
def collector_numbers(ctx: tp.Any, built: Built, prod: Products,
                      control: tp.Optional[Products] = None,
                      collected: tp.Optional[tp.Mapping[str, Tensor]] = None
                      ) -> tp.Dict[str, float]:
    """The seed cycle's transitions against the reference, with the
    collector's draws made again (``online.collector_numbers``' numbers, on
    the states with their carried columns; ``collected`` in place of the
    program's episodes for a fault)."""
    config, wl, device, ref = ctx.config, ctx.workload, ctx.device, ctx.reference
    env = ctx.environment
    shapes, cfg = program.shapes(config), ref.settings(config)
    weights = data.weights(ref.leaves(shapes), ref.TARGETS, ctx.seed, device)
    cols, state = _seed_cycle(ctx, built.collected if collected is None else collected,
                              built.seed_cycle)
    n, horizon = wl["num_envs"], wl["episode_length"]
    gen = torch.Generator(device=device).manual_seed(data.sub_seed(ctx.seed, data.COLLECTOR))
    normals, uniform = draws.collector_start(gen, n, shapes.z, env.RESET_DRAWS, device)
    start = env.start(uniform)
    z0 = shapes.z ** 0.5 * normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    write = max(_rel(state[:, 0], start), _rel(cols["z"][:, 0], z0),
                _rel(cols["observation"][:, 0], env.observation(start)))
    act = 0.0
    for t in range(horizon):
        step_draws = draws.collector_step(gen, n, shapes.z, shapes.action, device)
        z, action = ref.act(weights, shapes, cols["observation"][:, t], cols["z"][:, t], t,
                            step_draws, cfg, prod)
        if control is None:
            act = max(act, _rel(cols["action"][:, t + 1], action), _rel(cols["z"][:, t + 1], z))
        else:
            _, other = ref.act(weights, shapes, cols["observation"][:, t], cols["z"][:, t], t,
                               step_draws, cfg, control)
            act = max(act, _rel(other.clamp(-1.0, 1.0), action.clamp(-1.0, 1.0)))
    if control is not None:
        return {"act_gap": act}
    later = state[:, 1:].reshape(-1, state.shape[-1])
    physics = cols["physics"][:, 1:].reshape(later.shape[0], -1)
    goal = env.GOALS[config["agent_config"]["goal_space"]]
    write = max(write, _rel(cols["observation"][:, 1:].reshape(later.shape[0], -1),
                            env.observation(later)),
                _rel(cols["reward"][:, 1:].reshape(-1), env.REWARDS[wl["task"]](physics)),
                _rel(cols["goal"][:, 1:].reshape(later.shape[0], -1), goal(physics)),
                _rel(cols["discount"][:, 1:], torch.ones_like(cols["discount"][:, 1:])))
    return {"act_gap": act, **quantiles(step_gaps(env, state, cols["action"])),
            "write_gap": write}


def readings(ctx: tp.Any) -> tp.Dict[str, tp.Dict[str, float]]:
    """The numbers the limits are set from, for one seed (``control.py``):
    the program's; the environment's step in float32 at the batch of all
    transitions at once (a sound reordering of the step's arithmetic); the
    control's; and the faults': half of each batch left out, one collected
    transition altered where it is written, every step returning its state
    unchanged, one substep of each step left out, the update's noise drawn
    as zeros."""
    online, _, _, built = build(ctx, warm=False)
    del online
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    env, reference = ctx.environment, follow(ctx, built, ctx.products)
    program_numbers = offline.compare(ctx, built.first, reference)
    cols, state = _seed_cycle(ctx, built.collected, built.seed_cycle)
    width = state.shape[-1]
    before = state[:, :-1].reshape(-1, width)
    action = cols["action"][:, 1:].reshape(before.shape[0], -1)
    with torch.no_grad():
        reordered = env.step(before, action)
        missing = env.step(before.double(), action.double(), substeps=env.SUBSTEPS - 1)
    altered = dict(built.collected)
    altered["physics"] = altered["physics"].clone()
    altered["physics"][built.seed_cycle, len(altered["physics"][0]) // 2] += 0.01
    half = ctx.config["agent_config"]["batch_size"] // 2
    control = Products(**ctx.config["control"])
    zeroed = [{k: v if k == "perm" else torch.zeros_like(v) for k, v in n.items()}
              for n in built.first.noises]
    return {"program": {**collector_numbers(ctx, built, ctx.products),
                        **{k: v for k, (v, _) in program_numbers.items()}},
            "program_reordered_step": quantiles(step_gaps(env, state, cols["action"],
                                                          reordered)),
            "control": {**collector_numbers(ctx, built, ctx.products, control),
                        **offline.against(ctx, follow(ctx, built, control, None,
                                                      torch.float32).updates, reference)},
            "half_batch": offline.against(ctx, follow(ctx, built, ctx.products, half,
                                                      torch.float32).updates, reference),
            "altered_transition": collector_numbers(ctx, built, ctx.products,
                                                    collected=altered),
            "state_unchanged": quantiles(step_gaps(env, state, cols["action"],
                                                   state[:, :-1])),
            "substep_missing": quantiles(step_gaps(env, state, cols["action"], missing)),
            "noise_zeroed": {"noise_gap": check.noise(zeroed)}}
