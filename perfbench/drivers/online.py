"""Online training: the port's ``OnlineTrainer.run_cycle``, episode-granular
cycles of collection and updates in one of the port's locomotion tasks, at
a recipe's numbers (the workload's file).

A cycle collects one episode in each of ``num_envs`` environments (one
captured control step, replayed ``episode_length`` times), commits them
into the replay on the device, then runs ``episode_length * num_envs /
update_every_steps`` updates in calls of ``steps_per_call``. Set-up loads
the benchmark's weights, runs the seed cycles (collection only), takes the
first three updates through the cycle's own trainer (the capture), and one
whole cycle to warm the rest. The window then runs whole cycles until
``--seconds`` have passed (each ends with a device synchronisation):
``frames_per_s`` is all the frames of those cycles over all their time.
Evaluation is left out of the window. The traced run profiles one more
whole cycle.

``correct`` covers the collector and the update. The seed cycle's
transitions are checked from the program's own written state: the z and
the action that the reference agent's ``act`` takes with the same draws,
one step at a time; the environment's next physics under the written
action (the configuration's ``environment`` module, in float64); and the
observation, reward (the workload's ``task``) and goal written for it. The
three updates are followed by the reference on the episodes the program
collected, on the rows and with the noise the program drew.
"""

from __future__ import annotations

import gc
import math
import time
import typing as tp

import torch

from .. import check, data, program
from ..harness import span
from ..reference import draws
from ..reference.nets import Products
from ..trace import Profiler
from . import offline

Tensor = torch.Tensor


class Spanned:
    """``obj``, whose calls run inside the benchmark's span ``name``; every
    other attribute is ``obj``'s."""

    def __init__(self, obj: tp.Any, name: str) -> None:
        self._obj, self._name = obj, name

    def __call__(self, *args: tp.Any, **kwargs: tp.Any) -> tp.Any:
        with span(self._name):
            return self._obj(*args, **kwargs)

    def __getattr__(self, attr: str) -> tp.Any:
        return getattr(self._obj, attr)


class Built(tp.NamedTuple):
    """What the check needs of set-up, none of the program's state."""

    first: program.FirstSteps
    collected: tp.Dict[str, Tensor]  # the seed cycle's episodes, [E, T+1, ...], on the host


def build(ctx: tp.Any) -> tp.Tuple[tp.Any, torch.Generator, torch.Generator, Built]:
    """The online trainer with the benchmark's weights after the seed
    cycles, the three checked updates and one warm cycle; its two
    generators; what the check needs."""
    from controllable_agent_torch.data import ReplayBuffer
    from controllable_agent_torch.envs import locomotion
    from controllable_agent_torch.goals import spaces
    from controllable_agent_torch.train.loops import OnlineTrainer
    config, wl, device, ref = ctx.config, ctx.workload, ctx.device, ctx.reference
    shapes, replay = program.shapes(config), config["replay"]
    env = locomotion.make(wl["task"], episode_length=wl["episode_length"])
    _, space = spaces.goal_spaces.lookup(config["agent_config"]["goal_space"])
    agent = program.agent(config, device)
    weights = data.weights(ref.leaves(shapes), ref.TARGETS, ctx.seed, device)
    program.load_weights(agent, weights)
    buffer = ReplayBuffer(wl["replay_episodes"], discount=replay["discount"],
                          future=replay["future"], max_episode_length=wl["episode_length"],
                          device=device)
    online = OnlineTrainer(env, agent, buffer, num_envs=wl["num_envs"],
                           goal_fn=lambda phys: space(env.goal_features(phys)),
                           updates_per_step=0.0, max_steps_per_call=wl["steps_per_call"])
    gen = torch.Generator(device=device).manual_seed(data.sub_seed(ctx.seed, data.TRAINER))
    collect_gen = torch.Generator(device=device).manual_seed(
        data.sub_seed(ctx.seed, data.COLLECTOR))
    run_cycle = online.run_cycle
    for i in range(wl["seed_cycles"]):
        run_cycle(gen, collect_gen)
        if i == 0:
            online.collector = Spanned(online.collector, "collect")
    state = buffer.state
    collected = {k: v[:wl["num_envs"]].to("cpu", copy=True) for k, v in state.storage.items()}
    trainer = online.trainer
    online.trainer = Spanned(trainer, "trainer_call")
    first = program.first_steps(lambda: online.trainer(buffer.state, gen, steps=1), trainer,
                                agent, config, ref, weights)
    buffer.add_trajectory = Spanned(buffer.add_trajectory, "commit")
    online._sync = Spanned(online._sync, "sync")
    online.updates_per_step = 1.0 / config["agent_config"]["update_every_steps"]
    run_cycle(gen, collect_gen)
    return online, gen, collect_gen, Built(first, collected)


def run(ctx: tp.Any) -> tp.Dict[str, tp.Any]:
    wl, device = ctx.workload, ctx.device
    online, gen, collect_gen, built = build(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.started
    ctx.launches_before()

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
    frames = cycles * wl["num_envs"] * wl["episode_length"]
    updates = sum(int(t["updates"]) for t in timings)
    record: tp.Dict[str, tp.Any] = {"cycles": timings, "frames": frames, "window_s": window_s,
                                    "updates": updates}
    extra = 0
    if ctx.trace:
        prof = Profiler(device)
        with prof.window():  # the profiler's own start-up, left out
            online.trainer(online.buffer.state, gen, steps=1)
        with prof.window():
            online.run_cycle(gen, collect_gen)
        record["trace"] = prof.reading
        extra = 1 + int(online.timings["updates"])
    launches = ctx.launches_after(updates + extra)
    device_info = ctx.device_info()

    del online, metrics
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = {**collector_numbers(ctx, built.collected, ctx.products),
               **update_numbers(ctx, built)}
    for k, v in numbers.items():
        print(f"{k} {v!r}", file=ctx.log)
    return {"attempted": cycles, "failed": failed, "device": device_info,
            "e2e": {"frames_per_s": frames / window_s, "setup_s": setup_s},
            "record": record, "numbers": {**numbers, **launches}}


def _rel(a: Tensor, b: Tensor) -> float:
    """The largest |a - b| / (1 + |b|)."""
    return float(((a - b).abs() / (1.0 + b.abs())).max())


# the share of transitions whose step gap ``step_gap`` reads: a step through
# a contact's threshold can land on either side of it in another order of
# the same arithmetic, and such steps are a few of the thousands
STEP_QUANTILE = 0.9


def step_gaps(env: tp.Any, physics: Tensor, actions: Tensor,
              nxt: tp.Optional[Tensor] = None) -> Tensor:
    """Each transition's largest |next - next_ref| / (1 + |next_ref|): the
    written next physics (or ``nxt``) against the environment's step in
    float64 from the written physics under the written action, all the
    transitions of ``physics`` ([E, T+1, ·]) and ``actions`` at once."""
    width = physics.shape[-1]
    before = physics[:, :-1].reshape(-1, width).double()
    after = (physics[:, 1:] if nxt is None else nxt).reshape(-1, width).double()
    ref = env.step(before, actions[:, 1:].reshape(before.shape[0], -1).double())
    return ((after - ref).abs() / (1.0 + ref.abs())).amax(-1)


def quantiles(gaps: Tensor) -> tp.Dict[str, float]:
    qs = torch.quantile(gaps.float().cpu(), torch.tensor([0.5, STEP_QUANTILE, 0.99]))
    return {"step_gap": float(qs[1]), "step_gap_q50": float(qs[0]),
            "step_gap_q99": float(qs[2]), "step_gap_max": float(gaps.max())}


@torch.no_grad()
def collector_numbers(ctx: tp.Any, collected: tp.Mapping[str, Tensor], prod: Products,
                      control: tp.Optional[Products] = None) -> tp.Dict[str, float]:
    """The seed cycle's transitions against the reference, with the
    collector's draws made again (with ``control``, the control's actions
    against the reference's, and only ``act_gap``):

    - ``act_gap``: the largest gap of an action (and of a resampled z, as
      large as the gap of its unit vector), one step at a time from the
      written observation and z: the policy's precision;
    - ``step_gap``: the ``STEP_QUANTILE`` quantile over the transitions of
      ``step_gaps`` (beside it, not compared: its median, its 0.99 quantile
      and its largest);
    - ``write_gap``: the written observation, reward, goal and discount
      against those of the written physics, and the reset's first state.
    """
    config, wl, device, ref = ctx.config, ctx.workload, ctx.device, ctx.reference
    env = ctx.environment
    shapes, cfg = program.shapes(config), ref.settings(config)
    weights = data.weights(ref.leaves(shapes), ref.TARGETS, ctx.seed, device)
    cols = {k: v.to(device) for k, v in collected.items()}
    n, horizon = wl["num_envs"], wl["episode_length"]
    gen = torch.Generator(device=device).manual_seed(data.sub_seed(ctx.seed, data.COLLECTOR))
    normals, uniform = draws.collector_start(gen, n, shapes.z, env.RESET_DRAWS, device)
    start = env.start(uniform)
    z0 = shapes.z ** 0.5 * normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    write = max(_rel(cols["physics"][:, 0], start), _rel(cols["z"][:, 0], z0),
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
    physics = cols["physics"]
    later = physics[:, 1:].reshape(-1, physics.shape[-1])
    goal = env.GOALS[config["agent_config"]["goal_space"]]
    write = max(write, _rel(cols["observation"][:, 1:].reshape(later.shape[0], -1),
                            env.observation(later)),
                _rel(cols["reward"][:, 1:].reshape(-1), env.REWARDS[wl["task"]](later)),
                _rel(cols["goal"][:, 1:].reshape(later.shape[0], -1), goal(later)),
                _rel(cols["discount"][:, 1:], torch.ones_like(cols["discount"][:, 1:])))
    return {"act_gap": act, **quantiles(step_gaps(env, physics, cols["action"])),
            "write_gap": write}


def follow(ctx: tp.Any, built: Built, prod: Products, rows: tp.Optional[int] = None,
           dtype: tp.Optional[torch.dtype] = None) -> offline.Followed:
    """The reference's three updates on the collected episodes, on the rows
    and with the noise the program drew."""
    ref, device = ctx.reference, ctx.device
    weights = data.weights(ref.leaves(program.shapes(ctx.config)), ref.TARGETS, ctx.seed,
                           device)
    cols = {k: v.to(device) for k, v in built.collected.items()}
    return offline.follow_on(ctx, built.first, cols, weights, prod, rows, dtype)


def update_numbers(ctx: tp.Any, built: Built) -> tp.Dict[str, float]:
    """The three updates against the reference's on the collected episodes."""
    out = offline.compare(ctx, built.first, follow(ctx, built, ctx.products))
    return {k: v for k, (v, _) in out.items()}


def readings(ctx: tp.Any) -> tp.Dict[str, tp.Dict[str, float]]:
    """The numbers the limits are set from, for one seed (``control.py``):
    the program's; the environment's step in float32 at the batch of all
    transitions at once (a sound reordering of the step's arithmetic); the
    control's (the reference in the program's place at the precision below
    the configuration's); and the faults': half of each batch left out,
    one collected transition altered where it is written, every step
    returning its state unchanged, the update's noise drawn as zeros."""
    online, _, _, built = build(ctx)
    del online
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    env, reference = ctx.environment, follow(ctx, built, ctx.products)
    program_numbers = offline.compare(ctx, built.first, reference)
    cols = {k: v.to(ctx.device) for k, v in built.collected.items()}
    width = cols["physics"].shape[-1]
    before = cols["physics"][:, :-1].reshape(-1, width)
    reordered = env.step(before, cols["action"][:, 1:].reshape(before.shape[0], -1))
    altered = {k: v.clone() for k, v in built.collected.items()}
    altered["physics"][0, len(altered["physics"][0]) // 2] += 0.01
    half = ctx.config["agent_config"]["batch_size"] // 2
    control = Products(**ctx.config["control"])
    zeroed = [{k: v if k == "perm" else torch.zeros_like(v) for k, v in n.items()}
              for n in built.first.noises]
    return {"program": {**collector_numbers(ctx, built.collected, ctx.products),
                        **{k: v for k, (v, _) in program_numbers.items()}},
            "program_reordered_step": quantiles(step_gaps(env, cols["physics"], cols["action"],
                                                  reordered)),
            "control": {**collector_numbers(ctx, built.collected, ctx.products, control),
                        **offline.against(ctx, follow(ctx, built, control, None,
                                                      torch.float32).updates, reference)},
            "half_batch": offline.against(ctx, follow(ctx, built, ctx.products, half,
                                                      torch.float32).updates, reference),
            "altered_transition": collector_numbers(ctx, altered, ctx.products),
            "state_unchanged": quantiles(step_gaps(env, cols["physics"], cols["action"],
                                                   cols["physics"][:, :-1])),
            "noise_zeroed": {"noise_gap": check.noise(zeroed)}}
