"""Offline training: the port's captured ``OfflineTrainer`` (sample ->
update -> metric sums, one CUDA graph per update) over a replay of
synthetic walker episodes made on the device from the seed.

Set-up builds the agent and the replay, loads the benchmark's weights,
and takes the first three updates through the window's own call (the
first one captures); those, with the rows and the noise they drew, are
what the reference checks. The window then
runs calls of ``steps_per_call`` updates, each closed by reading one loss
(a device synchronisation), until ``--seconds`` have passed:
``updates_per_s`` is all the updates over all the window's time. The
traced run adds a profiled sub-window of ``profile_steps`` updates.
"""

from __future__ import annotations

import gc
import math
import time
import typing as tp

import torch

from .. import check, data, program
from ..harness import span
from ..reference import train as ref_train
from ..trace import Profiler


def build(ctx: tp.Any) -> tp.Tuple[tp.Any, tp.Any, tp.Any, torch.Generator,
                                   program.FirstSteps]:
    """The agent with the benchmark's weights, the replay, the trainer and
    its generator, after the first three updates (the capture among them)."""
    config, device, ref = ctx.config, ctx.device, ctx.reference
    shapes = program.shapes(config)
    agent = program.agent(config, device)
    weights = data.weights(ref.leaves(shapes), ref.TARGETS, ctx.seed, device)
    program.load_weights(agent, weights)
    storage = replay_data(ctx)
    state = program.replay_state(storage, config["replay"]["episode_length"])
    trainer = program.trainer(agent, config["replay"], ctx.workload["steps_per_call"])
    gen = torch.Generator(device=device).manual_seed(data.sub_seed(ctx.seed, data.TRAINER))
    first = program.first_steps(lambda: trainer(state, gen, steps=1), trainer, agent, config,
                                ref, weights)
    return agent, trainer, state, gen, first


def replay_data(ctx: tp.Any) -> tp.Dict[str, torch.Tensor]:
    replay = ctx.config["replay"]
    return data.replay(replay["episodes"], replay["episode_length"], ctx.config["env"],
                       ctx.seed, ctx.device, getattr(ctx.environment, "replay_physics", None))


def run(ctx: tp.Any) -> tp.Dict[str, tp.Any]:
    config, workload, device = ctx.config, ctx.workload, ctx.device
    ref = ctx.reference
    shapes = program.shapes(config)
    agent, trainer, state, gen, first = build(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.started
    ctx.launches_before()

    loss = ref.LOSSES[0]
    calls = failed = 0
    started = time.perf_counter()
    while True:
        with span("trainer_call"):
            metrics = trainer(state, gen)
        with span("sync"):
            value = float(metrics[loss])
        calls += 1
        failed += 0 if math.isfinite(value) else 1
        if time.perf_counter() - started >= ctx.seconds:
            break
    window_s = time.perf_counter() - started
    updates = calls * workload["steps_per_call"]
    record: tp.Dict[str, tp.Any] = {
        "updates": updates, "window_s": window_s, "calls": calls,
        "flops_per_update": ref.update_flops(shapes, agent.cfg.batch_size),
        "fused_loss": (agent.cfg.batch_size, shapes.z) if config.get("fused_loss") else None}
    if ctx.trace:
        prof = Profiler(device)
        with prof.window():  # the profiler's own start-up, left out
            trainer(state, gen, steps=1)
        with prof.window():
            with span("trainer_call"):
                metrics = trainer(state, gen, steps=workload["profile_steps"])
            with span("sync"):
                float(metrics[loss])
        record["trace"] = prof.reading
        record["profile_steps"] = workload["profile_steps"]
    launches = ctx.launches_after(updates + (1 + workload["profile_steps"] if ctx.trace else 0))
    device_info = ctx.device_info()

    del trainer, agent, state, metrics
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = reference_numbers(ctx, first)
    return {"attempted": calls, "failed": failed, "device": device_info,
            "e2e": {"updates_per_s": updates / window_s, "setup_s": setup_s},
            "record": record, "numbers": {**numbers, **launches}}


class Followed(tp.NamedTuple):
    """The reference's three updates, and what the program's draws read."""

    updates: ref_train.Followed
    draws: tp.Dict[str, float]


def follow(ctx: tp.Any, first: program.FirstSteps, prod: tp.Any,
           rows: tp.Optional[int] = None, dtype: tp.Optional[torch.dtype] = None) -> Followed:
    """The reference's three updates from the benchmark's weights on its
    replay, on the rows and with the noise the program drew."""
    config, device, ref = ctx.config, ctx.device, ctx.reference
    shapes = program.shapes(config)
    storage = replay_data(ctx)
    weights = data.weights(ref.leaves(shapes), ref.TARGETS, ctx.seed, device)
    return follow_on(ctx, first, storage, weights, prod, rows, dtype)


def follow_on(ctx: tp.Any, first: program.FirstSteps, storage: tp.Mapping[str, torch.Tensor],
              weights: tp.Mapping[str, torch.Tensor], prod: tp.Any,
              rows: tp.Optional[int] = None, dtype: tp.Optional[torch.dtype] = None
              ) -> Followed:
    """``follow`` on given data and weights (the online cell's are the
    episodes it collected), in ``dtype``: by default the configuration's
    ``reference_dtype`` (float32 where it names none)."""
    if dtype is None:
        dtype = getattr(torch, ctx.config.get("reference_dtype", "float32"))
    cfg = ctx.reference.settings(ctx.config)
    drawn, miss = [], 0.0
    for batch, noise in zip(first.batches, first.noises):
        ep, step, missed = check.rows(batch, storage, cfg["discount"], cfg["batch_size"])
        miss = max(miss, missed)
        drawn.append(ref_train.Drawn(ep, step, noise))
    followed = ref_train.follow(ctx.reference, cfg, program.shapes(ctx.config), weights,
                                storage, drawn, prod, rows, dtype)
    return Followed(followed, {"row_miss": miss, "noise_gap": check.noise(first.noises)})


def compare(ctx: tp.Any, first: program.FirstSteps, followed: Followed
            ) -> tp.Dict[str, tp.Tuple[float, str]]:
    """The program's first three updates held against the reference's."""
    grads = check.grad_norms_from_adam(first.grad_nu_sums)
    out = check.training(first.losses, grads, first.change_norms, followed.updates,
                         ctx.reference.LOSSES, ctx.reference.TARGETS, first.grad_abs,
                         ctx.reference.OPTIMIZERS.values())
    return {**{k: (v, "the program's draws") for k, v in followed.draws.items()}, **out}


def against(ctx: tp.Any, other: ref_train.Followed, reference: Followed) -> tp.Dict[str, float]:
    """The reference's updates in the program's place (a control, a fault)."""
    out = check.training(other.losses, other.grad_norms, other.change_norms, reference.updates,
                         ctx.reference.LOSSES, ctx.reference.TARGETS, other.grad_abs,
                         ctx.reference.OPTIMIZERS.values())
    return {k: v for k, (v, _) in out.items()}


def reference_numbers(ctx: tp.Any, first: program.FirstSteps) -> tp.Dict[str, float]:
    out = compare(ctx, first, follow(ctx, first, ctx.products))
    for k, (v, at) in out.items():
        print(f"{k} {v!r} at {at}", file=ctx.log)
    return {k: v for k, (v, _) in out.items()}


def readings(ctx: tp.Any) -> tp.Dict[str, tp.Dict[str, float]]:
    """The numbers the limits are set from, for one seed: the program's
    (a sound run), the control's (the reference in the program's place at
    the precision below the configuration's) and the faults': half of each
    batch left out, the mean over the rest; the update's noise drawn as
    zeros."""
    from ..reference.nets import Products
    agent, trainer, state, gen, first = build(ctx)
    del agent, trainer, state, gen
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    reference = follow(ctx, first, ctx.products)
    program_numbers = compare(ctx, first, reference)
    print("program read at", {k: at for k, (_, at) in program_numbers.items()}, file=ctx.log)
    half = ctx.config["agent_config"]["batch_size"] // 2
    zeroed = [{k: v if k == "perm" else torch.zeros_like(v) for k, v in n.items()}
              for n in first.noises]
    return {"program": {k: v for k, (v, _) in program_numbers.items()},
            "control": against(ctx, follow(ctx, first, Products(**ctx.config["control"]),
                                           dtype=torch.float32).updates, reference),
            "half_batch": against(ctx, follow(ctx, first, ctx.products, half,
                                              torch.float32).updates, reference),
            "noise_zeroed": {"noise_gap": check.noise(zeroed)}}
