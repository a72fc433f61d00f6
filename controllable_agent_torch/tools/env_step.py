"""One control step of an environment alone on the card: no policy, no
trajectory buffers.

    python -m controllable_agent_torch.tools.env_step

For cheetah and hopper at 16 environments it prints the time of a ``reset``
(the cheetah settles for 200 control steps first); for those two, the
quadruped (stand, escape, fetch) and jaco at 10, 1,024 and 16,384
environments, and the walker's rendered frames (``obs_type=pixels``) at 10,
1,024 and 4,096, the kernel launches and device time of one eager
``env.step`` under ``torch.profiler``, the wall time per replay of the step
as a ``CapturedProgram`` and the environment steps/s that makes, and whether
the captured step equals the eager one to the bit; and the time of one copy
of the escape terrain at the largest size (what a copy of the whole state
into held tensors would add to a step). ``chip_smoke.py`` phase 11 measures
the walker's whole evaluation step and phase 20 calls ``step_timing``.
Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import time
import typing as tp

import torch

from controllable_agent_torch.envs.pixels import make_pixel_env
from controllable_agent_torch.train.loops import _tensors_of
from controllable_agent_torch.train.workspace import make_env
from controllable_agent_torch.utils.device import card_name_and_power_limit
from controllable_agent_torch.utils.graphs import CapturedProgram

ENVS, REPLAYS = 16, 100
SIZES = (10, 1024, 16384)
TASKS_3D = ("quadruped_stand", "quadruped_escape", "quadruped_fetch", "jaco_reach_top_left")
# the walker's 84 x 84 frames, a stack of 3: 16,384 environments would hold
# 1 GB of stacked uint8 frames and some 30 GB of the render's intermediates
PIXEL_SIZES = (10, 1024, 4096)


@dataclasses.dataclass(frozen=True)
class StepTiming:
    launches: int  # kernel launches of one eager step
    device_ms: float  # their device time under the profiler
    replay_ms: float  # wall time per replay of the captured step
    steps_per_s: float  # environment steps per second of the replays
    bitwise: bool  # the captured step equals the eager one


def step_timing(env: tp.Any, envs: int, generator: torch.Generator,
                replays: int = REPLAYS) -> StepTiming:
    """``env.step`` of ``envs`` environments from a reset, with a random
    action, eager under the profiler and as replays of its graph."""
    state, _ = env.reset(generator, envs)
    action = torch.rand((envs, env.spec.action_dim), generator=generator,
                        device=generator.device) * 2 - 1
    eager = env.step(state, action)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        env.step(state, action)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in kernels)
    program = CapturedProgram(lambda: env.step(state, action), generator.device)
    program.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program.replay(replays)
    torch.cuda.synchronize()
    replay_ms = 1e3 * (time.perf_counter() - t0) / replays
    # the new state and timestep, every tensor of both
    same = all(torch.equal(a, b) for a, b in zip(
        _tensors_of(program.out[0]) + _tensors_of(program.out[1]),
        _tensors_of(eager[0]) + _tensors_of(eager[1])))
    return StepTiming(len(kernels), device_ms, replay_ms, 1e3 * envs / replay_ms, same)


def terrain_copy_ms(envs: int, generator: torch.Generator, copies: int = 20) -> float:
    """Device ms of one copy of ``envs`` escape terrains into held tensors."""
    env = make_env("quadruped_escape")
    state, _ = env.reset(generator, envs)
    held = torch.empty_like(state.terrain)
    held.copy_(state.terrain)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(copies):
        held.copy_(state.terrain)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / copies


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("env_step needs a CUDA device")
    print(f"card: {card_name_and_power_limit()}")
    failed = []
    for name in ("cheetah_run", "hopper_hop") + TASKS_3D:
        env = make_env(name)
        gen = torch.Generator(device="cuda").manual_seed(0)
        sizes = (ENVS,) if name in ("cheetah_run", "hopper_hop") else SIZES
        if name in ("cheetah_run", "hopper_hop"):
            env.reset(gen, ENVS)  # builds the model's constants on the card
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            env.reset(gen, ENVS)
            torch.cuda.synchronize()
            print(f"{name} E={ENVS}: reset {time.perf_counter() - t0:.3f} s")
        for envs in sizes:
            t = step_timing(env, envs, gen)
            print(f"{name} E={envs}: one control step ({env.n_substeps} substeps): "
                  f"{t.launches} launches, {t.device_ms:.4f} ms of device time eager under the "
                  f"profiler, {t.replay_ms:.4f} ms per replay of its graph ({t.steps_per_s:.0f} "
                  f"environment steps/s); captured equal to eager to the bit: {t.bitwise}")
            if not t.bitwise:
                failed.append(f"{name} E={envs}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    env = make_pixel_env("walker_walk")
    for envs in PIXEL_SIZES:
        t = step_timing(env, envs, gen)
        print(f"walker_walk pixels E={envs}: {t.launches} launches, {t.device_ms:.4f} ms of "
              f"device time eager, {t.replay_ms:.4f} ms per replay ({t.steps_per_s:.0f} "
              f"environment steps/s); captured equal to eager: {t.bitwise}")
        if not t.bitwise:
            failed.append(f"walker_walk pixels E={envs}")
    print(f"quadruped_escape E={SIZES[-1]}: one copy of the terrains "
          f"({SIZES[-1] * 101 * 101 * 4 / 1e6:.0f} MB) {terrain_copy_ms(SIZES[-1], gen):.4f} ms")
    if failed:
        raise SystemExit(f"the captured step differs from the eager one: {failed}")


if __name__ == "__main__":
    main()
