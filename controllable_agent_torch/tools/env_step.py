"""One control step of each planar environment alone on the card: no policy,
no trajectory buffers.

    python -m controllable_agent_torch.tools.env_step

For cheetah and hopper at 16 environments it prints the time of a ``reset``
(the cheetah settles for 200 control steps first), the kernel launches and
device time of one eager ``env.step`` under ``torch.profiler``, the wall time
per replay of the step as a ``CapturedProgram``, and whether the captured
step equals the eager one to the bit. ``chip_smoke.py`` phase 11 measures
the whole evaluation step of the walker; these are the two domains it does
not reach. Needs a CUDA device.
"""

from __future__ import annotations

import time

import torch

from controllable_agent_torch.envs import locomotion
from controllable_agent_torch.utils.graphs import CapturedProgram
from controllable_agent_torch.utils.device import card_name_and_power_limit

ENVS, REPLAYS = 16, 100


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("env_step needs a CUDA device")
    print(f"card: {card_name_and_power_limit()}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name in ("cheetah_run", "hopper_hop"):
        env = locomotion.make(name)
        gen = torch.Generator(device="cuda").manual_seed(0)
        env.reset(gen, ENVS)  # builds the model's constants on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = env.reset(gen, ENVS)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t0
        action = torch.rand((ENVS, env.spec.action_dim), generator=gen, device="cuda") * 2 - 1
        eager, _ = env.step(state, action)
        with torch.profiler.profile(activities=acts) as prof:
            env.step(state, action)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in kernels)
        program = CapturedProgram(lambda: env.step(state, action), torch.device("cuda"))
        program.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.replay(REPLAYS)
        torch.cuda.synchronize()
        replay_ms = 1e3 * (time.perf_counter() - t0) / REPLAYS
        captured = program.out[0]
        same = torch.equal(captured.q, eager.q) and torch.equal(captured.qd, eager.qd)
        print(f"{name} E={ENVS}: reset {reset_s:.3f} s; one control step ({env.n_substeps} "
              f"substeps): {len(kernels)} launches, {device_ms:.4f} ms of device time eager "
              f"under the profiler, {replay_ms:.4f} ms per replay of its graph; captured equal "
              f"to eager to the bit: {same}")
        if not same:
            raise SystemExit(f"{name}: the captured step differs from the eager one")


if __name__ == "__main__":
    main()
