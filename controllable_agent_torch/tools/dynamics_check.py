"""The planar dynamics in float32 on a device held to float64 on the CPU.

    python -m controllable_agent_torch.tools.dynamics_check

``check_domain`` is the one comparison that the smoke run's dynamics phase,
the card test and the CPU test share: ``forward_dynamics`` and one control
step (``step``) of a domain's model on random states, a share of them
penetrating the ground, each output compared state by state.

``forward_dynamics`` is smooth: every state is held to ``DYNAMICS_TOL`` of
the output's largest entry. A control step is 4 to 10 substeps through
contact gates (penetration > 0, normal force > 0) that are discontinuous in
the damping term: a state that crosses a gate in another substep in float32
than in float64 lands a force jump times a substep away. So ``step`` holds
every state to ``STEP_TOL`` of the largest entry except a share
``STEP_OUTLIERS`` of them, and those to ``OUTLIER_FACTOR`` times that
limit. Over seeds 0-3 x 4,096 states, on an NVIDIA H100 at most 0.10% of
the walker's states were beyond the limit, the worst by 6.3 times it, and
0.02% of the hopper's in one seed; the same call with ``device="cpu"``
(float32 there) has the walker's worst at 31 times the limit in seed 2 (the
velocities, clipped to +-100, off by 3.1). The cheetah had none.

Run as a script it prints that table for the CUDA device: every domain,
SEEDS seeds of STATES states each, and fails if any is not held.
"""

from __future__ import annotations

import dataclasses
import sys
import typing as tp

import numpy as np
import torch

from controllable_agent_torch.envs import locomotion
from controllable_agent_torch.envs import physics2d as p2d
from controllable_agent_torch.utils.device import (DeviceLike, card_name_and_power_limit,
                                                   resolve_device)

DOMAINS = ("walker", "cheetah", "hopper")
DYNAMICS_TOL, STEP_TOL = 1e-4, 1e-3  # of each output's largest entry
STEP_OUTLIERS = 0.003  # share of the states that may miss STEP_TOL after a control step
OUTLIER_FACTOR = 100.0  # and by how many times the limit at most
STATES, SEEDS = 4096, 4  # of the script's table


@dataclasses.dataclass(frozen=True)
class Held:
    """One output's comparison: errors are the largest entry's of each state."""
    what: str
    max_err: float
    limit: float
    beyond: float  # share of the states over the limit
    allowed: float
    ok: bool

    def __str__(self) -> str:
        return (f"{self.what} max abs err {self.max_err:.3e} ({self.max_err / self.limit:.2f}x "
                f"the limit {self.limit:.3e}), {self.beyond:.4f} of the states beyond it "
                f"(allowed {self.allowed})")


def hold(what: str, got: torch.Tensor, want: torch.Tensor, tol: float,
         allowed: float = 0.0) -> Held:
    """``got`` [S, n] against ``want`` in float64: each state's largest error
    within ``tol`` x max|want|, except a share ``allowed`` of the states,
    which stay within ``OUTLIER_FACTOR`` times that."""
    errs = (got.double().cpu() - want).abs().amax(-1)
    limit = tol * float(want.abs().max())
    beyond = float((errs > limit).double().mean())
    worst = float(errs.max())
    ok = (bool(torch.isfinite(got).all()) and beyond <= allowed
          and worst <= (OUTLIER_FACTOR if allowed else 1.0) * limit)
    return Held(what, worst, limit, beyond, allowed, ok)


def random_states(ndof: int, count: int, seed: int) -> tp.List[torch.Tensor]:
    """(q, qd, action) in float64: joints and pitch within a radian, the root
    between the ground and standing height, velocities of a few units."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-1, 1, (count, ndof))
    q[:, 1] = rng.uniform(0.0, 1.5, count)
    qd = rng.randn(count, ndof) * 3
    action = rng.uniform(-1, 1, (count, ndof - 3))
    return [torch.from_numpy(x) for x in (q, qd, action)]


def check_domain(domain: str, count: int, device: DeviceLike = None,
                 seed: int = 0) -> tp.Tuple[float, tp.List[Held]]:
    """The share of the states with a contact pressed, and the comparison of
    every output of ``forward_dynamics`` and ``step`` in float32 on
    ``device`` against float64 on the CPU."""
    dev = resolve_device(device)
    env = locomotion.make(f"{domain}_{locomotion.TASKS[domain][0]}")
    exact = random_states(env.model.ndof, count, seed)
    single = [x.float().to(dev) for x in exact]
    fd_got = p2d.forward_dynamics(env.model, *single)
    fd_want = p2d.forward_dynamics(env.model, *exact)
    step_got = p2d.step(env.model, *single, env.control_dt, env.n_substeps)
    step_want = p2d.step(env.model, *exact, env.control_dt, env.n_substeps)
    pressed = float((fd_want[1] > 0).any(-1).double().mean())
    held = [hold(f"forward_dynamics {name}", got, want, DYNAMICS_TOL)
            for name, got, want in zip(("qdd", "fn"), fd_got, fd_want)]
    held += [hold(f"step {name}", got, want, STEP_TOL, STEP_OUTLIERS)
             for name, got, want in zip(("q", "qd", "touch"), step_got, step_want)]
    return pressed, held


def main() -> int:
    resolve_device()
    print(f"card: {card_name_and_power_limit()}")
    failed = False
    for domain in DOMAINS:
        for seed in range(SEEDS):
            pressed, held = check_domain(domain, STATES, seed=seed)
            ok = all(h.ok for h in held)
            failed = failed or not ok
            print(f"{domain} seed {seed}: {STATES} states, {pressed:.2f} with a contact pressed: "
                  + "; ".join(str(h) for h in held) + (" ok" if ok else " FAIL"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
