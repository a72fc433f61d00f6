"""The planar and 3-D dynamics in float32 on a device held to float64 on the CPU.

    python -m controllable_agent_torch.tools.dynamics_check

``check_domain`` is the one comparison that the smoke run's dynamics phases,
the card tests and the CPU tests share: ``forward_dynamics`` and one control
step (``step``) of a domain's model on random states, a share of them
penetrating the ground, each output compared state by state. The planar
domains are walker, cheetah and hopper (``DOMAINS``); the 3-D ones
(``DOMAINS_3D``) are the quadruped on flat ground, the quadruped on an
escape terrain drawn from the seed (the states placed over it, its heights
in float64 for the reference), and jaco with its root pinned.

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

Jaco is held to the same constants. The quadruped is not, on flat ground
or on the escape terrain: a random state of it can press its feet and torso
deep (normal forces of 5e3-2e4 N on a 15 kg robot, velocities of tens of
units within one control step), and a state that crosses a gate in another
substep in float32 than in float64 is then pushed another way by up to the
velocity clip. On the escape terrain the normal also jumps at every cell
edge of the bilinear patches (0.6 m apart). With ``device="cpu"``: the
quadruped on flat ground, seeds 0-5 x 1,024 and x 4,096 states, at most 0.20%
of the states beyond the limit, the worst by 190 times it (seed 1 of 1,024,
velocities off by 17.6); the escape terrain, seeds 0-3 x 4,096, 0.61-0.81%,
the worst by 945 times (94.5 of the clip's span of 200). So each has its own
allowance (``ALLOWANCES``): the planar share for the quadruped, 1.5% for
escape, both bounded by the clip (``CLIP_FACTOR`` times the limit).

Run as a script it prints that table for the CUDA device: every domain,
SEEDS seeds of STATES states each, and fails if any is not held.
"""

from __future__ import annotations

import dataclasses
import sys
import typing as tp

import numpy as np
import torch

from controllable_agent_torch.envs import jaco, locomotion, quadruped
from controllable_agent_torch.envs import physics2d as p2d
from controllable_agent_torch.envs import physics3d as p3d
from controllable_agent_torch.utils.device import (DeviceLike, card_name_and_power_limit,
                                                   resolve_device)

DOMAINS = ("walker", "cheetah", "hopper")
DOMAINS_3D = ("quadruped", "quadruped_escape", "jaco")
DYNAMICS_TOL, STEP_TOL = 1e-4, 1e-3  # of each output's largest entry
STEP_OUTLIERS = 0.003  # share of the states that may miss STEP_TOL after a control step
OUTLIER_FACTOR = 100.0  # and by how many times the limit at most
# the quadruped's own allowances (above): a share of the states, bounded by
# the velocity clip's span (200 over a limit of 1e-3 x 100)
CLIP_FACTOR = 2000.0
ALLOWANCES = {"quadruped": (STEP_OUTLIERS, CLIP_FACTOR),
              "quadruped_escape": (0.015, CLIP_FACTOR)}
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
         allowed: float = 0.0, factor: float = OUTLIER_FACTOR) -> Held:
    """``got`` [S, n] against ``want`` in float64: each state's largest error
    within ``tol`` x max|want|, except a share ``allowed`` of the states,
    which stay within ``factor`` times that."""
    errs = (got.double().cpu() - want).abs().amax(-1)
    limit = tol * float(want.abs().max())
    beyond = float((errs > limit).double().mean())
    worst = float(errs.max())
    ok = (bool(torch.isfinite(got).all()) and beyond <= allowed
          and worst <= (factor if allowed else 1.0) * limit)
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


def random_states_3d(domain: str, count: int, seed: int
                     ) -> tp.Tuple[tp.Any, tp.List[torch.Tensor], tp.Optional[torch.Tensor]]:
    """A 3-D domain's environment and (q, qd, action) in float64: the root
    within a metre of the origin (over the escape terrain, anywhere on it)
    and up to 0.8 m above the ground, roll and pitch within half a radian,
    any yaw, joints within a radian of the stance, velocities of a few
    units; jaco's root pinned and its joints within a radian of the ready
    pose. Also the escape terrain [1, 101, 101] in float64 (None without)."""
    rng = np.random.RandomState(seed)
    env = (jaco.make("jaco_reach_top_left") if domain == "jaco"
           else quadruped.make(domain if domain != "quadruped" else "quadruped_stand"))
    ndof = env.model.ndof
    action = rng.uniform(-1, 1, (count, ndof - 6))
    qd = rng.randn(count, ndof) * 3
    terrain = None
    if domain == "jaco":
        pose, _ = env.constants(torch.device("cpu"), torch.float64)
        q = pose.numpy() + np.pad(rng.uniform(-1, 1, (count, ndof - 6)), ((0, 0), (6, 0)))
        qd[:, :6] = 0.0
    else:
        stance = env.constants(torch.device("cpu"), torch.float64).stance.numpy()
        q = stance + rng.uniform(-1, 1, (count, ndof))
        q[:, 2] = rng.uniform(0.0, 0.8, count)
        q[:, 3:5] = rng.uniform(-0.5, 0.5, (count, 2))
        q[:, 5] = rng.uniform(-np.pi, np.pi, count)
        if domain == "quadruped_escape":
            bumps = torch.from_numpy(rng.uniform(0.15, 1.0, (1, quadruped.BUMP_RES,
                                                             quadruped.BUMP_RES)))
            terrain = quadruped.generate_terrain(bumps)
            q[:, :2] = rng.uniform(-25, 25, (count, 2))
            ground = p3d.hf_height(env._hfield(terrain[0]), torch.from_numpy(q[:, :2]))
            q[:, 2] += ground.numpy()
    return env, [torch.from_numpy(x) for x in (q, qd, action)], terrain


def _model_inputs(domain: str, count: int, seed: int
                  ) -> tp.Tuple[tp.List[torch.Tensor], tp.Callable, tp.Callable]:
    """A domain's states, and its forward_dynamics and step functions of
    (q, qd, action) on the states' device and dtype."""
    if domain in DOMAINS:
        env = locomotion.make(f"{domain}_{locomotion.TASKS[domain][0]}")
        states = random_states(env.model.ndof, count, seed)
        return (states, lambda *x: p2d.forward_dynamics(env.model, *x),
                lambda *x: p2d.step(env.model, *x, env.control_dt, env.n_substeps))
    env, states, terrain = random_states_3d(domain, count, seed)

    def hfield(like: torch.Tensor) -> tp.Optional[p3d.Heightfield]:
        return None if terrain is None else env._hfield(terrain[0].to(like))

    return (states, lambda *x: p3d.forward_dynamics(env.model, *x, hfield(x[0])),
            lambda *x: p3d.step(env.model, *x, env.control_dt, env.n_substeps, hfield(x[0])))


def check_domain(domain: str, count: int, device: DeviceLike = None,
                 seed: int = 0) -> tp.Tuple[float, tp.List[Held]]:
    """The share of the states with a contact pressed, and the comparison of
    every output of ``forward_dynamics`` and ``step`` in float32 on
    ``device`` against float64 on the CPU."""
    dev = resolve_device(device)
    exact, forward, step = _model_inputs(domain, count, seed)
    single = [x.float().to(dev) for x in exact]
    fd_got = forward(*single)
    fd_want = forward(*exact)
    step_got = step(*single)
    step_want = step(*exact)
    pressed = float((fd_want[1] > 0).any(-1).double().mean())
    held = [hold(f"forward_dynamics {name}", got, want, DYNAMICS_TOL)
            for name, got, want in zip(("qdd", "fn"), fd_got, fd_want)]
    allowed, factor = ALLOWANCES.get(domain, (STEP_OUTLIERS, OUTLIER_FACTOR))
    held += [hold(f"step {name}", got, want, STEP_TOL, allowed, factor)
             for name, got, want in zip(("q", "qd", "touch"), step_got, step_want)]
    return pressed, held


def main() -> int:
    resolve_device()
    print(f"card: {card_name_and_power_limit()}")
    failed = False
    for domain in DOMAINS + DOMAINS_3D:
        for seed in range(SEEDS):
            pressed, held = check_domain(domain, STATES, seed=seed)
            ok = all(h.ok for h in held)
            failed = failed or not ok
            print(f"{domain} seed {seed}: {STATES} states, {pressed:.2f} with a contact pressed: "
                  + "; ".join(str(h) for h in held) + (" ok" if ok else " FAIL"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
