"""Write PARITY_TORCH.md: the port's engines against dm_control/MuJoCo on
shared states (the port's counterpart of the root
``tools/gen_parity_report.py``, whose ``PARITY.md`` is the JAX package's).

Random-action rollouts of dm_control's environments give MuJoCo [qpos, qvel]
rows; the port's physics adapters (``data/exorl.py``) map them into the
native layout, the path real ExORL data takes at ingestion, and the port's
goal features and reward functions run on them in torch on ``--device`` (the
card unless ``--device cpu``). They are set against the reference's named
physics reads and its physics-replay relabel on the same states. A row that
needs one of the reference's custom tasks (walker flip, the cheetah's, most
of the hopper's and the quadruped's, the point-mass maze) is written as not
run when those XMLs are absent (``mujoco_bridge.custom_tasks_available``).

    python -m controllable_agent_torch.tools.gen_parity_report [--device cpu] \\
        [--out PARITY_TORCH.md]
"""

from __future__ import annotations

import argparse
import typing as tp

import numpy as np
import torch

from ..data import exorl
from ..envs import locomotion
from ..envs.pointmass import PointMassMaze
from ..envs.quadruped import QuadrupedEnv
from ..utils.device import resolve_device
from . import mujoco_bridge as bridge

N_FEATURE_STEPS = 400
N_REWARD_STEPS = 300

FEATURE_DOMAINS = ["walker", "cheetah", "hopper"]
FEATURE_TASKS = {"walker": "walk", "cheetah": "run", "hopper": "stand"}  # suite tasks
REWARD_TASKS = [
    ("walker", "stand"), ("walker", "walk"), ("walker", "run"),
    ("walker", "flip"),
    ("cheetah", "walk"), ("cheetah", "run"), ("cheetah", "walk_backward"),
    ("cheetah", "run_backward"), ("cheetah", "flip"),
    ("cheetah", "flip_backward"),
    ("hopper", "stand"), ("hopper", "hop"), ("hopper", "hop_backward"),
    ("hopper", "flip"), ("hopper", "flip_backward"),
    ("point_mass_maze", "reach_top_left"),
    ("point_mass_maze", "reach_bottom_right"),
]
FEAT_NAMES = ["x", "z", "up", "vx", "vz", "am"]
QUAD_FEAT_NAMES = ["up", "x", "y", "z", "vx", "vy", "vz"]
QUAD_FEAT_COLS = [0, 2, 3, 4, 5, 6, 7]
QUAD_REWARD_TASKS = ["stand", "walk", "run", "jump", "roll", "roll_fast"]
NOT_RUN = "not run: custom task XML not in the repo"

FeatureRow = tp.Tuple[str, str, float, float, float, float]
RewardRow = tp.Tuple[str, tp.Optional[tp.Tuple[float, float, float, float, float]]]


def runnable(name: str) -> bool:
    """The task can be loaded here: the suite has it, or the custom XMLs are at hand."""
    return bridge.is_suite_task(name) or bridge.custom_tasks_available()


def _corr(a: np.ndarray, b: np.ndarray, floor: float) -> float:
    return float(np.corrcoef(a, b)[0, 1]) if b.std() > floor else float("nan")


def native_features(domain: str, mj_states: np.ndarray, device: torch.device) -> np.ndarray:
    """The port's goal features [N, 6] of MuJoCo states, adapted, on ``device``."""
    env = locomotion.make(f"{domain}_{'stand' if domain != 'cheetah' else 'walk'}")
    adapted = exorl.PHYSICS_ADAPTERS[f"mujoco_{domain}"](mj_states)
    return env.goal_features(torch.as_tensor(adapted, device=device)).cpu().double().numpy()


def native_rewards(name: str, mj_states: np.ndarray, device: torch.device) -> np.ndarray:
    """The port's reward of task ``name`` on MuJoCo states, on ``device``
    (the maze's with zero control, as the replay path has)."""
    domain, task = bridge.split_name(name)
    if domain == "point_mass_maze":
        phys = torch.as_tensor(mj_states, dtype=torch.float32, device=device)
        zero = torch.zeros(phys.shape[:-1] + (2,), device=device)
        out = PointMassMaze(task).reward_from_physics(phys, zero)
    elif domain == "quadruped":
        feats = exorl.mujoco_quadruped_features(mj_states).astype(np.float32)
        out = QuadrupedEnv(task).reward_from_features(torch.as_tensor(feats, device=device))
    else:
        adapted = exorl.PHYSICS_ADAPTERS[f"mujoco_{domain}"](mj_states)
        out = locomotion.make(name).reward_from_physics(torch.as_tensor(adapted, device=device))
    return out.cpu().double().numpy()


def feature_rows(device: torch.device, steps: int = N_FEATURE_STEPS) -> tp.List[FeatureRow]:
    rows = []
    for domain in FEATURE_DOMAINS:
        env = bridge.make_env(f"{domain}_{FEATURE_TASKS[domain]}", seed=12)
        roll = bridge.collect_rollout(env, steps, seed=0,
                                      feature_fn=getattr(bridge, f"{domain}_features"))
        ours, ref = native_features(domain, roll["physics"], device), roll["features"]
        for i, name in enumerate(FEAT_NAMES):
            err = np.abs(ours[:, i] - ref[:, i])
            rows.append((domain, name, float(err.mean()), float(err.max()),
                         float(ref[:, i].std()), _corr(ours[:, i], ref[:, i], 1e-9)))
    return rows


def _enrich_states(domain: str, states: np.ndarray) -> np.ndarray:
    """Widen the reward-relevant coverage: random rollouts of some tasks never
    leave the zero-reward region (hopper_hop needs standing and speed, the
    maze the target room). Synthetic root velocities and positions are
    injected; physics replay is defined at any state."""
    rng = np.random.RandomState(9)
    out = states.copy()
    n = len(out)
    if domain == "point_mass_maze":
        # a grid across the arena, near-target states included, zero velocity
        g = np.linspace(-0.29, 0.29, 18)
        xs, ys = np.meshgrid(g, g)
        grid = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size), np.zeros(xs.size)], -1)
        return np.concatenate([out, grid])
    ndof = states.shape[1] // 2
    out[:, ndof:ndof + 2] += rng.uniform(-6, 6, (n, 2))  # root linear velocities
    out[:, ndof + 2] += rng.uniform(-8, 8, n)  # root angular velocity, for the flips
    return out


def _reward_row(name: str, states: np.ndarray, device: torch.device) -> RewardRow:
    env = bridge.make_env(name, seed=3)
    ref = np.array([bridge.reward_from_state(env, s) for s in states])
    ours = native_rewards(name, states, device)
    err = np.abs(ours - ref)
    return name, (float(err.mean()), float(err.max()), float(ref.mean()), float(ref.std()),
                  _corr(ours, ref, 1e-3))


def reward_rows(device: torch.device, steps: int = N_REWARD_STEPS) -> tp.List[RewardRow]:
    rows: tp.List[RewardRow] = []
    for domain, task in REWARD_TASKS:
        name = f"{domain}_{task}"
        if not runnable(name):
            rows.append((name, None))
            continue
        roll = bridge.collect_rollout(bridge.make_env(name, seed=3), steps, seed=1)
        rows.append(_reward_row(name, _enrich_states(domain, roll["physics"]), device))
    return rows


def quadruped_feature_rows(steps: int = N_FEATURE_STEPS) -> tp.List[FeatureRow]:
    """Feature-level parity for the quadruped: the morphologies differ
    (dm_control's 12 actuators and 23-wide qpos against the native 8
    joints), so ``data/exorl.py:mujoco_quadruped_features`` maps states to
    the shared torso-level features instead of state to state."""
    env = bridge.make_env("quadruped_walk", seed=12)
    roll = bridge.collect_rollout(env, steps, seed=0, feature_fn=bridge.quadruped_features)
    ours = exorl.mujoco_quadruped_features(roll["physics"]).astype(np.float64)
    ref = roll["features"]
    rows = []
    for name, col in zip(QUAD_FEAT_NAMES, QUAD_FEAT_COLS):
        err = np.abs(ours[:, col] - ref[:, col])
        rows.append(("quadruped", name, float(err.mean()), float(err.max()),
                     float(ref[:, col].std()), _corr(ours[:, col], ref[:, col], 1e-9)))
    # the jump's height read: the native layout has the root z, the reference the COM z
    err = np.abs(ours[:, 4] - ref[:, 1])
    rows.append(("quadruped", "com_z (vs root z)", float(err.mean()), float(err.max()),
                 float(ref[:, 1].std()), _corr(ours[:, 4], ref[:, 1], 1e-9)))
    return rows


def quadruped_states(steps: int = N_REWARD_STEPS) -> np.ndarray:
    """quadruped_run rollout states, and the same with their root
    velocities widened (replay is defined at any state)."""
    roll = bridge.collect_rollout(bridge.make_env("quadruped_run", seed=3), steps, seed=1)
    states = roll["physics"]
    fast = states.copy()
    fast[:, 23:26] += np.random.RandomState(9).uniform(-6, 6, (len(fast), 3))
    return np.concatenate([states, fast])


def quadruped_reward_rows(device: torch.device, steps: int = N_REWARD_STEPS
                          ) -> tp.List[RewardRow]:
    states = quadruped_states(steps)
    return [_reward_row(f"quadruped_{task}", states, device)
            if runnable(f"quadruped_{task}") else (f"quadruped_{task}", None)
            for task in QUAD_REWARD_TASKS]


def _fmt(value: float, digits: int) -> str:
    return "n/a" if np.isnan(value) else f"{value:.{digits}f}"


def report(frows: tp.Sequence[FeatureRow], rrows: tp.Sequence[RewardRow],
           device: torch.device) -> str:
    lines = [
        "# PARITY_TORCH — the port's engines against dm_control/MuJoCo",
        "",
        "Generated by `python -m controllable_agent_torch.tools.gen_parity_report "
        f"--device {device.type}`",
        "(`PARITY.md` is the JAX package's report). The same comparisons, on",
        "shorter rollouts, are tests: `tests/test_torch_mujoco_bridge.py`.",
        "All comparisons are on shared states: random-action rollouts of",
        "dm_control's environments, mapped into the native layout by the",
        "`data/exorl.py` physics adapters, the path ExORL data takes at",
        "ingestion. The port's features and rewards ran in torch on",
        f"`{device}`.",
        "",
        f"Rollout lengths: features {N_FEATURE_STEPS} steps, rewards {N_REWARD_STEPS} steps,",
        "random uniform actions. Rows of the reference's custom tasks (walker",
        "flip, the cheetah's tasks but run, the hopper's but stand and hop, the",
        "quadruped's but walk and run, the point-mass maze) need its XMLs",
        f"(`mujoco_bridge.custom_tasks_dir()`); where they are absent the row reads \"{NOT_RUN}\".",
        "",
        "## Goal-feature agreement",
        "",
        "The port's `goal_features` (the inputs of every goal space in",
        "`goals/spaces.py`) against the reference's named physics reads",
        "(`url_benchmark/goals.py:66-94`).",
        "",
        "| domain | feature | mean abs err | max abs err | ref std | corr |",
        "|---|---|---|---|---|---|",
    ]
    for dom, name, me, mx, std, corr in frows:
        lines.append(f"| {dom} | {name} | {me:.5f} | {mx:.5f} | {std:.3f} | {_fmt(corr, 4)} |")
    lines += [
        "",
        "x/z/up map exactly (the same generalized coordinates after the adapter);",
        "vx/vz/am are COM-velocity and angular-momentum reads of composite",
        "bodies. The quadruped is compared at the feature level",
        "(`data/exorl.py:mujoco_quadruped_features`): its morphology differs from",
        "the native 8-joint model. The `com_z (vs root z)` row is the one",
        "approximation by design: the reference's jump reward reads the whole",
        "robot's COM height where the native layout carries the root z.",
        "",
        "## Reward relabel agreement",
        "",
        "The port's reward functions on adapted states against the reference's",
        "physics-replay relabel (`in_memory_replay_buffer.py:40-55`: set_state",
        "and task.get_reward), the semantics used to relabel ExORL buffers.",
        "",
        "| task | mean abs err | max abs err | ref mean | ref std | corr |",
        "|---|---|---|---|---|---|",
    ]
    for name, values in rrows:
        if values is None:
            lines.append(f"| {name} | {NOT_RUN} | | | | |")
            continue
        me, mx, rm, rs, corr = values
        lines.append(f"| {name} | {me:.4f} | {mx:.4f} | {rm:.4f} | {rs:.4f} | {_fmt(corr, 4)} |")
    lines += [
        "",
        "Rewards are in [0, 1] per step: `mean abs err` is the average per-step",
        "discrepancy a relabeled buffer would see.",
        "",
    ]
    return "\n".join(lines)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--out", default="PARITY_TORCH.md")
    p.add_argument("--device", default="cuda",
                   help="where the port's features and rewards run (the card unless cpu)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    frows = feature_rows(device) + quadruped_feature_rows()
    rrows = reward_rows(device) + quadruped_reward_rows(device)
    text = report(frows, rrows, device)
    with open(args.out, "w") as f:
        f.write(text)
    ran = sum(values is not None for _, values in rrows)
    print(f"wrote {args.out}: {len(frows)} feature rows, {ran} of {len(rrows)} reward rows "
          f"run")
    return text


if __name__ == "__main__":
    main()
