"""Zero-shot evaluation of a trained agent on the real dm_control stack (the
port's counterpart of the root ``tools/eval_mujoco.py``).

Closes the loop on the offline recipe (reference README.md:63-78): after
offline FB training on a real MuJoCo ExORL-format buffer, the agent is
evaluated zero-shot on dm_control's environments, with the reward the
reference reports, not on the port's engines. Per task it infers z by
reward regression over relabeled replay samples (the finalize protocol of
the reference, pretrain.py:496-533 / _init_eval_meta:166-184), as the
spherical mean of ``--z-draws`` single draws, and rolls out episodes.

The work is split in two. The device half (``Evaluator``) rebuilds the
training workspace on ``--device`` (the card unless ``--device cpu``), fills
a fresh replay with the buffer's episodes, infers z and gives an
``act(obs) -> action`` that runs the policy in eval mode there, one
observation up and one action down per step; it is deterministic given z.
The host loop (``rollout_return``) steps MuJoCo and feeds the policy the
native observation recomputed from the adapted MuJoCo state.

Flags before ``--`` are the evaluation's; the rest rebuild the training
workspace and must match the training invocation:

    python -m controllable_agent_torch.tools.eval_mujoco --replay-dir exorl_data/walker_rnd \\
        --physics-format mujoco_walker --tasks walker_stand,walker_walk,walker_run \\
        --out results/walker_offline_mujoco [--device cpu] -- \\
        agent=fb_ddpg task=walker_walk goal_space=walker_pos_speed_z \\
        folder=exp_local/walker_offline_mujoco

Writes ``<out>/test_rewards.json`` (``--episodes`` returns per task) and,
with ``--snapshots``, ``<out>/eval.csv``: the primary task's return on
dm_control at every saved snapshot of the run.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..data import ReplayBuffer
from ..data.exorl import PHYSICS_ADAPTERS, load_exorl_episodes
from ..goals import get_reward_function
from ..pretrain import build_workspace
from ..train.workspace import OfflineWorkspace
from . import mujoco_bridge as bridge
from .collect_mujoco_buffer import flat_obs

Act = tp.Callable[[np.ndarray], np.ndarray]


def rollout_return(env: tp.Any, act: Act, episode_length: int,
                   obs_fn: tp.Optional[tp.Callable[[tp.Any], np.ndarray]] = None) -> float:
    """One episode of ``env`` from a reset under ``act``; its return."""
    ts = env.reset()
    total = 0.0
    for _ in range(episode_length):
        obs = flat_obs(ts) if obs_fn is None else obs_fn(env)
        ts = env.step(act(obs))
        total += 0.0 if ts.reward is None else float(ts.reward)
        if ts.last():
            break
    return total


def spherical_mean(draws: torch.Tensor) -> tp.Tuple[torch.Tensor, float]:
    """The norm-preserving spherical mean of ``draws`` [K, d] (the mean of
    the unit directions, scaled to the first draw's norm) and their
    coherence, the mean pairwise cosine (1.0: the single-draw protocol was
    already stable)."""
    unit = draws / torch.linalg.vector_norm(draws, dim=-1, keepdim=True).clamp_min(1e-12)
    n = len(unit)
    coherence = float(((unit @ unit.T).sum() - n) / (n * (n - 1))) if n > 1 else 1.0
    z = unit.mean(0)
    z = z / torch.linalg.vector_norm(z).clamp_min(1e-12) * torch.linalg.vector_norm(draws[0])
    return z, coherence


class Evaluator:
    """The evaluator's device half over a trained workspace ``ws``."""

    def __init__(self, ws: OfflineWorkspace, physics_format: str = "mujoco_walker",
                 z_draws: int = 8) -> None:
        if ws.global_step == 0:
            raise ValueError(f"no checkpoint found in the workspace folder {ws.work_dir}")
        self.ws, self.physics_format, self.z_draws = ws, physics_format, z_draws
        self.adapter = PHYSICS_ADAPTERS[physics_format]
        self.native_obs_fn = getattr(ws.env, "obs_from_physics", None)
        if self.adapter is not None and self.native_obs_fn is None:
            raise ValueError(f"physics_format={physics_format} needs a task with "
                             f"obs_from_physics, not {ws.cfg.task!r}")

    @classmethod
    def build(cls, ws_args: tp.Sequence[str], device: str, physics_format: str = "mujoco_walker",
              z_draws: int = 8) -> "Evaluator":
        """The training workspace rebuilt from its arguments on ``device``."""
        ws = build_workspace(list(ws_args) + [f"device={device}"], OfflineWorkspace)
        return cls(ws, physics_format, z_draws)

    def load_episodes(self, replay_dir: Path, limit: int) -> int:
        """A fresh replay of the first ``limit`` episodes of ``replay_dir``: z
        inference sees only these (any replay the checkpoint restored goes),
        with the native observations recomputed from the adapted physics, as
        ``train_offline`` ingests them, and the goal column appended."""
        ws = self.ws
        ws.buffer = ReplayBuffer(max_episodes=limit, discount=ws.cfg.discount,
                                 future=ws.cfg.future,
                                 max_episode_length=ws.env.spec.episode_length, device=ws.device)
        episodes = load_exorl_episodes(Path(replay_dir), limit=limit,
                                       physics_format=self.physics_format)
        if self.adapter is not None:
            episodes = ({**ep, "observation": self.native_obs_fn(ep["physics"]).numpy()}
                        for ep in episodes)
        if ws.goal_fn is not None:
            episodes = ({**ep, "goal": ws.goal_fn(ep["physics"]).numpy()} for ep in episodes)
        ws.buffer.load_episodes(episodes)
        return len(ws.buffer)

    def infer_z(self, reward_fn: tp.Any) -> tp.Tuple[torch.Tensor, float]:
        """The spherical mean of ``z_draws`` single-draw reward regressions of
        ``reward_fn`` over the replay, and the draws' coherence."""
        draws = torch.stack([self.ws._infer_meta_from_replay(reward_fn, draws=1)
                             for _ in range(max(self.z_draws, 1))])
        return spherical_mean(draws)

    def make_act(self, z: torch.Tensor) -> Act:
        """The policy under task ``z`` in eval mode, on the workspace's device."""
        agent, device = self.ws.agent, self.ws.device
        meta = {agent.meta_key: z.to(device).reshape(1, -1)}

        @torch.no_grad()
        def act(obs: np.ndarray) -> np.ndarray:
            obs_t = torch.as_tensor(obs, dtype=torch.float32, device=device).unsqueeze(0)
            action = agent.policy_act(obs_t, meta, 0, eval_mode=True)
            return action[0].float().cpu().numpy()
        return act

    def obs_from_state(self, state: np.ndarray) -> np.ndarray:
        """The policy's observation for a MuJoCo [qpos, qvel] row: the row
        adapted from float32, as the buffer's files keep it, then the native
        observation recomputed from it (on the host)."""
        phys = self.adapter(state[None].astype(np.float32))
        return self.native_obs_fn(phys)[0].numpy()

    def obs_fn(self) -> tp.Optional[tp.Callable[[tp.Any], np.ndarray]]:
        """``rollout_return``'s observation of a dm_control env (None:
        dm_control's own, for a native-format buffer)."""
        if self.adapter is None:
            return None
        return lambda env: self.obs_from_state(bridge.mj_state(env))

    def returns(self, env: tp.Any, z: torch.Tensor, episodes: int,
                episode_length: int) -> tp.List[float]:
        """``episodes`` returns on the dm_control ``env`` under task ``z``."""
        act = self.make_act(z)
        return [rollout_return(env, act, episode_length, self.obs_fn())
                for _ in range(episodes)]


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.List[float]]:
    argv = list(sys.argv[1:] if argv is None else argv)
    ws_args: tp.List[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, ws_args = argv[:split], argv[split + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--replay-dir", required=True)
    p.add_argument("--physics-format", default="mujoco_walker")
    p.add_argument("--tasks", default="walker_stand,walker_walk,walker_run,walker_flip")
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--episode-length", type=int, default=1000)
    p.add_argument("--buffer-episodes", type=int, default=1000)
    p.add_argument("--out", required=True)
    p.add_argument("--snapshots", action="store_true",
                   help="also evaluate every models/snapshot_* on the primary task into "
                        "eval.csv")
    p.add_argument("--z-draws", type=int, default=8,
                   help="average the inferred z over this many independent 5120-sample "
                        "reward regressions (the single-draw reference protocol, "
                        "pretrain.py:166-184, is noisy on foreign buffers; the spherical "
                        "mean cuts the estimator's variance by ~1/sqrt(draws))")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="where the replay, z inference and the policy run (the card "
                        "unless cpu); MuJoCo steps on the host")
    args = p.parse_args(argv)

    evaluator = Evaluator.build(ws_args, args.device, args.physics_format, args.z_draws)
    ws = evaluator.ws
    print(f"loaded checkpoint at step {ws.global_step} on {ws.device}")
    count = evaluator.load_episodes(Path(args.replay_dir), args.buffer_episodes)
    print(f"buffer: {count} episodes for z inference")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    results: tp.Dict[str, tp.List[float]] = {}
    for task in args.tasks.split(","):
        z, coherence = evaluator.infer_z(get_reward_function(task, ws.cfg.seed))
        print(f"{task}: z draw coherence {coherence:.3f}", flush=True)
        returns = evaluator.returns(bridge.make_env(task, seed=args.seed), z, args.episodes,
                                    args.episode_length)
        results[task] = returns
        print(f"{task}: mean {np.mean(returns):.1f} (+- {np.std(returns):.1f})", flush=True)
    (out_dir / "test_rewards.json").write_text(json.dumps(results))

    if args.snapshots:
        primary = ws.cfg.task
        reward_fn = get_reward_function(primary, ws.cfg.seed)
        env = bridge.make_env(primary, seed=args.seed)
        snaps = sorted((ws.work_dir / "models").glob("snapshot_*"),
                       key=lambda pth: int(pth.name.split("_")[1]))
        snaps.append(ws.work_dir / "models" / "latest")
        rows = []
        final_step = ws.global_step
        for snap in snaps:
            ws.load_checkpoint(snap, only=["agent"])
            step = (int(snap.name.split("_")[1]) if snap.name.startswith("snapshot")
                    else final_step)
            z, _ = evaluator.infer_z(reward_fn)
            returns = evaluator.returns(env, z, args.episodes, args.episode_length)
            rows.append({"step": step, "episode_reward": float(np.mean(returns)),
                         "episode_reward#std": float(np.std(returns))})
            print(f"snapshot {step}: {primary} {np.mean(returns):.1f}", flush=True)
        with (out_dir / "eval.csv").open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    print(f"wrote {out_dir}")
    return results


if __name__ == "__main__":
    main()
