"""Why z inference is unstable across draws, on a saved run (the port's
counterpart of the root ``tools/z_study.py``).

The same cheetah checkpoint can score walk 249 with ONE 5,120-sample reward
regression (the reference protocol, url_benchmark/pretrain.py:166-184) and
950 with the spherical mean of 8 independent draws. This reads a run folder
of the port (``models/latest`` with ``agent.pt`` and ``replay.pt``) and
reports, per task:

  * the relabeled rewards' distribution (q50/q90/q99/max, the effective
    sample size of the r-weighted mean);
  * the coherence (mean pairwise cosine) of K independent draws for each
    protocol: plain rB, plain with 4x samples, covariance-whitened
    Cov(B)^-1 rB, whitened with 4x samples;
  * the eigenspectrum of Cov(B) = E[B Bᵀ] on buffer states;
  * optionally, returns of rollouts (``train/loops.py:Rollout`` through the
    workspace) under the first few plain draws, their spherical mean and
    the whitened z's.

    python -m controllable_agent_torch.tools.z_study --folder exp_local/cheetah \\
        --tasks cheetah_walk,cheetah_run --draws 12 --eval-episodes 5 \\
        --per-draw-evals 6 --out results/z_study/cheetah.json [--device cpu]

The backward net, the sampling and the rollouts run on the card unless
``--device cpu``; the statistics are float64 numpy on the host.
"""

from __future__ import annotations

import argparse
import json
import typing as tp
from pathlib import Path

import numpy as np
import torch


def pairwise_coherence(zs: np.ndarray) -> float:
    """Mean pairwise cosine of draw directions (1.0 = perfectly stable)."""
    unit = zs / np.maximum(np.linalg.norm(zs, axis=-1, keepdims=True), 1e-12)
    cos = unit @ unit.T
    n = len(zs)
    if n < 2:
        return 1.0
    return float((cos.sum() - n) / (n * (n - 1)))


def spherical_mean(zs: np.ndarray) -> np.ndarray:
    unit = zs / np.maximum(np.linalg.norm(zs, axis=-1, keepdims=True), 1e-12)
    m = unit.mean(0)
    m = m / max(float(np.linalg.norm(m)), 1e-12)
    return (m * np.linalg.norm(zs[0])).astype(zs.dtype)


def cov_stats(b: np.ndarray) -> tp.Dict[str, float]:
    """Conditioning of Cov(B) = BᵀB / N over rows ``b`` [N, d] (float64)."""
    cov = (b.T @ b) / len(b)
    eig = np.linalg.eigvalsh(cov)
    return {"eig_max": float(eig[-1]), "eig_min": float(eig[0]),
            "cond": float(eig[-1] / max(eig[0], 1e-12)),
            "trace_over_dim": float(eig.sum() / b.shape[1])}


def reward_stats(r: np.ndarray) -> tp.Dict[str, float]:
    """Quantiles of rewards ``r`` and the effective sample size of the
    r-weighted mean, (sum r)^2 / sum r^2."""
    q = np.quantile(r, [0.5, 0.9, 0.99])
    ess = float(r.sum() ** 2 / max((r ** 2).sum(), 1e-12))
    return {"q50": float(q[0]), "q90": float(q[1]), "q99": float(q[2]),
            "max": float(r.max()), "mean": float(r.mean()), "ess": ess,
            "ess_frac": ess / len(r)}


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--folder", required=True)
    p.add_argument("--tasks", required=True,
                   help="comma-separated task names to relabel/evaluate")
    p.add_argument("--draws", type=int, default=12)
    p.add_argument("--eval-episodes", type=int, default=5,
                   help="rollout episodes per evaluated z (0 = stats only)")
    p.add_argument("--per-draw-evals", type=int, default=6,
                   help="how many individual plain draws to roll out")
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from controllable_agent_torch.goals import get_reward_function
    from controllable_agent_torch.pretrain import build_workspace
    from controllable_agent_torch.train.workspace import OfflineWorkspace

    ws = build_workspace([f"folder={args.folder}", "save_eval_video=false",
                          f"device={args.device}"], OfflineWorkspace)
    agent = ws.agent
    if len(ws.buffer) == 0:
        raise ValueError(f"{args.folder}: the checkpoint has no replay")
    n_inf = int(getattr(agent.cfg, "num_inference_steps", 5120))
    z_dim = int(agent.cfg.z_dim)
    meta_key = getattr(agent, "meta_key", "z")
    # every draw and every rollout's reset comes from this seed
    ws.generator.manual_seed(args.seed)

    @torch.no_grad()
    def draw_batch(n: int, reward_fn: tp.Any) -> tp.Tuple[np.ndarray, np.ndarray]:
        """B of n sampled goal states (float64) and their relabeled rewards."""
        batch = ws.buffer.sample(ws.generator, n, custom_reward=reward_fn.from_physics)
        obs = batch.next_obs if (ws.cfg.goal_space is None
                                 or batch.next_goal is None) else batch.next_goal
        b = agent.backward_net(obs).float()
        return (b.cpu().numpy().astype(np.float64),
                batch.reward.reshape(-1).cpu().numpy())

    def z_plain(b: np.ndarray, r: np.ndarray) -> np.ndarray:
        z = (r[:, None] * b).mean(0)
        return (np.sqrt(z_dim) * z / max(np.linalg.norm(z), 1e-12)).astype(np.float32)

    def z_whitened(b: np.ndarray, r: np.ndarray, eps: float = 1e-4) -> np.ndarray:
        cov = (b.T @ b) / len(b)
        z = np.linalg.solve(cov + eps * np.eye(z_dim, dtype=cov.dtype),
                            (r[:, None] * b).mean(0))
        return (np.sqrt(z_dim) * z / max(np.linalg.norm(z), 1e-12)).astype(np.float32)

    def returns_for(z: np.ndarray, reward_fn: tp.Any) -> tp.List[float]:
        z_t = torch.as_tensor(z, device=ws.device)
        _, physics, _ = ws._eval_rollout({meta_key: z_t}, args.eval_episodes)
        return [float(x) for x in reward_fn.from_physics(physics).sum(1).tolist()]

    # Cov(B) on buffer states (task-independent)
    b0, _ = draw_batch(4 * n_inf, get_reward_function(args.tasks.split(",")[0], ws.cfg.seed))
    stats = cov_stats(b0)
    print(f"Cov(B) on buffer states: cond {stats['cond']:.1f}, eig [{stats['eig_min']:.4f}, "
          f"{stats['eig_max']:.4f}], tr/d {stats['trace_over_dim']:.3f}", flush=True)

    report: tp.Dict[str, tp.Any] = {"folder": args.folder, "draws": args.draws,
                                    "num_inference_steps": n_inf, "cov_B": stats, "tasks": {}}
    for task in args.tasks.split(","):
        reward_fn = get_reward_function(task, ws.cfg.seed)
        _, r_big = draw_batch(4 * n_inf, reward_fn)
        rstats = reward_stats(r_big)
        protocols: tp.Dict[str, tp.Dict[str, float]] = {}
        zs_by_proto: tp.Dict[str, np.ndarray] = {}
        for name, mk_z, n in [("plain", z_plain, n_inf), ("plain_4x", z_plain, 4 * n_inf),
                              ("whitened", z_whitened, n_inf),
                              ("whitened_4x", z_whitened, 4 * n_inf)]:
            zs_by_proto[name] = np.stack([mk_z(*draw_batch(n, reward_fn))
                                          for _ in range(args.draws)])
            protocols[name] = {"coherence": pairwise_coherence(zs_by_proto[name])}
        # cross-protocol agreement of the MEAN directions
        mp = spherical_mean(zs_by_proto["plain"])
        mw = spherical_mean(zs_by_proto["whitened"])
        cross = float(mp @ mw / (np.linalg.norm(mp) * np.linalg.norm(mw)))
        entry: tp.Dict[str, tp.Any] = {"reward": rstats, "protocols": protocols,
                                       "plain_mean_vs_whitened_mean_cos": cross}
        if args.eval_episodes > 0:
            per_draw = [returns_for(zs_by_proto["plain"][i], reward_fn)
                        for i in range(min(args.per_draw_evals, args.draws))]
            entry["returns"] = {
                "plain_per_draw_mean": [float(np.mean(r)) for r in per_draw],
                "plain_spherical_mean": returns_for(mp, reward_fn),
                "whitened_single": returns_for(zs_by_proto["whitened"][0], reward_fn),
                "whitened_mean": returns_for(mw, reward_fn)}
        report["tasks"][task] = entry
        print(f"{task}: coherence plain {protocols['plain']['coherence']:.3f} / plain_4x "
              f"{protocols['plain_4x']['coherence']:.3f} / whitened "
              f"{protocols['whitened']['coherence']:.3f} / whitened_4x "
              f"{protocols['whitened_4x']['coherence']:.3f}; reward ess "
              f"{rstats['ess']:.0f}/{len(r_big)} q99 {rstats['q99']:.3f}", flush=True)
        if args.eval_episodes > 0:
            rr = entry["returns"]
            print(f"  returns: per-draw {[round(x) for x in rr['plain_per_draw_mean']]} "
                  f"mean8 {np.mean(rr['plain_spherical_mean']):.0f} "
                  f"whitened {np.mean(rr['whitened_single']):.0f} "
                  f"whitened_mean {np.mean(rr['whitened_mean']):.0f}", flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
