"""CLI: roll out and visualize a trained checkpoint (mirror of
``controllable_agent_tpu/play_behaviors.py``).

Load a run's folder, infer z for a requested task (``play_task=``, z
regressed on the replay's relabeled samples; without it, or with an empty
replay, the z that evaluation would choose), play ``num_episodes`` episodes
in one batch, and save each as ``eval_video/play_<ep>.png`` (an animated
PNG, ``train/video.py``) and the returns as ``play_rewards.json``:

    python -m controllable_agent_torch.play_behaviors folder=/path/to/xp \\
        task=walker_walk num_episodes=3

Every other ``key=value`` overrides the saved workspace config (as in the
JAX tool, ``task=`` is such a key: it sets the environment, ``play_task=``
the z). ``device=cpu`` runs on the CPU; the default is the card.
"""

from __future__ import annotations

import json
import sys
import typing as tp

import torch


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Optional[tp.Dict[str, tp.Any]]:
    """Runs the CLI; returns the summary written to ``play_rewards.json``
    (None after ``--help``)."""
    from .goals import get_reward_function
    from .pretrain import build_workspace
    from .train.video import Renderer, VideoRecorder
    from .train.workspace import OfflineWorkspace

    argv = list(argv if argv is not None else sys.argv[1:])
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return None
    opts = dict(arg.split("=", 1) for arg in argv)
    folder = opts.pop("folder")
    play_task = opts.pop("play_task", None)
    num_episodes = int(opts.pop("num_episodes", "3"))

    ws = build_workspace([f"folder={folder}"] + [f"{k}={v}" for k, v in opts.items()],
                         OfflineWorkspace)
    meta_key = getattr(ws.agent, "meta_key", "z")
    if play_task is not None and len(ws.buffer) > 0:
        reward_fn = get_reward_function(play_task, ws.cfg.seed)
        z = ws._infer_meta_from_replay(reward_fn)
    else:
        meta = ws._init_eval_meta()
        z = meta.get(meta_key, torch.zeros(1, device=ws.device))
    totals, physics, _ = ws._eval_rollout({meta_key: z}, num_episodes)

    recorder = VideoRecorder(ws.work_dir, Renderer(ws.domain, ws._base_env()))
    phys = physics.cpu().numpy()
    for ep in range(num_episodes):
        recorder.frames = []
        recorder.record_trajectory(phys[ep])
        recorder.save(f"play_{ep}.gif")

    summary = {"rewards": [float(x) for x in totals.tolist()],
               "task": play_task or ws.cfg.task}
    (ws.work_dir / "play_rewards.json").write_text(json.dumps(summary))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
