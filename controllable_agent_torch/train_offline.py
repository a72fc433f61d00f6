"""CLI: offline training from a directory of ExORL-format episodes (mirror of
``controllable_agent_tpu/train_offline.py``).

    python -m controllable_agent_torch.train_offline agent=fb_ddpg \\
        replay_dir=/path/to/episodes relabel=false \\
        agent.use_pallas_loss=true agent.compute_dtype=bfloat16 \\
        num_grad_steps=100000 eval_every_steps=0 checkpoint_every=0 final_tests=0

Trains on the rewards stored in the episodes and, when training ends, prints
the task z inferred from them (z = rᵀB/N, spherical mean of
``z_inference_draws`` draws). ``device=cpu`` runs on the CPU; the default is
the card.

Not ported yet: ``load_replay=`` and ``relabel=true`` (checkpoints and the
reward zoo, ROADMAP Queue A item 7), and physics formats other than
``native``.
"""

from __future__ import annotations

import itertools
import sys
import typing as tp
from pathlib import Path

from .data.exorl import load_exorl_episodes
from .pretrain import build_workspace
from .train.workspace import EnvSpec, OfflineWorkspace


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> OfflineWorkspace:
    """Runs the CLI; returns the trained workspace (with ``last_row`` and
    ``inferred_z`` set) for callers that drive it from Python."""
    argv = list(argv if argv is not None else sys.argv[1:])
    replay_dir: tp.Optional[str] = None
    relabel = True
    physics_format = "native"
    rest: tp.List[str] = []
    for arg in argv:
        if arg.startswith("replay_dir="):
            replay_dir = arg.split("=", 1)[1]
        elif arg.startswith("load_replay="):
            raise NotImplementedError(
                "load_replay= needs checkpoints, not ported to "
                "controllable_agent_torch yet (ROADMAP Queue A item 7)")
        elif arg.startswith("relabel="):
            relabel = arg.split("=", 1)[1].lower() == "true"
        elif arg.startswith("physics_format="):
            physics_format = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    if relabel:
        raise NotImplementedError(
            "relabel=true needs the reward zoo, not ported to "
            "controllable_agent_torch yet (ROADMAP Queue A item 7); pass "
            "relabel=false to train on the rewards stored in the episodes")
    if replay_dir is None:
        raise ValueError("train_offline needs replay_dir=<directory of .npz episodes>")
    episodes = load_exorl_episodes(Path(replay_dir), physics_format=physics_format)
    first = next(episodes, None)
    if first is None:
        raise ValueError(f"no .npz episodes in {replay_dir}")
    spec = EnvSpec(obs_dim=first["observation"].shape[-1],
                   action_dim=first["action"].shape[-1],
                   episode_length=first["observation"].shape[0] - 1)
    ws = build_workspace(rest, spec)
    ws.buffer.load_episodes(itertools.chain([first], episodes))
    ws.last_row = ws.train()
    ws.inferred_z = ws._infer_meta_from_replay()
    print("inferred z (r^T B / N from the stored rewards): "
          + " ".join(f"{v:.4f}" for v in ws.inferred_z.tolist()), flush=True)
    return ws


if __name__ == "__main__":
    main()
