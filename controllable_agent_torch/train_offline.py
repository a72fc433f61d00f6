"""CLI: offline training from a stored replay buffer (mirror of
``controllable_agent_tpu/train_offline.py``).

Load episodes, either ``replay_dir=`` (a directory of ExORL-format .npz
episodes) or ``load_replay=`` (the replay of a checkpoint), by default
relabel their rewards for ``task`` from the stored physics on the replay's
device (``relabel=false`` keeps the stored rewards; the gridworld's tasks
have no reward functions, so grid episodes take it), then run gradient
steps:

    python -m controllable_agent_torch.train_offline agent=fb_ddpg \\
        task=walker_walk replay_dir=/path/to/episodes \\
        agent.use_pallas_loss=true agent.compute_dtype=bfloat16 \\
        num_grad_steps=100000 eval_every_steps=10000 final_tests=10

    python -m controllable_agent_torch.train_offline agent=fb_ddpg \\
        task=walker_walk goal_space=walker_pos_speed_z \\
        load_replay=exp_rnd/models/latest relabel=true

``physics_format=mujoco_walker`` (``_cheetah``, ``_hopper``) converts
dm_control physics to the native layout and recomputes the observations
from it. The run writes ``train.csv``, ``hip.log`` and
``models/latest`` into ``folder``; running the same command again resumes
from that checkpoint. Every ``eval_every_steps`` updates it rolls out
``num_eval_episodes`` episodes of the task's environment under the task's z
(an ``eval`` row in ``eval.csv``), and when training ends it runs the final
test battery (``final_tests`` episodes for each task of the domain, z from
rewards relabeled on the replay's physics) into ``test_rewards.json`` and
prints the task z chosen as evaluation chooses it (a registered goal, else
z = rᵀB/N over the replay, spherical mean of ``z_inference_draws`` draws).
A ``d4rl_<domain>`` task (``halfcheetah``, ``hopper``, ``walker2d``, ...)
with ``d4rl_dataset=<.npz of a d4rl dataset dict>`` and neither of the two
loads that dataset's episodes with their stored rewards, and evaluates on
them (``envs/d4rl_replay.py``) with d4rl's ``normalized_score`` in each
``eval.csv`` row:

    python -m controllable_agent_torch.train_offline agent=fb_ddpg \\
        task=d4rl_halfcheetah d4rl_dataset=halfcheetah-medium-v2.npz

``load_model=`` warm-starts from a checkpoint of the port or of the JAX
package (a folder with ``agent.msgpack``). ``device=cpu`` runs on the CPU;
the default is the card. ``save_eval_video`` (on by default) writes the
first episode of each evaluation to ``eval_video/<step>.png``; ``--help``
lists every key.
"""

from __future__ import annotations

import itertools
import sys
import time
import typing as tp
from pathlib import Path

import numpy as np

from .data.d4rl import load_d4rl_dataset
from .data.exorl import load_exorl_episodes
from .goals import get_reward_function
from .pretrain import build_config, wants_help
from .train import checkpoint as ckpt_lib
from .train.workspace import OfflineWorkspace, make_env
from .utils import resolve_device

Episode = tp.Dict[str, np.ndarray]


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Optional[OfflineWorkspace]:
    """Runs the CLI; returns the trained workspace (with ``last_row`` and
    ``inferred_z`` set) for callers that drive it from Python, None after
    ``--help``."""
    argv = list(argv if argv is not None else sys.argv[1:])
    if wants_help(argv, __doc__):
        return None
    replay_dir: tp.Optional[str] = None
    load_replay: tp.Optional[str] = None
    relabel = True
    physics_format = "native"
    rest: tp.List[str] = []
    for arg in argv:
        if arg.startswith("replay_dir="):
            replay_dir = arg.split("=", 1)[1]
        elif arg.startswith("load_replay="):
            load_replay = arg.split("=", 1)[1]
        elif arg.startswith("relabel="):
            relabel = arg.split("=", 1)[1].lower() == "true"
        elif arg.startswith("physics_format="):
            physics_format = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    cfg, agent_overrides, agent_cfg_base = build_config(rest)

    episodes: tp.Optional[tp.Iterator[Episode]] = None
    if replay_dir is not None:
        episodes = load_exorl_episodes(Path(replay_dir), physics_format=physics_format)
        if physics_format != "native":
            # foreign-engine episodes: the stored observations follow the
            # source engine's sign conventions; recompute them from the
            # adapted physics, as the native engine emits them
            env = make_env(cfg.task, cfg.episode_length)
            if not hasattr(env, "obs_from_physics"):
                raise ValueError(f"physics_format={physics_format} needs a task "
                                 f"with obs_from_physics, not {cfg.task!r}")
            episodes = ({**ep, "observation": env.obs_from_physics(ep["physics"]).numpy()}
                        for ep in episodes)
        first = next(episodes, None)
        if first is None:
            raise ValueError(f"no .npz episodes in {replay_dir}")
        episodes = itertools.chain([first], episodes)
    elif load_replay is not None:
        # read once, straight onto the run's device
        restored = ckpt_lib.load_checkpoint(Path(load_replay), only=["replay"],
                                            device=resolve_device(cfg.device))
        if "replay" not in restored or restored["replay"].n_episodes == 0:
            raise ValueError(f"no episodes in {load_replay}")
        first = restored["replay"].storage
    elif not (cfg.task.startswith("d4rl_") and cfg.d4rl_dataset is not None):
        raise ValueError("train_offline needs replay_dir=<directory of .npz "
                         "episodes>, load_replay=<checkpoint> or, for a d4rl_* task, "
                         "d4rl_dataset=<.npz>")

    ws = OfflineWorkspace(cfg, agent_cfg_overrides=agent_overrides,
                          agent_cfg_base=agent_cfg_base)
    if episodes is None and load_replay is None:
        # the d4rl dataset into the replay; its rewards are the stored ones
        # and its physics a zero column, so nothing is relabeled
        started = time.perf_counter()
        with np.load(cfg.d4rl_dataset) as data:
            dataset = {k: data[k] for k in data.files}
        count = load_d4rl_dataset(ws.buffer, dataset)
        print(f"loaded {count} d4rl episodes from {cfg.d4rl_dataset} in "
              f"{time.perf_counter() - started:.2f} s", flush=True)
        ws.train()
        return _print_z(ws)
    ws.check_data(first)
    if episodes is not None:
        ws.buffer.load_episodes(episodes)
    else:
        ws.buffer.state = restored["replay"]  # the replay of a checkpoint only
    # rewards for the target task and the goal column for the requested goal
    # space from the stored physics, on the buffer's device (the JAX package
    # relabels episodes one at a time on the host before loading them)
    if relabel:
        ws.buffer.relabel(get_reward_function(cfg.task, cfg.seed).from_physics)
    if ws.goal_fn is not None:
        ws.buffer.set_goals(ws.goal_fn)
    ws.train()
    return _print_z(ws)


def _print_z(ws: OfflineWorkspace) -> OfflineWorkspace:
    """Print the task z that evaluation chooses, for an agent with a task
    vector (a battery of goals has no one z)."""
    meta_key = getattr(ws.agent, "meta_key", None)
    if ws.cfg.custom_reward != "maze_multi_goal" and meta_key is not None:
        ws.inferred_z = ws._init_eval_meta()[meta_key]
        print("inferred z: " + " ".join(f"{v:.4f}" for v in ws.inferred_z.tolist()),
              flush=True)
    return ws


if __name__ == "__main__":
    main()
