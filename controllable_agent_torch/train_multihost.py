"""CLI: offline training over several processes (mirror of
``controllable_agent_tpu/train_multihost.py``).

  * ``torch.distributed`` joins the processes (``parallel/multihost.py``:
    NCCL between cards, gloo with ``device=cpu``);
  * each process loads a disjoint replay shard (the ExORL episode files
    round-robined by rank), so no replay crosses processes;
  * the update is data-parallel, for every agent: each process samples its
    rows of every batch from its shard, the terms that couple the batch (the
    FB loss, ``pbe``'s neighbours, a covariance) take the gathered rows and
    the gradients are summed, so every process holds the same parameters;
  * evaluation, the final battery and checkpoints run on process 0 only;
    every other process logs quietly into ``<folder>/host_<rank>``.

Run the same command in every process, with its ``process_id``:

    python -m controllable_agent_torch.train_multihost agent=fb_ddpg \\
        task=walker_walk replay_dir=/data/rnd_walker \\
        coordinator=10.0.0.2:1234 num_processes=4 process_id=$RANK

``coordinator`` is the rendezvous of ``init_process_group``
(``tcp://<coordinator>``; a value with a scheme, such as
``file:///shared/rendezvous``, is used as it is). ``relabel`` and
``physics_format`` are ``train_offline``'s. Without ``num_processes`` (or
with 1) and without a coordinator it is a single-process run.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import typing as tp
from pathlib import Path

from .data.exorl import load_exorl_episodes
from .goals import get_reward_function
from .parallel import multihost
from .pretrain import build_config, wants_help
from .train.workspace import OfflineWorkspace, make_env


class MultiHostOfflineWorkspace(OfflineWorkspace):
    """The offline workspace with the data-parallel trainer, and evaluation,
    the battery and checkpoints on process 0 alone."""

    def _make_offline_trainer(self) -> tp.Callable[[], tp.Any]:
        self.mh_trainer = multihost.MultiHostTrainer(
            self.agent, self.buffer, self.agent.cfg.batch_size,
            steps_per_call=self.cfg.steps_per_call, seed=self.cfg.seed)
        return self.mh_trainer.step

    def evaluate(self) -> tp.Dict[str, float]:
        if multihost.process_index() != 0:
            return {}
        return super().evaluate()

    def finalize(self) -> tp.Dict[str, tp.List[float]]:
        if multihost.process_index() != 0:
            return {}
        return super().finalize()

    def save_checkpoint(self, path: tp.Optional[Path] = None,
                        exclude: tp.Sequence[str] = ()) -> None:
        if multihost.process_index() != 0:
            return
        super().save_checkpoint(path, exclude)


@dataclasses.dataclass
class MultiHostArgs:
    """The options this CLI reads itself; ``rest`` goes to the workspace's
    config (``pretrain.build_config``)."""

    coordinator: tp.Optional[str] = None
    num_processes: tp.Optional[int] = None
    process_id: tp.Optional[int] = None
    replay_dir: tp.Optional[str] = None
    relabel: bool = True
    physics_format: str = "native"
    rest: tp.List[str] = dataclasses.field(default_factory=list)


def parse_args(argv: tp.Sequence[str]) -> MultiHostArgs:
    args = MultiHostArgs()
    for arg in argv:
        key, _, val = arg.partition("=")
        if key == "coordinator":
            args.coordinator = val
        elif key == "num_processes":
            args.num_processes = int(val)
        elif key == "process_id":
            args.process_id = int(val)
        elif key == "replay_dir":
            args.replay_dir = val
        elif key == "relabel":
            args.relabel = val.lower() == "true"
        elif key == "physics_format":
            args.physics_format = val
        else:
            args.rest.append(arg)
    return args


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Optional[MultiHostOfflineWorkspace]:
    """Runs the CLI; returns the trained workspace, None after ``--help``."""
    argv = list(argv if argv is not None else sys.argv[1:])
    if wants_help(argv, __doc__):
        return None
    args = parse_args(argv)
    cfg, agent_overrides, agent_cfg_base = build_config(args.rest)
    joined = multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                                  device=cfg.device)
    try:
        return _run(cfg, agent_overrides, agent_cfg_base, args.replay_dir, args.relabel,
                    args.physics_format)
    finally:
        if joined:
            multihost.shutdown()


def _run(cfg: tp.Any, agent_overrides: tp.List[str], agent_cfg_base: tp.Any,
         replay_dir: tp.Optional[str], relabel: bool,
         physics_format: str) -> MultiHostOfflineWorkspace:
    rank, world = multihost.process_index(), multihost.process_count()
    if rank != 0:
        # the other processes log quietly into a folder of their own, so that
        # train.csv and config.json of process 0 are never overwritten
        cfg = dataclasses.replace(cfg, use_console=False,
                                  folder=str(Path(cfg.folder) / f"host_{rank}"))
    ws = MultiHostOfflineWorkspace(cfg, agent_cfg_overrides=agent_overrides,
                                   agent_cfg_base=agent_cfg_base)
    if replay_dir is not None:
        episodes = load_exorl_episodes(Path(replay_dir), shard=rank, num_shards=world,
                                       physics_format=physics_format)
        if physics_format != "native":
            env = make_env(cfg.task, cfg.episode_length)
            episodes = ({**ep, "observation": env.obs_from_physics(ep["physics"]).numpy()}
                        for ep in episodes)
        first = next(episodes, None)
        if first is None:
            raise ValueError(f"no .npz episodes of shard {rank} in {replay_dir}")
        ws.check_data(first)
        ws.buffer.load_episodes(itertools.chain([first], episodes))
        # rewards and goals from the stored physics on the shard's device, as
        # train_offline relabels
        if relabel:
            ws.buffer.relabel(get_reward_function(cfg.task, cfg.seed).from_physics)
        if ws.goal_fn is not None:
            ws.buffer.set_goals(ws.goal_fn)
    ws.train()
    ws.mh_trainer.release()  # its graphs hold the group's collectives
    return ws


if __name__ == "__main__":
    main()
