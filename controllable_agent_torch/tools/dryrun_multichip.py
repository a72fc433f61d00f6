"""A data-parallel dry run at world size N: the port's analogue of the JAX
package's ``__graft_entry__.dryrun_multichip``.

    python -m controllable_agent_torch.tools.dryrun_multichip 2 device=cpu
    python -m controllable_agent_torch.tools.dryrun_multichip 4 agent=proto

It starts N processes joined by ``torch.distributed`` (gloo with
``device=cpu``, NCCL with one card per process, the default), rendezvous
through a file in a fresh temporary folder. Each process runs one
data-parallel update (``make_dp_trainer``) of a small agent of ``agent=``
(any name of ``agents.AGENTS``, ``fb_ddpg`` by default) on a fixed batch,
then one ``OnlineTrainer`` cycle with the group on the point-mass maze (the
gridworld for a discrete agent; each process steps its share of the
environments, every process commits all episodes, the updates are
data-parallel). It checks that the metrics are finite and that every
process ends with the same parameters, prints one line per process, and
exits 0 when all passed. A process that does not finish within
``timeout=`` seconds (240 by default) fails the run, and every process is
stopped.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import typing as tp
from pathlib import Path

import numpy as np
import torch

OBS_DIM, ACTION_DIM = 24, 6
WORKER_MODULE = "controllable_agent_torch.tools.dryrun_multichip"


GOAL_AGENTS = ("goal_td3", "goal_sm")  # they learn on the maze's goal space
MAZE_GOAL_SPACE = "simplified_point_mass_maze"


def _small_agent(name: str, obs_dim: int, actions: int, device: tp.Any, seed: int,
                 batch_size: int, **overrides: tp.Any) -> tp.Any:
    """A small agent of ``name`` (the widths its config has cut down);
    ``actions`` is the action width, or the number of actions of a discrete
    agent."""
    from controllable_agent_torch.agents import AGENTS
    cfg_cls, cls = AGENTS[name]
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    small = {k: v for k, v in dict(hidden_dim=64, backward_hidden_dim=64, feature_dim=32,
                                   z_dim=16).items() if k in fields}
    goal_dim = None
    if name in GOAL_AGENTS:
        small["goal_space"], goal_dim = MAZE_GOAL_SPACE, 2
    cfg = cfg_cls(**small, batch_size=batch_size, **overrides)
    return cls(cfg, obs_dim, actions, goal_dim=goal_dim, device=device, seed=seed)


def worker(rank: int, world: int, init_method: str, device: str,
           agent_name: str = "fb_ddpg") -> str:
    """One process of the dry run; returns its report line."""
    from controllable_agent_torch.data import ReplayBuffer
    from controllable_agent_torch.data.episode_batch import EpisodeBatch
    from controllable_agent_torch.envs.pointmass import PointMassMaze
    from controllable_agent_torch.goals.spaces import simplified_point_mass_maze
    from controllable_agent_torch.parallel import make_dp_trainer, make_group, multihost
    from controllable_agent_torch.train.loops import OnlineTrainer, init_meta_batched
    from controllable_agent_torch.train.workspace import make_env
    from controllable_agent_torch.utils.dist import Shard

    def progress(what: str) -> None:
        print(f"rank {rank}: {what}", flush=True)

    torch.set_num_threads(1)
    multihost.initialize(init_method, world, rank, device=device)
    progress("joined the group")
    try:
        dev = torch.device("cuda") if device == "cuda" else torch.device(device)
        group = make_group()
        batch_size = max(16, 2 * world)
        discrete = agent_name.startswith("discrete_")
        actions = 5 if discrete else ACTION_DIM
        overrides = dict(mix_ratio=0.5, future_ratio=0.2) if agent_name == "fb_ddpg" else {}
        agent = _small_agent(agent_name, OBS_DIM, actions, dev, 0, batch_size, **overrides)
        rng = np.random.RandomState(0)

        def rows(*shape: int, uniform: bool = False) -> torch.Tensor:
            x = rng.uniform(-1, 1, shape) if uniform else rng.randn(*shape)
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        action = (torch.as_tensor(rng.randint(0, actions, (batch_size, 1)), dtype=torch.float32,
                                  device=dev)
                  if discrete else rows(batch_size, ACTION_DIM, uniform=True))
        goal_dim = getattr(agent, "goal_dim", OBS_DIM)
        generator = torch.Generator(device=dev).manual_seed(1)
        # the meta columns the agent's update reads (a skill, a task, a z, a goal)
        meta = init_meta_batched(agent, generator, batch_size)
        batch = EpisodeBatch(obs=rows(batch_size, OBS_DIM), action=action,
                             reward=rows(batch_size, 1), next_obs=rows(batch_size, OBS_DIM),
                             discount=torch.full((batch_size, 1), 0.98, device=dev),
                             future_obs=rows(batch_size, OBS_DIM), meta=meta,
                             goal=rows(batch_size, goal_dim),
                             next_goal=rows(batch_size, goal_dim),
                             future_goal=rows(batch_size, goal_dim))
        metrics = make_dp_trainer(agent, group)(batch, generator)
        metric = "fb_loss" if "fb_loss" in metrics else sorted(
            k for k in metrics if k.endswith("loss"))[0]
        loss = float(metrics[metric])
        progress("took the data-parallel update")

        if discrete:
            env = make_env("grid_simple", 8)
            actions = env.spec.n_actions
        else:
            env = PointMassMaze("reach_top_left", episode_length=8)
            actions = env.spec.action_dim
        agent2 = _small_agent(agent_name, env.spec.obs_dim, actions, dev, 2, batch_size)
        goal_fn = simplified_point_mass_maze if agent_name in GOAL_AGENTS else None
        buffer = ReplayBuffer(max_episodes=2 * world, discount=0.98, future=0.99, device=dev)
        trainer = OnlineTrainer(env, agent2, buffer, num_envs=world, updates_per_step=0.25,
                                goal_fn=goal_fn, group=group)
        collect = torch.Generator(device=dev).manual_seed(3 + rank)
        cycle = trainer.run_cycle(torch.Generator(device=dev).manual_seed(4), collect)
        trainer.trainer.release()  # its graphs hold the group's collectives
        progress("ran the online cycle")

        flat = torch.cat([p.detach().reshape(-1).float() for a in (agent, agent2)
                          for p in a.parameters()])
        every = Shard(group).gather(flat[None])
        same = bool((every == flat).all())
        ok = (np.isfinite(loss) and np.isfinite(cycle["episode_reward"])
              and metric in cycle and len(buffer) == world and same)
        return (f"rank {rank} of {world}: {agent_name} {metric} {loss:.6f}, cycle "
                f"episode_reward {cycle['episode_reward']:.6f}, "
                f"{cycle.get(metric, float('nan')):.6f} {metric}, {len(buffer)} episodes "
                f"committed, parameters equal on every process: {same} -> "
                f"{'ok' if ok else 'FAILED'}")
    finally:
        multihost.shutdown()


def spawn(module: str, world: int, args: tp.Callable[[int, str], tp.Sequence[str]],
          timeout: float, what: str) -> tp.List[tp.Tuple[int, str]]:
    """``python -m module *args(rank, init_method)`` in ``world`` processes
    that join through a file in a fresh temporary folder (``init_method``);
    each process's exit code and output, in rank order. If a process does
    not finish within ``timeout`` seconds, every process is stopped and it
    raises with what each said (``what`` names the run)."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [subprocess.Popen([sys.executable, "-m", module, *args(rank, init)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=env) for rank in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            said = "\n".join(f"--- process {rank}:\n{p.communicate()[0][-3000:]}"
                             for rank, p in enumerate(procs))
            raise RuntimeError(f"a process of {what} did not finish in {timeout} s; "
                               f"what each said:\n{said}") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def run(world: int, device: str = "cuda", timeout: float = 240.0,
        agent: str = "fb_ddpg") -> tp.List[str]:
    """The dry run of ``agent`` at ``world`` processes; their report lines,
    in rank order. Raises if a process fails or does not finish in
    ``timeout`` seconds."""
    results = spawn(WORKER_MODULE, world,
                    lambda rank, init: ["--worker", str(rank), str(world), init, device, agent],
                    timeout, "the dry run")
    lines = []
    for rank, (code, out) in enumerate(results):
        report = [line for line in out.splitlines() if line.startswith(f"rank {rank} of")]
        if code != 0 or not report or not report[-1].endswith("ok"):
            raise RuntimeError(f"process {rank} of the dry run failed:\n{out[-4000:]}")
        lines.append(report[-1])
    return lines


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if args and args[0] == "--worker":
        print(worker(int(args[1]), int(args[2]), args[3], args[4], args[5]), flush=True)
        return 0
    world = int(args[0]) if args else 2
    options = dict(a.split("=", 1) for a in args[1:])
    device = options.get("device", "cuda")
    agent = options.get("agent", "fb_ddpg")
    from controllable_agent_torch.agents import agent_classes
    agent_classes(agent)  # an unknown name raises with the known ones
    if device == "cuda" and torch.cuda.device_count() < world:
        print(f"dryrun_multichip: {world} processes need {world} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    for line in run(world, device, float(options.get("timeout", 240)), agent):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
