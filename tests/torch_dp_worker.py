"""One process of the port's data-parallel tests on gloo (not a test module).

    python tests/torch_dp_worker.py RANK WORLD INIT_METHOD DIR

Joins the group, then runs every job whose input ``DIR`` holds and writes
its results into ``DIR/out_<RANK>.pt``:

  * ``updates.pt``: per case, an FB config's overrides, a train state, a
    global batch and the global batch's noise -> the metrics and the train
    state after one ``make_dp_trainer`` update;
  * ``offline.pt``: episodes, a config and a seed -> the train state after
    ``make_dp_offline_trainer`` runs its updates;
  * ``multihost.pt``: the same and the trainer's seed, each process keeping
    its shard of the episodes -> the train state after
    ``MultiHostTrainer.step()``;
  * ``agent_updates.pt``: per case, an agent's name, config, arguments and
    train state, a global batch and the global batch's noise (the agent's
    noise dataclass) -> the metrics and the train state after one
    ``make_dp_trainer`` update;
  * ``online.pt``: an agent, a task and a cycle's sizes -> the metrics, the
    train state and the committed episodes after one
    ``OnlineTrainer(group=)`` cycle, each process stepping its share of the
    environments from a collect generator seeded by its rank.

A job names its agent (``agent``, FBDDPG when absent), its config
overrides (``cfg``) and the agent's arguments (``args``, or ``obs_dim`` and
``action_dim``; ``kwargs``).
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from controllable_agent_torch.agents import AGENTS, UpdateNoise  # noqa: E402
from controllable_agent_torch.data import ReplayBuffer  # noqa: E402
from controllable_agent_torch.data.episode_batch import EpisodeBatch  # noqa: E402
from controllable_agent_torch.parallel import (make_dp_offline_trainer,  # noqa: E402
                                               make_dp_trainer, make_group, multihost)
from controllable_agent_torch.train.loops import OnlineTrainer  # noqa: E402
from controllable_agent_torch.train.workspace import make_env  # noqa: E402


def _agent(job: dict, args: tuple = ()):
    cfg_cls, cls = AGENTS[job.get("agent", "fb_ddpg")]
    args = args or tuple(job.get("args", (job.get("obs_dim"), job.get("action_dim"))))
    kwargs = {"device": "cpu", "seed": job.get("seed", 0), **job.get("kwargs", {})}
    agent = cls(cfg_cls(**job["cfg"]), *args, **kwargs)
    if "state" in job:
        agent.load_train_state(job["state"])
    return agent


def _replay(episodes: list, max_episodes: int) -> ReplayBuffer:
    buffer = ReplayBuffer(max_episodes=max_episodes, discount=0.98, future=0.99, device="cpu")
    buffer.load_episodes(episodes)
    return buffer


def main(rank: int, world: int, init_method: str, folder: Path) -> None:
    torch.set_num_threads(1)
    multihost.initialize(init_method, world, rank, device="cpu")
    group = make_group()
    out: dict = {}
    try:
        if (folder / "updates.pt").exists():
            cases = torch.load(folder / "updates.pt", weights_only=False)
            out["updates"] = {}
            for name, job in cases.items():
                agent = _agent(job)
                metrics = make_dp_trainer(agent, group)(EpisodeBatch(**job["batch"]),
                                                        UpdateNoise(**job["noise"]))
                out["updates"][name] = {"metrics": metrics,
                                        "state": dict(agent.train_state())}
        if (folder / "offline.pt").exists():
            job = torch.load(folder / "offline.pt", weights_only=False)
            agent = _agent(job)
            buffer = _replay(job["episodes"], len(job["episodes"]))
            trainer = make_dp_offline_trainer(agent, buffer.cfg, job["cfg"]["batch_size"],
                                              job["steps"], group)
            metrics = trainer(buffer.state, torch.Generator().manual_seed(job["seed"]))
            out["offline"] = {"metrics": metrics, "state": dict(agent.train_state())}
        if (folder / "multihost.pt").exists():
            job = torch.load(folder / "multihost.pt", weights_only=False)
            agent = _agent(job)
            shard = job["episodes"][rank::world]
            buffer = _replay(shard, len(shard))
            trainer = multihost.MultiHostTrainer(agent, buffer, job["cfg"]["batch_size"],
                                                 job["steps"], seed=job["trainer_seed"])
            metrics = trainer.step()
            out["multihost"] = {"metrics": metrics, "state": dict(agent.train_state())}
        if (folder / "agent_updates.pt").exists():
            cases = torch.load(folder / "agent_updates.pt", weights_only=False)
            out["agent_updates"] = {}
            for name, job in cases.items():
                agent = _agent(job)
                metrics = make_dp_trainer(agent, group)(job["batch"], job["noise"])
                out["agent_updates"][name] = {"metrics": metrics,
                                              "state": dict(agent.train_state())}
        if (folder / "online.pt").exists():
            job = torch.load(folder / "online.pt", weights_only=False)
            env = make_env(job["task"], job["episode_length"])
            agent = _agent(job, (env.spec.obs_dim, env.spec.n_actions or env.spec.action_dim))
            buffer = ReplayBuffer(max_episodes=job["num_envs"], discount=0.98, future=0.99,
                                  max_episode_length=job["episode_length"], device="cpu")
            trainer = OnlineTrainer(env, agent, buffer, num_envs=job["num_envs"],
                                    updates_per_step=job["updates_per_step"], group=group)
            seed = job["generator_seed"]
            metrics = trainer.run_cycle(torch.Generator().manual_seed(seed),
                                        torch.Generator().manual_seed(seed + 1 + rank))
            out["online"] = {"metrics": metrics, "state": dict(agent.train_state()),
                             "storage": dict(buffer.state.storage), "episodes": len(buffer),
                             "updates": trainer.timings["updates"]}
    finally:
        multihost.shutdown()
    torch.save(out, folder / f"out_{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
