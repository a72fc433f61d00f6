"""A small offline FB run of the port on the CPU, for the tests of what reads
a run's folder (the demo server, play_behaviors, export_replay, the
orchestration's offline entry point, the port's analysis tools)."""

import typing as tp
from pathlib import Path

import numpy as np
import torch

from controllable_agent_torch import train_offline
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import save_exorl_episodes
from controllable_agent_torch.envs import locomotion

EPISODES, STEPS = 4, 30
SMALL = ["device=cpu", "use_console=false", "save_eval_video=false", "final_tests=0",
         "agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
         "agent.z_dim=8", "agent.batch_size=16", "agent.num_inference_steps=64",
         "z_inference_draws=2", "steps_per_call=5", "log_every_steps=5",
         f"replay_buffer_episodes={EPISODES}", f"episode_length={STEPS}"]


def walker_episodes(n: int = EPISODES, steps: int = STEPS,
                    seed: int = 1) -> tp.List[tp.Dict[str, np.ndarray]]:
    """Walker-shaped ExORL episodes with physics: the torso between lying and
    standing height, joints within a radian, velocities of a few units."""
    rng = np.random.RandomState(seed)
    env = locomotion.make("walker_walk")
    episodes = []
    for _ in range(n):
        q = rng.uniform(-1.0, 1.0, (steps + 1, 9))
        q[:, 1] = rng.uniform(0.6, 1.5, steps + 1)
        physics = np.concatenate([q, rng.randn(steps + 1, 9) * 2], -1).astype(np.float32)
        episodes.append({
            "observation": env.obs_from_physics(torch.from_numpy(physics)).numpy(),
            "action": rng.uniform(-1, 1, (steps + 1, 6)).astype(np.float32),
            "reward": rng.rand(steps + 1, 1).astype(np.float32),
            "discount": np.ones((steps + 1, 1), np.float32), "physics": physics})
    return episodes


def write_episodes(out_dir: Path, episodes: tp.Optional[tp.List] = None) -> Path:
    store = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cpu")
    store.load_episodes(episodes or walker_episodes())
    save_exorl_episodes(store.state, out_dir)
    return out_dir


def small_run(folder: Path, *extra: str, steps: int = 10) -> tp.Any:
    """``train_offline`` on walker episodes relabeled for walker_walk: ``steps``
    updates, an evaluation every 5 with 2 episodes, a checkpoint with the
    replay in ``folder/models/latest``. Returns the workspace."""
    episodes_dir = write_episodes(Path(folder).parent / f"{Path(folder).name}_episodes")
    return train_offline.main([f"replay_dir={episodes_dir}", "task=walker_walk",
                               f"num_grad_steps={steps}", "eval_every_steps=5",
                               "num_eval_episodes=2", f"folder={folder}", *SMALL, *extra])
