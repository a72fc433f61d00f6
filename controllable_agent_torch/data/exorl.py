"""ExORL-format episode files (mirror of ``controllable_agent_tpu/data/exorl.py``).

One ``.npz`` per episode with keys observation, action, reward, discount
(and physics), arrays [T+1, ...]. Only the ``native`` physics format is
ported; the foreign-physics adapters (``mujoco_*``) wait for the reward and
physics side of the port (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np

from .replay import ReplayState

PHYSICS_FORMATS = ("native",)


def load_episode(fn: Path) -> tp.Dict[str, np.ndarray]:
    with fn.open("rb") as f:
        episode = np.load(f)
        return {k: episode[k].astype(np.float32) for k in episode.keys()}


def load_exorl_episodes(replay_dir: Path, limit: tp.Optional[int] = None,
                        shard: int = 0, num_shards: int = 1,
                        physics_format: str = "native",
                        ) -> tp.Iterator[tp.Dict[str, np.ndarray]]:
    """Yield episodes in file-name order. ``limit`` is a global cap applied
    before ``shard``/``num_shards`` round-robin the files."""
    if physics_format not in PHYSICS_FORMATS:
        raise NotImplementedError(
            f"physics_format={physics_format!r}: the foreign-physics adapters "
            "are not ported yet (ROADMAP Queue A item 7); known: "
            f"{list(PHYSICS_FORMATS)}")
    eps_fns = sorted(Path(replay_dir).glob("*.npz"))
    if limit is not None:
        eps_fns = eps_fns[:limit]
    if num_shards > 1:
        eps_fns = eps_fns[shard::num_shards]
    for fn in eps_fns:
        yield load_episode(fn)


def synthetic_episodes(n_episodes: int, length: int, obs_dim: int,
                       action_dim: int, seed: int = 0
                       ) -> tp.List[tp.Dict[str, np.ndarray]]:
    """Random episodes in the ExORL layout (the JAX bench's synthetic data,
    ``bench.py:42-52``): normal observations, uniform actions in [-1, 1],
    uniform rewards in [0, 1), discount 1."""
    rng = np.random.RandomState(seed)
    t = length + 1
    return [{"observation": rng.randn(t, obs_dim).astype(np.float32),
             "action": rng.uniform(-1, 1, (t, action_dim)).astype(np.float32),
             "reward": rng.rand(t, 1).astype(np.float32),
             "discount": np.ones((t, 1), np.float32)} for _ in range(n_episodes)]


def save_exorl_episodes(replay_state: ReplayState, out_dir: Path) -> int:
    """Write a ReplayState's committed episodes as ExORL-format ``.npz`` files
    (one per episode, padding past each episode's length trimmed). Returns
    the number of episodes written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    storage = {k: v.cpu().numpy() for k, v in replay_state.storage.items()}
    lengths = replay_state.ep_lengths.cpu().numpy()
    n = replay_state.n_episodes
    for i in range(n):
        t = int(lengths[i]) + 1
        np.savez(out_dir / f"episode_{i:06d}_{t - 1}.npz",
                 **{k: v[i, :t] for k, v in storage.items()})
    return n
