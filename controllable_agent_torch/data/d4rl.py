"""D4RL offline datasets (mirror of ``controllable_agent_tpu/data/d4rl.py``).

A d4rl dataset is a dict of arrays:

    observations [N, obs_dim], actions [N, act_dim], rewards [N],
    terminals [N] (environment termination), timeouts [N] (time limit).

``d4rl_to_episodes`` cuts it into replay-format episodes: an episode ends
where ``terminals | timeouts`` fires; row t carries ``observations[t]`` with
the action and reward leading into it (``actions[t-1]``, ``rewards[t-1]``);
the last transition's discount is 0 on a termination and 1 on a timeout;
the reward of an episode's last dataset row is dropped; the physics is a
zero column (d4rl has no simulator state). ``normalized_score`` is d4rl's
``get_normalized_score`` from the published reference scores.

Numpy only, on the host, like the JAX module; the port keeps its own copy.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np


@dataclasses.dataclass
class D4RLConfig:
    minimum_episode_length: tp.Optional[int] = None
    ignore_terminals: bool = False


def filter_dataset_by_episode_length(
        dataset: tp.Dict[str, np.ndarray],
        minimum_episode_length: tp.Optional[int]) -> tp.Dict[str, np.ndarray]:
    """Drop the rows of episodes shorter than the minimum; trailing rows that
    belong to no completed episode are dropped too."""
    if minimum_episode_length is None or minimum_episode_length <= 1:
        return dataset
    end_indices = (dataset["terminals"].astype(bool)
                   | dataset["timeouts"].astype(bool)).nonzero()[0]
    episode_lengths = np.diff(np.concatenate(([-1], end_indices)))
    expanded = episode_lengths.repeat(episode_lengths)
    diff_len = dataset["observations"].shape[0] - len(expanded)
    assert diff_len >= 0
    expanded = np.concatenate((expanded, np.zeros(diff_len, dtype=int)))
    keep = expanded >= minimum_episode_length
    n = len(dataset["observations"])
    return {k: (v[keep] if isinstance(v, np.ndarray) and len(v) == n else v)
            for k, v in dataset.items()}


def d4rl_to_episodes(dataset: tp.Dict[str, np.ndarray],
                     cfg: tp.Optional[D4RLConfig] = None
                     ) -> tp.Iterator[tp.Dict[str, np.ndarray]]:
    """Replay-format episode dicts ([T+1, ...]; row 0 is the dummy first
    transition) of a d4rl dataset dict."""
    cfg = cfg or D4RLConfig()
    dataset = filter_dataset_by_episode_length(dataset, cfg.minimum_episode_length)
    obs = np.asarray(dataset["observations"], np.float32)
    actions = np.asarray(dataset["actions"], np.float32)
    rewards = np.asarray(dataset["rewards"], np.float32).reshape(-1)
    terminals = np.asarray(dataset["terminals"], bool)
    if cfg.ignore_terminals:
        terminals = np.zeros_like(terminals)
    timeouts = np.asarray(dataset["timeouts"], bool)
    end_indices = (terminals | timeouts).nonzero()[0]

    start = 0
    for end in end_indices:
        length = end - start + 1  # dataset rows in this episode
        if length < 2:  # a 1-row episode has no transition
            start = end + 1
            continue
        ep_action = np.concatenate([np.zeros_like(actions[start:start + 1]),
                                    actions[start:end]])
        ep_reward = np.concatenate([np.zeros(1, np.float32), rewards[start:end]])[:, None]
        ep_discount = np.ones((length, 1), np.float32)
        if terminals[end]:
            ep_discount[-1] = 0.0
        yield {
            "observation": obs[start:end + 1],
            "action": ep_action,
            "reward": ep_reward,
            "discount": ep_discount,
            "physics": np.zeros((length, 1), np.float32),
        }
        start = end + 1


def load_d4rl_dataset(buffer: tp.Any, dataset: tp.Dict[str, np.ndarray],
                      cfg: tp.Optional[D4RLConfig] = None) -> int:
    """Load a d4rl dataset dict into a ``ReplayBuffer`` (one transfer per
    array into an empty buffer); returns the number of episodes in the
    dataset. The buffer keeps the last ``max_episodes`` of them, as its ring
    would after one commit per episode."""
    episodes = list(d4rl_to_episodes(dataset, cfg))
    buffer.load_episodes(episodes[-buffer.max_episodes:])
    return len(episodes)


# published d4rl v2 reference scores (d4rl/infos.py):
# normalized = 100 * (score - random) / (expert - random)
REF_SCORES: tp.Dict[str, tp.Tuple[float, float]] = {
    "halfcheetah": (-280.178953, 12135.0),
    "hopper": (-20.272305, 3234.3),
    "walker2d": (1.629008, 4592.3),
    "ant": (-325.6, 3879.7),
    "pen": (96.262799, 3076.8331017826813),
    "door": (-56.512833, 2880.5693087298737),
    "hammer": (-274.856578, 12794.134825156867),
    "relocate": (-6.425911, 4233.877797728884),
}


def normalized_score(domain: str, total_reward: float,
                     ref_scores: tp.Optional[tp.Dict[str, tp.Tuple[float, float]]] = None
                     ) -> float:
    """100 * (r - random) / (expert - random)."""
    table = ref_scores or REF_SCORES
    if domain not in table:
        raise KeyError(f"No reference scores for {domain!r}; known: {sorted(table)}")
    lo, hi = table[domain]
    return 100.0 * (float(total_reward) - lo) / (hi - lo)
