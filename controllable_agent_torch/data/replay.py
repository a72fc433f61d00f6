"""Device-resident episodic replay buffer (mirror of
``controllable_agent_tpu/data/replay.py``).

Episode-granular ring storage ``[max_episodes, T+1, ...]`` on the device,
length-weighted episode draws, steps uniform in [1, len], a geometric future
step clipped to the episode end, and n-step returns. Index 0 in time is the
dummy first transition, so ``action[t]`` is the action leading into
``obs[t]``.

Randomness comes from an explicit ``torch.Generator`` on the storage's
device. The counters ``n_episodes`` and ``idx`` are host integers: the
port's loops run on the host, and keeping them there costs no device sync.
"""

from __future__ import annotations

import dataclasses
import itertools
import typing as tp

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .episode_batch import EpisodeBatch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Static sampling knobs (discount, future horizon, n-step)."""

    discount: float = 0.99
    future: float = 0.99
    # n-step: reward = sum_i prod_{j<i}(d_j*gamma) r_{t+i}, discount =
    # prod_i (d_i*gamma), next_obs at t+nstep-1; start steps are sampled
    # so the whole window fits inside the episode
    nstep: int = 1


@dataclasses.dataclass
class ReplayState:
    """Preallocated episode storage: storage[name] is [max_episodes, T+1, ...];
    ep_lengths[i] is the number of real transitions of episode i."""

    storage: tp.Dict[str, Tensor]
    ep_lengths: Tensor  # [max_episodes] int64
    n_episodes: int
    idx: int
    max_episodes: int
    max_episode_length: int


def init_replay_state(specs: tp.Dict[str, tp.Tuple[tp.Tuple[int, ...], torch.dtype]],
                      max_episodes: int, max_episode_length: int,
                      device: DeviceLike = None) -> ReplayState:
    """specs: name -> (per-step shape, dtype). Time axis is T+1."""
    dev = resolve_device(device)
    storage = {
        name: torch.zeros((max_episodes, max_episode_length + 1) + tuple(shape),
                          dtype=dtype, device=dev)
        for name, (shape, dtype) in specs.items()}
    return ReplayState(storage=storage,
                       ep_lengths=torch.zeros(max_episodes, dtype=torch.int64, device=dev),
                       n_episodes=0, idx=0, max_episodes=max_episodes,
                       max_episode_length=max_episode_length)


def add_episode(state: ReplayState, episode: tp.Dict[str, Tensor],
                length: int) -> None:
    """Commit one episode (arrays [t, ...], t <= T+1) at the ring slot, in
    place; steps past the episode's end are zeroed."""
    for name, values in episode.items():
        dst = state.storage[name]
        if values.shape[0] > dst.shape[1]:
            raise ValueError(
                f"episode for {name!r} has {values.shape[0]} steps but the "
                f"buffer was sized for {dst.shape[1]} (max_episode_length="
                f"{state.max_episode_length})")
        dst[state.idx].zero_()
        dst[state.idx, :values.shape[0]] = values.to(dst.device, dst.dtype)
    state.ep_lengths[state.idx] = length
    state.n_episodes = min(state.n_episodes + 1, state.max_episodes)
    state.idx = (state.idx + 1) % state.max_episodes


def _sample_indices(state: ReplayState, generator: torch.Generator,
                    batch_size: int, future: float, nstep: int = 1
                    ) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Draw (episode, step, future-step) indices: episodes with probability
    proportional to length, steps uniform in [1, len - nstep + 1], future
    step = step + Geom(1 - future), clipped to the episode end."""
    dev = state.ep_lengths.device
    weights = state.ep_lengths[:state.n_episodes].float()
    ep_idx = torch.multinomial(weights, batch_size, replacement=True,
                               generator=generator)
    lengths = state.ep_lengths[ep_idx]
    u = torch.rand(batch_size, device=dev, generator=generator)
    n_starts = (lengths - (nstep - 1)).clamp_min(1)
    step_idx = (u * n_starts.float()).long() + 1
    if future < 1.0:
        g = torch.rand(batch_size, device=dev, generator=generator)
        g = g * (1.0 - 1e-10) + 1e-10  # uniform in [1e-10, 1)
        geom = torch.floor(torch.log(g) / np.log(future)).long() + 1
        future_idx = torch.minimum((step_idx + geom).clamp_min(0), lengths)
    else:
        future_idx = step_idx
    return ep_idx, step_idx, future_idx


def sample(state: ReplayState, generator: torch.Generator, batch_size: int,
           cfg: SampleConfig, with_physics: bool = False,
           with_future: bool = True) -> EpisodeBatch:
    """Batched gather on the storage's device."""
    ep_idx, step_idx, future_idx = _sample_indices(
        state, generator, batch_size, cfg.future, cfg.nstep)
    s = state.storage

    def at(name: str, t: Tensor) -> Tensor:
        return s[name][ep_idx, t]

    if cfg.nstep > 1:
        reward = torch.zeros_like(at("reward", step_idx))
        running = torch.ones_like(reward)
        for i in range(cfg.nstep):
            reward = reward + running * at("reward", step_idx + i)
            running = running * at("discount", step_idx + i) * cfg.discount
        discount = running
        next_t = step_idx + cfg.nstep - 1
    else:
        reward = at("reward", step_idx)
        discount = cfg.discount * at("discount", step_idx)
        next_t = step_idx

    batch_names = {"observation", "action", "reward", "discount", "goal",
                   "physics", "step_type"}
    has_goal = "goal" in s
    want_future = with_future and cfg.future < 1
    return EpisodeBatch(
        obs=at("observation", step_idx - 1),
        action=at("action", step_idx),
        reward=reward,
        discount=discount,
        next_obs=at("observation", next_t),
        goal=at("goal", step_idx - 1) if has_goal else None,
        next_goal=at("goal", next_t) if has_goal else None,
        future_obs=at("observation", future_idx - 1) if want_future else None,
        future_goal=at("goal", future_idx - 1) if (has_goal and want_future) else None,
        physics=at("physics", step_idx) if (with_physics and "physics" in s) else None,
        meta={name: at(name, step_idx - 1) for name in s if name not in batch_names},
    )


class ReplayBuffer:
    """Host-side wrapper: episode commits, bulk loading and sampling.

    ``relabel`` and ``set_goals`` of the JAX buffer are not ported yet (they
    need the reward zoo).
    """

    def __init__(self, max_episodes: int, discount: float, future: float,
                 max_episode_length: tp.Optional[int] = None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self._max_episodes = max_episodes
        self.cfg = SampleConfig(discount=discount, future=future)
        self._max_episode_length = max_episode_length
        self.state: tp.Optional[ReplayState] = None

    def __len__(self) -> int:
        return 0 if self.state is None else self.state.n_episodes

    def _ensure_state(self, episode: tp.Dict[str, np.ndarray]) -> None:
        if self.state is not None:
            return
        length = self._max_episode_length
        if length is None:
            length = next(iter(episode.values())).shape[0] - 1
        specs = {name: (tuple(v.shape[1:]), torch.from_numpy(np.asarray(v)[:0]).dtype)
                 for name, v in episode.items()}
        self.state = init_replay_state(specs, self._max_episodes, length, self.device)

    def add_episode(self, episode: tp.Dict[str, np.ndarray]) -> None:
        self._ensure_state(episode)
        assert self.state is not None
        length = next(iter(episode.values())).shape[0] - 1
        add_episode(self.state, {k: torch.from_numpy(np.asarray(v))
                                 for k, v in episode.items()}, length)

    def sample(self, generator: torch.Generator, batch_size: int,
               with_physics: bool = False) -> EpisodeBatch:
        assert self.state is not None, "empty replay buffer"
        return sample(self.state, generator, batch_size, self.cfg,
                      with_physics=with_physics)

    def load_episodes(self, episodes: tp.Iterable[tp.Dict[str, np.ndarray]]) -> None:
        """Bulk ingest (ExORL-style episode dicts of [T+1, ...] arrays).

        Into an EMPTY buffer the whole storage is assembled on the host and
        moved in one transfer per array; a non-empty buffer takes the
        per-episode ring path.
        """
        it = iter(episodes)
        if self.state is not None and len(self) > 0:
            for episode in it:
                if len(self) >= self._max_episodes:
                    break
                self.add_episode(episode)
            return
        first = next(it, None)
        if first is None:
            return
        length = self._max_episode_length
        if length is None:
            length = next(iter(first.values())).shape[0] - 1
        storage = {name: np.zeros((self._max_episodes, length + 1) + tuple(v.shape[1:]),
                                  v.dtype)
                   for name, v in first.items()}
        lengths = np.zeros((self._max_episodes,), np.int64)
        n = 0
        for episode in itertools.chain([first], it):
            if n >= self._max_episodes:
                break
            t = next(iter(episode.values())).shape[0]
            if t > length + 1:
                raise ValueError(
                    f"episode has {t - 1} steps but the buffer was sized "
                    f"for {length} (max_episode_length)")
            for name, v in episode.items():
                storage[name][n, :t] = v
            lengths[n] = t - 1
            n += 1
        self.state = ReplayState(
            storage={k: torch.from_numpy(v).to(self.device) for k, v in storage.items()},
            ep_lengths=torch.from_numpy(lengths).to(self.device),
            n_episodes=n, idx=n % self._max_episodes,
            max_episodes=self._max_episodes, max_episode_length=length)
