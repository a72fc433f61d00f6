"""D4RL replay environment (mirror of ``controllable_agent_tpu/envs/d4rl_replay.py``).

The d4rl/gym stack is not installed, so, as in the JAX package, a ``d4rl_*``
task is the environment interface over the converted dataset
(``data/d4rl.py``): ``reset`` picks a stored episode for each environment,
``step`` replays its next transition (the action cannot change the replay)
and ``get_normalized_score`` applies d4rl's reference scores. This scores
the dataset's behaviour policy through the whole d4rl wiring: the task
dispatch, the evaluation loop and the ``normalized_score`` column of
``eval.csv``.

Batched like every environment of the port (``[E, ...]``): the padded
``[episodes, T+1, ...]`` arrays are tensors on the device the environment
was built for, the state is each environment's episode and row, and
``step`` only indexes those arrays with device tensors, so a rollout
captures one control step and replays it.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from ..data.d4rl import D4RLConfig, d4rl_to_episodes, normalized_score
from ..utils.device import DeviceLike, resolve_device
from .base import Environment, EnvSpec, StepType, TimeStep

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class D4RLReplayState:
    episode: Tensor  # [E] int64: which stored episode each environment replays
    t: Tensor  # [E] int64: the row within it


class D4RLReplayEnv(Environment):
    """Converted d4rl episodes replayed through the Environment API."""

    def __init__(self, domain: str, observations: np.ndarray, actions: np.ndarray,
                 rewards: np.ndarray, discounts: np.ndarray, lengths: np.ndarray,
                 device: DeviceLike = None) -> None:
        # padded [episodes, T+1, ...] arrays; lengths[e] = transitions in episode e
        self.domain = domain
        self.device = resolve_device(device)

        def placed(x: np.ndarray, dtype: torch.dtype = torch.float32) -> Tensor:
            return torch.as_tensor(np.asarray(x)).to(self.device, dtype)

        self._obs = placed(observations)
        self._actions = placed(actions)
        self._rewards = placed(rewards)[..., 0]
        self._discounts = placed(discounts)[..., 0]
        self._lengths = placed(lengths, torch.int64)
        self._physics = torch.zeros(1, device=self.device)
        self.spec = EnvSpec(obs_dim=int(observations.shape[-1]),
                            action_dim=int(actions.shape[-1]),
                            physics_dim=1,  # d4rl has no simulator state
                            episode_length=int(observations.shape[1] - 1))

    @property
    def num_episodes(self) -> int:
        return int(self._lengths.shape[0])

    @classmethod
    def from_dataset(cls, domain: str, dataset: tp.Dict[str, np.ndarray],
                     cfg: tp.Optional[D4RLConfig] = None,
                     device: DeviceLike = None) -> "D4RLReplayEnv":
        episodes = list(d4rl_to_episodes(dataset, cfg))
        if not episodes:
            raise ValueError("dataset contains no complete episodes")
        max_t = max(ep["observation"].shape[0] for ep in episodes)

        def padded(name: str) -> np.ndarray:
            first = episodes[0][name]
            out = np.zeros((len(episodes), max_t) + first.shape[1:], first.dtype)
            for i, ep in enumerate(episodes):
                out[i, :len(ep[name])] = ep[name]
            return out

        lengths = np.array([ep["observation"].shape[0] - 1 for ep in episodes])
        return cls(domain, padded("observation"), padded("action"), padded("reward"),
                   padded("discount"), lengths, device=device)

    @classmethod
    def from_npz(cls, domain: str, path: str, cfg: tp.Optional[D4RLConfig] = None,
                 device: DeviceLike = None) -> "D4RLReplayEnv":
        with np.load(path) as data:
            dataset = {k: data[k] for k in data.files}
        return cls.from_dataset(domain, dataset, cfg, device=device)

    def get_normalized_score(self, total_reward: float) -> float:
        return normalized_score(self.domain, total_reward)

    def episode_returns(self, episodes: Tensor) -> Tensor:
        """The stored return of each of ``episodes``: the rewards of rows 1 to
        its length (what a replay of the whole episode sums)."""
        return self._rewards[episodes, 1:].sum(-1)

    # -- Environment API -------------------------------------------------
    def _timestep(self, state: D4RLReplayState, first: bool) -> TimeStep:
        e, t = state.episode, state.t
        length = self._lengths[e]
        row = torch.minimum(t, length)
        if first:
            step_type = torch.full_like(t, StepType.FIRST)
        else:
            step_type = torch.where(t >= length, StepType.LAST, StepType.MID)
        reward = self._rewards[e, row]
        reward = torch.zeros_like(reward) if first else torch.where(t > length, 0.0, reward)
        return TimeStep(
            step_type=step_type.to(torch.int32), reward=reward,
            discount=self._discounts[e, row], observation=self._obs[e, row],
            action=self._actions[e, row], physics=self._physics.expand(t.shape[0], 1))

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> tp.Tuple[D4RLReplayState, TimeStep]:
        return self.reset_from_uniform(
            torch.rand(num_envs, generator=generator, device=generator.device))

    def reset_from_uniform(self, u: Tensor) -> tp.Tuple[D4RLReplayState, TimeStep]:
        """``reset`` with its [0, 1) draws ``u`` [E] handed in: environment i
        replays stored episode floor(u[i] * episodes)."""
        u = u.to(self.device)
        episode = (u * self.num_episodes).long().clamp_max(self.num_episodes - 1)
        state = D4RLReplayState(episode=episode, t=torch.zeros_like(episode))
        return state, self._timestep(state, first=True)

    def step(self, state: D4RLReplayState, action: Tensor
             ) -> tp.Tuple[D4RLReplayState, TimeStep]:
        del action  # a replay: the dataset's transitions are fixed
        new_state = D4RLReplayState(episode=state.episode, t=state.t + 1)
        return new_state, self._timestep(new_state, first=False)
