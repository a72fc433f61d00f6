"""Exploration agents: DDPG trained on an intrinsic reward (mirror of
``controllable_agent_tpu/agents/exploration.py``).

``IntrinsicDDPGAgent`` is the shared update: the auxiliary module's loss and
Adam step, the intrinsic reward from the updated module, then the DDPG
update on that reward with ``use_reward_model=False`` (the batch already
carries the agent's reward). ``RNDAgent`` is the explorer that makes the
offline recipe's buffers: a predictor trained against a frozen random
target, reward = prediction error over its running standard deviation.
The running statistics live on the device and advance inside a captured
update. The other agents of the JAX module (DIAYN, ICM, ICM-APT,
Disagreement, MaxEnt) are ROADMAP Queue A item 13.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import MLP, _Net
from ..ops.pbe import RMSState, rms_update
from ..optim import Adam
from ..utils.device import DeviceLike
from .base import MetaDict, StepNoise, load_train_state
from .ddpg import DDPGAgent, DDPGConfig, DDPGNoise

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class IntrinsicConfig(DDPGConfig):
    reward_free: bool = True  # train on the intrinsic reward
    goal_space: tp.Optional[str] = None
    knn_rms: bool = True
    knn_k: int = 12
    knn_avg: bool = True
    knn_clip: float = 0.0001


class IntrinsicDDPGAgent(nn.Module):
    """DDPG plus an auxiliary module and an intrinsic reward. Subclasses
    define ``_make_module``, ``_module_loss`` and ``_intrinsic_reward``."""

    meta_dim: int = 0

    def __init__(self, cfg: IntrinsicConfig, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.goal_dim = goal_dim if goal_dim is not None else obs_dim
        # the DDPG agent holds no reward model: the intrinsic reward takes its place
        self.ddpg = DDPGAgent(dataclasses.replace(cfg, reward_free=False), obs_dim,
                              action_dim, device=device, seed=seed, meta_dim=self.meta_dim)
        self.device = self.ddpg.device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + 1)
            self.module = self._make_module()
        self.module_opt: tp.Optional[Adam] = None
        if self.module is not None:
            self.module.to(self.device)
            self.module_opt = Adam(self.module, cfg.lr)
        rms = RMSState.create(device=self.device)
        for name in ("mean", "var", "n"):
            self.register_buffer(f"rms_{name}", getattr(rms, name))

    # -- subclass hooks --------------------------------------------------
    def _make_module(self) -> tp.Optional[nn.Module]:
        return None

    def _module_loss(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor
                     ) -> tp.Tuple[Tensor, Metrics]:
        raise NotImplementedError

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState) -> tp.Tuple[Tensor, RMSState]:
        raise NotImplementedError

    # -- state -----------------------------------------------------------
    @property
    def step(self) -> int:
        return self.ddpg.step

    @step.setter
    def step(self, value: int) -> None:
        self.ddpg.step = value

    @property
    def rms(self) -> RMSState:
        return RMSState(mean=self.rms_mean, var=self.rms_var, n=self.rms_n)

    def train_state(self) -> tp.Dict[str, Tensor]:
        """Every tensor an update changes, by name and not copied: the DDPG
        agent's (under ``ddpg.``), the module, its Adam state and the
        running statistics."""
        out = dict(self.state_dict())
        out.update({f"ddpg.{k}": v for k, v in self.ddpg.train_state().items()})
        if self.module_opt is not None:
            out.update({f"module_opt.{k}": v for k, v in self.module_opt.state().items()})
        return out

    def load_train_state(self, state: tp.Mapping[str, Tensor]) -> None:
        load_train_state(self, state)

    # -- the policy interface (DDPG's) -----------------------------------
    def act(self, *args: tp.Any, **kwargs: tp.Any) -> Tensor:
        return self.ddpg.act(*args, **kwargs)

    def policy_act(self, *args: tp.Any, **kwargs: tp.Any) -> Tensor:
        return self.ddpg.policy_act(*args, **kwargs)

    def step_noise(self, n: int, generator: torch.Generator) -> StepNoise:
        return self.ddpg.step_noise(n, generator)

    def rollout_update_meta(self, meta: MetaDict, t: Tensor, noise: StepNoise) -> MetaDict:
        return meta

    def init_meta(self, generator: torch.Generator) -> MetaDict:
        return {}

    # -- the update ------------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator) -> Metrics:
        """One gradient step with noise drawn from ``generator``."""
        return self._update(batch, DDPGNoise.draw(batch.obs.shape[0], self.action_dim,
                                                  generator, self.device))

    def _update(self, batch: EpisodeBatch, noise: DDPGNoise) -> Metrics:
        cfg = self.cfg
        use_goal = cfg.goal_space is not None and batch.goal is not None
        goal = batch.goal if use_goal else batch.obs
        next_goal = batch.next_goal if use_goal else batch.next_obs
        metrics: Metrics = {}
        if self.module is not None:
            assert self.module_opt is not None
            loss, module_metrics = self._module_loss(batch, goal, next_goal)
            # a frozen part of the module (RND's target) gets a zero gradient,
            # so Adam leaves it where it is, as optax does
            self.module_opt.step(torch.autograd.grad(
                loss, list(self.module_opt.params.values()), allow_unused=True,
                materialize_grads=True))
            metrics.update(module_metrics)
        reward = batch.reward
        if cfg.reward_free:
            with torch.no_grad():
                reward, rms = self._intrinsic_reward(batch, goal, next_goal, self.rms)
                for name in ("mean", "var", "n"):
                    getattr(self, f"rms_{name}").copy_(getattr(rms, name))
            metrics["intr_reward"] = reward.mean()
        metrics.update(self.ddpg._update(dataclasses.replace(batch, reward=reward), noise,
                                         use_reward_model=False))
        return {k: v.detach().float() for k, v in metrics.items()}


# ================================================================== RND

@dataclasses.dataclass(frozen=True)
class RNDConfig(IntrinsicConfig):
    name: str = "rnd"
    rnd_rep_dim: int = 512
    rnd_scale: float = 1.0


class _RNDNets(_Net):
    """Predictor (``mlps[0]``) and frozen random target (``mlps[1]``) over
    observations normalised by their batch statistics, clipped to ±5."""

    def __init__(self, in_dim: int, hidden_dim: int, rep_dim: int) -> None:
        layers = (hidden_dim, "irelu", hidden_dim, "irelu", rep_dim)
        super().__init__([MLP(in_dim, layers), MLP(in_dim, layers)], torch.float32)

    def forward(self, obs: Tensor) -> tp.Tuple[Tensor, Tensor]:
        mean = obs.mean(0, keepdim=True)
        std = obs.std(0, unbiased=False, keepdim=True) + 1e-5
        obs = ((obs - mean) / std).clamp(-5.0, 5.0)
        return self.mlps[0](obs), self.mlps[1](obs).detach()


class RNDAgent(IntrinsicDDPGAgent):
    cfg: RNDConfig

    def _make_module(self) -> nn.Module:
        return _RNDNets(self.goal_dim, self.cfg.hidden_dim, self.cfg.rnd_rep_dim)

    def _pred_error(self, goal: Tensor) -> Tensor:
        pred, target = self.module(goal)
        return (target - pred).square().mean(-1, keepdim=True)

    def _module_loss(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor
                     ) -> tp.Tuple[Tensor, Metrics]:
        err = self._pred_error(goal).mean()
        return err, {"rnd_loss": err}

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState) -> tp.Tuple[Tensor, RMSState]:
        err = self._pred_error(goal)
        rms, _, std = rms_update(rms, err)
        return self.cfg.rnd_scale * err / (std + 1e-8), rms
