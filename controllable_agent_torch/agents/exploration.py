"""Exploration agents: DDPG trained on an intrinsic reward (mirror of
``controllable_agent_tpu/agents/exploration.py``).

``IntrinsicDDPGAgent`` is the shared update: the auxiliary module's loss and
Adam step, the intrinsic reward from the updated module, then the DDPG
update on that reward with ``use_reward_model=False`` (the batch already
carries the agent's reward). The running statistics live on the device
and advance inside a captured update. Data-parallel (``group``), the terms
that couple the batch take the rows of every process: RND's batch
statistics and the running statistics of its error, and ``pbe``'s nearest
neighbours (ICM-APT, MaxEnt); the other losses are per row.

  * ``RNDAgent``, the explorer that makes the offline recipe's buffers: a
    predictor trained against a frozen random target; reward = prediction
    error over its running standard deviation.
  * ``DIAYNAgent``: a one-hot skill in the meta (``skill``), resampled in
    the episode every ``update_skill_every_step`` steps; a discriminator
    q(skill | s') trained by cross-entropy; reward = log q(z | s') - log(1/K).
  * ``ICMAgent``: forward and inverse dynamics; reward = the forward
    model's error.
  * ``ICMAPTAgent``: APT, the particle-based entropy (``ops/pbe.py:pbe``)
    of an ICM trunk's representation (``rep="identity"``: of the state).
  * ``DisagreementAgent``: an ensemble of forward models whose parameters
    are stacked, one batched product per layer for all of them (JAX:
    ``nn.vmap``); reward = the variance of their predictions.
  * ``MaxEntAgent``: the particle-based entropy of the next goal (or state).
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import MLP, _Net
from ..ops.pbe import RMSState, pbe, rms_update
from ..optim import Adam
from ..utils.device import DeviceLike
from ..utils.dist import Shard
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

    def _module_loss(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                     noise: DDPGNoise, shard: Shard = Shard()) -> tp.Tuple[Tensor, Metrics]:
        """The module's loss on this process's rows (its part of the global
        batch's loss, ``Shard.grad``) and its metrics (means over the rows)."""
        raise NotImplementedError

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState, noise: DDPGNoise, shard: Shard = Shard()
                          ) -> tp.Tuple[Tensor, RMSState]:
        """The reward of this process's rows [B, 1] and the running
        statistics advanced by the global batch."""
        raise NotImplementedError

    def _draw(self, n: int, generator: torch.Generator) -> DDPGNoise:
        """The draws of one update: DDPG's, and those of the module's loss and
        reward (SMM's VAE noise, Proto's candidates) in a subclass of
        ``DDPGNoise``."""
        return DDPGNoise.draw(n, self.action_dim, generator, self.device)

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
        """Resample each environment's one-hot skill at the steps ``t`` (the
        index inside the episode, a device tensor) that are multiples of
        ``update_skill_every_step``, to ``noise.skill_index``; an agent
        without one keeps its meta."""
        key = "skill" if "skill" in meta else ("z" if "z" in meta else None)
        every = getattr(self.cfg, "update_skill_every_step", 0)
        if key is None or not every:
            return meta
        assert noise.skill_index is not None
        skill = meta[key]
        new = torch.nn.functional.one_hot(noise.skill_index, skill.shape[-1]).to(skill.dtype)
        return {**meta, key: torch.where((t % every) == 0, new, skill)}

    def init_meta(self, generator: torch.Generator) -> MetaDict:
        return {}

    @property
    def meta_dims(self) -> tp.Dict[str, int]:
        """The width of each meta entry the policy takes."""
        return {}

    # -- the update ------------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator,
               group: tp.Any = None) -> Metrics:
        """One gradient step with noise drawn from ``generator``; with a
        process group, the noise of the global batch (``DDPGAgent.update``)."""
        return self._update(batch, self._draw(batch.obs.shape[0] * Shard(group).world,
                                              generator), group)

    def _update(self, batch: EpisodeBatch, noise: DDPGNoise, group: tp.Any = None) -> Metrics:
        """One gradient step; with ``group`` a data-parallel one
        (``DDPGAgent._update``)."""
        cfg = self.cfg
        shard = Shard(group)
        global_noise, noise = noise, shard.noise(noise, batch.obs.shape[0])
        use_goal = cfg.goal_space is not None and batch.goal is not None
        goal = batch.goal if use_goal else batch.obs
        next_goal = batch.next_goal if use_goal else batch.next_obs
        metrics: Metrics = {}
        if self.module is not None:
            assert self.module_opt is not None
            loss, module_metrics = self._module_loss(batch, goal, next_goal, noise, shard)
            # a frozen part of the module (RND's target) gets a zero gradient,
            # so Adam leaves it where it is, as optax does
            self.module_opt.step(shard.grad(loss, self.module_opt.leaves,
                                            allow_unused=True, materialize_grads=True))
            metrics.update(module_metrics)
        reward = batch.reward
        if cfg.reward_free:
            with torch.no_grad():
                reward, rms = self._intrinsic_reward(batch, goal, next_goal, self.rms, noise,
                                                     shard)
                for name in ("mean", "var", "n"):
                    getattr(self, f"rms_{name}").copy_(getattr(rms, name))
            metrics["intr_reward"] = reward.mean()
        metrics = shard.mean({k: v.detach().float() for k, v in metrics.items()})
        metrics.update(self.ddpg._update(dataclasses.replace(batch, reward=reward), global_noise,
                                         use_reward_model=False, group=group))
        return metrics


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

    def forward(self, obs: Tensor, shard: Shard = Shard()) -> tp.Tuple[Tensor, Tensor]:
        """Predictor and target on this process's rows, normalised by the
        statistics of the global batch."""
        every = shard.gather(obs)
        mean = every.mean(0, keepdim=True)
        std = every.std(0, unbiased=False, keepdim=True) + 1e-5
        obs = ((obs - mean) / std).clamp(-5.0, 5.0)
        return self.mlps[0](obs), self.mlps[1](obs).detach()


class RNDAgent(IntrinsicDDPGAgent):
    cfg: RNDConfig

    def _make_module(self) -> nn.Module:
        return _RNDNets(self.goal_dim, self.cfg.hidden_dim, self.cfg.rnd_rep_dim)

    def _pred_error(self, goal: Tensor, shard: Shard = Shard()) -> Tensor:
        pred, target = self.module(goal, shard)
        return (target - pred).square().mean(-1, keepdim=True)

    def _module_loss(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                     noise: DDPGNoise, shard: Shard = Shard()) -> tp.Tuple[Tensor, Metrics]:
        err = self._pred_error(goal, shard).mean()
        return err, {"rnd_loss": err}

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState, noise: DDPGNoise, shard: Shard = Shard()
                          ) -> tp.Tuple[Tensor, RMSState]:
        err = self._pred_error(goal, shard)
        # the running statistics advance by the errors of the global batch
        rms, _, std = rms_update(rms, shard.gather(err))
        return self.cfg.rnd_scale * err / (std + 1e-8), rms


# ================================================================ DIAYN

@dataclasses.dataclass(frozen=True)
class DIAYNConfig(IntrinsicConfig):
    name: str = "diayn"
    skill_dim: int = 16
    diayn_scale: float = 1.0
    update_skill_every_step: int = 50


class SkillMetaMixin:
    """A one-hot skill of width ``meta_dim`` in the meta under ``skill_key``
    (DIAYN's ``skill``, SMM's ``z``): drawn uniformly, resampled every
    ``update_skill_every_step`` steps; the collector's draw of it is
    ``StepNoise.skill_index``."""

    skill_key: str = "skill"
    # what the agent that takes this mixin provides
    cfg: tp.Any
    ddpg: DDPGAgent
    device: torch.device
    meta_dim: int

    @property
    def meta_dims(self) -> tp.Dict[str, int]:
        return {self.skill_key: self.meta_dim}

    def init_meta(self, generator: torch.Generator) -> MetaDict:
        """A uniform skill, one-hot [meta_dim]."""
        idx = torch.randint(self.meta_dim, (), generator=generator, device=generator.device)
        return {self.skill_key: torch.nn.functional.one_hot(idx, self.meta_dim).float()}

    def update_meta(self, meta: MetaDict, global_step: int,
                    generator: torch.Generator) -> MetaDict:
        if global_step % self.cfg.update_skill_every_step == 0:
            return self.init_meta(generator)
        return meta

    def step_noise(self, n: int, generator: torch.Generator) -> StepNoise:
        """The policy's draws and each environment's skill index."""
        noise = self.ddpg.step_noise(n, generator)
        noise.skill_index = torch.randint(self.meta_dim, (n,), generator=generator,
                                          device=self.device)
        return noise


class DIAYNAgent(SkillMetaMixin, IntrinsicDDPGAgent):
    cfg: DIAYNConfig

    @property
    def meta_dim(self) -> int:  # type: ignore[override]
        return self.cfg.skill_dim

    def _make_module(self) -> nn.Module:
        hidden = self.cfg.hidden_dim
        return MLP(self.obs_dim, (hidden, "irelu", hidden, "irelu", self.cfg.skill_dim))

    def _logits(self, batch: EpisodeBatch) -> tp.Tuple[Tensor, Tensor]:
        return self.module(batch.next_obs), batch.meta["skill"].argmax(1)

    def _module_loss(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                     noise: DDPGNoise, shard: Shard = Shard()) -> tp.Tuple[Tensor, Metrics]:
        logits, z_hat = self._logits(batch)
        loss = torch.nn.functional.cross_entropy(logits, z_hat)
        acc = (logits.argmax(1) == z_hat).float().mean()
        return loss, {"diayn_loss": loss, "diayn_acc": acc}

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState, noise: DDPGNoise, shard: Shard = Shard()
                          ) -> tp.Tuple[Tensor, RMSState]:
        logits, z_hat = self._logits(batch)
        log_q = torch.log_softmax(logits, 1).gather(1, z_hat[:, None])
        return self.cfg.diayn_scale * (log_q - math.log(1.0 / self.cfg.skill_dim)), rms


# ================================================================== ICM

@dataclasses.dataclass(frozen=True)
class ICMConfig(IntrinsicConfig):
    name: str = "icm"
    icm_scale: float = 1.0


def _errors(next_obs: Tensor, next_hat: Tensor, action: Tensor, action_hat: Tensor
            ) -> tp.Tuple[Tensor, Tensor]:
    return (torch.linalg.vector_norm(next_obs - next_hat, dim=-1, keepdim=True),
            torch.linalg.vector_norm(action - action_hat, dim=-1, keepdim=True))


class _ICMNets(_Net):
    """Forward model (``mlps[0]``: state, action -> next state) and inverse
    model (``mlps[1]``: state, next state -> action); returns both errors."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_dim: int) -> None:
        super().__init__([MLP(obs_dim + action_dim, (hidden_dim, "irelu", obs_dim)),
                          MLP(2 * obs_dim, (hidden_dim, "irelu", action_dim, "tanh"))],
                         torch.float32)

    def forward(self, obs: Tensor, action: Tensor, next_obs: Tensor
                ) -> tp.Tuple[Tensor, Tensor]:
        next_hat = self.mlps[0](torch.cat([obs, action], -1))
        action_hat = self.mlps[1](torch.cat([obs, next_obs], -1))
        return _errors(next_obs, next_hat, action, action_hat)


class ICMAgent(IntrinsicDDPGAgent):
    cfg: ICMConfig

    def _make_module(self) -> nn.Module:
        return _ICMNets(self.obs_dim, self.action_dim, self.cfg.hidden_dim)

    def _module_loss(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                     noise: DDPGNoise, shard: Shard = Shard()) -> tp.Tuple[Tensor, Metrics]:
        fwd, bwd = self.module(batch.obs, batch.action, batch.next_obs)
        loss = fwd.mean() + bwd.mean()
        return loss, {"icm_loss": loss}

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState, noise: DDPGNoise, shard: Shard = Shard()
                          ) -> tp.Tuple[Tensor, RMSState]:
        fwd, _ = self.module(batch.obs, batch.action, batch.next_obs)
        return self.cfg.icm_scale * fwd, rms


# =============================================================== ICM-APT

@dataclasses.dataclass(frozen=True)
class ICMAPTConfig(IntrinsicConfig):
    name: str = "icm_apt"
    icm_rep_dim: int = 512
    knn_clip: float = 0.0
    knn_k: int = 12
    rep: str = "icm"  # "icm" | "identity" (the ind_apt/state_apt ablations)


class _APTNets(nn.Module):
    """ICM over a trunk's representation (LayerNorm + tanh): forward and
    inverse models in that space. Named as the flax module's attributes."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_dim: int, rep_dim: int) -> None:
        super().__init__()
        self.trunk = MLP(obs_dim, (rep_dim, "ntanh"))
        self.forward_net = MLP(rep_dim + action_dim, (hidden_dim, "irelu", rep_dim))
        self.backward_net = MLP(2 * rep_dim, (hidden_dim, "irelu", action_dim, "tanh"))

    def rep(self, obs: Tensor) -> Tensor:
        return self.trunk(obs)

    def forward(self, obs: Tensor, action: Tensor, next_obs: Tensor
                ) -> tp.Tuple[Tensor, Tensor]:
        h, next_h = self.trunk(obs), self.trunk(next_obs)
        next_hat = self.forward_net(torch.cat([h, action], -1))
        action_hat = self.backward_net(torch.cat([h, next_h], -1))
        return _errors(next_h, next_hat, action, action_hat)


class ICMAPTAgent(IntrinsicDDPGAgent):
    cfg: ICMAPTConfig

    def _make_module(self) -> tp.Optional[nn.Module]:
        if self.cfg.rep == "identity":
            return None
        return _APTNets(self.obs_dim, self.action_dim, self.cfg.hidden_dim,
                        self.cfg.icm_rep_dim)

    def _module_loss(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                     noise: DDPGNoise, shard: Shard = Shard()) -> tp.Tuple[Tensor, Metrics]:
        fwd, bwd = self.module(batch.obs, batch.action, batch.next_obs)
        loss = fwd.mean() + bwd.mean()
        return loss, {"icm_loss": loss}

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState, noise: DDPGNoise, shard: Shard = Shard()
                          ) -> tp.Tuple[Tensor, RMSState]:
        rep = batch.obs if self.module is None else self.module.rep(batch.obs)
        cfg = self.cfg
        return pbe(rep, rms, knn_k=cfg.knn_k, knn_avg=cfg.knn_avg, knn_clip=cfg.knn_clip,
                   knn_rms=cfg.knn_rms, shard=shard)


# ========================================================== Disagreement

@dataclasses.dataclass(frozen=True)
class DisagreementConfig(IntrinsicConfig):
    name: str = "disagreement"
    n_models: int = 5


class _StackedDense(nn.Module):
    """``n`` dense layers with stacked weights [n, out, in] and biases [n,
    out]: one batched product [n, B, in] -> [n, B, out]."""

    def __init__(self, n: int, in_dim: int, out_dim: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(n, out_dim))
        with torch.no_grad():
            for w in self.weight:
                nn.init.orthogonal_(w)

    def forward(self, x: Tensor) -> Tensor:
        return torch.baddbmm(self.bias[:, None, :], x, self.weight.transpose(1, 2))


class _StackedMLP(nn.Module):
    """``n`` MLPs (hidden, relu, out) on the same input, layers named as
    flax's ``nn.vmap`` of the MLP stacks them (``Dense_0``, ``Dense_1``)."""

    def __init__(self, n: int, in_dim: int, hidden_dim: int, out_dim: int) -> None:
        super().__init__()
        self.n = n
        self.Dense_0 = _StackedDense(n, in_dim, hidden_dim)
        self.Dense_1 = _StackedDense(n, hidden_dim, out_dim)

    def forward(self, x: Tensor) -> Tensor:
        h = torch.relu(self.Dense_0(x.expand((self.n,) + x.shape)))
        return self.Dense_1(h)


class _Ensemble(nn.Module):
    """The forward models of the ensemble: (state, action) -> [n_models, B,
    obs_dim]. Its path, ``VmapMLPWrap_0.mlps.0``, is flax's for the vmapped
    ``MLPWrap``, so ``convert.py`` maps the JAX parameters by name."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_dim: int, n_models: int) -> None:
        super().__init__()
        self.VmapMLPWrap_0 = _Net([_StackedMLP(n_models, obs_dim + action_dim, hidden_dim,
                                               obs_dim)], torch.float32)

    def forward(self, obs: Tensor, action: Tensor) -> Tensor:
        return self.VmapMLPWrap_0.mlps[0](torch.cat([obs, action], -1))


class DisagreementAgent(IntrinsicDDPGAgent):
    cfg: DisagreementConfig

    def _make_module(self) -> nn.Module:
        return _Ensemble(self.obs_dim, self.action_dim, self.cfg.hidden_dim, self.cfg.n_models)

    def _module_loss(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                     noise: DDPGNoise, shard: Shard = Shard()) -> tp.Tuple[Tensor, Metrics]:
        preds = self.module(batch.obs, batch.action)
        loss = torch.linalg.vector_norm(batch.next_obs[None] - preds, dim=-1).mean()
        return loss, {"disagreement_loss": loss}

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState, noise: DDPGNoise, shard: Shard = Shard()
                          ) -> tp.Tuple[Tensor, RMSState]:
        preds = self.module(batch.obs, batch.action)
        return preds.var(0, unbiased=False).mean(-1, keepdim=True), rms


# ================================================================ MaxEnt

@dataclasses.dataclass(frozen=True)
class MaxEntConfig(IntrinsicConfig):
    name: str = "max_ent"
    knn_k: int = 12


class MaxEntAgent(IntrinsicDDPGAgent):
    cfg: MaxEntConfig

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState, noise: DDPGNoise, shard: Shard = Shard()
                          ) -> tp.Tuple[Tensor, RMSState]:
        cfg = self.cfg
        return pbe(next_goal, rms, knn_k=cfg.knn_k, knn_avg=cfg.knn_avg,
                   knn_clip=cfg.knn_clip, knn_rms=cfg.knn_rms, shard=shard)
