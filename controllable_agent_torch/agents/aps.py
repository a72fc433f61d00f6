"""APSAgent and NEWAPSAgent — Active Pretraining with Successor features
(mirror of ``controllable_agent_tpu/agents/aps.py``).

  * ``APSAgent``: DDPG with a twin critic whose heads emit ``sf_dim``
    successor features projected on the task (``CriticSF``), a feature net
    φ trained by maximum likelihood (−task·φ̂(s')), and the intrinsic reward
    pbe(φ(s')) + task·φ̂(s'), φ̂ the unit-normalised φ. The meta is
    ``task`` (width ``sf_dim``), resampled on the sphere every
    ``update_task_every_step`` steps; the collector's draw of it is
    ``StepNoise.z_normal``. APS has no ``infer_meta_from_obs_and_rewards``,
    so its evaluation takes a random task, as the JAX workspace does;
    ``regress_meta`` is the least-squares task, which nothing in the
    workspace calls.
  * ``NEWAPSAgent``: the FB-shaped ``Actor`` and ``ForwardMap`` (no
    preprocessing towers, no trunk) with a scalar-Q TD loss on F·z, φ (512
    ``ntanh``, 512 ``relu``, z_dim) trained as APS's, the same reward on φ
    with z in place of the task; z is unit-norm (no √d), resampled every
    ``update_z_every_step`` steps; with ``future_ratio`` > 0 a share of the
    update's z is φ̂(future goal)·Cov(φ̂)⁺, the pseudo-inverse run eagerly
    between two captured graphs (``utils/graphs.py:eager_step``). It infers
    z by least squares, so the final battery runs.

As the other agents, each is an ``nn.Module`` updated in place, its step
counter and running statistics are device tensors, and the draws of an
update come in as one noise dataclass (``DDPGNoise``, ``NEWAPSNoise``).
Both run in float32 whatever ``compute_dtype`` says, as in JAX.
Data-parallel (``group``, ``utils/dist.py``), ``pbe`` finds each row's
neighbours among every process's rows and NEWAPS whitens with the
covariance of every process's φ̂(future); the losses are per row.
"""

from __future__ import annotations

import copy
import dataclasses
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import MLP, Actor, ForwardMap, _Net, l2_normalize
from ..ops.linalg import lstsq, pinv
from ..ops.pbe import RMSState, pbe
from ..optim import Adam
from ..utils.device import DeviceLike, resolve_device
from ..utils.dist import RowNoise, Shard
from ..utils.distributions import TruncatedNormal
from ..utils.graphs import eager_step
from ..utils.schedules import schedule
from ..utils.tree import soft_update
from .base import MetaDict, StepNoise, ZMetaMixin, act_draws, explore_until, load_train_state
from .ddpg import DDPGActor, DDPGNoise

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


def _dot(x: Tensor, y: Tensor) -> Tensor:
    """Row-wise x·y [B] (einsum "bi,bi->b")."""
    return (x * y).sum(-1)


def _unit(x: Tensor) -> Tensor:
    return l2_normalize(x, scale_sqrt_dim=False)


class _IntrinsicSFBase(ZMetaMixin, nn.Module):
    """What APS and NEWAPS share: the device step counter, the running
    statistics of ``pbe``, the train state and the exploring policy."""

    OPTIMIZERS: tp.Tuple[str, ...] = ()

    def _init_common(self, cfg: tp.Any, obs_dim: int, action_dim: int,
                     goal_dim: tp.Optional[int], device: DeviceLike) -> None:
        self.cfg = cfg
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.goal_dim = goal_dim if goal_dim is not None else obs_dim
        self.device = resolve_device(device)
        self._stddev = schedule(cfg.stddev_schedule)

    def _finish_init(self) -> None:
        self.register_buffer("step_t", torch.zeros((), dtype=torch.int64))
        rms = RMSState.create()
        for name in ("mean", "var", "n"):
            self.register_buffer(f"rms_{name}", getattr(rms, name))
        self.to(self.device)

    @property
    def step(self) -> int:
        """Gradient steps taken (reading it waits for the device)."""
        return int(self.step_t)

    @step.setter
    def step(self, value: int) -> None:
        self.step_t.fill_(value)

    @property
    def rms(self) -> RMSState:
        return RMSState(mean=self.rms_mean, var=self.rms_var, n=self.rms_n)

    def _set_rms(self, rms: RMSState) -> None:
        for name in ("mean", "var", "n"):
            getattr(self, f"rms_{name}").copy_(getattr(rms, name))

    def train_state(self) -> tp.Dict[str, Tensor]:
        """Every tensor an update changes, by name and not copied: the
        networks, targets, counters and statistics (``state_dict``) and the
        Adam states."""
        out = dict(self.state_dict())
        for name in self.OPTIMIZERS:
            out.update({f"{name}.{k}": v for k, v in getattr(self, name).state().items()})
        return out

    def load_train_state(self, state: tp.Mapping[str, Tensor]) -> None:
        load_train_state(self, state)

    def _explore(self, mu: Tensor, step: tp.Union[int, Tensor],
                 generator: tp.Optional[torch.Generator],
                 noise: tp.Optional[StepNoise]) -> Tensor:
        normal, uniform = act_draws(noise, mu, generator)
        action = TruncatedNormal(mu, self._stddev(step)).sample(normal)
        return explore_until(action, uniform, step, self.cfg.num_expl_steps)

    def _intrinsic(self, rep: Tensor, direction: Tensor, shard: Shard = Shard()
                   ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        """(pbe(rep) + direction·φ̂, the entropy part, the SF part), each
        [B, 1], the running statistics advanced (by the global batch)."""
        cfg = self.cfg
        ent, rms = pbe(rep, self.rms, knn_k=cfg.knn_k, knn_avg=cfg.knn_avg,
                       knn_clip=cfg.knn_clip, knn_rms=cfg.knn_rms, shard=shard)
        self._set_rms(rms)
        sf = _dot(direction, _unit(rep))[:, None]
        return ent + sf, ent, sf


# =================================================================== APS

@dataclasses.dataclass(frozen=True)
class APSConfig:
    """Same fields and defaults as the JAX ``APSConfig``."""

    name: str = "aps"
    reward_free: bool = True
    lr: float = 1e-4
    critic_target_tau: float = 0.01
    update_every_steps: int = 2
    hidden_dim: int = 1024
    feature_dim: int = 50
    stddev_schedule: str = "0.2"
    stddev_clip: float = 0.3
    batch_size: int = 1024
    sf_dim: int = 10
    update_task_every_step: int = 5
    knn_rms: bool = True
    knn_k: int = 12
    knn_avg: bool = True
    knn_clip: float = 0.0001
    lstsq_batch_size: int = 4096
    num_inference_steps: int = 10000
    num_expl_steps: int = 0
    goal_space: tp.Optional[str] = None
    compute_dtype: str = "float32"


class CriticSF(_Net):
    """Twin heads of ``sf_dim`` successor features on a shared trunk, each
    projected on the task."""

    def __init__(self, in_dim: int, action_dim: int, hidden_dim: int, sf_dim: int) -> None:
        super().__init__([MLP(in_dim + action_dim, (hidden_dim, "ntanh")),
                          MLP(hidden_dim, (hidden_dim, "irelu", sf_dim)),
                          MLP(hidden_dim, (hidden_dim, "irelu", sf_dim))], torch.float32)

    def forward(self, obs: Tensor, action: Tensor, task: Tensor) -> tp.Tuple[Tensor, Tensor]:
        h = self.mlps[0](torch.cat([obs, action], -1))
        return _dot(task, self.mlps[1](h))[:, None], _dot(task, self.mlps[2](h))[:, None]


class APSAgent(_IntrinsicSFBase):
    """Networks, target critic, optimizers and running statistics of APS."""

    meta_key = "task"
    OPTIMIZERS = ("actor_opt", "critic_opt", "aps_opt")

    def __init__(self, cfg: APSConfig, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__()
        self._init_common(cfg, obs_dim, action_dim, goal_dim, device)
        in_dim = obs_dim + cfg.sf_dim
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.actor = DDPGActor(in_dim, action_dim, cfg.hidden_dim)
            self.critic = CriticSF(in_dim, action_dim, cfg.hidden_dim, cfg.sf_dim)
            self.aps_net = MLP(obs_dim, (cfg.hidden_dim, "irelu", cfg.hidden_dim, "irelu",
                                         cfg.sf_dim))
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)
        self._finish_init()
        self.actor_opt = Adam(self.actor, cfg.lr)
        self.critic_opt = Adam(self.critic, cfg.lr)
        self.aps_opt = Adam(self.aps_net, cfg.lr)

    @property
    def meta_dims(self) -> tp.Dict[str, int]:
        return {"task": self.cfg.sf_dim}

    def features(self, obs: Tensor, norm: bool = True) -> Tensor:
        phi = self.aps_net(obs)
        return _unit(phi) if norm else phi

    # -- meta ------------------------------------------------------------
    def init_meta(self, generator: torch.Generator) -> MetaDict:
        """A task on the unit sphere [sf_dim]."""
        task = torch.randn(self.cfg.sf_dim, generator=generator, device=generator.device)
        return {"task": task / torch.linalg.vector_norm(task)}

    def update_meta(self, meta: MetaDict, global_step: int,
                    generator: torch.Generator) -> MetaDict:
        if global_step % self.cfg.update_task_every_step == 0:
            return self.init_meta(generator)
        return meta

    def step_noise(self, n: int, generator: torch.Generator) -> StepNoise:
        """The policy's draws and each environment's new task's normal draw."""
        noise = StepNoise.draw(n, self.action_dim, generator, self.device)
        noise.z_normal = torch.randn(n, self.cfg.sf_dim, generator=generator,
                                     device=self.device)
        return noise

    def rollout_update_meta(self, meta: MetaDict, t: Tensor, noise: StepNoise) -> MetaDict:
        """A new task on the sphere (``noise.z_normal`` normalised) at the
        steps ``t`` that are multiples of update_task_every_step."""
        assert noise.z_normal is not None
        resample = (t % self.cfg.update_task_every_step) == 0
        return {**meta, "task": torch.where(resample, _unit(noise.z_normal), meta["task"])}

    @torch.no_grad()
    def regress_meta(self, obs: Tensor, reward: Tensor) -> Tensor:
        """task = lstsq(φ̂(s), r), unit-normalised [sf_dim]."""
        task = lstsq(self.features(obs), reward.reshape(-1, 1).float())
        return (task / torch.linalg.vector_norm(task).clamp_min(1e-12))[:, 0]

    # -- acting ----------------------------------------------------------
    @torch.no_grad()
    def act(self, obs: Tensor, task: Tensor, step: tp.Union[int, Tensor],
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        """The actor's mean on [obs, task] in eval mode, else its truncated
        normal sample or a uniform action while ``step`` < num_expl_steps;
        a task [sf_dim] serves every row."""
        task = task.expand(obs.shape[0], task.shape[-1])
        mu = self.actor(torch.cat([obs, task], -1))
        return mu if eval_mode else self._explore(mu, step, generator, noise)

    # -- the update ------------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator,
               group: tp.Any = None) -> Metrics:
        """One gradient step with noise drawn from ``generator``; with a
        process group, the noise of the global batch (``DDPGAgent.update``)."""
        return self._update(batch, DDPGNoise.draw(batch.obs.shape[0] * Shard(group).world,
                                                  self.action_dim, generator, self.device),
                            group)

    def _update(self, batch: EpisodeBatch, noise: DDPGNoise, group: tp.Any = None) -> Metrics:
        """One gradient step; with ``group`` a data-parallel one
        (``DDPGAgent._update``)."""
        cfg = self.cfg
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        task = batch.meta["task"]
        metrics: Metrics = {}
        reward = batch.reward
        if cfg.reward_free:
            aps_loss = -_dot(task, self.features(batch.next_obs)).mean()
            self.aps_opt.step(shard.grad(aps_loss, self.aps_opt.leaves))
            with torch.no_grad():
                reward, ent, sf = self._intrinsic(self.features(batch.next_obs, norm=False),
                                                  task, shard)
            metrics.update(aps_loss=aps_loss, intr_reward=reward.mean(),
                           intr_ent_reward=ent.mean(), intr_sf_reward=sf.mean())
        obs = torch.cat([batch.obs, task], -1)
        next_obs = torch.cat([batch.next_obs, task], -1)
        stddev = self._stddev(self.step_t)
        with torch.no_grad():
            next_action = TruncatedNormal(self.actor(next_obs), stddev).sample(
                noise.critic_normal, clip=cfg.stddev_clip)
            tq1, tq2 = self.target_critic(next_obs, next_action, task)
            target_q = reward + batch.discount * torch.minimum(tq1, tq2)
        q1, q2 = self.critic(obs, batch.action, task)
        critic_loss = (q1 - target_q).square().mean() + (q2 - target_q).square().mean()
        self.critic_opt.step(shard.grad(critic_loss, self.critic_opt.leaves))
        # the actor step sees the freshly updated critic, as the JAX update does
        action = TruncatedNormal(self.actor(obs), stddev).sample(noise.actor_normal,
                                                                 clip=cfg.stddev_clip)
        aq1, aq2 = self.critic(obs, action, task)
        actor_loss = -torch.minimum(aq1, aq2).mean()
        self.actor_opt.step(shard.grad(actor_loss, self.actor_opt.leaves))
        soft_update(self.critic, self.target_critic, cfg.critic_target_tau)
        self.step_t += 1
        metrics.update(critic_loss=critic_loss, critic_q1=q1.mean(), actor_loss=actor_loss)
        return shard.mean({k: v.detach() for k, v in metrics.items()})


# =============================================================== NEW APS

@dataclasses.dataclass(frozen=True)
class NEWAPSConfig:
    """Same fields and defaults as the JAX ``NEWAPSConfig``."""

    name: str = "new_aps"
    reward_free: bool = True
    lr: float = 1e-4
    lr_coef: float = 1.0
    sf_target_tau: float = 0.01
    update_every_steps: int = 2
    hidden_dim: int = 1024
    backward_hidden_dim: int = 512
    feature_dim: int = 512
    z_dim: int = 10
    stddev_schedule: str = "0.2"
    stddev_clip: float = 0.3
    update_z_every_step: int = 100
    batch_size: int = 1024
    goal_space: tp.Optional[str] = None
    preprocess: bool = False
    knn_rms: bool = True
    knn_k: int = 12
    knn_avg: bool = True
    knn_clip: float = 0.0001
    num_inference_steps: int = 5120
    add_trunk: bool = False
    future_ratio: float = 0.0
    num_expl_steps: int = 0
    compute_dtype: str = "float32"


@dataclasses.dataclass
class NEWAPSNoise(RowNoise):
    """Every draw of one NEWAPS update: z's normal (used when the batch has
    no ``z``), the target policy's and the actor's noise, and with
    ``future_ratio`` > 0 the future mask's uniform."""

    z_normal: Tensor  # [n, z_dim]
    critic_normal: Tensor  # [n, action_dim]
    actor_normal: Tensor  # [n, action_dim]
    future_uniform: tp.Optional[Tensor] = None  # [n, 1]

    @classmethod
    def draw(cls, n: int, z_dim: int, action_dim: int, future: bool,
             generator: torch.Generator, device: torch.device) -> "NEWAPSNoise":
        def normal(*shape: int) -> Tensor:
            return torch.randn(shape, generator=generator, device=device)

        return cls(normal(n, z_dim), normal(n, action_dim), normal(n, action_dim),
                   torch.rand((n, 1), generator=generator, device=device) if future else None)


class NEWAPSAgent(_IntrinsicSFBase):
    """Actor, successor nets and their target, φ, optimizers and running
    statistics of NEWAPS."""

    OPTIMIZERS = ("actor_opt", "sf_opt", "phi_opt")

    def __init__(self, cfg: NEWAPSConfig, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__()
        self._init_common(cfg, obs_dim, action_dim, goal_dim, device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.actor = Actor(obs_dim, cfg.z_dim, action_dim, cfg.feature_dim,
                               cfg.hidden_dim, preprocess=cfg.preprocess,
                               add_trunk=cfg.add_trunk)
            self.successor_net = ForwardMap(obs_dim, cfg.z_dim, action_dim, cfg.feature_dim,
                                            cfg.hidden_dim, preprocess=cfg.preprocess,
                                            add_trunk=cfg.add_trunk)
            self.phi_net = MLP(self.goal_dim, (cfg.backward_hidden_dim, "ntanh",
                                               cfg.backward_hidden_dim, "relu", cfg.z_dim))
        self.target_successor_net = copy.deepcopy(self.successor_net).requires_grad_(False)
        self._finish_init()
        self.actor_opt = Adam(self.actor, cfg.lr)
        self.sf_opt = Adam(self.successor_net, cfg.lr)
        self.phi_opt = Adam(self.phi_net, cfg.lr_coef * cfg.lr)

    def features(self, goal: Tensor, norm: bool = True) -> Tensor:
        phi = self.phi_net(goal)
        return _unit(phi) if norm else phi

    # -- z and meta ------------------------------------------------------
    def z_from_noise(self, normal: Tensor, uniform: tp.Optional[Tensor] = None) -> Tensor:
        """z from its normal draw: on the unit sphere (no √d scale)."""
        return _unit(normal)

    def sample_z(self, size: int, generator: torch.Generator) -> Tensor:
        return self.z_from_noise(torch.randn(size, self.cfg.z_dim, generator=generator,
                                             device=generator.device))

    def init_meta(self, generator: torch.Generator) -> MetaDict:
        return {"z": self.sample_z(1, generator)[0]}

    def update_meta(self, meta: MetaDict, global_step: int,
                    generator: torch.Generator) -> MetaDict:
        if global_step % self.cfg.update_z_every_step == 0:
            return self.init_meta(generator)
        return meta

    @torch.no_grad()
    def infer_meta_from_obs_and_rewards(self, obs: Tensor, reward: Tensor) -> Tensor:
        """z = lstsq(φ̂(s), r), unit-normalised [z_dim]."""
        z = lstsq(self.features(obs), reward.reshape(-1, 1).float())
        return (z / torch.linalg.vector_norm(z, dim=0, keepdim=True).clamp_min(1e-12))[:, 0]

    # -- acting ----------------------------------------------------------
    @torch.no_grad()
    def act(self, obs: Tensor, z: Tensor, step: tp.Union[int, Tensor],
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        mu = self.actor(obs, z.expand(obs.shape[0], z.shape[-1]))
        return mu if eval_mode else self._explore(mu, step, generator, noise)

    # -- the update ------------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator,
               group: tp.Any = None) -> Metrics:
        """One gradient step with noise drawn from ``generator``; with a
        process group, the noise of the global batch (``DDPGAgent.update``)."""
        return self._update(batch, NEWAPSNoise.draw(
            batch.obs.shape[0] * Shard(group).world, self.cfg.z_dim, self.action_dim,
            self.cfg.future_ratio > 0, generator, self.device), group)

    @torch.no_grad()
    def _future_z(self, z: Tensor, batch: EpisodeBatch, noise: NEWAPSNoise,
                  shard: Shard = Shard()) -> Tensor:
        """z replaced, with probability future_ratio, by φ̂(future goal)
        whitened by the pseudo-inverse of its covariance over the global
        batch."""
        cfg = self.cfg
        future = batch.future_goal if cfg.goal_space is not None else batch.future_obs
        assert future is not None and noise.future_uniform is not None
        phi = self.features(future)
        every = shard.gather(phi)
        cov = every.T @ every / every.shape[0]
        inv_cov = eager_step(lambda: pinv(cov))
        return torch.where(noise.future_uniform < cfg.future_ratio, _unit(phi @ inv_cov), z)

    def _q(self, net: nn.Module, obs: Tensor, z: Tensor, action: Tensor
           ) -> tp.Tuple[Tensor, Tensor]:
        f1, f2 = net(obs, z, action)
        return _dot(f1, z), _dot(f2, z)

    def _update(self, batch: EpisodeBatch, noise: NEWAPSNoise, group: tp.Any = None) -> Metrics:
        """One gradient step; with ``group`` a data-parallel one
        (``DDPGAgent._update``)."""
        cfg = self.cfg
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        next_goal = batch.next_goal if cfg.goal_space is not None else batch.next_obs
        z = batch.meta.get("z")
        if z is None:
            z = self.z_from_noise(noise.z_normal)
        metrics: Metrics = {}
        reward = batch.reward
        if cfg.reward_free:
            phi_loss = -_dot(self.features(next_goal), z).mean()
            self.phi_opt.step(shard.grad(phi_loss, self.phi_opt.leaves))
            with torch.no_grad():
                reward, ent, sf = self._intrinsic(self.features(next_goal, norm=False), z,
                                                  shard)
            metrics.update(phi_loss=phi_loss, intrinsic_reward=reward.mean(),
                           entropy_reward=ent.mean(), diayn_reward=sf.mean())
        if cfg.future_ratio > 0:
            z = self._future_z(z, batch, noise, shard)
        stddev = self._stddev(self.step_t)
        with torch.no_grad():
            next_action = TruncatedNormal(self.actor(batch.next_obs, z), stddev).sample(
                noise.critic_normal, clip=cfg.stddev_clip)
            next_q = torch.minimum(*self._q(self.target_successor_net, batch.next_obs, z,
                                            next_action))
            target_q = reward[:, 0] + batch.discount[:, 0] * next_q
        q1, q2 = self._q(self.successor_net, batch.obs, z, batch.action)
        sf_loss = (q1 - target_q).square().mean() + (q2 - target_q).square().mean()
        self.sf_opt.step(shard.grad(sf_loss, self.sf_opt.leaves))
        # the actor step sees the freshly updated successor nets
        action = TruncatedNormal(self.actor(batch.obs, z), stddev).sample(
            noise.actor_normal, clip=cfg.stddev_clip)
        actor_loss = -torch.minimum(*self._q(self.successor_net, batch.obs, z, action)).mean()
        self.actor_opt.step(shard.grad(actor_loss, self.actor_opt.leaves))
        soft_update(self.successor_net, self.target_successor_net, cfg.sf_target_tau)
        self.step_t += 1
        metrics.update(sf_loss=sf_loss, Q1=q1.mean(), target_Q=target_q.mean(),
                       actor_loss=actor_loss)
        return shard.mean({k: v.detach() for k, v in metrics.items()})
