"""DDPGAgent — twin-critic DDPG (mirror of ``controllable_agent_tpu/agents/ddpg.py``).

A truncated-normal exploration policy, twin critics with a min-target, an
optional meta vector concatenated to the observation (the skill agents
build on this), and the reward-free mode that fits a reward model by
regression (``train_reward``). The exploration agents
(``agents/exploration.py``) train it on their intrinsic reward.

As ``FBDDPGAgent``, the agent is an ``nn.Module`` that owns its networks,
target critic and optimizers and updates them in place, its step counter is
a device tensor, and the update's draws are one ``DDPGNoise`` (``update``
draws it from a ``torch.Generator``, ``_update`` takes it), so
``make_offline_trainer`` captures its update and a test can hand both
packages the same noise.

``obs_type="pixels"`` takes flat uint8 frames (``obs_shape`` is their (H,
W, C)) through the 4-conv ``PixelEncoder``, with its own Adam, and DrQ's
random shifts (``ops/augment.py``; the two [B, 2] draws are in
``DDPGNoise``). As in the JAX update, the encoder's gradient comes from the
critic loss alone, the target's features are taken without gradient, and
the actor sees the critic's features detached: all three from the
encoder's parameters before its step.
"""

from __future__ import annotations

import copy
import dataclasses
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import MLP, PixelEncoder, _Net, conv_repr_dim
from ..ops.augment import draw_shifts, random_shift_aug
from ..optim import Adam
from ..utils.device import DeviceLike, resolve_device
from ..utils.dist import RowNoise, Shard
from ..utils.distributions import TruncatedNormal
from ..utils.schedules import schedule
from ..utils.tree import soft_update
from .base import MetaDict, StepNoise, act_draws, explore_until, load_train_state

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """Same fields and defaults as the JAX ``DDPGConfig``."""

    name: str = "ddpg"
    reward_free: bool = False
    lr: float = 1e-4
    critic_target_tau: float = 0.01
    update_every_steps: int = 2
    hidden_dim: int = 1024
    feature_dim: int = 50
    stddev_schedule: str = "0.2"
    stddev_clip: float = 0.3
    nstep: int = 3
    batch_size: int = 1024
    init_critic: bool = True
    num_expl_steps: int = 0
    compute_dtype: str = "float32"
    obs_type: str = "states"
    aug_pad: int = 4
    update_encoder: bool = True


class DDPGActor(_Net):
    """trunk (LayerNorm + tanh) -> policy MLP -> tanh mean."""

    def __init__(self, in_dim: int, action_dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__([MLP(in_dim, (hidden_dim, "ntanh")),
                          MLP(hidden_dim, (hidden_dim, "irelu", action_dim))], dtype)

    def forward(self, obs: Tensor) -> Tensor:
        with self._compute(obs):
            return torch.tanh(self.mlps[1](self.mlps[0](obs)))


class DDPGCritic(_Net):
    """Twin Q over (obs, action) on a shared trunk."""

    def __init__(self, in_dim: int, action_dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__([MLP(in_dim + action_dim, (hidden_dim, "ntanh")),
                          MLP(hidden_dim, (hidden_dim, "irelu", 1)),
                          MLP(hidden_dim, (hidden_dim, "irelu", 1))], dtype)

    def forward(self, obs: Tensor, action: Tensor) -> tp.Tuple[Tensor, Tensor]:
        with self._compute(obs):
            h = self.mlps[0](torch.cat([obs, action], dim=-1))
            return self.mlps[1](h), self.mlps[2](h)


class RewardModel(_Net):
    """reward_model(obs) of the reward-free mode."""

    def __init__(self, in_dim: int, hidden_dim: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__([MLP(in_dim, (hidden_dim, "irelu", hidden_dim, "irelu", 1))], dtype)

    def forward(self, obs: Tensor) -> Tensor:
        with self._compute(obs):
            return self.mlps[0](obs)


@dataclasses.dataclass
class DDPGNoise(RowNoise):
    """The draws of one update: the target policy's noise (critic loss) and
    the policy's noise in the actor loss, each [n, action_dim]; on pixels
    also the random shifts of the observations and of the next
    observations, [n, 2] int64 each."""

    critic_normal: Tensor
    actor_normal: Tensor
    obs_shifts: tp.Optional[Tensor] = None
    next_obs_shifts: tp.Optional[Tensor] = None

    @classmethod
    def draw(cls, n: int, action_dim: int, generator: torch.Generator,
             device: torch.device, aug_pad: tp.Optional[int] = None) -> "DDPGNoise":
        """The draws of one update; ``aug_pad`` adds the shifts of the pixel
        update."""
        normals = [torch.randn(n, action_dim, generator=generator, device=device)
                   for _ in range(2)]
        if aug_pad is None:
            return cls(*normals)
        return cls(*normals, *(draw_shifts(n, aug_pad, generator, device) for _ in range(2)))


def with_meta(obs: Tensor, meta: MetaDict) -> Tensor:
    """The observation with the meta columns appended, in key order."""
    parts = [obs] + [meta[k] for k in sorted(meta)]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else obs


class DDPGAgent(nn.Module):
    """Networks, target critic and optimizers of one DDPG agent."""

    # the workspace hands it the environment's frame shape
    takes_obs_shape = True

    def __init__(self, cfg: DDPGConfig, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0, meta_dim: int = 0,
                 obs_shape: tp.Tuple[int, ...] = ()) -> None:
        super().__init__()
        self.cfg = cfg
        self.pixels = cfg.obs_type == "pixels"
        self.obs_shape = tuple(obs_shape)
        if self.pixels and len(self.obs_shape) != 3:
            raise ValueError(f"obs_type=pixels needs an (H, W, C) obs_shape, got {self.obs_shape}")
        # on pixels the networks take the encoder's features
        feature_dim = conv_repr_dim(*self.obs_shape[:2]) if self.pixels else obs_dim
        self.obs_dim, self.action_dim, self.meta_dim = feature_dim, action_dim, meta_dim
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        in_dim = feature_dim + meta_dim
        # weights are drawn on the CPU from the seed, then moved
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.actor = DDPGActor(in_dim, action_dim, cfg.hidden_dim, dtype)
            self.critic = DDPGCritic(in_dim, action_dim, cfg.hidden_dim, dtype)
            self.reward_model = (RewardModel(in_dim, cfg.hidden_dim, dtype)
                                 if cfg.reward_free else None)
            self.encoder = PixelEncoder(self.obs_shape[2], dtype) if self.pixels else None
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)
        self.to(self.device)
        self.actor_opt = Adam(self.actor, cfg.lr)
        self.critic_opt = Adam(self.critic, cfg.lr)
        self.encoder_opt = Adam(self.encoder, cfg.lr) if self.encoder is not None else None
        # over the MLP itself: the JAX reward model is a bare MLP, so its Adam
        # state carries the MLP's own parameter names
        self.reward_opt = (Adam(self.reward_model.mlps[0], 1e-3)
                           if self.reward_model is not None else None)
        self.register_buffer("step_t", torch.zeros((), dtype=torch.int64, device=self.device))
        self._stddev = schedule(cfg.stddev_schedule)

    @property
    def step(self) -> int:
        """Gradient steps taken (reading it waits for the device)."""
        return int(self.step_t)

    @step.setter
    def step(self, value: int) -> None:
        self.step_t.fill_(value)

    def _optimizers(self) -> tp.Dict[str, Adam]:
        opts = {"actor_opt": self.actor_opt, "critic_opt": self.critic_opt}
        if self.reward_opt is not None:
            opts["reward_opt"] = self.reward_opt
        if self.encoder_opt is not None:
            opts["encoder_opt"] = self.encoder_opt
        return opts

    def train_state(self) -> tp.Dict[str, Tensor]:
        """Every tensor an update changes, by name and not copied (as
        ``FBDDPGAgent.train_state``)."""
        out = dict(self.state_dict())
        for name, opt in self._optimizers().items():
            out.update({f"{name}.{k}": v for k, v in opt.state().items()})
        return out

    def load_train_state(self, state: tp.Mapping[str, Tensor]) -> None:
        load_train_state(self, state)

    # -- the policy interface ------------------------------------------
    def init_meta(self, generator: torch.Generator) -> MetaDict:
        return {}

    def rollout_update_meta(self, meta: MetaDict, t: Tensor, noise: StepNoise) -> MetaDict:
        return meta

    def step_noise(self, n: int, generator: torch.Generator) -> StepNoise:
        return StepNoise.draw(n, self.action_dim, generator, self.device)

    def policy_act(self, obs: Tensor, meta: MetaDict, step: tp.Union[int, Tensor],
                   generator: tp.Optional[torch.Generator] = None,
                   eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        return self.act(obs, meta, step, generator, eval_mode=eval_mode, noise=noise)

    @torch.no_grad()
    def act(self, obs: Tensor, meta: MetaDict, step: tp.Union[int, Tensor],
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        """Batched policy: the tanh mean in eval mode, else its truncated-normal
        sample, or a uniform action while ``step`` < num_expl_steps (selected
        on the device when ``step`` is a tensor)."""
        if self.pixels:
            obs = self._encode(obs)
        mu = self.actor(with_meta(obs, meta))
        if eval_mode:
            return mu
        normal, uniform = act_draws(noise, mu, generator)
        action = TruncatedNormal(mu, self._stddev(step)).sample(normal)
        return explore_until(action, uniform, step, self.cfg.num_expl_steps)

    def _encode(self, obs: Tensor) -> Tensor:
        """Flat frames [B, H*W*C] -> the encoder's features [B, D]."""
        assert self.encoder is not None
        return self.encoder(obs.reshape((obs.shape[0],) + self.obs_shape))

    def _augment(self, obs: Tensor, shifts: tp.Optional[Tensor]) -> Tensor:
        assert shifts is not None, "a pixel update takes its shifts in DDPGNoise"
        return random_shift_aug(obs.reshape((obs.shape[0],) + self.obs_shape), shifts,
                                self.cfg.aug_pad).reshape(obs.shape)

    # -- reward model (reward-free mode) ---------------------------------
    def train_reward(self, obs: Tensor, reward: Tensor, num_iters: int = 2000) -> None:
        """Fit reward_model(obs) to ``reward`` by regression, ``num_iters``
        Adam steps."""
        assert self.reward_model is not None and self.reward_opt is not None
        leaves = self.reward_opt.leaves
        for _ in range(num_iters):
            loss = (self.reward_model(obs).float() - reward).square().mean()
            self.reward_opt.step(torch.autograd.grad(loss, leaves))

    # -- the update -----------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator,
               group: tp.Any = None) -> Metrics:
        """One gradient step with noise drawn from ``generator``. With a
        process group, ``batch`` is this process's rows and the noise is
        drawn for the global batch (the generator seeded alike on every
        process), as ``_update`` takes it."""
        return self._update(batch, DDPGNoise.draw(
            batch.obs.shape[0] * Shard(group).world, self.action_dim, generator, self.device,
            aug_pad=self.cfg.aug_pad if self.pixels else None), group=group)

    def _update(self, batch: EpisodeBatch, noise: DDPGNoise,
                use_reward_model: tp.Optional[bool] = None, group: tp.Any = None) -> Metrics:
        """One gradient step. ``use_reward_model`` (default: reward_free)
        puts reward_model(next_obs) in place of the batch reward; the
        intrinsic agents pass False, their batch carries their reward. With
        ``group``, a data-parallel step (``utils/dist.py``): ``batch`` holds
        this process's rows, ``noise`` the global batch's draws; every loss is
        a mean over rows, so each process differentiates its part and the
        gradients are summed before each Adam step.

        On pixels the step runs with cuDNN's deterministic algorithms: a
        convolution's weight gradient may otherwise be summed with atomics
        in any order, and a captured update would not repeat the eager one
        to the bit."""
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        if not self.pixels:
            return self._step(batch, noise, use_reward_model, shard)
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return self._step(batch, noise, use_reward_model, shard)
        finally:
            torch.backends.cudnn.deterministic = before

    def _step(self, batch: EpisodeBatch, noise: DDPGNoise,
              use_reward_model: tp.Optional[bool], shard: Shard) -> Metrics:
        cfg = self.cfg
        if use_reward_model is None:
            use_reward_model = cfg.reward_free
        if self.pixels:
            obs_aug = self._augment(batch.obs, noise.obs_shifts)
            with torch.no_grad():
                next_obs = with_meta(self._encode(
                    self._augment(batch.next_obs, noise.next_obs_shifts)), batch.meta)
            # the encoder's gradient comes from the critic loss below
            obs = with_meta(self._encode(obs_aug), batch.meta)
        else:
            obs = with_meta(batch.obs, batch.meta)
            next_obs = with_meta(batch.next_obs, batch.meta)
        reward = batch.reward
        stddev = self._stddev(self.step_t)
        with torch.no_grad():
            if use_reward_model:
                assert self.reward_model is not None
                reward = self.reward_model(next_obs).float()
            mu = self.actor(next_obs)
            next_action = TruncatedNormal(mu, stddev).sample(noise.critic_normal,
                                                             clip=cfg.stddev_clip)
            tq1, tq2 = self.target_critic(next_obs, next_action)
            target_q = reward + batch.discount * torch.minimum(tq1, tq2).float()
        q1, q2 = self.critic(obs, batch.action)
        q1, q2 = q1.float(), q2.float()
        critic_loss = (q1 - target_q).square().mean() + (q2 - target_q).square().mean()
        critic_leaves = self.critic_opt.leaves
        encoder_leaves = (self.encoder_opt.leaves
                          if self.encoder_opt is not None and cfg.update_encoder else [])
        grads = shard.grad(critic_loss, critic_leaves + encoder_leaves)
        self.critic_opt.step(grads[:len(critic_leaves)])
        if encoder_leaves:
            assert self.encoder_opt is not None
            self.encoder_opt.step(grads[len(critic_leaves):])
        # the actor sees the critic's features detached: the encoder's
        # parameters before its step, as in the JAX update
        obs = obs.detach()

        # the actor step sees the freshly updated critic, as the JAX update does
        mu = self.actor(obs)
        dist = TruncatedNormal(mu, stddev)
        action = dist.sample(noise.actor_normal, clip=cfg.stddev_clip)
        aq1, aq2 = self.critic(obs, action)
        actor_loss = -torch.minimum(aq1, aq2).float().mean()
        self.actor_opt.step(shard.grad(actor_loss, self.actor_opt.leaves))
        soft_update(self.critic, self.target_critic, cfg.critic_target_tau)
        self.step_t += 1
        metrics = {"batch_reward": reward.mean(), "critic_target_q": target_q.mean(),
                   "critic_q1": q1.mean(), "critic_q2": q2.mean(), "critic_loss": critic_loss,
                   "actor_loss": actor_loss,
                   "actor_logprob": dist.log_prob(action).sum(-1).mean()}
        return shard.mean({k: v.detach().float() for k, v in metrics.items()})

