"""Goal-conditioned baselines: GoalTD3 and GoalSM (mirror of
``controllable_agent_tpu/agents/goal_agents.py``).

  * ``GoalTD3Agent``: a twin critic Q(s, g, a) and an actor π(s, g) trained
    by TD on the maze's tolerance reward to a desired goal: one of the 20
    maze goals drawn uniformly (``supervised``), else the batch's achieved
    goals permuted; with ``future_ratio`` > 0 a share of them is the
    sampled future goal (hindsight). ``fb_reward`` is a field that the
    update never reads, as in JAX.
  * ``GoalSMAgent``: the successor-measure critic, an off-diagonal TD term
    against the desired goals (no reward) and a −Q(s, achieved goal, a)
    diagonal bonus. Its desired goals are the batch's ``g`` meta when it
    has one: ``init_meta`` is zeros, as in JAX, so an online run stores
    zero goals and trains on them; the permuted achieved goals are used
    only when the batch carries no ``g``.

The meta key is ``g`` and ``get_goal_meta`` is the identity, so the
workspace's 20-goal maze sweep (``eval_maze_goals``) drives either agent
with the goals themselves. The draws of an update come in one
``GoalNoise``.
"""

from __future__ import annotations

import copy
import dataclasses
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..goals.rewards import MazeMultiGoal
from ..models.networks import MLP, _Net
from ..ops.tolerance import tolerance
from ..optim import Adam
from ..utils.device import DeviceLike, resolve_device
from ..utils.dist import RowNoise, Shard
from ..utils.distributions import TruncatedNormal
from ..utils.schedules import schedule
from ..utils.tree import soft_update
from .base import MetaDict, StepNoise, ZMetaMixin, act_draws, explore_until, load_train_state

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]

# the 20 maze goals, in the order of the 20-goal sweep
MAZE_GOALS = MazeMultiGoal().goals


def maze_goal_reward(achieved: Tensor, desired: Tensor) -> Tensor:
    """The maze's tolerance reward on the goal distance [..., 1]: 1 within
    0.03, 0.1 at 0.03 beyond it."""
    dist = torch.linalg.vector_norm(achieved - desired, dim=-1)
    return tolerance(dist, bounds=(0.0, 0.03), margin=0.03)[..., None]


class GoalActor(_Net):
    def __init__(self, obs_dim: int, goal_dim: int, action_dim: int, hidden_dim: int) -> None:
        super().__init__([MLP(obs_dim + goal_dim, (hidden_dim, "ntanh")),
                          MLP(hidden_dim, (hidden_dim, "irelu", action_dim))], torch.float32)

    def forward(self, obs: Tensor, goal: Tensor) -> Tensor:
        return torch.tanh(self.mlps[1](self.mlps[0](torch.cat([obs, goal], -1))))


class GoalCritic(_Net):
    """Twin Q over (obs, goal, action) on a shared trunk."""

    def __init__(self, obs_dim: int, goal_dim: int, action_dim: int, hidden_dim: int) -> None:
        super().__init__([MLP(obs_dim + goal_dim + action_dim, (hidden_dim, "ntanh")),
                          MLP(hidden_dim, (hidden_dim, "irelu", 1)),
                          MLP(hidden_dim, (hidden_dim, "irelu", 1))], torch.float32)

    def forward(self, obs: Tensor, goal: Tensor, action: Tensor) -> tp.Tuple[Tensor, Tensor]:
        h = self.mlps[0](torch.cat([obs, goal, action], -1))
        return self.mlps[1](h), self.mlps[2](h)


@dataclasses.dataclass(frozen=True)
class GoalTD3Config:
    """Same fields and defaults as the JAX ``GoalTD3Config``."""

    name: str = "goal_td3"
    lr: float = 1e-4
    critic_target_tau: float = 0.01
    update_every_steps: int = 2
    hidden_dim: int = 1024
    feature_dim: int = 512
    stddev_schedule: str = "0.2"
    stddev_clip: float = 0.3
    batch_size: int = 1024
    goal_space: tp.Optional[str] = None
    supervised: bool = True  # uniform maze goals vs replay goals
    future_ratio: float = 0.0
    fb_reward: bool = False
    num_expl_steps: int = 0
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class GoalSMConfig:
    """Same fields and defaults as the JAX ``GoalSMConfig``."""

    name: str = "goal_sm"
    lr: float = 1e-4
    critic_target_tau: float = 0.01
    update_every_steps: int = 2
    hidden_dim: int = 1024
    stddev_schedule: str = "0.2"
    stddev_clip: float = 0.3
    batch_size: int = 1024
    goal_space: tp.Optional[str] = None
    update_meta_every_step: int = 100
    future_ratio: float = 0.0
    num_expl_steps: int = 0
    compute_dtype: str = "float32"


@dataclasses.dataclass
class GoalNoise(RowNoise):
    """Every draw of one update: the maze goals' indices (``supervised``),
    the permutation of the achieved goals (of the global batch), the future
    mask's uniform (``future_ratio`` > 0), the target policy's and the
    actor's noise."""

    WHOLE = ("perm",)

    critic_normal: Tensor  # [n, action_dim]
    actor_normal: Tensor  # [n, action_dim]
    perm: Tensor  # [n]
    goal_index: tp.Optional[Tensor] = None  # [n] int64 in [0, 20)
    future_uniform: tp.Optional[Tensor] = None  # [n, 1]

    @classmethod
    def draw(cls, n: int, action_dim: int, supervised: bool, future: bool,
             generator: torch.Generator, device: torch.device) -> "GoalNoise":
        normals = [torch.randn(n, action_dim, generator=generator, device=device)
                   for _ in range(2)]
        return cls(*normals, perm=torch.randperm(n, generator=generator, device=device),
                   goal_index=torch.randint(len(MAZE_GOALS), (n,), generator=generator,
                                            device=device) if supervised else None,
                   future_uniform=torch.rand((n, 1), generator=generator, device=device)
                   if future else None)


class GoalTD3Agent(ZMetaMixin, nn.Module):
    """Actor, twin critic, its target and two Adams."""

    meta_key = "g"

    def __init__(self, cfg: tp.Any, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.goal_dim = goal_dim if goal_dim is not None else 2
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.actor = GoalActor(obs_dim, self.goal_dim, action_dim, cfg.hidden_dim)
            self.critic = GoalCritic(obs_dim, self.goal_dim, action_dim, cfg.hidden_dim)
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)
        self.register_buffer("step_t", torch.zeros((), dtype=torch.int64))
        # a constant, not state: left out of checkpoints
        self.register_buffer("maze_goals", torch.from_numpy(MAZE_GOALS), persistent=False)
        self.to(self.device)
        self.actor_opt = Adam(self.actor, cfg.lr)
        self.critic_opt = Adam(self.critic, cfg.lr)
        self._stddev = schedule(cfg.stddev_schedule)

    @property
    def step(self) -> int:
        """Gradient steps taken (reading it waits for the device)."""
        return int(self.step_t)

    @step.setter
    def step(self, value: int) -> None:
        self.step_t.fill_(value)

    def train_state(self) -> tp.Dict[str, Tensor]:
        """Every tensor an update changes, by name and not copied."""
        out = dict(self.state_dict())
        for name in ("actor_opt", "critic_opt"):
            out.update({f"{name}.{k}": v for k, v in getattr(self, name).state().items()})
        return out

    def load_train_state(self, state: tp.Mapping[str, Tensor]) -> None:
        load_train_state(self, state)

    # -- meta ------------------------------------------------------------
    @property
    def meta_dims(self) -> tp.Dict[str, int]:
        return {"g": self.goal_dim}

    def init_meta(self, generator: torch.Generator) -> MetaDict:
        """One of the 20 maze goals, uniformly."""
        idx = torch.randint(len(MAZE_GOALS), (), generator=generator, device=generator.device)
        return {"g": self.maze_goals.to(generator.device)[idx]}

    def update_meta(self, meta: MetaDict, global_step: int,
                    generator: torch.Generator) -> MetaDict:
        return meta

    def get_goal_meta(self, goal: Tensor) -> Tensor:
        return goal

    # -- acting ----------------------------------------------------------
    @torch.no_grad()
    def act(self, obs: Tensor, goal: Tensor, step: tp.Union[int, Tensor],
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        mu = self.actor(obs, goal.expand(obs.shape[0], goal.shape[-1]))
        if eval_mode:
            return mu
        normal, uniform = act_draws(noise, mu, generator)
        action = TruncatedNormal(mu, self._stddev(step)).sample(normal)
        return explore_until(action, uniform, step, self.cfg.num_expl_steps)

    # -- the update ------------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator,
               group: tp.Any = None) -> Metrics:
        """One gradient step with noise drawn from ``generator``; with a
        process group, the noise of the global batch (``DDPGAgent.update``)."""
        cfg = self.cfg
        return self._update(batch, GoalNoise.draw(
            batch.obs.shape[0] * Shard(group).world, self.action_dim,
            getattr(cfg, "supervised", False), cfg.future_ratio > 0, generator, self.device),
            group)

    def _future_mix(self, desired: Tensor, batch: EpisodeBatch, noise: GoalNoise) -> Tensor:
        """``desired``, a share future_ratio of it replaced by the future goal."""
        cfg = self.cfg
        future = batch.future_goal if cfg.goal_space is not None else batch.future_obs
        if cfg.future_ratio > 0 and future is not None:
            assert noise.future_uniform is not None
            desired = torch.where(noise.future_uniform < cfg.future_ratio,
                                  future[..., :desired.shape[-1]], desired)
        return desired

    @staticmethod
    def _permuted(achieved: Tensor, noise: GoalNoise, shard: Shard = Shard()) -> Tensor:
        """This process's rows of the global batch's achieved goals permuted."""
        return shard.gather(achieved)[noise.perm[shard.rows(noise.perm.shape[0])]]

    def _desired(self, batch: EpisodeBatch, achieved: Tensor, noise: GoalNoise,
                 shard: Shard = Shard()) -> Tensor:
        if self.cfg.supervised:
            assert noise.goal_index is not None
            desired = self.maze_goals[noise.goal_index]
        else:
            desired = self._permuted(achieved, noise, shard)
        return self._future_mix(desired, batch, noise)

    def _critic_loss(self, batch: EpisodeBatch, achieved: Tensor, desired: Tensor,
                     next_action: Tensor) -> tp.Tuple[Tensor, Tensor, Metrics]:
        """TD on the maze reward: (loss, Q1, metrics)."""
        reward = maze_goal_reward(achieved, desired)
        with torch.no_grad():
            tq1, tq2 = self.target_critic(batch.next_obs, desired, next_action)
            target_q = reward + batch.discount * torch.minimum(tq1, tq2)
        q1, q2 = self.critic(batch.obs, desired, batch.action)
        loss = (q1 - target_q).square().mean() + (q2 - target_q).square().mean()
        return loss, q1, {"batch_reward": reward.mean()}

    def _update(self, batch: EpisodeBatch, noise: GoalNoise, group: tp.Any = None) -> Metrics:
        """One gradient step; with ``group`` a data-parallel one
        (``DDPGAgent._update``): the permutation ranges over the global
        batch, the losses are per row."""
        cfg = self.cfg
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        achieved = batch.next_goal if batch.next_goal is not None else batch.next_obs
        desired = self._desired(batch, achieved, noise, shard)
        stddev = self._stddev(self.step_t)
        with torch.no_grad():
            next_action = TruncatedNormal(self.actor(batch.next_obs, desired), stddev).sample(
                noise.critic_normal, clip=cfg.stddev_clip)
        critic_loss, q1, metrics = self._critic_loss(batch, achieved, desired, next_action)
        self.critic_opt.step(shard.grad(critic_loss, self.critic_opt.leaves))
        # the actor step sees the freshly updated critic
        action = TruncatedNormal(self.actor(batch.obs, desired), stddev).sample(
            noise.actor_normal, clip=cfg.stddev_clip)
        actor_loss = -torch.minimum(*self.critic(batch.obs, desired, action)).mean()
        self.actor_opt.step(shard.grad(actor_loss, self.actor_opt.leaves))
        soft_update(self.critic, self.target_critic, cfg.critic_target_tau)
        self.step_t += 1
        metrics.update(critic_loss=critic_loss, critic_q1=q1.mean(), actor_loss=actor_loss)
        return shard.mean({k: v.detach() for k, v in metrics.items()})


class GoalSMAgent(GoalTD3Agent):
    """The successor-measure critic on GoalTD3's networks."""

    def init_meta(self, generator: torch.Generator) -> MetaDict:
        """Zeros: the JAX agent has no replay to draw an achieved goal from."""
        return {"g": torch.zeros(self.goal_dim, device=generator.device)}

    def _desired(self, batch: EpisodeBatch, achieved: Tensor, noise: GoalNoise,
                 shard: Shard = Shard()) -> Tensor:
        desired = batch.meta.get("g")
        if desired is None or desired.ndim == 1:
            desired = self._permuted(achieved, noise, shard)
        return self._future_mix(desired, batch, noise)

    def _critic_loss(self, batch: EpisodeBatch, achieved: Tensor, desired: Tensor,
                     next_action: Tensor) -> tp.Tuple[Tensor, Tensor, Metrics]:
        """The off-diagonal TD term against the desired goals plus the
        diagonal bonus −Q(s, achieved, a)."""
        with torch.no_grad():
            target_q = torch.minimum(*self.target_critic(batch.next_obs, desired, next_action))
        q1, q2 = self.critic(batch.obs, desired, batch.action)
        q1d, q2d = self.critic(batch.obs, achieved, batch.action)
        offdiag = 0.5 * ((q1 - batch.discount * target_q).square().mean()
                         + (q2 - batch.discount * target_q).square().mean())
        return offdiag - (q1d.mean() + q2d.mean()), q1, {}
