"""UVFAgent — a universal value function on the FB networks (mirror of
``controllable_agent_tpu/agents/uvf.py``).

A goal-conditioned critic Q(s, a, z) = F(s, a, z)·z with z = B(desired
goal), trained by TD on the indicator reward ‖next goal − desired‖ < 1e-6;
F and B both take the critic loss's gradient (B at ``lr_coef``·lr). The
desired goals are the batch's next goals permuted, a share ``mix_ratio``
of them replaced by the row's own next goal. ``BackwardMap`` normalises its
output when ``norm_z`` is set, and ``get_goal_meta`` normalises z = B(g)
again, as the JAX agent does; both are kept.

The permutation is ``torch.randperm`` from the registered generator (as
SF's); a parity test hands the JAX update's own draws in through
``UVFNoise``. Data-parallel (``group``, ``utils/dist.py``), it permutes the
next goals of the global batch; the losses are per row.
"""

from __future__ import annotations

import copy
import dataclasses
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import Actor, BackwardMap, ForwardMap, l2_normalize
from ..ops.fb import sample_z
from ..optim import Adam
from ..utils.device import DeviceLike, resolve_device
from ..utils.dist import RowNoise, Shard
from ..utils.distributions import TruncatedNormal
from ..utils.schedules import schedule
from ..utils.tree import soft_update
from .base import MetaDict, StepNoise, ZMetaMixin, act_draws, explore_until, load_train_state

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class UVFConfig:
    """Same fields and defaults as the JAX ``UVFConfig``."""

    name: str = "uvf"
    lr: float = 1e-4
    lr_coef: float = 1.0
    fb_target_tau: float = 0.01
    update_every_steps: int = 2
    num_inference_steps: int = 5120
    hidden_dim: int = 1024
    backward_hidden_dim: int = 526
    feature_dim: int = 512
    z_dim: int = 50
    stddev_schedule: str = "0.2"
    stddev_clip: float = 0.3
    update_z_every_step: int = 300
    batch_size: int = 1024
    goal_space: tp.Optional[str] = None
    boltzmann: bool = False
    temp: float = 1.0
    mix_ratio: float = 0.5
    preprocess: bool = True
    norm_z: bool = True
    add_trunk: bool = False
    num_expl_steps: int = 0
    compute_dtype: str = "float32"


@dataclasses.dataclass
class UVFNoise(RowNoise):
    """Every draw of one UVF update: the permutation of the desired goals
    (of the global batch), the mix mask's uniform, the target policy's and
    the actor's noise."""

    WHOLE = ("perm",)

    perm: Tensor  # [n]
    mix_uniform: Tensor  # [n, 1]
    critic_normal: Tensor  # [n, action_dim]
    actor_normal: Tensor  # [n, action_dim]

    @classmethod
    def draw(cls, n: int, action_dim: int, generator: torch.Generator,
             device: torch.device) -> "UVFNoise":
        return cls(torch.randperm(n, generator=generator, device=device),
                   torch.rand((n, 1), generator=generator, device=device),
                   *(torch.randn(n, action_dim, generator=generator, device=device)
                     for _ in range(2)))


def _dot(x: Tensor, z: Tensor) -> Tensor:
    return (x * z).sum(-1)


class UVFAgent(ZMetaMixin, nn.Module):
    """Actor, forward and backward maps, the forward target and three Adams."""

    def __init__(self, cfg: UVFConfig, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.goal_dim = goal_dim if goal_dim is not None else obs_dim
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.actor = Actor(obs_dim, cfg.z_dim, action_dim, cfg.feature_dim,
                               cfg.hidden_dim, preprocess=cfg.preprocess,
                               add_trunk=cfg.add_trunk)
            self.forward_net = ForwardMap(obs_dim, cfg.z_dim, action_dim, cfg.feature_dim,
                                          cfg.hidden_dim, preprocess=cfg.preprocess,
                                          add_trunk=cfg.add_trunk)
            self.backward_net = BackwardMap(self.goal_dim, cfg.z_dim, cfg.backward_hidden_dim,
                                            norm_z=cfg.norm_z)
        self.target_forward_net = copy.deepcopy(self.forward_net).requires_grad_(False)
        self.register_buffer("step_t", torch.zeros((), dtype=torch.int64))
        self.to(self.device)
        self.actor_opt = Adam(self.actor, cfg.lr)
        self.fw_opt = Adam(self.forward_net, cfg.lr)
        self.bw_opt = Adam(self.backward_net, cfg.lr_coef * cfg.lr)
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
        for name in ("actor_opt", "fw_opt", "bw_opt"):
            out.update({f"{name}.{k}": v for k, v in getattr(self, name).state().items()})
        return out

    def load_train_state(self, state: tp.Mapping[str, Tensor]) -> None:
        load_train_state(self, state)

    # -- meta ------------------------------------------------------------
    def z_from_noise(self, normal: Tensor, uniform: tp.Optional[Tensor] = None) -> Tensor:
        """z from its normal draw: on the sphere of radius sqrt(z_dim)."""
        return sample_z(normal, None, True)

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
    def get_goal_meta(self, goal: Tensor) -> Tensor:
        """z = B(g), normalised once more with norm_z."""
        z = self.backward_net(goal[None])
        if self.cfg.norm_z:
            z = l2_normalize(z)
        return z[0]

    # -- acting ----------------------------------------------------------
    @torch.no_grad()
    def act(self, obs: Tensor, z: Tensor, step: tp.Union[int, Tensor],
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        mu = self.actor(obs, z.expand(obs.shape[0], z.shape[-1]))
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
        return self._update(batch, UVFNoise.draw(batch.obs.shape[0] * Shard(group).world,
                                                 self.action_dim, generator, self.device),
                            group)

    def _q(self, net: nn.Module, obs: Tensor, z: Tensor, action: Tensor
           ) -> tp.Tuple[Tensor, Tensor]:
        f1, f2 = net(obs, z, action)
        return _dot(f1, z), _dot(f2, z)

    def _update(self, batch: EpisodeBatch, noise: UVFNoise, group: tp.Any = None) -> Metrics:
        """One gradient step; with ``group`` a data-parallel one
        (``DDPGAgent._update``)."""
        cfg = self.cfg
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        next_goal = batch.next_goal if cfg.goal_space is not None else batch.next_obs
        desired = shard.gather(next_goal)[noise.perm[shard.rows(noise.perm.shape[0])]]
        if cfg.mix_ratio > 0:
            desired = torch.where(noise.mix_uniform < cfg.mix_ratio, next_goal, desired)
        stddev = self._stddev(self.step_t)

        z = self.backward_net(desired)
        with torch.no_grad():
            reward = (torch.linalg.vector_norm(next_goal - desired, dim=1) < 1e-6).float()
            zd = z.detach()
            next_action = TruncatedNormal(self.actor(batch.next_obs, zd), stddev).sample(
                noise.critic_normal, clip=cfg.stddev_clip)
            next_q = torch.minimum(*self._q(self.target_forward_net, batch.next_obs, zd,
                                            next_action))
            target_q = reward + batch.discount[:, 0] * next_q
        q1, q2 = self._q(self.forward_net, batch.obs, z, batch.action)
        fb_loss = (q1 - target_q).square().mean() + (q2 - target_q).square().mean()
        fw_leaves = self.fw_opt.leaves
        bw_leaves = self.bw_opt.leaves
        grads = shard.grad(fb_loss, fw_leaves + bw_leaves)
        self.fw_opt.step(grads[:len(fw_leaves)])
        self.bw_opt.step(grads[len(fw_leaves):])

        # the actor step sees the freshly updated F and B
        with torch.no_grad():
            z = self.backward_net(desired)
        action = TruncatedNormal(self.actor(batch.obs, z), stddev).sample(
            noise.actor_normal, clip=cfg.stddev_clip)
        actor_loss = -torch.minimum(*self._q(self.forward_net, batch.obs, z, action)).mean()
        self.actor_opt.step(shard.grad(actor_loss, self.actor_opt.leaves))
        soft_update(self.forward_net, self.target_forward_net, cfg.fb_target_tau)
        self.step_t += 1
        metrics = {"fb_loss": fb_loss, "z_norm": torch.linalg.vector_norm(zd, dim=-1).mean(),
                   "actor_loss": actor_loss}
        return shard.mean({k: v.detach() for k, v in metrics.items()})
