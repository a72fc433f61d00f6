"""FBDDPGAgent — the Forward-Backward zero-shot RL agent (mirror of
``controllable_agent_tpu/agents/fb_ddpg.py``).

Scaled-normalized z sampling, z-mixing from B(goals) with optional random
convex weights, hindsight future-goal z substitution, twin forward maps with
a min-target, the off-diagonal FB Bellman loss with the diagonal bonus, the
optional Q-loss with implicit reward B·Cov⁻¹·z, the B-orthonormality
regularizer, a DDPG actor on min(F1·z, F2·z), and zero-shot inference
z = B(g) and z = rᵀB/N.

In PyTorch idiom the agent is an ``nn.Module`` that owns its networks,
target networks and optimizers and updates them in place. All randomness of
an update is drawn up front into an ``UpdateNoise`` (``update`` draws it
from a ``torch.Generator``; ``_update`` takes it as an argument), so a test
can hand both packages identical noise.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import (Actor, BackwardMap, DiagGaussianActor, ForwardMap,
                               IdentityMap, l2_normalize)
from ..ops.fb import fb_loss_terms, orthonormality_loss, sample_z
from ..ops.fused_fb import fb_loss_terms_fused
from ..optim import Adam
from ..utils.device import DeviceLike, resolve_device
from ..utils.distributions import SquashedNormal, TruncatedNormal
from ..utils.schedules import schedule
from ..utils.tree import soft_update
from .base import MetaDict, ZMetaMixin

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class FBDDPGConfig:
    """Same fields and defaults as the JAX ``FBDDPGConfig``."""

    name: str = "fb_ddpg"
    obs_type: str = "states"
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
    update_z_proba: float = 1.0
    batch_size: int = 1024
    init_fb: bool = True
    goal_space: tp.Optional[str] = None
    ortho_coef: float = 1.0
    log_std_bounds: tp.Tuple[float, float] = (-5.0, 2.0)
    temp: float = 1.0
    boltzmann: bool = False
    debug: bool = False
    future_ratio: float = 0.0
    mix_ratio: float = 0.5
    rand_weight: bool = False
    preprocess: bool = True
    norm_z: bool = True
    q_loss: bool = False
    q_loss_coef: float = 0.01
    add_trunk: bool = False
    num_expl_steps: int = 0
    additional_metric: bool = False
    compute_dtype: str = "float32"  # "bfloat16" runs the net matmuls in bf16
    adam_mu_dtype: str = "bfloat16"  # Adam first-moment dtype ("float32" to disable)
    # the fused FB loss through the CUDA kernels of ops/fused_fb.py; it
    # skips the metrics that need the full M matrix (target_M, orth_linf,
    # orth_l2)
    use_pallas_loss: bool = False


@dataclasses.dataclass
class UpdateNoise:
    """Every random draw of one update, in the shapes the JAX update draws
    them (``_build_train_z``, the target policy noise, the actor noise)."""

    z_normal: Tensor  # [n, z_dim] standard normal of sample_z
    perm: Tensor  # [n] permutation of the backward inputs
    mix_uniform: Tensor  # [n, 1] mix mask draw
    next_action_normal: Tensor  # [n, action_dim] target policy noise
    actor_normal: Tensor  # [n, action_dim] actor-loss policy noise
    z_uniform: tp.Optional[Tensor] = None  # [n, z_dim], norm_z=False only
    w_uniform: tp.Optional[Tensor] = None  # [n, n], rand_weight only
    w_scale: tp.Optional[Tensor] = None  # [n, 1], rand_weight only
    future_uniform: tp.Optional[Tensor] = None  # [n, 1], future_ratio > 0 only

    @classmethod
    def draw(cls, cfg: FBDDPGConfig, n: int, action_dim: int,
             generator: torch.Generator, device: torch.device) -> "UpdateNoise":
        def normal(*shape: int) -> Tensor:
            return torch.randn(shape, generator=generator, device=device)

        def uniform(*shape: int) -> Tensor:
            return torch.rand(shape, generator=generator, device=device)

        rand_weight = cfg.rand_weight and cfg.mix_ratio > 0
        return cls(
            z_normal=normal(n, cfg.z_dim),
            perm=torch.randperm(n, generator=generator, device=device),
            mix_uniform=uniform(n, 1),
            next_action_normal=normal(n, action_dim),
            actor_normal=normal(n, action_dim),
            z_uniform=None if cfg.norm_z else uniform(n, cfg.z_dim),
            w_uniform=uniform(n, n) if rand_weight else None,
            w_scale=uniform(n, 1) if rand_weight else None,
            future_uniform=uniform(n, 1) if cfg.future_ratio > 0 else None)


def _dot(x: Tensor, z: Tensor) -> Tensor:
    """Row-wise x·z in float32 (einsum "sd,sd->s")."""
    return (x.float() * z.float()).sum(-1)


class FBDDPGAgent(ZMetaMixin, nn.Module):
    """Networks, target networks and optimizers of one FB agent."""

    def __init__(self, cfg: FBDDPGConfig, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.goal_dim = goal_dim if goal_dim is not None else obs_dim
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

        # weights are drawn on the CPU from the seed, then moved: the same
        # seed gives the same agent on every device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            if cfg.boltzmann:
                self.actor: nn.Module = DiagGaussianActor(
                    obs_dim, cfg.z_dim, action_dim, cfg.hidden_dim,
                    log_std_bounds=tuple(cfg.log_std_bounds), dtype=dtype)
            else:
                self.actor = Actor(obs_dim, cfg.z_dim, action_dim, cfg.feature_dim,
                                   cfg.hidden_dim, preprocess=cfg.preprocess,
                                   add_trunk=cfg.add_trunk, dtype=dtype)
            self.forward_net = ForwardMap(
                obs_dim, cfg.z_dim, action_dim, cfg.feature_dim, cfg.hidden_dim,
                preprocess=cfg.preprocess, add_trunk=cfg.add_trunk, dtype=dtype)
            if cfg.debug:
                self.backward_net: nn.Module = IdentityMap()
            else:
                self.backward_net = BackwardMap(self.goal_dim, cfg.z_dim,
                                                cfg.backward_hidden_dim,
                                                norm_z=cfg.norm_z, dtype=dtype)
        self.target_forward_net = copy.deepcopy(self.forward_net).requires_grad_(False)
        self.target_backward_net = copy.deepcopy(self.backward_net).requires_grad_(False)
        self.to(self.device)

        mu_dtype = torch.bfloat16 if cfg.adam_mu_dtype == "bfloat16" else torch.float32
        self.actor_opt = Adam(self.actor, cfg.lr, mu_dtype)
        self.fw_opt = Adam(self.forward_net, cfg.lr, mu_dtype)
        self.bw_opt = Adam(self.backward_net, cfg.lr_coef * cfg.lr, mu_dtype)
        self.step = 0  # gradient-step counter
        self._stddev = schedule(cfg.stddev_schedule)

    # -- z sampling and meta -------------------------------------------
    def sample_z(self, size: int, generator: torch.Generator) -> Tensor:
        normal = torch.randn(size, self.cfg.z_dim, generator=generator,
                             device=self.device)
        uniform = None if self.cfg.norm_z else torch.rand(
            size, self.cfg.z_dim, generator=generator, device=self.device)
        return sample_z(normal, uniform, self.cfg.norm_z)

    def init_meta(self, generator: torch.Generator) -> MetaDict:
        return {"z": self.sample_z(1, generator)[0]}

    @torch.no_grad()
    def get_goal_meta(self, goal: Tensor) -> Tensor:
        """Zero-shot z from a goal state: z = B(g)."""
        z = self.backward_net(goal[None]).float()
        if self.cfg.norm_z:
            z = l2_normalize(z)
        return z[0]

    @torch.no_grad()
    def infer_meta_from_obs_and_rewards(self, obs: Tensor, reward: Tensor) -> Tensor:
        """Zero-shot z from (state, reward) samples: z = rᵀB/N."""
        b = self.backward_net(obs).float()
        reward = reward.reshape(-1, 1).float()
        z = reward.T @ b / reward.shape[0]
        if self.cfg.norm_z:
            z = l2_normalize(z)
        return z[0]

    # -- eval diagnostics -------------------------------------------------
    @torch.no_grad()
    def compute_z_correl(self, goals: Tensor, z: Tensor) -> Tensor:
        """Mean L1-normalized correlation between B(goal_t) and z."""
        b = self.backward_net(goals).float()
        b = b / b.abs().sum(-1, keepdim=True).clamp_min(1e-12)
        zn = z / z.abs().sum().clamp_min(1e-12)
        return (b @ zn).mean()

    @torch.no_grad()
    def compute_actor_success(self, obs: Tensor, z: Tensor,
                              generator: torch.Generator) -> Tensor:
        """Fraction of states where Q(actor mean action) beats Q(uniform
        random action)."""
        zb = z.expand(obs.shape[0], z.shape[-1])
        if self.cfg.boltzmann:
            mu = torch.tanh(self.actor(obs, zb)[0])
        else:
            mu = self.actor(obs, zb)
        rand = torch.rand(mu.shape, generator=generator, device=mu.device) * 2.0 - 1.0

        def q_of(action: Tensor) -> Tensor:
            f1, f2 = self.forward_net(obs, zb, action)
            return torch.minimum(_dot(f1, zb), _dot(f2, zb))

        return (q_of(mu) > q_of(rand.to(mu.dtype))).float().mean()

    # -- acting ---------------------------------------------------------
    @torch.no_grad()
    def act(self, obs: Tensor, z: Tensor, step: int,
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False) -> Tensor:
        """Batched policy; obs [B, obs_dim], z [B, z_dim] -> action [B, A]."""
        if self.cfg.boltzmann:
            mu, std = self.actor(obs, z)
            dist = SquashedNormal(mu, std)
            if eval_mode:
                return dist.mean
            return dist.sample(torch.randn(mu.shape, generator=generator,
                                           device=mu.device))
        mu = self.actor(obs, z)
        if eval_mode:
            return mu
        if step < self.cfg.num_expl_steps:
            return torch.rand(mu.shape, generator=generator, device=mu.device) * 2 - 1
        dist = TruncatedNormal(mu, self._stddev(step))
        return dist.sample(torch.randn(mu.shape, generator=generator,
                                       device=mu.device))

    # -- z construction for the update ----------------------------------
    @torch.no_grad()
    def _build_train_z(self, batch: EpisodeBatch, noise: UpdateNoise) -> Tensor:
        cfg = self.cfg
        z = sample_z(noise.z_normal, noise.z_uniform, cfg.norm_z)
        backward_input = batch.goal if cfg.goal_space is not None else batch.obs
        future_goal = (batch.future_goal if cfg.goal_space is not None
                       else batch.future_obs)
        backward_input = backward_input[noise.perm]

        if cfg.mix_ratio > 0:
            b_all = self.backward_net(backward_input).float()
            if cfg.rand_weight:
                # random convex-ish mixtures of the whole batch's B vectors
                w = noise.w_uniform
                w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True).clamp_min(1e-12)
                mix_z = (noise.w_scale * w) @ b_all
            else:
                mix_z = b_all
            if cfg.norm_z:
                mix_z = l2_normalize(mix_z)
            z = torch.where(noise.mix_uniform < cfg.mix_ratio, mix_z, z)

        if cfg.future_ratio > 0:
            assert future_goal is not None, "future_ratio > 0 requires future goals"
            fut_z = self.backward_net(future_goal).float()
            z = torch.where(noise.future_uniform < cfg.future_ratio, fut_z, z)
        return z

    # -- losses ---------------------------------------------------------
    @torch.no_grad()
    def _targets(self, batch: EpisodeBatch, z: Tensor, next_goal: Tensor,
                 normal: Tensor) -> tp.Tuple[Tensor, Tensor, Tensor]:
        """Target F1, F2 at the next state and target B at the next goal,
        float32 and without gradient."""
        next_obs = batch.next_obs
        if self.cfg.boltzmann:
            mu, std = self.actor(next_obs, z)
            next_action = SquashedNormal(mu, std).sample(normal)
        else:
            mu = self.actor(next_obs, z)
            dist = TruncatedNormal(mu, self._stddev(self.step))
            next_action = dist.sample(normal, clip=self.cfg.stddev_clip)
        tf1, tf2 = self.target_forward_net(next_obs, z, next_action)
        tb = self.target_backward_net(next_goal)
        return tf1.float(), tf2.float(), tb.float()

    def _fb_loss(self, batch: EpisodeBatch, z: Tensor, next_goal: Tensor,
                 normal: Tensor) -> tp.Tuple[Tensor, Metrics]:
        cfg = self.cfg
        target_f1, target_f2, target_b = self._targets(batch, z, next_goal, normal)
        if cfg.use_pallas_loss:
            return self._fb_loss_fused(batch, z, next_goal, target_f1, target_f2,
                                       target_b)
        target_m = torch.minimum(target_f1 @ target_b.T, target_f2 @ target_b.T)

        f1, f2 = self.forward_net(batch.obs, z, batch.action)
        b = self.backward_net(next_goal)
        fb_loss, fb_diag, fb_offdiag = fb_loss_terms(f1, f2, b, target_m,
                                                     batch.discount)
        metrics: Metrics = {
            "target_M": target_m.mean(),
            "F1": f1.mean(),
            "B": b.mean(),
            "B_norm": torch.linalg.vector_norm(b, dim=-1).mean(),
            "z_norm": torch.linalg.vector_norm(z, dim=-1).mean(),
            "fb_diag": fb_diag,
            "fb_offdiag": fb_offdiag,
        }

        bf = b.float()
        if cfg.q_loss:
            # Q-regularizer with implicit reward B·Cov⁻¹·z, in float32 (the
            # JAX path inverts in the compute dtype; the two agree in f32)
            next_q = torch.minimum(_dot(target_f1, z), _dot(target_f2, z))
            cov = bf.T @ bf / bf.shape[0]
            implicit_reward = ((bf @ torch.linalg.inv(cov)) * z).sum(1)
            target_q = (implicit_reward + batch.discount[:, 0] * next_q).detach()
            q_loss = ((_dot(f1, z) - target_q).square().mean()
                      + (_dot(f2, z) - target_q).square().mean())
            fb_loss = fb_loss + cfg.q_loss_coef * q_loss
            metrics["q_loss"] = q_loss

        orth_loss, orth_diag, orth_offdiag = orthonormality_loss(b)
        fb_loss = fb_loss + cfg.ortho_coef * orth_loss
        metrics.update(orth_loss=orth_loss, orth_loss_diag=orth_diag,
                       orth_loss_offdiag=orth_offdiag, fb_loss=fb_loss)
        eye_diff = (bf.T @ bf / bf.shape[0]
                    - torch.eye(bf.shape[1], device=bf.device))
        metrics["orth_linf"] = eye_diff.abs().max()
        metrics["orth_l2"] = torch.linalg.norm(eye_diff) / math.sqrt(bf.shape[1])
        return fb_loss, metrics

    def _fb_loss_fused(self, batch: EpisodeBatch, z: Tensor, next_goal: Tensor,
                       target_f1: Tensor, target_f2: Tensor, target_b: Tensor
                       ) -> tp.Tuple[Tensor, Metrics]:
        """FB + orthonormality losses through the CUDA kernels
        (ops/fused_fb.py; the JAX ``_fb_loss_pallas``); same math as the
        unfused path minus the full-matrix diagnostics."""
        cfg = self.cfg
        n = batch.obs.shape[0]
        f1, f2 = self.forward_net(batch.obs, z, batch.action)
        b = self.backward_net(next_goal)
        off_sum, diag_sum, cov_off_sum, cov_diag_sum = fb_loss_terms_fused(
            f1.float(), f2.float(), b.float(), target_f1, target_f2, target_b,
            batch.discount.float())
        denom = n * (n - 1)
        fb_offdiag = 0.5 * off_sum / denom
        fb_diag = -diag_sum / n
        orth_diag = -2.0 * cov_diag_sum / n
        orth_offdiag = cov_off_sum / denom
        orth_loss = orth_offdiag + orth_diag
        fb_loss = fb_offdiag + fb_diag + cfg.ortho_coef * orth_loss
        metrics: Metrics = {
            "F1": f1.mean(), "B": b.mean(),
            "B_norm": torch.linalg.vector_norm(b, dim=-1).mean(),
            "z_norm": torch.linalg.vector_norm(z, dim=-1).mean(),
            "fb_diag": fb_diag, "fb_offdiag": fb_offdiag,
            "orth_loss": orth_loss, "orth_loss_diag": orth_diag,
            "orth_loss_offdiag": orth_offdiag, "fb_loss": fb_loss,
        }
        return fb_loss, metrics

    def _actor_loss(self, obs: Tensor, z: Tensor, normal: Tensor
                    ) -> tp.Tuple[Tensor, Metrics]:
        cfg = self.cfg
        if cfg.boltzmann:
            mu, std = self.actor(obs, z)
            dist = SquashedNormal(mu, std)
            action, pre_tanh = dist.sample_with_pre_tanh(normal)
            log_prob = dist.log_prob_from_pre_tanh(pre_tanh).sum(-1)
        else:
            mu = self.actor(obs, z)
            tn = TruncatedNormal(mu, self._stddev(self.step))
            action = tn.sample(normal, clip=cfg.stddev_clip)
            log_prob = tn.log_prob(action).sum(-1)
        f1, f2 = self.forward_net(obs, z, action)
        q = torch.minimum(_dot(f1, z), _dot(f2, z))
        actor_loss = ((cfg.temp * log_prob - q).mean() if cfg.boltzmann
                      else -q.mean())
        return actor_loss, {"actor_loss": actor_loss, "q": q.mean(),
                            "actor_logprob": log_prob.mean()}

    # -- the update -----------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator) -> Metrics:
        """One gradient step with noise drawn from ``generator``."""
        noise = UpdateNoise.draw(self.cfg, batch.obs.shape[0], self.action_dim,
                                 generator, self.device)
        return self._update(batch, noise)

    def _update(self, batch: EpisodeBatch, noise: UpdateNoise) -> Metrics:
        cfg = self.cfg
        next_goal = batch.next_goal if cfg.goal_space is not None else batch.next_obs
        z = self._build_train_z(batch, noise)

        fb_loss, metrics = self._fb_loss(batch, z, next_goal, noise.next_action_normal)
        fw_params = list(self.fw_opt.params.values())
        bw_params = list(self.bw_opt.params.values())
        grads = torch.autograd.grad(fb_loss, fw_params + bw_params)
        self.fw_opt.step(grads[:len(fw_params)])
        self.bw_opt.step(grads[len(fw_params):])

        # the actor step uses the freshly updated forward net, as the JAX
        # update does (fb_ddpg.py:471-476)
        actor_loss, actor_metrics = self._actor_loss(batch.obs, z, noise.actor_normal)
        self.actor_opt.step(torch.autograd.grad(
            actor_loss, list(self.actor_opt.params.values())))

        soft_update(self.forward_net, self.target_forward_net, cfg.fb_target_tau)
        soft_update(self.backward_net, self.target_backward_net, cfg.fb_target_tau)
        self.step += 1
        metrics.update(actor_metrics)
        return {k: v.detach() for k, v in metrics.items()}
