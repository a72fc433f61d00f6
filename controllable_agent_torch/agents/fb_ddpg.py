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

An update touches no host state: the step counter is a device tensor
(``step_t``; ``step`` reads it), the schedules take it as it is, Adam keeps
its counts and moments in fixed tensors, and the noise is drawn with
operations that a CUDA graph can capture. ``train/loops.py`` captures
sample -> update as one program; the generator it draws from has to be
registered with that graph. With ``q_loss`` the inverse of Cov(B) runs
eagerly between two graphs (``utils/graphs.py:eager_step``).
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
from ..utils.dist import RowNoise, Shard
from ..utils.distributions import SquashedNormal, TruncatedNormal
from ..utils.graphs import eager_step
from ..utils.schedules import schedule
from ..utils.tree import soft_update
from .base import (MetaDict, StepNoise, ZMetaMixin, act_draws, explore_until,
                   load_train_state)

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
class UpdateNoise(RowNoise):
    """Every random draw of one update, in the shapes the JAX update draws
    them (``_build_train_z``, the target policy noise, the actor noise; a
    discrete FB update draws no action noise). ``rows`` slices every
    per-row draw and keeps the permutation (over the global batch) whole."""

    WHOLE = ("perm",)

    z_normal: Tensor  # [n, z_dim] standard normal of sample_z
    perm: Tensor  # [n] permutation of the backward inputs
    mix_uniform: Tensor  # [n, 1] mix mask draw
    next_action_normal: tp.Optional[Tensor] = None  # [n, action_dim] target policy noise
    actor_normal: tp.Optional[Tensor] = None  # [n, action_dim] actor-loss policy noise
    z_uniform: tp.Optional[Tensor] = None  # [n, z_dim], norm_z=False only
    w_uniform: tp.Optional[Tensor] = None  # [n, n], rand_weight only
    w_scale: tp.Optional[Tensor] = None  # [n, 1], rand_weight only
    future_uniform: tp.Optional[Tensor] = None  # [n, 1], future_ratio > 0 only

    @classmethod
    def draw(cls, cfg: tp.Any, n: int, action_dim: int,
             generator: torch.Generator, device: torch.device) -> "UpdateNoise":
        """The draws for ``cfg`` (an FB or discrete FB config); ``action_dim``
        0 draws no action noise."""
        def normal(*shape: int) -> Tensor:
            return torch.randn(shape, generator=generator, device=device)

        def uniform(*shape: int) -> Tensor:
            return torch.rand(shape, generator=generator, device=device)

        rand_weight = cfg.rand_weight and cfg.mix_ratio > 0
        return cls(
            z_normal=normal(n, cfg.z_dim),
            perm=torch.randperm(n, generator=generator, device=device),
            mix_uniform=uniform(n, 1),
            next_action_normal=normal(n, action_dim) if action_dim else None,
            actor_normal=normal(n, action_dim) if action_dim else None,
            z_uniform=None if cfg.norm_z else uniform(n, cfg.z_dim),
            w_uniform=uniform(n, n) if rand_weight else None,
            w_scale=uniform(n, 1) if rand_weight else None,
            future_uniform=uniform(n, 1) if cfg.future_ratio > 0 else None)


def _dot(x: Tensor, z: Tensor) -> Tensor:
    """Row-wise x·z in float32 (einsum "sd,sd->s")."""
    return (x.float() * z.float()).sum(-1)


@torch.no_grad()
def build_train_z(cfg: tp.Any, backward_net: nn.Module, batch: EpisodeBatch,
                  noise: UpdateNoise, shard: Shard = Shard()) -> Tensor:
    """The z of each sample of an update (FB and discrete FB alike): sampled,
    replaced with probability mix_ratio by B of permuted goals (random
    convex-ish mixtures of them with rand_weight), and with probability
    future_ratio by B of the sampled future goal. Data-parallel, ``batch``
    and ``noise`` are this process's rows (``UpdateNoise.rows``) and the
    permutation and the mixtures range over the goals of every process."""
    z = sample_z(noise.z_normal, noise.z_uniform, cfg.norm_z)
    backward_input = batch.goal if cfg.goal_space is not None else batch.obs
    future_goal = (batch.future_goal if cfg.goal_space is not None
                   else batch.future_obs)
    backward_input = shard.gather(backward_input)[noise.perm]

    if cfg.mix_ratio > 0:
        b_all = backward_net(backward_input).float()
        if cfg.rand_weight:
            # random convex-ish mixtures of the whole batch's B vectors
            w = noise.w_uniform
            w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True).clamp_min(1e-12)
            mix_z = (noise.w_scale * w) @ b_all
        else:
            mix_z = b_all[shard.rows(b_all.shape[0])]
        if cfg.norm_z:
            mix_z = l2_normalize(mix_z)
        z = torch.where(noise.mix_uniform < cfg.mix_ratio, mix_z, z)

    if cfg.future_ratio > 0:
        assert future_goal is not None, "future_ratio > 0 requires future goals"
        fut_z = backward_net(future_goal).float()
        z = torch.where(noise.future_uniform < cfg.future_ratio, fut_z, z)
    return z


class FBMetaMixin(ZMetaMixin):
    """What FB and discrete FB share around their networks: the device step
    counter (``step_t``), z sampling, the host-side ``update_meta`` and
    zero-shot inference through ``backward_net``."""

    @property
    def step(self) -> int:
        """Gradient steps taken (reading it waits for the device)."""
        return int(self.step_t)

    @step.setter
    def step(self, value: int) -> None:
        self.step_t.fill_(value)

    # -- z sampling and meta -------------------------------------------
    def sample_z(self, size: int, generator: torch.Generator) -> Tensor:
        normal = torch.randn(size, self.cfg.z_dim, generator=generator,
                             device=self.device)
        uniform = None if self.cfg.norm_z else torch.rand(
            size, self.cfg.z_dim, generator=generator, device=self.device)
        return self.z_from_noise(normal, uniform)

    def z_from_noise(self, normal: Tensor, uniform: tp.Optional[Tensor]) -> Tensor:
        """``sample_z`` from its draws: a normal and, without norm_z, a uniform."""
        return sample_z(normal, uniform, self.cfg.norm_z)

    def init_meta(self, generator: torch.Generator) -> MetaDict:
        return {"z": self.sample_z(1, generator)[0]}

    def update_meta(self, meta: MetaDict, global_step: int,
                    generator: torch.Generator) -> MetaDict:
        """Resample z every update_z_every_step environment steps, with
        probability update_z_proba (the host-side hook; the collector
        resamples inside its step with ``rollout_update_meta``)."""
        if global_step % self.cfg.update_z_every_step == 0:
            new_z = self.sample_z(1, generator)[0]
            take = torch.rand((), generator=generator, device=self.device) < self.cfg.update_z_proba
            return {**meta, "z": torch.where(take, new_z, meta["z"])}
        return meta

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


class FBDDPGAgent(FBMetaMixin, nn.Module):
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
        # gradient-step counter, on the device: a captured update advances it
        self.register_buffer("step_t", torch.zeros((), dtype=torch.int64,
                                                   device=self.device))
        self._stddev = schedule(cfg.stddev_schedule)

    def train_state(self) -> tp.Dict[str, Tensor]:
        """Every tensor an update changes, by name and not copied: the five
        networks and the step counter (``state_dict``), and the three Adam
        states. A checkpoint saves these; loading copies into them in place,
        so a captured update keeps seeing them."""
        out = dict(self.state_dict())
        for name in ("actor_opt", "fw_opt", "bw_opt"):
            out.update({f"{name}.{k}": v for k, v in getattr(self, name).state().items()})
        return out

    def load_train_state(self, state: tp.Mapping[str, Tensor]) -> None:
        """Copy ``state`` (as ``train_state`` names it) into the agent."""
        load_train_state(self, state)

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
    def act(self, obs: Tensor, z: Tensor, step: tp.Union[int, Tensor],
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        """Batched policy; obs [B, obs_dim], z [B, z_dim] -> action [B, A].

        Out of eval mode the action is the truncated-normal sample at the
        schedule's stddev, or a uniform action while ``step`` <
        num_expl_steps. ``step`` may be a device tensor: both draws are made
        and one is selected on the device, so a captured collector step
        follows the step it is handed at every replay. The draws come from
        ``noise`` or, without it, from ``generator``."""
        if self.cfg.boltzmann:
            mu, std = self.actor(obs, z)
            dist = SquashedNormal(mu, std)
            if eval_mode:
                return dist.mean
            return dist.sample(act_draws(noise, mu, generator)[0])
        mu = self.actor(obs, z)
        if eval_mode:
            return mu
        normal, uniform = act_draws(noise, mu, generator)
        action = TruncatedNormal(mu, self._stddev(step)).sample(normal)
        return explore_until(action, uniform, step, self.cfg.num_expl_steps)

    # -- z construction for the update ----------------------------------
    def _build_train_z(self, batch: EpisodeBatch, noise: UpdateNoise,
                       shard: Shard = Shard()) -> Tensor:
        return build_train_z(self.cfg, self.backward_net, batch, noise, shard)

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
            dist = TruncatedNormal(mu, self._stddev(self.step_t))
            next_action = dist.sample(normal, clip=self.cfg.stddev_clip)
        tf1, tf2 = self.target_forward_net(next_obs, z, next_action)
        tb = self.target_backward_net(next_goal)
        return tf1.float(), tf2.float(), tb.float()

    def _fb_loss(self, batch: EpisodeBatch, z: Tensor, next_goal: Tensor,
                 normal: Tensor, shard: Shard = Shard()) -> tp.Tuple[Tensor, Metrics]:
        """The FB loss (with the Q-loss and the orthonormality loss) and its
        metrics. Data-parallel, every process computes the loss of the whole
        batch from the rows of every process (``shard.gather``), and its
        gradient reaches each process's own rows."""
        cfg = self.cfg
        target_f1, target_f2, target_b = self._targets(batch, z, next_goal, normal)
        f1, f2 = self.forward_net(batch.obs, z, batch.action)
        b = self.backward_net(next_goal)
        discount = batch.discount
        if shard.group is not None:
            target_f1, target_f2, target_b, f1, f2, b, z, discount = (
                shard.gather(x) for x in (target_f1, target_f2, target_b, f1, f2, b, z,
                                          discount))
        if cfg.use_pallas_loss:
            return self._fb_loss_fused(f1, f2, b, z, discount, target_f1, target_f2,
                                       target_b)
        target_m = torch.minimum(target_f1 @ target_b.T, target_f2 @ target_b.T)
        fb_loss, fb_diag, fb_offdiag = fb_loss_terms(f1, f2, b, target_m, discount)
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
            # the inverse is checked on the host, so it runs eagerly between
            # two captured graphs, as discrete FB's pseudo-inverse does
            cov = (bf.T @ bf / bf.shape[0]).detach()
            implicit_reward = ((bf @ eager_step(lambda: torch.linalg.inv(cov))) * z).sum(1)
            target_q = (implicit_reward + discount[:, 0] * next_q).detach()
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

    def _fb_loss_fused(self, f1: Tensor, f2: Tensor, b: Tensor, z: Tensor, discount: Tensor,
                       target_f1: Tensor, target_f2: Tensor, target_b: Tensor
                       ) -> tp.Tuple[Tensor, Metrics]:
        """FB + orthonormality losses through the CUDA kernels
        (ops/fused_fb.py; the JAX ``_fb_loss_pallas``); same math as the
        unfused path minus the full-matrix diagnostics."""
        cfg = self.cfg
        n = f1.shape[0]
        off_sum, diag_sum, cov_off_sum, cov_diag_sum = fb_loss_terms_fused(
            f1.float(), f2.float(), b.float(), target_f1, target_f2, target_b,
            discount.float())
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
            tn = TruncatedNormal(mu, self._stddev(self.step_t))
            action = tn.sample(normal, clip=cfg.stddev_clip)
            log_prob = tn.log_prob(action).sum(-1)
        f1, f2 = self.forward_net(obs, z, action)
        q = torch.minimum(_dot(f1, z), _dot(f2, z))
        actor_loss = ((cfg.temp * log_prob - q).mean() if cfg.boltzmann
                      else -q.mean())
        return actor_loss, {"actor_loss": actor_loss, "q": q.mean(),
                            "actor_logprob": log_prob.mean()}

    # -- the update -----------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator,
               group: tp.Any = None) -> Metrics:
        """One gradient step with noise drawn from ``generator``. With a
        process group (``torch.distributed``), ``batch`` is this process's
        rows of the global batch and the noise is drawn for the global batch
        (the generator seeded alike on every process), as ``_update`` takes
        it."""
        n = batch.obs.shape[0] * Shard(group).world
        noise = UpdateNoise.draw(self.cfg, n, self.action_dim, generator, self.device)
        return self._update(batch, noise, group)

    def _update(self, batch: EpisodeBatch, noise: UpdateNoise, group: tp.Any = None) -> Metrics:
        """One gradient step. With ``group``, a data-parallel one: ``batch``
        holds this process's rows and ``noise`` the global batch's draws. The
        FB loss is computed on every process from the gathered rows, scaled by
        1/world since each process differentiates it; the actor's per-row loss
        is this process's part of the global mean; gradients are summed over
        the group before each Adam step, so every process takes the step of
        the whole batch. Metrics are the global batch's."""
        cfg = self.cfg
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        next_goal = batch.next_goal if cfg.goal_space is not None else batch.next_obs
        z = self._build_train_z(batch, noise, shard)

        fb_loss, metrics = self._fb_loss(batch, z, next_goal, noise.next_action_normal, shard)
        fw_leaves = self.fw_opt.leaves
        bw_leaves = self.bw_opt.leaves
        grads = shard.grad(fb_loss, fw_leaves + bw_leaves)
        self.fw_opt.step(grads[:len(fw_leaves)])
        self.bw_opt.step(grads[len(fw_leaves):])

        # the actor step uses the freshly updated forward net, as the JAX
        # update does (fb_ddpg.py:471-476)
        actor_loss, actor_metrics = self._actor_loss(batch.obs, z, noise.actor_normal)
        self.actor_opt.step(shard.grad(actor_loss, self.actor_opt.leaves))

        soft_update(self.forward_net, self.target_forward_net, cfg.fb_target_tau)
        soft_update(self.backward_net, self.target_backward_net, cfg.fb_target_tau)
        self.step_t += 1
        metrics.update(shard.mean(actor_metrics))
        return {k: v.detach() for k, v in metrics.items()}
