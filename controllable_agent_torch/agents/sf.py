"""SFAgent — successor features with pluggable φ learners (mirror of
``controllable_agent_tpu/agents/sf.py``).

Twin successor nets F(s, a, z) with a min-Q-selected TD target
target_F = φ(s') + γ·F_target(s', a', z), the loss in Q space (F·z) or in
feature space, an actor on min(F1·z, F2·z), and thirteen φ learners:
random / identity / lap / contrastive (v1, v2) / icm / transition / latent /
autoencoder / svd_sr / svd_srv2 / svd_p / fb. Each learner is an
``nn.Module`` with ``features(goal)`` and ``loss(obs, action, next_obs,
future_obs)``; its submodules carry the flax names (``feature_net``,
``mu_net``, ``target_feature_net``, ...), so ``convert.py`` maps a JAX
``feature_params`` tree onto it by name. Learners with target networks
(latent, svd_sr, svd_srv2) list (online, target) pairs in ``TARGET_PAIRS``;
the agent soft-updates them after each φ step.

Zero-shot inference: z = lstsq(φ(s), r) and z = φ(g)·Σ⁺ for a goal, Σ⁺ the
pseudo-inverse of the φ covariance (``precompute_cov``; the identity until
it is called, as in the JAX package, whose workspace never calls it). Both
go through ``ops/linalg.py``, which keeps JAX's cutoffs on every device.

As ``FBDDPGAgent``, the agent is an ``nn.Module`` that owns its networks,
targets and optimizers and updates them in place; its step counter is a
device tensor and an update's draws are one ``SFNoise``, so the captured
trainer holds the update as one CUDA graph. With ``mix_ratio`` > 0 the
update whitens φ of permuted replay goals with a pseudo-inverse, an SVD
that PyTorch checks on the host: it runs as an eager step between two
captured graphs (``utils/graphs.py:eager_step``).

SF runs in float32 whatever ``compute_dtype`` says, as the JAX SF does
(that field is read by nothing there).

Data-parallel (``group``, ``utils/dist.py``), the learners whose loss
couples the batch (``lap``'s orthonormality, the contrastive logits, the
factorizations of ``svd_sr``, ``svd_srv2`` and ``svd_p``) compute it on
every process's rows, and the mix permutes and whitens the replay goals of
the global batch; the other losses are per row.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import MLP, Actor, BackwardMap, DiagGaussianActor, ForwardMap, l2_normalize
from ..ops.fb import off_diagonal_mask, orthonormality_loss
from ..ops.linalg import lstsq, pinv
from ..optim import Adam
from ..utils.device import DeviceLike, resolve_device
from ..utils.dist import RowNoise, Shard
from ..utils.distributions import SquashedNormal, TruncatedNormal
from ..utils.graphs import eager_step
from ..utils.schedules import schedule
from ..utils.tree import soft_update
from .base import MetaDict, StepNoise, ZMetaMixin, act_draws, explore_until, load_train_state

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


# ------------------------------------------------------------- learners

def phi_mlp(in_dim: int, hidden_dim: int, z_dim: int, l2: bool = True) -> MLP:
    """in -> hidden ntanh -> hidden relu -> z (sqrt(z)-scaled L2): the φ and
    μ towers of the learners."""
    return MLP(in_dim, (hidden_dim, "ntanh", hidden_dim, "relu", z_dim) + (("L2",) if l2 else ()))


def model_mlp(in_dim: int, hidden_dim: int, out_dim: int, tanh: bool = False) -> MLP:
    """in -> hidden irelu -> hidden irelu -> out: the dynamics models and the
    decoder."""
    return MLP(in_dim, (hidden_dim, "irelu", hidden_dim, "irelu", out_dim)
               + (("tanh",) if tanh else ()))


def _mean_square(x: Tensor) -> Tensor:
    return x.float().square().mean()


def factorization_loss(p: Tensor, resid: Tensor) -> Tensor:
    """-2 trace(P)/n + Σ_offdiag resid² / (n (n-1)); the diagonal as
    ``diagonal().sum()``, whose backward a CUDA graph holds (trace's reads
    its gradient on the host)."""
    n = p.shape[0]
    off = off_diagonal_mask(n, p.device)
    return (-2.0 * p.diagonal().sum() / n
            + torch.where(off, resid.square(), 0.0).sum() / (n * (n - 1)))


class FeatureLearner(nn.Module):
    """``random``: φ(s) = feature_net(s), a network that is never trained.

    ``loss`` takes this process's rows and returns its part of the global
    batch's loss (``Shard.grad``): a mean over its rows, or, where the loss
    couples the batch, the loss of the rows gathered from every process."""

    # (online, target) submodules soft-updated after each φ step
    TARGET_PAIRS: tp.Tuple[tp.Tuple[str, str], ...] = ()

    def __init__(self, obs_dim: int, action_dim: int, z_dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.obs_dim, self.action_dim, self.z_dim = obs_dim, action_dim, z_dim
        self.hidden_dim = hidden_dim
        self.feature_net = self.make_feature_net()

    def make_feature_net(self) -> nn.Module:
        return phi_mlp(self.obs_dim, self.hidden_dim, self.z_dim)

    def features(self, obs: Tensor) -> Tensor:
        return self.feature_net(obs)

    def loss(self, obs: Tensor, action: Tensor, next_obs: Tensor,
             future_obs: tp.Optional[Tensor], shard: Shard = Shard()) -> tp.Optional[Tensor]:
        return None


class Identity(FeatureLearner):
    """φ(s) = s: no parameters (the agent sets z_dim to the goal width)."""

    def make_feature_net(self) -> nn.Module:
        return nn.Identity()


class Laplacian(FeatureLearner):
    """|φ(s) − φ(s')|² + orthonormality."""

    def loss(self, obs, action, next_obs, future_obs, shard=Shard()):
        # both terms on every process's rows: φ(s) then reaches the loss
        # through one gather, and its gradient sums as the single-process one
        phi = shard.gather(self.feature_net(obs))
        orth, _, _ = orthonormality_loss(phi)
        return _mean_square(phi - shard.gather(self.feature_net(next_obs))) + orth


class ContrastiveFeature(FeatureLearner):
    """InfoNCE between φ(s) and μ(s_future); ``swap`` (contrastivev2) lets
    μ see the state and φ the future."""

    def __init__(self, obs_dim: int, action_dim: int, z_dim: int, hidden_dim: int,
                 swap: bool = False) -> None:
        super().__init__(obs_dim, action_dim, z_dim, hidden_dim)
        self.swap = swap
        self.mu_net = phi_mlp(obs_dim, hidden_dim, z_dim)

    def loss(self, obs, action, next_obs, future_obs, shard=Shard()):
        assert future_obs is not None, "the contrastive learners need future observations"
        if self.swap:
            a, b = self.mu_net(obs), self.feature_net(future_obs)
        else:
            a, b = self.feature_net(obs), self.mu_net(future_obs)
        a, b = shard.gather(a), shard.gather(b)
        logits = (l2_normalize(a.float(), scale_sqrt_dim=False)
                  @ l2_normalize(b.float(), scale_sqrt_dim=False).T)
        off = off_diagonal_mask(logits.shape[0], logits.device)
        negatives = torch.where(off, logits, -math.inf)
        return (-logits.diagonal() + torch.logsumexp(negatives, dim=1)).mean()


class ICM(FeatureLearner):
    """Inverse dynamics: predict a from (φ(s), φ(s'))."""

    def __init__(self, obs_dim: int, action_dim: int, z_dim: int, hidden_dim: int) -> None:
        super().__init__(obs_dim, action_dim, z_dim, hidden_dim)
        self.inverse_dynamic_net = model_mlp(2 * z_dim, hidden_dim, action_dim, tanh=True)

    def loss(self, obs, action, next_obs, future_obs, shard=Shard()):
        pred = self.inverse_dynamic_net(
            torch.cat([self.feature_net(obs), self.feature_net(next_obs)], -1))
        return _mean_square(action - pred)


class TransitionModel(FeatureLearner):
    """Predict s' from (φ(s), a)."""

    def __init__(self, obs_dim: int, action_dim: int, z_dim: int, hidden_dim: int) -> None:
        super().__init__(obs_dim, action_dim, z_dim, hidden_dim)
        self.forward_dynamic_net = model_mlp(z_dim + action_dim, hidden_dim, obs_dim)

    def loss(self, obs, action, next_obs, future_obs, shard=Shard()):
        pred = self.forward_dynamic_net(torch.cat([self.feature_net(obs), action], -1))
        return _mean_square(pred - next_obs)


class TransitionLatentModel(FeatureLearner):
    """Predict the target φ(s') from (φ(s), a)."""

    TARGET_PAIRS = (("feature_net", "target_feature_net"),)

    def __init__(self, obs_dim: int, action_dim: int, z_dim: int, hidden_dim: int) -> None:
        super().__init__(obs_dim, action_dim, z_dim, hidden_dim)
        self.forward_dynamic_net = model_mlp(z_dim + action_dim, hidden_dim, z_dim)
        self.target_feature_net = phi_mlp(obs_dim, hidden_dim, z_dim)

    def loss(self, obs, action, next_obs, future_obs, shard=Shard()):
        with torch.no_grad():
            next_phi = self.target_feature_net(next_obs)
        pred = self.forward_dynamic_net(torch.cat([self.feature_net(obs), action], -1))
        return _mean_square(pred - next_phi)


class AutoEncoder(FeatureLearner):
    """Reconstruct s from φ(s)."""

    def __init__(self, obs_dim: int, action_dim: int, z_dim: int, hidden_dim: int) -> None:
        super().__init__(obs_dim, action_dim, z_dim, hidden_dim)
        self.decoder = model_mlp(z_dim, hidden_dim, obs_dim)

    def loss(self, obs, action, next_obs, future_obs, shard=Shard()):
        return _mean_square(self.decoder(self.feature_net(obs)) - obs)


class SVDSR(FeatureLearner):
    """Successor-rate factorization φ(s)·μ(s') against its discounted target
    nets (γ 0.99); ``swap`` (svd_srv2) factors μ(s)·φ(s') (γ 0.98)."""

    TARGET_PAIRS = (("feature_net", "target_feature_net"), ("mu_net", "target_mu_net"))

    def __init__(self, obs_dim: int, action_dim: int, z_dim: int, hidden_dim: int,
                 swap: bool = False) -> None:
        super().__init__(obs_dim, action_dim, z_dim, hidden_dim)
        self.swap = swap
        self.mu_net = phi_mlp(obs_dim, hidden_dim, z_dim, l2=False)
        self.target_feature_net = phi_mlp(obs_dim, hidden_dim, z_dim)
        self.target_mu_net = phi_mlp(obs_dim, hidden_dim, z_dim, l2=False)

    def loss(self, obs, action, next_obs, future_obs, shard=Shard()):
        with torch.no_grad():
            t_phi = shard.gather(self.target_feature_net(next_obs).float())
            t_mu = shard.gather(self.target_mu_net(next_obs).float())
            target_sr = t_mu @ t_phi.T if self.swap else t_phi @ t_mu.T
        if self.swap:
            phi = shard.gather(self.feature_net(next_obs))
            sr = shard.gather(self.mu_net(obs)).float() @ phi.float().T
            gamma = 0.98
        else:
            phi = shard.gather(self.feature_net(obs))
            sr = phi.float() @ shard.gather(self.mu_net(next_obs)).float().T
            gamma = 0.99
        orth, _, _ = orthonormality_loss(phi)
        return factorization_loss(sr, sr - gamma * target_sr) + orth


class SVDP(FeatureLearner):
    """Transition factorization μ(s, a)·φ(s')."""

    def __init__(self, obs_dim: int, action_dim: int, z_dim: int, hidden_dim: int) -> None:
        super().__init__(obs_dim, action_dim, z_dim, hidden_dim)
        self.mu_net = phi_mlp(obs_dim + action_dim, hidden_dim, z_dim, l2=False)

    def loss(self, obs, action, next_obs, future_obs, shard=Shard()):
        phi = shard.gather(self.feature_net(next_obs))
        p = shard.gather(self.mu_net(torch.cat([obs, action], -1))).float() @ phi.float().T
        orth, _, _ = orthonormality_loss(phi)
        return factorization_loss(p, p) + orth


class FBFeatures(FeatureLearner):
    """φ(s) = B(s) of a trained FB agent, frozen: the geometry of the FB
    agent's backward net, so its weights drop in (``SFAgent.load_fb_features``)."""

    def make_feature_net(self) -> nn.Module:
        return BackwardMap(self.obs_dim, self.z_dim, self.hidden_dim)


def _swapped(cls: tp.Callable[..., FeatureLearner]) -> tp.Callable[..., FeatureLearner]:
    return lambda *args: cls(*args, swap=True)


# name -> learner(obs_dim, action_dim, z_dim, hidden_dim)
FEATURE_LEARNERS: tp.Dict[str, tp.Callable[..., FeatureLearner]] = {
    "random": FeatureLearner,
    "fb": FBFeatures,
    "identity": Identity,
    "lap": Laplacian,
    "contrastive": ContrastiveFeature,
    "contrastivev2": _swapped(ContrastiveFeature),
    "icm": ICM,
    "transition": TransitionModel,
    "latent": TransitionLatentModel,
    "autoencoder": AutoEncoder,
    "svd_sr": SVDSR,
    "svd_srv2": _swapped(SVDSR),
    "svd_p": SVDP,
}
# the learners whose loss is never taken
FROZEN_LEARNERS = ("random", "identity", "fb")


# ------------------------------------------------------------- agents

@dataclasses.dataclass(frozen=True)
class SFConfig:
    """Same fields and defaults as the JAX ``SFConfig``. ``compute_dtype`` is
    read by nothing, in JAX as here: SF runs in float32."""

    name: str = "sf"
    lr: float = 1e-4
    lr_coef: float = 1.0
    sf_target_tau: float = 0.01
    update_every_steps: int = 2
    num_inference_steps: int = 5120
    hidden_dim: int = 1024
    backward_hidden_dim: int = 512
    feature_dim: int = 512
    z_dim: int = 100
    stddev_schedule: str = "0.2"
    stddev_clip: float = 0.3
    update_z_every_step: int = 100
    batch_size: int = 1024
    goal_space: tp.Optional[str] = None
    log_std_bounds: tp.Tuple[float, float] = (-5.0, 2.0)
    temp: float = 1.0
    boltzmann: bool = False
    preprocess: bool = True
    num_sf_updates: int = 1
    feature_learner: str = "icm"
    mix_ratio: float = 0.0
    q_loss: bool = True
    add_trunk: bool = False
    num_expl_steps: int = 0
    learner_target_tau: float = 0.01
    compute_dtype: str = "float32"


@dataclasses.dataclass
class SFNoise(RowNoise):
    """Every random draw of one update, in the shapes the JAX updates draw
    them: z's normal, the target policy's and the actor's noise (none for
    discrete SF, which has no actor), and, with ``mix_ratio`` > 0, the
    permutation of the replay goals (of the global batch) and the mix mask's
    uniform."""

    WHOLE = ("perm",)

    z_normal: Tensor  # [n, z_dim]
    next_action_normal: tp.Optional[Tensor] = None  # [n, action_dim]
    actor_normal: tp.Optional[Tensor] = None  # [n, action_dim]
    perm: tp.Optional[Tensor] = None  # [n], mix_ratio > 0 only
    mix_uniform: tp.Optional[Tensor] = None  # [n, 1], mix_ratio > 0 only

    @classmethod
    def draw(cls, n: int, z_dim: int, action_dim: int, mix: bool,
             generator: torch.Generator, device: torch.device) -> "SFNoise":
        def normal(*shape: int) -> Tensor:
            return torch.randn(shape, generator=generator, device=device)

        return cls(z_normal=normal(n, z_dim),
                   next_action_normal=normal(n, action_dim) if action_dim else None,
                   actor_normal=normal(n, action_dim) if action_dim else None,
                   perm=torch.randperm(n, generator=generator, device=device) if mix else None,
                   mix_uniform=torch.rand((n, 1), generator=generator, device=device)
                   if mix else None)


def _dot(x: Tensor, z: Tensor) -> Tensor:
    """Row-wise x·z in float32 (einsum "sd,sd->s")."""
    return (x.float() * z.float()).sum(-1)


def normalized_solution(phi: Tensor, reward: Tensor, z_dim: int) -> Tensor:
    """z = lstsq(φ, r), scaled to norm sqrt(z_dim)."""
    z = lstsq(phi.float(), reward.reshape(-1, 1).float())
    z = math.sqrt(z_dim) * z / torch.linalg.vector_norm(z, dim=0, keepdim=True).clamp_min(1e-12)
    return z[:, 0]


class SuccessorFeatureAgent(ZMetaMixin, nn.Module):
    """What SF and SF-SVD share: the actor, the twin successor nets and their
    target, their two Adams, the step counter, z sampling, acting, and the
    SF and actor losses. A subclass adds its φ and its update."""

    def __init__(self, cfg: tp.Any, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int], device: DeviceLike, seed: int) -> None:
        super().__init__()
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.goal_dim = goal_dim if goal_dim is not None else obs_dim
        self.device = resolve_device(device)
        self.boltzmann = bool(getattr(cfg, "boltzmann", False))
        # weights are drawn on the CPU from the seed, then moved: the same
        # seed gives the same agent on every device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            if self.boltzmann:
                self.actor: nn.Module = DiagGaussianActor(
                    obs_dim, cfg.z_dim, action_dim, cfg.hidden_dim,
                    log_std_bounds=tuple(cfg.log_std_bounds))
            else:
                self.actor = Actor(obs_dim, cfg.z_dim, action_dim, cfg.feature_dim,
                                   cfg.hidden_dim, preprocess=cfg.preprocess,
                                   add_trunk=cfg.add_trunk)
            self.successor_net = ForwardMap(obs_dim, cfg.z_dim, action_dim, cfg.feature_dim,
                                            cfg.hidden_dim, preprocess=cfg.preprocess,
                                            add_trunk=cfg.add_trunk)
            self._build_learner()
        self.target_successor_net = copy.deepcopy(self.successor_net).requires_grad_(False)
        # gradient-step counter, on the device: a captured update advances it
        self.register_buffer("step_t", torch.zeros((), dtype=torch.int64))
        self.to(self.device)
        self.actor_opt = Adam(self.actor, cfg.lr)
        self.sf_opt = Adam(self.successor_net, cfg.lr)
        self._stddev = schedule(cfg.stddev_schedule)

    def _build_learner(self) -> None:
        """Build the φ learner (inside the seeded block of ``__init__``)."""
        raise NotImplementedError

    OPTIMIZERS: tp.Tuple[str, ...] = ("actor_opt", "sf_opt")
    # whether an update draws the permutation and mask of the z mix
    mixes = False

    @property
    def step(self) -> int:
        """Gradient steps taken (reading it waits for the device)."""
        return int(self.step_t)

    @step.setter
    def step(self, value: int) -> None:
        self.step_t.fill_(value)

    def train_state(self) -> tp.Dict[str, Tensor]:
        """Every tensor an update changes, by name and not copied: the
        networks, targets and buffers (``state_dict``) and the Adam states."""
        out = dict(self.state_dict())
        for name in self.OPTIMIZERS:
            opt = getattr(self, name)
            if opt is not None:
                out.update({f"{name}.{k}": v for k, v in opt.state().items()})
        return out

    def load_train_state(self, state: tp.Mapping[str, Tensor]) -> None:
        """Copy ``state`` (as ``train_state`` names it) into the agent."""
        load_train_state(self, state)

    # -- z sampling and meta -------------------------------------------
    def z_from_noise(self, normal: Tensor, uniform: tp.Optional[Tensor] = None) -> Tensor:
        """z from its normal draw: sqrt(z_dim)-scaled L2 normalization."""
        return l2_normalize(normal)

    def sample_z(self, size: int, generator: torch.Generator) -> Tensor:
        return self.z_from_noise(torch.randn(size, self.cfg.z_dim, generator=generator,
                                             device=self.device))

    def init_meta(self, generator: torch.Generator) -> MetaDict:
        return {"z": self.sample_z(1, generator)[0]}

    def update_meta(self, meta: MetaDict, global_step: int,
                    generator: torch.Generator) -> MetaDict:
        """A new z every update_z_every_step environment steps."""
        if global_step % self.cfg.update_z_every_step == 0:
            return self.init_meta(generator)
        return meta

    # -- acting ---------------------------------------------------------
    @torch.no_grad()
    def act(self, obs: Tensor, z: Tensor, step: tp.Union[int, Tensor],
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        """Batched policy, as ``FBDDPGAgent.act``: the squashed Gaussian's
        sample (boltzmann), else the truncated normal at the schedule's
        stddev or a uniform action while ``step`` < num_expl_steps."""
        if self.boltzmann:
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

    # -- losses ---------------------------------------------------------
    @torch.no_grad()
    def _target_f(self, batch: EpisodeBatch, z: Tensor, target_phi: Tensor,
                  normal: Tensor) -> Tensor:
        """φ + γ·F_target(s', a', z), F_target the twin with the smaller F·z."""
        next_obs = batch.next_obs
        if self.boltzmann:
            mu, std = self.actor(next_obs, z)
            next_action = SquashedNormal(mu, std).sample(normal)
        else:
            mu = self.actor(next_obs, z)
            next_action = TruncatedNormal(mu, self._stddev(self.step_t)).sample(
                normal, clip=self.cfg.stddev_clip)
        next_f1, next_f2 = self.target_successor_net(next_obs, z, next_action)
        next_f = torch.where((_dot(next_f1, z) < _dot(next_f2, z))[:, None],
                             next_f1.float(), next_f2.float())
        return target_phi.float() + batch.discount * next_f

    def _successor_loss(self, batch: EpisodeBatch, z: Tensor, target_f: Tensor
                        ) -> tp.Tuple[Tensor, Tensor]:
        """The SF loss (in Q space with q_loss) and F1."""
        f1, f2 = self.successor_net(batch.obs, z, batch.action)
        if self.cfg.q_loss:
            target_q = _dot(target_f, z)
            loss = ((_dot(f1, z) - target_q).square().mean()
                    + (_dot(f2, z) - target_q).square().mean())
        else:
            loss = ((f1.float() - target_f).square().mean()
                    + (f2.float() - target_f).square().mean())
        return loss, f1

    def _actor_loss(self, obs: Tensor, z: Tensor, normal: Tensor) -> tp.Tuple[Tensor, Metrics]:
        cfg = self.cfg
        if self.boltzmann:
            mu, std = self.actor(obs, z)
            dist = SquashedNormal(mu, std)
            action, pre_tanh = dist.sample_with_pre_tanh(normal)
            log_prob = dist.log_prob_from_pre_tanh(pre_tanh).sum(-1)
        else:
            mu = self.actor(obs, z)
            tn = TruncatedNormal(mu, self._stddev(self.step_t))
            action = tn.sample(normal, clip=cfg.stddev_clip)
            log_prob = tn.log_prob(action).sum(-1)
        f1, f2 = self.successor_net(obs, z, action)
        q = torch.minimum(_dot(f1, z), _dot(f2, z))
        loss = (cfg.temp * log_prob - q).mean() if self.boltzmann else -q.mean()
        return loss, {"actor_loss": loss, "actor_logprob": log_prob.mean()}

    def _step(self, opt: Adam, loss: Tensor, shard: Shard = Shard()) -> None:
        opt.step(shard.grad(loss, opt.leaves))

    def update(self, batch: EpisodeBatch, generator: torch.Generator,
               group: tp.Any = None) -> Metrics:
        """One gradient step with noise drawn from ``generator``; with a
        process group, the noise of the global batch (``DDPGAgent.update``)."""
        noise = SFNoise.draw(batch.obs.shape[0] * Shard(group).world, self.cfg.z_dim,
                             self.action_dim, self.mixes, generator, self.device)
        return self._update(batch, noise, group)

    def _update(self, batch: EpisodeBatch, noise: SFNoise, group: tp.Any = None) -> Metrics:
        """One gradient step; with ``group`` a data-parallel one
        (``DDPGAgent._update``)."""
        raise NotImplementedError


class SFAgent(SuccessorFeatureAgent):
    """Networks, targets, φ learner and optimizers of one SF agent."""

    OPTIMIZERS = ("actor_opt", "sf_opt", "phi_opt")

    def __init__(self, cfg: SFConfig, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        if cfg.feature_learner not in FEATURE_LEARNERS:
            raise ValueError(f"Unknown feature learner {cfg.feature_learner!r}; "
                             f"known: {sorted(FEATURE_LEARNERS)}")
        if cfg.feature_learner == "identity":
            cfg = dataclasses.replace(cfg, z_dim=goal_dim or obs_dim)
        super().__init__(cfg, obs_dim, action_dim, goal_dim, device, seed)
        learner = self.feature_learner
        for _, target in type(learner).TARGET_PAIRS:
            getattr(learner, target).requires_grad_(False)
        # Σ⁺ of get_goal_meta: the identity until precompute_cov
        self.register_buffer("inv_cov", torch.eye(cfg.z_dim, device=self.device))
        trainable = {k: p for k, p in learner.named_parameters() if p.requires_grad}
        # the learner's Adam (none for identity, which has no parameters);
        # random and fb keep one that never steps, as in JAX
        self.phi_opt = Adam(trainable, cfg.lr_coef * cfg.lr) if trainable else None
        self.learner_trainable = cfg.feature_learner not in FROZEN_LEARNERS
        self.mixes = cfg.mix_ratio > 0

    def _build_learner(self) -> None:
        cfg = self.cfg
        self.feature_learner = FEATURE_LEARNERS[cfg.feature_learner](
            self.goal_dim, self.action_dim, cfg.z_dim, cfg.backward_hidden_dim)

    @torch.no_grad()
    def features(self, goal: Tensor) -> Tensor:
        """φ(goal), float32."""
        return self.feature_learner.features(goal).float()

    def load_fb_features(self, backward: tp.Mapping[str, tp.Any]) -> None:
        """Graft a trained FB agent's backward net in as the frozen φ
        (``feature_learner="fb"``): the state dict of the port's
        ``FBDDPGAgent.backward_net``, or the JAX ``FBTrainState.backward_params``
        (a flax tree, ``{"params": ...}``). Shapes must match."""
        if self.cfg.feature_learner != "fb":
            raise ValueError("load_fb_features requires feature_learner='fb'")
        if "params" in backward:
            from ..convert import flax_to_state_dict
            backward = flax_to_state_dict(backward)
        self.feature_learner.feature_net.load_state_dict(backward)

    # -- zero-shot inference ------------------------------------------------
    @torch.no_grad()
    def compute_inv_cov(self, goals: Tensor) -> Tensor:
        """Σ⁺ of the φ covariance over ``goals``."""
        phi = self.features(goals)
        return pinv(phi.T @ phi / phi.shape[0])

    def precompute_cov(self, goals: Tensor) -> None:
        self.inv_cov.copy_(self.compute_inv_cov(goals))

    @torch.no_grad()
    def get_goal_meta(self, goal: Tensor) -> Tensor:
        """z = φ(g)·Σ⁺, sqrt(z_dim)-normalized."""
        return l2_normalize(self.features(goal[None]) @ self.inv_cov)[0]

    @torch.no_grad()
    def infer_meta_from_obs_and_rewards(self, obs: Tensor, reward: Tensor) -> Tensor:
        """z = lstsq(φ(s), r), sqrt(z_dim)-normalized."""
        return normalized_solution(self.features(obs), reward, self.cfg.z_dim)

    # -- losses ---------------------------------------------------------
    def _sf_loss(self, batch: EpisodeBatch, next_goal: Tensor, z: Tensor,
                 normal: Tensor) -> tp.Tuple[Tensor, Metrics]:
        target_phi = self.features(next_goal)
        target_f = self._target_f(batch, z, target_phi, normal)
        loss, f1 = self._successor_loss(batch, z, target_f)
        return loss, {
            "target_F": target_f.mean(), "F1": f1.mean(), "phi": target_phi.mean(),
            "phi_norm": torch.linalg.vector_norm(target_phi, dim=-1).mean(),
            "z_norm": torch.linalg.vector_norm(z, dim=-1).mean(), "sf_loss": loss}

    def _phi_loss(self, goal: Tensor, action: Tensor, next_goal: Tensor,
                  future_goal: tp.Optional[Tensor], shard: Shard = Shard()) -> Tensor:
        loss = self.feature_learner.loss(goal, action, next_goal, future_goal, shard)
        return loss if loss is not None else torch.zeros((), device=goal.device)

    @torch.no_grad()
    def _mix_z(self, z: Tensor, next_goal: Tensor, noise: SFNoise,
               shard: Shard = Shard()) -> Tensor:
        """z replaced, with probability mix_ratio, by φ of permuted replay
        goals (of the global batch) whitened by their covariance's
        pseudo-inverse."""
        assert noise.perm is not None and noise.mix_uniform is not None
        phi = self.features(shard.gather(next_goal)[noise.perm])
        cov = phi.T @ phi / phi.shape[0]
        inv_cov = eager_step(lambda: pinv(cov))
        return torch.where(noise.mix_uniform < self.cfg.mix_ratio,
                           l2_normalize(phi[shard.rows(phi.shape[0])] @ inv_cov), z)

    # -- the update -----------------------------------------------------
    def _update(self, batch: EpisodeBatch, noise: SFNoise, group: tp.Any = None) -> Metrics:
        cfg = self.cfg
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        use_goal = cfg.goal_space is not None
        goal = batch.goal if use_goal else batch.obs
        next_goal = batch.next_goal if use_goal else batch.next_obs
        future_goal = batch.future_goal if use_goal else batch.future_obs
        z = self.z_from_noise(noise.z_normal)
        if self.mixes:
            z = self._mix_z(z, next_goal, noise, shard)

        sf_loss, metrics = self._sf_loss(batch, next_goal, z, noise.next_action_normal)
        self._step(self.sf_opt, sf_loss, shard)
        if self.learner_trainable:
            assert self.phi_opt is not None
            phi_loss = self._phi_loss(goal, batch.action, next_goal, future_goal, shard)
            self._step(self.phi_opt, phi_loss, shard)
            for online, target in type(self.feature_learner).TARGET_PAIRS:
                soft_update(getattr(self.feature_learner, online),
                            getattr(self.feature_learner, target), cfg.learner_target_tau)
            metrics["phi_loss"] = phi_loss
        # the actor step reads the freshly updated successor nets (sf.py:603-605)
        actor_loss, actor_metrics = self._actor_loss(batch.obs, z, noise.actor_normal)
        self._step(self.actor_opt, actor_loss, shard)
        soft_update(self.successor_net, self.target_successor_net, cfg.sf_target_tau)
        self.step_t += 1
        metrics.update(actor_metrics)
        return shard.mean({k: v.detach() for k, v in metrics.items()})
