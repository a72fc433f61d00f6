"""DiscreteFBAgent — Forward-Backward for discrete action spaces (mirror of
``controllable_agent_tpu/agents/discrete_fb.py``).

A per-action forward map F(s, z) of shape [B, z_dim, n_actions], a greedy
policy on Q(s, a) = min(F1(s, ·, a)·z, F2(s, ·, a)·z) with ε-greedy
exploration, and the FB Bellman loss with a Boltzmann-weighted (the
default, temperature ``temp``) or argmax target F. No actor network.

As ``FBDDPGAgent``, the agent owns its networks, targets and optimizers and
updates them in place; its step counter is a device tensor and an update's
draws are one ``UpdateNoise`` (FB's, without action noise), so the captured
trainer holds the update as one CUDA graph. ``q_loss=True`` whitens B with
the pseudo-inverse of its covariance, an SVD that PyTorch checks on the
host: that step runs eagerly between two captured graphs
(``utils/graphs.py:eager_step``). Data-parallel (``group``,
``utils/dist.py``), the loss is FB's: computed on every process from the
rows of every process, the pseudo-inverse of the global batch's Cov(B)
included, and z mixes B of the global batch's permuted goals.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import BackwardMap, DiscreteForwardMap
from ..ops.fb import fb_loss_terms, orthonormality_loss
from ..ops.linalg import pinv
from ..optim import Adam
from ..utils.device import DeviceLike, resolve_device
from ..utils.dist import Shard
from ..utils.graphs import eager_step
from ..utils.tree import soft_update
from .base import StepNoise, epsilon_greedy, load_train_state
from .fb_ddpg import FBMetaMixin, UpdateNoise, build_train_z

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class DiscreteFBConfig:
    """Same fields and defaults as the JAX ``DiscreteFBConfig``."""

    name: str = "discrete_fb"
    lr: float = 1e-4
    lr_coef: float = 1.0
    fb_target_tau: float = 0.01
    update_every_steps: int = 2
    num_inference_steps: int = 5120
    hidden_dim: int = 1024
    backward_hidden_dim: int = 526
    feature_dim: int = 512
    z_dim: int = 50
    update_z_every_step: int = 300
    update_z_proba: float = 1.0
    batch_size: int = 1024
    goal_space: tp.Optional[str] = None
    ortho_coef: float = 1.0
    temp: float = 100.0
    boltzmann: bool = True
    future_ratio: float = 0.0
    mix_ratio: float = 0.5
    rand_weight: bool = False
    preprocess: bool = False
    norm_z: bool = True
    q_loss: bool = False
    q_loss_coef: float = 0.01
    add_trunk: bool = False
    expl_eps: float = 0.2
    num_expl_steps: int = 0
    compute_dtype: str = "float32"


def q_values(f1: Tensor, f2: Tensor, z: Tensor) -> Tensor:
    """min over the twins of F(s, ·, a)·z: [B, z_dim, n_actions] -> [B, n_actions],
    float32 (einsum "sda,sd->sa")."""
    z = z.float()[:, :, None]
    return torch.minimum((f1.float() * z).sum(1), (f2.float() * z).sum(1))


class DiscreteFBAgent(FBMetaMixin, nn.Module):
    """Networks, target networks and optimizers of one discrete FB agent; z
    sampling, ``update_meta`` and the zero-shot inference are FB's
    (``FBMetaMixin``)."""

    # the workspace builds it with the environment's number of actions
    takes_n_actions = True

    def __init__(self, cfg: DiscreteFBConfig, obs_dim: int, n_actions: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.goal_dim = goal_dim if goal_dim is not None else obs_dim
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        # weights are drawn on the CPU from the seed, then moved: the same
        # seed gives the same agent on every device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.forward_net = DiscreteForwardMap(
                obs_dim, cfg.z_dim, n_actions, cfg.feature_dim, cfg.hidden_dim,
                preprocess=cfg.preprocess, add_trunk=cfg.add_trunk, dtype=dtype)
            self.backward_net = BackwardMap(self.goal_dim, cfg.z_dim, cfg.backward_hidden_dim,
                                            norm_z=cfg.norm_z, dtype=dtype)
        self.target_forward_net = copy.deepcopy(self.forward_net).requires_grad_(False)
        self.target_backward_net = copy.deepcopy(self.backward_net).requires_grad_(False)
        self.to(self.device)
        self.fw_opt = Adam(self.forward_net, cfg.lr)
        self.bw_opt = Adam(self.backward_net, cfg.lr_coef * cfg.lr)
        # gradient-step counter, on the device: a captured update advances it
        self.register_buffer("step_t", torch.zeros((), dtype=torch.int64,
                                                   device=self.device))

    def train_state(self) -> tp.Dict[str, Tensor]:
        """Every tensor an update changes, by name and not copied: the four
        networks and the step counter (``state_dict``), and the two Adam
        states."""
        out = dict(self.state_dict())
        for name in ("fw_opt", "bw_opt"):
            out.update({f"{name}.{k}": v for k, v in getattr(self, name).state().items()})
        return out

    def load_train_state(self, state: tp.Mapping[str, Tensor]) -> None:
        """Copy ``state`` (as ``train_state`` names it) into the agent."""
        load_train_state(self, state)

    # -- acting ---------------------------------------------------------
    @torch.no_grad()
    def act(self, obs: Tensor, z: Tensor, step: tp.Union[int, Tensor],
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        """Batched policy; obs [B, obs_dim], z [B, z_dim] -> action indices
        [B] (int64): greedy in eval mode, else ε-greedy."""
        q = q_values(*self.forward_net(obs, z), z)
        if eval_mode:
            return q.argmax(-1)
        return epsilon_greedy(q, step, self.cfg.expl_eps, self.cfg.num_expl_steps, noise,
                              generator)

    # -- the loss -------------------------------------------------------
    @torch.no_grad()
    def _target_f(self, next_obs: Tensor, z: Tensor) -> tp.Tuple[Tensor, Tensor, Tensor]:
        """Target F1, F2 at the next state, Boltzmann-weighted over the
        actions or at the argmax action, and the next state's value."""
        tf1, tf2 = (f.float() for f in self.target_forward_net(next_obs, z))
        next_q = q_values(tf1, tf2, z)
        if self.cfg.boltzmann:
            pi = torch.softmax(next_q / self.cfg.temp, dim=-1)
            return ((tf1 * pi[:, None]).sum(-1), (tf2 * pi[:, None]).sum(-1),
                    (pi * next_q).sum(-1))
        index = next_q.argmax(-1)[:, None, None].expand(-1, tf1.shape[1], 1)
        return (tf1.gather(-1, index)[..., 0], tf2.gather(-1, index)[..., 0],
                next_q.max(-1).values)

    def _fb_loss(self, batch: EpisodeBatch, z: Tensor, next_goal: Tensor,
                 shard: Shard = Shard()) -> tp.Tuple[Tensor, Metrics]:
        """The loss and its metrics; data-parallel, every process computes
        the loss of the whole batch from the rows of every process, as
        ``FBDDPGAgent._fb_loss`` does."""
        cfg = self.cfg
        target_f1, target_f2, next_q = self._target_f(batch.next_obs, z)
        with torch.no_grad():
            target_b = self.target_backward_net(next_goal).float()

        # online F at the taken action
        f1_all, f2_all = self.forward_net(batch.obs, z)
        index = batch.action.reshape(-1).long()[:, None, None].expand(-1, f1_all.shape[1], 1)
        f1, f2 = f1_all.gather(-1, index)[..., 0], f2_all.gather(-1, index)[..., 0]
        b = self.backward_net(next_goal)
        discount = batch.discount
        if shard.group is not None:
            target_f1, target_f2, next_q, target_b, f1, f2, b, z, discount = (
                shard.gather(x) for x in (target_f1, target_f2, next_q, target_b, f1, f2, b, z,
                                          discount))
        with torch.no_grad():
            target_m = torch.minimum(target_f1 @ target_b.T, target_f2 @ target_b.T)
        fb_loss, fb_diag, fb_offdiag = fb_loss_terms(f1, f2, b, target_m, discount)
        metrics: Metrics = {
            "target_M": target_m.mean(), "F1": f1.mean(), "B": b.mean(),
            "B_norm": torch.linalg.vector_norm(b, dim=-1).mean(),
            "z_norm": torch.linalg.vector_norm(z, dim=-1).mean(),
            "fb_diag": fb_diag, "fb_offdiag": fb_offdiag,
        }
        bf = b.float()
        if cfg.q_loss:
            # the implicit reward B·Cov⁺·z; the pseudo-inverse (an SVD checked
            # on the host) runs eagerly between two captured graphs
            cov = (bf.T @ bf / bf.shape[0]).detach()
            inv_cov = eager_step(lambda: pinv(cov))
            implicit_reward = ((bf @ inv_cov) * z).sum(1)
            target_q = (implicit_reward + discount[:, 0] * next_q).detach()
            z32 = z.float()
            q_loss = (((f1.float() * z32).sum(-1) - target_q).square().mean()
                      + ((f2.float() * z32).sum(-1) - target_q).square().mean())
            fb_loss = fb_loss + cfg.q_loss_coef * q_loss
            metrics["q_loss"] = q_loss
        orth_loss, orth_diag, orth_offdiag = orthonormality_loss(b)
        fb_loss = fb_loss + cfg.ortho_coef * orth_loss
        metrics.update(orth_loss=orth_loss, orth_loss_diag=orth_diag,
                       orth_loss_offdiag=orth_offdiag, fb_loss=fb_loss)
        eye_diff = bf.T @ bf / bf.shape[0] - torch.eye(bf.shape[1], device=bf.device)
        metrics["orth_linf"] = eye_diff.abs().max()
        metrics["orth_l2"] = torch.linalg.norm(eye_diff) / math.sqrt(bf.shape[1])
        return fb_loss, metrics

    # -- the update -----------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator,
               group: tp.Any = None) -> Metrics:
        """One gradient step with noise drawn from ``generator``; with a
        process group, the noise of the global batch (``FBDDPGAgent.update``)."""
        noise = UpdateNoise.draw(self.cfg, batch.obs.shape[0] * Shard(group).world, 0,
                                 generator, self.device)
        return self._update(batch, noise, group)

    def _update(self, batch: EpisodeBatch, noise: UpdateNoise, group: tp.Any = None) -> Metrics:
        """One gradient step; with ``group`` a data-parallel one
        (``FBDDPGAgent._update``)."""
        cfg = self.cfg
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        next_goal = batch.next_goal if cfg.goal_space is not None else batch.next_obs
        z = build_train_z(cfg, self.backward_net, batch, noise, shard)
        fb_loss, metrics = self._fb_loss(batch, z, next_goal, shard)
        fw_leaves = self.fw_opt.leaves
        bw_leaves = self.bw_opt.leaves
        grads = shard.grad(fb_loss, fw_leaves + bw_leaves)
        self.fw_opt.step(grads[:len(fw_leaves)])
        self.bw_opt.step(grads[len(fw_leaves):])
        soft_update(self.forward_net, self.target_forward_net, cfg.fb_target_tau)
        soft_update(self.backward_net, self.target_backward_net, cfg.fb_target_tau)
        self.step_t += 1
        return {k: v.detach() for k, v in metrics.items()}
