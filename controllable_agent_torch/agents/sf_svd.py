"""SFSVDAgent — successor features of a joint SVD learner (mirror of
``controllable_agent_tpu/agents/sf_svd.py``).

One ``SVDLearner`` factors the transition operator as φ(s, a)·μ(s') with
the −2·trace + off-diagonal² loss and φ-orthonormality; the successor nets
and the actor are SF's (``agents/sf.py:SuccessorFeatureAgent``). Task
inference needs (obs, action, reward): z = lstsq(φ(s, a), r). As in JAX,
the learner steps first and the SF target reads the updated φ at the
batch's (goal, action), and an update draws three things: z's normal, the
target policy's noise and the actor's. SF-SVD runs in float32 whatever
``compute_dtype`` says, as the JAX SF-SVD does. Data-parallel (``group``,
``utils/dist.py``), the factorization and orthonormality losses take the
rows of every process; the SF and actor losses are per row.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..ops.fb import orthonormality_loss
from ..optim import Adam
from ..utils.device import DeviceLike
from ..utils.dist import Shard
from ..utils.tree import soft_update
from .sf import (Metrics, SFNoise, SuccessorFeatureAgent, factorization_loss,
                 normalized_solution, phi_mlp)

Tensor = torch.Tensor


class SVDLearner(nn.Module):
    """φ(s, a)·μ(s') factorization."""

    def __init__(self, obs_dim: int, action_dim: int, z_dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.feature_net = phi_mlp(obs_dim + action_dim, hidden_dim, z_dim)
        self.mu_net = phi_mlp(obs_dim, hidden_dim, z_dim, l2=False)

    def features(self, obs: Tensor, action: Tensor) -> Tensor:
        return self.feature_net(torch.cat([obs, action], -1))

    def loss(self, obs: Tensor, action: Tensor, next_obs: Tensor,
             shard: Shard = Shard()) -> Tensor:
        """The loss of the rows of every process (``shard``)."""
        phi = shard.gather(self.features(obs, action))
        p = phi.float() @ shard.gather(self.mu_net(next_obs)).float().T
        orth, _, _ = orthonormality_loss(phi)
        return factorization_loss(p, p) + orth


@dataclasses.dataclass(frozen=True)
class SFSVDConfig:
    """Same fields and defaults as the JAX ``SFSVDConfig``; like there,
    ``mix_ratio`` and ``compute_dtype`` are read by nothing."""

    name: str = "sf_svd"
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
    preprocess: bool = True
    q_loss: bool = True
    mix_ratio: float = 0.0
    add_trunk: bool = False
    num_expl_steps: int = 0
    compute_dtype: str = "float32"


class SFSVDAgent(SuccessorFeatureAgent):
    """Networks, targets, SVD learner and optimizers of one SF-SVD agent."""

    OPTIMIZERS = ("actor_opt", "sf_opt", "svd_opt")

    def __init__(self, cfg: SFSVDConfig, obs_dim: int, action_dim: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__(cfg, obs_dim, action_dim, goal_dim, device, seed)
        self.svd_opt = Adam(self.svd, cfg.lr_coef * cfg.lr)

    def _build_learner(self) -> None:
        self.svd = SVDLearner(self.goal_dim, self.action_dim, self.cfg.z_dim,
                              self.cfg.backward_hidden_dim)

    @torch.no_grad()
    def features(self, goal: Tensor, action: Tensor) -> Tensor:
        """φ(goal, action), float32."""
        return self.svd.features(goal, action).float()

    @torch.no_grad()
    def infer_meta_from_obs_action_and_rewards(self, obs: Tensor, action: Tensor,
                                               reward: Tensor) -> Tensor:
        """z = lstsq(φ(s, a), r), sqrt(z_dim)-normalized."""
        return normalized_solution(self.features(obs, action), reward, self.cfg.z_dim)

    def _update(self, batch: EpisodeBatch, noise: SFNoise, group: tp.Any = None) -> Metrics:
        cfg = self.cfg
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        use_goal = cfg.goal_space is not None
        goal = batch.goal if use_goal else batch.obs
        next_goal = batch.next_goal if use_goal else batch.next_obs
        z = self.z_from_noise(noise.z_normal)

        phi_loss = self.svd.loss(goal, batch.action, next_goal, shard)
        self._step(self.svd_opt, phi_loss, shard)
        # the SF target reads the updated φ at (goal, action) (sf_svd.py:210-211)
        target_f = self._target_f(batch, z, self.features(goal, batch.action),
                                  noise.next_action_normal)
        sf_loss, _ = self._successor_loss(batch, z, target_f)
        self._step(self.sf_opt, sf_loss, shard)
        actor_loss, _ = self._actor_loss(batch.obs, z, noise.actor_normal)
        self._step(self.actor_opt, actor_loss, shard)
        soft_update(self.successor_net, self.target_successor_net, cfg.sf_target_tau)
        self.step_t += 1
        return shard.mean({"phi_loss": phi_loss.detach(), "sf_loss": sf_loss.detach(),
                           "actor_loss": actor_loss.detach()})
