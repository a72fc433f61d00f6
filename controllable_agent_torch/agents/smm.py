"""SMMAgent — State Marginal Matching (mirror of
``controllable_agent_tpu/agents/smm.py``).

DDPG on an intrinsic reward, with a one-hot skill ``z`` (``z_dim`` = 4) in
the meta, resampled every ``update_skill_every_step`` steps as DIAYN's
skill; a VAE density model over [obs, z] (encoder 150-150, μ and log σ² of
width ``code_dim``, a decoder back to obs_dim + z_dim) and a skill
predictor q(z | s). The reward is

    state_ent_coef·h(s|z) + latent_ent_coef·log K + latent_cond_ent_coef·h(z|s)

with h(s|z) the VAE's summed reconstruction error and h(z|s) the
predictor's cross-entropy. The VAE's ε is drawn twice per update, once for
the loss and once for the reward (``SMMNoise``), as the JAX update draws it
from two keys.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import MLP
from ..ops.pbe import RMSState
from ..utils.dist import Shard
from .ddpg import DDPGNoise
from .exploration import IntrinsicConfig, IntrinsicDDPGAgent, SkillMetaMixin

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class SMMConfig(IntrinsicConfig):
    name: str = "smm"
    z_dim: int = 4
    sknn_hidden_dim: int = 128
    vae_beta: float = 0.5
    code_dim: int = 128
    state_ent_coef: float = 1.0
    latent_ent_coef: float = 1.0
    latent_cond_ent_coef: float = 1.0
    update_skill_every_step: int = 50


@dataclasses.dataclass
class SMMNoise(DDPGNoise):
    """DDPG's draws and the VAE's ε of the module loss and of the reward,
    [n, code_dim] each."""

    loss_eps: tp.Optional[Tensor] = None
    reward_eps: tp.Optional[Tensor] = None


class _SMMNets(nn.Module):
    """The VAE over [obs, z] and the skill predictor, named as the flax
    module's attributes."""

    def __init__(self, obs_dim: int, z_dim: int, hidden_dim: int, code_dim: int) -> None:
        super().__init__()
        obs_z_dim = obs_dim + z_dim
        self.enc = MLP(obs_z_dim, (150, "irelu", 150, "irelu"))
        self.enc_mu = MLP(150, (code_dim,))
        self.enc_logvar = MLP(150, (code_dim,))
        self.dec = MLP(code_dim, (150, "irelu", 150, "irelu", obs_z_dim))
        self.z_pred_net = MLP(obs_dim, (hidden_dim, "irelu", hidden_dim, "irelu", z_dim))

    def vae(self, obs_z: Tensor, eps: Tensor) -> tp.Tuple[Tensor, Tensor]:
        """(the KL term, h(s|z) per sample [B, 1])."""
        h = self.enc(obs_z)
        mu, logvar = self.enc_mu(h), self.enc_logvar(h)
        recon = self.dec(eps * torch.exp(0.5 * logvar) + mu)
        kle = -0.5 * (1 + logvar - mu.square() - logvar.exp()).sum(1).mean()
        return kle, (obs_z - recon).square().sum(1, keepdim=True)


class SMMAgent(SkillMetaMixin, IntrinsicDDPGAgent):
    cfg: SMMConfig
    skill_key = "z"

    @property
    def meta_dim(self) -> int:  # type: ignore[override]
        return self.cfg.z_dim

    def _make_module(self) -> nn.Module:
        cfg = self.cfg
        return _SMMNets(self.obs_dim, cfg.z_dim, cfg.hidden_dim, cfg.code_dim)

    def _draw(self, n: int, generator: torch.Generator) -> SMMNoise:
        base = DDPGNoise.draw(n, self.action_dim, generator, self.device)
        eps = [torch.randn(n, self.cfg.code_dim, generator=generator, device=self.device)
               for _ in range(2)]
        return SMMNoise(base.critic_normal, base.actor_normal, loss_eps=eps[0],
                        reward_eps=eps[1])

    def _terms(self, batch: EpisodeBatch, eps: tp.Optional[Tensor]
               ) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
        """(the KL term, h(s|z) [B, 1], h(z|s) [B], [obs, z]'s width)."""
        assert eps is not None, "an SMM update takes its VAE noise in SMMNoise"
        z = batch.meta["z"]
        obs_z = torch.cat([batch.obs, z], -1)
        kle, h_s_z = self.module.vae(obs_z, eps)
        h_z_s = F.cross_entropy(self.module.z_pred_net(batch.obs), z.argmax(1),
                                reduction="none")
        return kle, h_s_z, h_z_s, obs_z.shape[1]

    def _module_loss(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                     noise: DDPGNoise, shard: Shard = Shard()) -> tp.Tuple[Tensor, Metrics]:
        kle, h_s_z, h_z_s, width = self._terms(batch, getattr(noise, "loss_eps", None))
        vae_loss = self.cfg.vae_beta * kle + h_s_z.mean() / width
        pred_loss = h_z_s.mean()
        return vae_loss + pred_loss, {"loss_vae": vae_loss, "loss_pred": pred_loss}

    def _intrinsic_reward(self, batch: EpisodeBatch, goal: Tensor, next_goal: Tensor,
                          rms: RMSState, noise: DDPGNoise, shard: Shard = Shard()
                          ) -> tp.Tuple[Tensor, RMSState]:
        cfg = self.cfg
        _, h_s_z, h_z_s, _ = self._terms(batch, getattr(noise, "reward_eps", None))
        reward = (cfg.state_ent_coef * h_s_z + cfg.latent_ent_coef * math.log(cfg.z_dim)
                  + cfg.latent_cond_ent_coef * h_z_s[:, None])
        return reward, rms
