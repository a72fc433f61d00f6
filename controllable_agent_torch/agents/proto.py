"""ProtoAgent — ProtoRL, SwAV-style prototypes (mirror of
``controllable_agent_tpu/agents/proto.py``).

A predictor and projector tower, a prototype matrix whose columns are
L2-normalised before scoring, Sinkhorn-Knopp target assignments (three
fixed iterations), the cross-entropy swap loss with one Adam step, then an
EMA of the predictor into its target (τ = ``encoder_target_tau``, after the
step). The intrinsic reward is the ``topk``-th smallest distance from each
next state's embedding to a queue of candidate embeddings.

The candidate queue ``[queue_size, pred_dim]`` and its pointer are device
buffers of the agent, so they are train state: checkpoints save them and a
captured update advances them. The write follows JAX's index arithmetic:
min(num_protos, queue_size) rows go in at ``ptr % (queue_size - num + 1)``
(``dynamic_update_slice`` clamps its start), then ``ptr = (ptr + num) %
queue_size``, all on the device. Each prototype's candidate row is a
Gumbel-max draw over the batch (``jax.random.categorical``), taken as the
Gumbel noise [num_protos, batch] in ``ProtoNoise``.

The distances are differences taken directly (``torch.cdist`` without the
matrix-product form), as JAX's ``norm(z[:, None] - queue[None])``: the
queue holds this batch's own candidates, whose distance must come out 0; the
product form would give the square root of a rounding residue, ~1e-3 at
unit norm, the scale of the reward itself.

Data-parallel (``group``), the Sinkhorn-Knopp normalisation runs over the
target scores of every process's rows (its column sums couple the batch),
the candidates are drawn from the embeddings of the global batch, so the
replicated queue and its pointer stay the same on every process, and each
process scores its own rows against the queue.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import MLP, l2_normalize
from ..utils.dist import Shard
from ..utils.tree import soft_update
from .ddpg import DDPGNoise
from .exploration import IntrinsicConfig, IntrinsicDDPGAgent

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class ProtoConfig(IntrinsicConfig):
    name: str = "proto"
    pred_dim: int = 128
    proj_dim: int = 512
    num_protos: int = 512
    tau: float = 0.1
    topk: int = 3
    queue_size: int = 2048
    encoder_target_tau: float = 0.05


@dataclasses.dataclass
class ProtoNoise(DDPGNoise):
    """DDPG's draws and the Gumbel noise of the candidates' categorical
    draw, [num_protos, n] over the global batch."""

    WHOLE = ("candidate_gumbel",)
    candidate_gumbel: tp.Optional[Tensor] = None


def sinkhorn_knopp(q: Tensor, n_iters: int = 3) -> Tensor:
    """Balanced soft assignments of scores [batch, protos]: rows and columns
    rescaled ``n_iters`` times to uniform marginals, then each sample's
    assignment normalised to sum to 1."""
    q = torch.exp(q - q.max()).T
    q = q / q.sum()
    r, c = 1.0 / q.shape[0], 1.0 / q.shape[1]
    for _ in range(n_iters):
        q = q * (r / q.sum(1))[:, None]
        q = q * (c / q.sum(0))[None, :]
    return (q / q.sum(0, keepdim=True)).T


class _ProtoNets(nn.Module):
    """The predictor, the projector, the prototypes [pred_dim, num_protos]
    and the predictor's target, named as the flax module's attributes. The
    target is in the module's parameters (and in its Adam, with zero
    gradients, as in JAX) and moves by the EMA only."""

    def __init__(self, obs_dim: int, pred_dim: int, proj_dim: int, num_protos: int) -> None:
        super().__init__()
        self.predictor = MLP(obs_dim, (pred_dim,))
        self.projector = MLP(pred_dim, (proj_dim, "irelu", pred_dim))
        self.protos = nn.Parameter(nn.init.orthogonal_(torch.empty(pred_dim, num_protos)))
        self.target_predictor = MLP(obs_dim, (pred_dim,))

    def embed(self, obs: Tensor) -> Tensor:
        return l2_normalize(self.predictor(obs), scale_sqrt_dim=False)

    def scores(self, z: Tensor) -> Tensor:
        """z · the prototypes, each column L2-normalised."""
        w = self.protos
        return z @ (w / torch.linalg.vector_norm(w, dim=0, keepdim=True).clamp_min(1e-12))

    def forward(self, obs: Tensor, next_obs: Tensor) -> tp.Tuple[Tensor, Tensor]:
        """The online scores of ``obs`` and the target's of ``next_obs``
        (without gradient)."""
        s = l2_normalize(self.projector(self.predictor(obs)), scale_sqrt_dim=False)
        with torch.no_grad():
            t = l2_normalize(self.target_predictor(next_obs), scale_sqrt_dim=False)
            scores_t = self.scores(t)
        return self.scores(s), scores_t


class ProtoAgent(IntrinsicDDPGAgent):
    cfg: ProtoConfig

    def __init__(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        super().__init__(*args, **kwargs)
        cfg = self.cfg
        self.register_buffer("queue", torch.zeros(cfg.queue_size, cfg.pred_dim,
                                                  device=self.device))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.int64,
                                                      device=self.device))

    def _make_module(self) -> nn.Module:
        cfg = self.cfg
        return _ProtoNets(self.obs_dim, cfg.pred_dim, cfg.proj_dim, cfg.num_protos)

    def _draw(self, n: int, generator: torch.Generator) -> ProtoNoise:
        base = DDPGNoise.draw(n, self.action_dim, generator, self.device)
        u = torch.rand(self.cfg.num_protos, n, generator=generator, device=self.device)
        return ProtoNoise(base.critic_normal, base.actor_normal,
                          candidate_gumbel=-torch.log(-torch.log(u)))

    @torch.no_grad()
    def _queue_reward(self, next_obs: Tensor, gumbel: Tensor, shard: Shard = Shard()) -> Tensor:
        """Push the candidates of the global batch into the queue, then the
        ``topk``-th smallest distance of each of this process's embeddings
        to the queue [B, 1]."""
        cfg = self.cfg
        z = self.module.embed(next_obs)
        every = shard.gather(z)
        candidates = (self.module.scores(every).T + gumbel).argmax(1)  # [num_protos]
        size = self.queue.shape[0]
        num = min(cfg.num_protos, size)
        start = self.queue_ptr % (size - num + 1)
        rows = start + torch.arange(num, device=self.device)
        self.queue.index_copy_(0, rows, every[candidates[:num]])
        self.queue_ptr.copy_((self.queue_ptr + num) % size)
        dist = torch.cdist(z, self.queue, compute_mode="donot_use_mm_for_euclid_dist")
        return torch.topk(dist, cfg.topk, dim=1, largest=False).values[:, -1:]

    def _update(self, batch: EpisodeBatch, noise: DDPGNoise, group: tp.Any = None) -> Metrics:
        cfg = self.cfg
        shard = Shard(group)
        global_noise, noise = noise, shard.noise(noise, batch.obs.shape[0])
        assert self.module_opt is not None
        scores_s, scores_t = self.module(batch.obs, batch.next_obs)
        log_p_s = torch.log_softmax(scores_s / cfg.tau, dim=1)
        every_t = shard.gather(scores_t / cfg.tau)
        q_t = sinkhorn_knopp(every_t)[shard.rows(every_t.shape[0])]
        repr_loss = -(q_t * log_p_s).sum(1).mean()
        self.module_opt.step(shard.grad(repr_loss, self.module_opt.leaves,
                                        allow_unused=True, materialize_grads=True))
        soft_update(self.module.predictor, self.module.target_predictor,
                    cfg.encoder_target_tau)
        metrics: Metrics = {"repr_loss": repr_loss}
        reward = batch.reward
        if cfg.reward_free:
            gumbel = getattr(noise, "candidate_gumbel", None)
            assert gumbel is not None, "a Proto update takes its candidates' draw in ProtoNoise"
            reward = self._queue_reward(batch.next_obs, gumbel, shard)
            metrics["intr_reward"] = reward.mean()
        metrics = shard.mean({k: v.detach().float() for k, v in metrics.items()})
        metrics.update(self.ddpg._update(dataclasses.replace(batch, reward=reward), global_noise,
                                         use_reward_model=False, group=group))
        return metrics
