"""DiscreteSFAgent — successor features for discrete action spaces (mirror of
``controllable_agent_tpu/agents/discrete_sf.py``).

SF's twin successor nets F(s, a, z) and its φ learners, with the action fed
one-hot; no actor: the policy is greedy (ε-greedy while exploring) over
Q(s, a) = min(F1·z, F2·z) of every action. The actions are enumerated as one
batched pass over [n_actions·B] rows where JAX ``vmap``s a pass per action.
The TD target takes F at the greedy next action from the twin with the
smaller Q.

JAX quirks kept on purpose: there is no ``get_goal_meta`` and no inference
API (the workspace evaluates with ``init_meta``'s random z),
``mix_ratio`` is read by nothing, and the learners' target networks are
never updated. Data-parallel (``group``, ``utils/dist.py``), the learners
that couple the batch take every process's rows, as in SF.
"""

from __future__ import annotations

import copy
import dataclasses
import typing as tp

import torch
from torch import nn

from ..data.episode_batch import EpisodeBatch
from ..models.networks import ForwardMap, l2_normalize
from ..optim import Adam
from ..utils.device import DeviceLike, resolve_device
from ..utils.dist import Shard
from ..utils.tree import soft_update
from .base import MetaDict, StepNoise, ZMetaMixin, epsilon_greedy, load_train_state
from .sf import FEATURE_LEARNERS, SFConfig, SFNoise, _dot

Tensor = torch.Tensor
Metrics = tp.Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class DiscreteSFConfig(SFConfig):
    """Same fields and defaults as the JAX ``DiscreteSFConfig``."""

    name: str = "discrete_sf"
    expl_eps: float = 0.2
    preprocess: bool = False


def one_hot(index: Tensor, n: int) -> Tensor:
    """[B] integer indices -> [B, n] float32, with no host read (a CUDA
    graph holds it)."""
    return (index.reshape(-1, 1).long() == torch.arange(n, device=index.device)).float()


class DiscreteSFAgent(ZMetaMixin, nn.Module):
    """Successor nets, their target, the φ learner and the optimizers of one
    discrete SF agent."""

    # the workspace builds it with the environment's number of actions
    takes_n_actions = True

    def __init__(self, cfg: DiscreteSFConfig, obs_dim: int, n_actions: int,
                 goal_dim: tp.Optional[int] = None, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__()
        if cfg.feature_learner not in FEATURE_LEARNERS:
            raise ValueError(f"Unknown feature learner {cfg.feature_learner!r}; "
                             f"known: {sorted(FEATURE_LEARNERS)}")
        if cfg.feature_learner == "identity":
            cfg = dataclasses.replace(cfg, z_dim=goal_dim or obs_dim)
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.goal_dim = goal_dim if goal_dim is not None else obs_dim
        self.device = resolve_device(device)
        # weights are drawn on the CPU from the seed, then moved: the same
        # seed gives the same agent on every device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.successor_net = ForwardMap(obs_dim, cfg.z_dim, n_actions, cfg.feature_dim,
                                            cfg.hidden_dim, preprocess=cfg.preprocess,
                                            add_trunk=cfg.add_trunk)
            self.feature_learner = FEATURE_LEARNERS[cfg.feature_learner](
                self.goal_dim, n_actions, cfg.z_dim, cfg.backward_hidden_dim)
        self.target_successor_net = copy.deepcopy(self.successor_net).requires_grad_(False)
        for _, target in type(self.feature_learner).TARGET_PAIRS:
            getattr(self.feature_learner, target).requires_grad_(False)
        self.register_buffer("step_t", torch.zeros((), dtype=torch.int64))
        self.to(self.device)
        self.sf_opt = Adam(self.successor_net, cfg.lr)
        trainable = {k: p for k, p in self.feature_learner.named_parameters()
                     if p.requires_grad}
        # the learner's Adam, its targets left out (none for identity, which
        # has no parameters); the JAX agent steps every learner but random and
        # identity, fb's with a zero loss
        self.phi_opt = Adam(trainable, cfg.lr_coef * cfg.lr) if trainable else None
        self.learner_trainable = cfg.feature_learner not in ("random", "identity")

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
        for name in ("sf_opt", "phi_opt"):
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

    @torch.no_grad()
    def features(self, goal: Tensor) -> Tensor:
        """φ(goal), float32."""
        return self.feature_learner.features(goal).float()

    # -- acting ---------------------------------------------------------
    def all_action_q(self, net: nn.Module, obs: Tensor, z: Tensor) -> Tensor:
        """Q(s, a, z) = min(F1·z, F2·z) of every action, [B, n_actions]: one
        pass of ``net`` over the [n_actions·B] rows of each action's one-hot
        beside the batch."""
        n, b = self.n_actions, obs.shape[0]
        actions = one_hot(torch.arange(n, device=obs.device), n).repeat_interleave(b, 0)
        zs = z.repeat(n, 1)
        f1, f2 = net(obs.repeat(n, 1), zs, actions)
        return torch.minimum(_dot(f1, zs), _dot(f2, zs)).reshape(n, b).T

    @torch.no_grad()
    def act(self, obs: Tensor, z: Tensor, step: tp.Union[int, Tensor],
            generator: tp.Optional[torch.Generator] = None,
            eval_mode: bool = False, noise: tp.Optional[StepNoise] = None) -> Tensor:
        """Batched policy; obs [B, obs_dim], z [B, z_dim] -> action indices
        [B] (int64): greedy in eval mode, else ε-greedy."""
        q = self.all_action_q(self.successor_net, obs, z)
        if eval_mode:
            return q.argmax(-1)
        return epsilon_greedy(q, step, self.cfg.expl_eps, self.cfg.num_expl_steps, noise,
                              generator)

    # -- losses ---------------------------------------------------------
    @torch.no_grad()
    def _target_f(self, batch: EpisodeBatch, z: Tensor, next_goal: Tensor) -> Tensor:
        """φ(s') + γ·F_target(s', a', z): a' the greedy next action, F_target
        the twin with the smaller F·z there."""
        next_q = self.all_action_q(self.target_successor_net, batch.next_obs, z)
        next_action = one_hot(next_q.argmax(-1), self.n_actions)
        nf1, nf2 = self.target_successor_net(batch.next_obs, z, next_action)
        next_f = torch.where((_dot(nf1, z) < _dot(nf2, z))[:, None], nf1.float(), nf2.float())
        return self.features(next_goal) + batch.discount * next_f

    def _sf_loss(self, batch: EpisodeBatch, z: Tensor, action: Tensor,
                 next_goal: Tensor) -> Tensor:
        target_f = self._target_f(batch, z, next_goal)
        f1, f2 = self.successor_net(batch.obs, z, action)
        if self.cfg.q_loss:
            target_q = _dot(target_f, z)
            return ((_dot(f1, z) - target_q).square().mean()
                    + (_dot(f2, z) - target_q).square().mean())
        return ((f1.float() - target_f).square().mean()
                + (f2.float() - target_f).square().mean())

    # -- the update -----------------------------------------------------
    def update(self, batch: EpisodeBatch, generator: torch.Generator,
               group: tp.Any = None) -> Metrics:
        """One gradient step with noise drawn from ``generator``; with a
        process group, the noise of the global batch (``DDPGAgent.update``)."""
        noise = SFNoise.draw(batch.obs.shape[0] * Shard(group).world, self.cfg.z_dim, 0,
                             False, generator, self.device)
        return self._update(batch, noise, group)

    def _update(self, batch: EpisodeBatch, noise: SFNoise, group: tp.Any = None) -> Metrics:
        """One gradient step; with ``group`` a data-parallel one
        (``DDPGAgent._update``)."""
        cfg = self.cfg
        shard = Shard(group)
        noise = shard.noise(noise, batch.obs.shape[0])
        use_goal = cfg.goal_space is not None
        goal = batch.goal if use_goal else batch.obs
        next_goal = batch.next_goal if use_goal else batch.next_obs
        z = self.z_from_noise(noise.z_normal)
        action = one_hot(batch.action, self.n_actions)

        sf_loss = self._sf_loss(batch, z, action, next_goal)
        self.sf_opt.step(shard.grad(sf_loss, self.sf_opt.leaves))
        metrics: Metrics = {"sf_loss": sf_loss}
        if self.learner_trainable and self.phi_opt is not None:
            leaves = self.phi_opt.leaves
            phi_loss = self.feature_learner.loss(
                goal, action, next_goal, batch.future_goal if use_goal else batch.future_obs,
                shard)
            if phi_loss is None:  # fb: a frozen φ whose Adam steps on zeros, as in JAX
                phi_loss = torch.zeros((), device=goal.device)
                grads: tp.Sequence[Tensor] = [torch.zeros_like(p) for p in leaves]
            else:
                grads = shard.grad(phi_loss, leaves)
            self.phi_opt.step(grads)
            metrics["phi_loss"] = phi_loss
        soft_update(self.successor_net, self.target_successor_net, cfg.sf_target_tau)
        self.step_t += 1
        return shard.mean({k: v.detach() for k, v in metrics.items()})
