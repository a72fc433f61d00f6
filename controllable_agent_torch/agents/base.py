"""Agent meta-dict interface (mirror of ``controllable_agent_tpu/agents/base.py``).

The episode collector advances a batch of environments one control step at
a time, and on a CUDA device that step is a captured graph: so everything
a step reads (the step counter that the exploration schedule takes, the
index ``t`` inside the episode) is a device tensor, and every random draw of
a step is one ``StepNoise``, drawn from a ``torch.Generator`` or, in a
parity test, handed in.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

MetaDict = tp.Dict[str, torch.Tensor]
Tensor = torch.Tensor


@dataclasses.dataclass
class StepNoise:
    """Every random draw of one collector step for ``n`` environments, in
    the shapes the JAX collector draws them: the policy's noise and uniform
    exploration (``act``; a discrete policy's ε draw and random action
    instead), and the draws of ``rollout_update_meta`` (a z's, or a skill's
    index)."""

    act_normal: tp.Optional[Tensor] = None  # [n, action_dim]
    act_uniform: tp.Optional[Tensor] = None  # [n, action_dim], in [0, 1)
    meta_uniform: tp.Optional[Tensor] = None  # [n, 1], resample when < update_z_proba
    z_normal: tp.Optional[Tensor] = None  # [n, z_dim], the new z's normal draw (APS: task's)
    z_uniform: tp.Optional[Tensor] = None  # [n, z_dim], norm_z=False only
    explore_uniform: tp.Optional[Tensor] = None  # [n], explore when < expl_eps (discrete)
    random_action: tp.Optional[Tensor] = None  # [n] int64 in [0, n_actions) (discrete)
    skill_index: tp.Optional[Tensor] = None  # [n] int64, a resampled one-hot skill (DIAYN)

    @classmethod
    def draw(cls, n: int, action_dim: int, generator: torch.Generator,
             device: torch.device, z_dim: int = 0, norm_z: bool = True,
             n_actions: int = 0) -> "StepNoise":
        """The draws of one step; ``z_dim`` > 0 adds those of a z resample,
        ``n_actions`` > 0 draws a discrete policy's in place of the normal
        and uniform actions."""
        def normal(*shape: int) -> Tensor:
            return torch.randn(shape, generator=generator, device=device)

        def uniform(*shape: int) -> Tensor:
            return torch.rand(shape, generator=generator, device=device)

        meta = dict(meta_uniform=uniform(n, 1) if z_dim else None,
                    z_normal=normal(n, z_dim) if z_dim else None,
                    z_uniform=uniform(n, z_dim) if z_dim and not norm_z else None)
        if n_actions:
            return cls(explore_uniform=uniform(n), random_action=torch.randint(
                n_actions, (n,), generator=generator, device=device), **meta)
        return cls(act_normal=normal(n, action_dim), act_uniform=uniform(n, action_dim), **meta)


def act_draws(noise: tp.Optional[StepNoise], mu: Tensor,
              generator: tp.Optional[torch.Generator]) -> tp.Tuple[Tensor, Tensor]:
    """The policy's normal and uniform draws: ``noise``'s, or fresh ones."""
    if noise is not None:
        assert noise.act_normal is not None and noise.act_uniform is not None
        return noise.act_normal, noise.act_uniform
    return (torch.randn(mu.shape, generator=generator, device=mu.device),
            torch.rand(mu.shape, generator=generator, device=mu.device))


def epsilon_greedy(q: Tensor, step: tp.Union[int, Tensor], expl_eps: float,
                   num_expl_steps: int, noise: tp.Optional[StepNoise],
                   generator: tp.Optional[torch.Generator]) -> Tensor:
    """A discrete policy's actions [B] (int64) from its Q values [B,
    n_actions]: the first argmax, or a uniform random action where the ε
    draw is below ``expl_eps`` or while ``step`` < ``num_expl_steps`` (a
    device ``step`` selects on the device). The draws come from ``noise``
    or, without it, from ``generator``."""
    greedy = q.argmax(-1)
    if noise is None:
        noise = StepNoise.draw(q.shape[0], 0, generator, q.device,  # type: ignore[arg-type]
                               n_actions=q.shape[-1])
    assert noise.explore_uniform is not None and noise.random_action is not None
    explore = (noise.explore_uniform < expl_eps) | (step < num_expl_steps)
    return torch.where(explore, noise.random_action, greedy)


def explore_until(action: Tensor, uniform: Tensor, step: tp.Union[int, Tensor],
                  num_expl_steps: int) -> Tensor:
    """``action``, or the uniform action ``2 u - 1`` while ``step`` <
    ``num_expl_steps``; a device ``step`` selects on the device."""
    explore = step < num_expl_steps
    expl = (uniform * 2 - 1).to(action.dtype)
    if isinstance(explore, Tensor):
        return torch.where(explore, expl, action)
    return expl if explore else action


def load_train_state(agent: tp.Any, state: tp.Mapping[str, Tensor]) -> None:
    """Copy ``state`` (as the agent's ``train_state`` names it) into the
    agent, in place, so that a captured update keeps seeing it."""
    own = agent.train_state()
    if set(own) != set(state):
        raise ValueError(
            "agent state does not match this agent: missing "
            f"{sorted(set(own) - set(state))}, unexpected "
            f"{sorted(set(state) - set(own))}")
    with torch.no_grad():
        for name, dst in own.items():
            if dst.shape != state[name].shape:
                raise ValueError(f"{name}: saved shape {tuple(state[name].shape)}, "
                                 f"agent has {tuple(dst.shape)}")
            dst.copy_(state[name])


class ZMetaMixin:
    """Uniform meta-dict policy interface for agents whose act() takes the
    task vector under ``meta_key``."""

    meta_key: str = "z"

    @property
    def meta_dims(self) -> tp.Dict[str, int]:
        """The width of each meta entry the policy takes: its task vector's."""
        return {self.meta_key: self.cfg.z_dim}  # type: ignore[attr-defined]

    def policy_act(self, obs: Tensor, meta: MetaDict, step: tp.Union[int, Tensor],
                   generator: tp.Optional[torch.Generator] = None,
                   eval_mode: bool = False,
                   noise: tp.Optional[StepNoise] = None) -> Tensor:
        return self.act(obs, meta[self.meta_key], step, generator,  # type: ignore[attr-defined]
                        eval_mode=eval_mode, noise=noise)

    def step_noise(self, n: int, generator: torch.Generator) -> StepNoise:
        """The draws of one collector step for ``n`` environments."""
        cfg = self.cfg  # type: ignore[attr-defined]
        resamples = bool(getattr(cfg, "update_z_every_step", 0))
        n_actions = getattr(self, "n_actions", 0)
        return StepNoise.draw(n, 0 if n_actions else self.action_dim,  # type: ignore[attr-defined]
                              generator, self.device,  # type: ignore[attr-defined]
                              z_dim=cfg.z_dim if resamples else 0,
                              norm_z=getattr(cfg, "norm_z", True), n_actions=n_actions)

    def rollout_update_meta(self, meta: MetaDict, t: Tensor, noise: StepNoise) -> MetaDict:
        """Resample the task vector of each environment at the steps ``t``
        (a device tensor: the index inside the episode) that are multiples of
        update_z_every_step, with probability update_z_proba."""
        cfg = self.cfg  # type: ignore[attr-defined]
        every = getattr(cfg, "update_z_every_step", 0)
        if not every or not hasattr(self, "z_from_noise"):
            return meta
        assert noise.meta_uniform is not None and noise.z_normal is not None
        z = meta[self.meta_key]
        resample = ((t % every) == 0) & (noise.meta_uniform < getattr(cfg, "update_z_proba", 1.0))
        new_z = self.z_from_noise(noise.z_normal, noise.z_uniform)
        return {**meta, self.meta_key: torch.where(resample, new_z, z)}

    def infer_meta(self, buffer: tp.Any, generator: torch.Generator) -> MetaDict:
        """Task inference from a replay buffer's STORED rewards: sample
        num_inference_steps transitions and regress z on them, on (next
        state, action) for an agent with the action-conditioned API (SF-SVD)
        and on the next state otherwise; agents without a regression API
        fall back to a random task vector."""
        cfg = self.cfg  # type: ignore[attr-defined]
        has_sa = hasattr(self, "infer_meta_from_obs_action_and_rewards")
        if not (has_sa or hasattr(self, "infer_meta_from_obs_and_rewards")) or len(buffer) == 0:
            return self.init_meta(generator)  # type: ignore[attr-defined]
        batch = buffer.sample(generator, getattr(cfg, "num_inference_steps", 5120))
        obs = (batch.next_goal
               if (getattr(cfg, "goal_space", None) is not None
                   and batch.next_goal is not None) else batch.next_obs)
        if has_sa:  # the SVD family regresses on (state, action)
            z = self.infer_meta_from_obs_action_and_rewards(  # type: ignore[attr-defined]
                obs, batch.action, batch.reward)
        else:
            z = self.infer_meta_from_obs_and_rewards(obs, batch.reward)  # type: ignore[attr-defined]
        return {self.meta_key: z}
