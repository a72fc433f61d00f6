"""Agent meta-dict interface (mirror of ``controllable_agent_tpu/agents/base.py``)."""

from __future__ import annotations

import typing as tp

import torch

MetaDict = tp.Dict[str, torch.Tensor]


class ZMetaMixin:
    """Uniform meta-dict policy interface for agents whose act() takes the
    task vector under ``meta_key``."""

    meta_key: str = "z"

    def policy_act(self, obs: torch.Tensor, meta: MetaDict, step: int,
                   generator: tp.Optional[torch.Generator] = None,
                   eval_mode: bool = False) -> torch.Tensor:
        return self.act(obs, meta[self.meta_key], step, generator,  # type: ignore[attr-defined]
                        eval_mode=eval_mode)

    def infer_meta(self, buffer: tp.Any, generator: torch.Generator) -> MetaDict:
        """Task inference from a replay buffer's STORED rewards: sample
        num_inference_steps transitions and regress z on them; agents
        without a regression API fall back to a random task vector."""
        cfg = self.cfg  # type: ignore[attr-defined]
        if not hasattr(self, "infer_meta_from_obs_and_rewards") or len(buffer) == 0:
            return self.init_meta(generator)  # type: ignore[attr-defined]
        batch = buffer.sample(generator, getattr(cfg, "num_inference_steps", 5120))
        obs = (batch.next_goal
               if (getattr(cfg, "goal_space", None) is not None
                   and batch.next_goal is not None) else batch.next_obs)
        z = self.infer_meta_from_obs_and_rewards(obs, batch.reward)
        return {self.meta_key: z}
