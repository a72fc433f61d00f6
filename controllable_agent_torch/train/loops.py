"""Training loops (mirror of ``controllable_agent_tpu/train/loops.py``).

Only the offline trainer is ported so far: the episode collector and the
online trainer come with the online path (ROADMAP Queue A item 10).
"""

from __future__ import annotations

import typing as tp

import torch

from ..data import replay as replay_lib
from ..data.replay import ReplayState, SampleConfig


def make_offline_trainer(agent: tp.Any, sample_cfg: SampleConfig,
                         batch_size: int, steps_per_call: int,
                         with_future: bool = True) -> tp.Callable:
    """Returns ``train_n(replay_state, generator) -> metrics`` running
    ``steps_per_call`` updates of ``agent`` in place, each sampling its batch
    on the replay's device. Metrics are the mean over the call, left on the
    device (no host sync inside the call).

    A plain Python loop: the JAX version scans the steps in one program;
    capturing the step in a CUDA graph is later work.
    """

    def train_n(replay_state: ReplayState,
                generator: torch.Generator) -> tp.Dict[str, torch.Tensor]:
        sums: tp.Dict[str, torch.Tensor] = {}
        for _ in range(steps_per_call):
            batch = replay_lib.sample(replay_state, generator, batch_size,
                                      sample_cfg, with_future=with_future)
            metrics = agent.update(batch, generator)
            for k, v in metrics.items():
                v = v.float()
                sums[k] = sums[k] + v if k in sums else v
        return {k: v / steps_per_call for k, v in sums.items()}

    return train_n
