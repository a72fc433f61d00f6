"""Point-mass maze: the task table only (mirror of the ``TASKS`` of
``controllable_agent_tpu/envs/pointmass.py``). The environment itself is
ROADMAP Queue A item 12; physics = [x, y, vx, vy]."""

from __future__ import annotations

import typing as tp

import numpy as np

TASKS: tp.Dict[str, np.ndarray] = {
    "reach_top_left": np.array([-0.15, 0.15], np.float32),
    "reach_top_right": np.array([0.15, 0.15], np.float32),
    "reach_bottom_left": np.array([-0.15, -0.15], np.float32),
    "reach_bottom_right": np.array([0.15, -0.15], np.float32),
}
