"""Canonical benchmark task lists (mirror of
``controllable_agent_tpu/envs/benchmark.py``): the domains, each domain's
tasks, and the reward-free pretraining task of each domain. Every name here
resolves through ``train.workspace.make_env``.
"""

from __future__ import annotations

import typing as tp

DOMAINS = [
    "walker",
    "quadruped",
    "jaco",
    "point_mass_maze",
    "cheetah",
    "hopper",
    "grid",
]

WALKER_TASKS = [
    "walker_stand",
    "walker_walk",
    "walker_run",
    "walker_flip",
]

CHEETAH_TASKS = [
    "cheetah_walk",
    "cheetah_walk_backward",
    "cheetah_run",
    "cheetah_run_backward",
]

QUADRUPED_TASKS = [
    "quadruped_walk",
    "quadruped_run",
    "quadruped_stand",
    "quadruped_jump",
]

JACO_TASKS = [
    "jaco_reach_top_left",
    "jaco_reach_top_right",
    "jaco_reach_bottom_left",
    "jaco_reach_bottom_right",
]

POINT_MASS_MAZE_TASKS = [
    "point_mass_maze_reach_top_left",
    "point_mass_maze_reach_top_right",
    "point_mass_maze_reach_bottom_left",
    "point_mass_maze_reach_bottom_right",
]

TASKS: tp.List[str] = (WALKER_TASKS + QUADRUPED_TASKS + JACO_TASKS
                       + POINT_MASS_MAZE_TASKS)

# reward-free pretraining entry task per domain
PRIMAL_TASKS = {
    "walker": "walker_stand",
    "jaco": "jaco_reach_top_left",
    "quadruped": "quadruped_walk",
    "cheetah": "cheetah_walk",
    "hopper": "hopper_stand",
    "point_mass_maze": "point_mass_maze_reach_top_left",
    "grid": "grid_simple",
}
