"""Environments of the port, batched over a leading ``[E]`` axis
(``envs/base.py``): the planar locomotion domains (``locomotion.py`` on
``physics2d.py``), the quadruped and jaco (``quadruped.py`` and ``jaco.py`` on
the 3-D engine ``physics3d.py``), the point-mass maze (``pointmass.py``), the
gridworld (``gridworld.py``) and the replay of a d4rl dataset
(``d4rl_replay.py``); ``benchmark.py`` lists the tasks by domain."""

from .gridworld import GridWorld, build_gridworld_task

__all__ = ["GridWorld", "build_gridworld_task"]
