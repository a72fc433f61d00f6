"""Environments of the port, batched over a leading ``[E]`` axis
(``envs/base.py``): the planar locomotion domains (``locomotion.py`` on
``physics2d.py``), the quadruped and jaco (``quadruped.py`` and ``jaco.py`` on
the 3-D engine ``physics3d.py``), the point-mass maze (``pointmass.py``) and
the gridworld (``gridworld.py``)."""

from .gridworld import GridWorld, build_gridworld_task

__all__ = ["GridWorld", "build_gridworld_task"]
