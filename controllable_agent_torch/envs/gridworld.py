"""Gridworld, the discrete agents' testbed (mirror of
``controllable_agent_tpu/envs/gridworld.py``).

Layouts ``simple`` / ``obstacle`` / ``random_goal``, five actions
(up/right/down/left/stay), a wall leaves the agent in place and pays
``penalty_for_walls``, a step onto the goal pays ``reward_goal`` and the
episode goes on, ``LAST`` at ``max_episode_length``; five observation types.
Batched over a leading ``[E]`` axis like the port's other environments.

``step`` takes the action as the collector and the rollout hand it, a float
``[E]`` or ``[E, 1]`` holding the index (cast to an integer as the JAX cast
to int32 does), and touches only device tensors: a CUDA graph replays it.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from .base import Environment, EnvSpec, StepType, TimeStep

Tensor = torch.Tensor

# layouts: -1 = wall, 0 = empty
_SIMPLE = [
    [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [-1, 0, 0, 0, 0, 0, 0, 0, 0, -1],
    [-1, 0, 0, 0, -1, -1, 0, 0, 0, -1],
    [-1, 0, 0, 0, -1, -1, 0, 0, 0, -1],
    [-1, 0, 0, 0, -1, -1, 0, 0, 0, -1],
    [-1, 0, 0, 0, 0, 0, 0, 0, 0, -1],
    [-1, 0, 0, 0, 0, 0, 0, 0, 0, -1],
    [-1, 0, 0, 0, 0, 0, 0, 0, 0, -1],
    [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
]
_OBSTACLE = [
    [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [-1, 0, 0, 0, 0, 0, -1, 0, 0, -1],
    [-1, 0, 0, 0, -1, 0, 0, 0, 0, -1],
    [-1, 0, 0, 0, -1, -1, 0, 0, 0, -1],
    [-1, 0, 0, 0, -1, -1, 0, 0, 0, -1],
    [-1, 0, 0, 0, 0, 0, 0, 0, 0, -1],
    [-1, 0, 0, 0, 0, 0, 0, 0, 0, -1],
    [-1, 0, 0, 0, 0, 0, 0, 0, 0, -1],
    [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
]

TASKS: tp.Dict[str, tp.Dict[str, tp.Any]] = {
    "simple": {"layout": _SIMPLE, "start": (2, 2), "randomize_goals": True, "goal": None},
    "obstacle": {"layout": _OBSTACLE, "start": (2, 2), "randomize_goals": False,
                 "goal": (2, 8)},
    "random_goal": {"layout": _SIMPLE, "start": (2, 2), "randomize_goals": False,
                    "goal": None},
}

# action deltas: up, right, down, left, stay
_DELTAS = np.array([[-1, 0], [0, 1], [1, 0], [0, -1], [0, 0]], np.int32)

OBS_AGENT_POS = "agent_pos"
OBS_AGENT_ONEHOT = "agent_onehot"
OBS_STATE_INDEX = "state_index"
OBS_GRID = "grid"  # flat H x W x 3: walls / agent / goal channels
OBS_AGENT_GOAL_POS = "agent_goal_pos"  # (ay, ax, gy, gx)
OBSERVATION_TYPES = (OBS_AGENT_POS, OBS_AGENT_ONEHOT, OBS_STATE_INDEX, OBS_GRID,
                     OBS_AGENT_GOAL_POS)


@dataclasses.dataclass(frozen=True)
class GridState:
    pos: Tensor  # [E, 2] int32 (y, x)
    goal: Tensor  # [E, 2] int32
    t: Tensor  # [E] int32, steps taken this episode


class GridWorld(Environment):
    """A layout of walls and free cells, a start cell and a goal per episode."""

    def __init__(self, layout: tp.Sequence[tp.Sequence[int]], start: tp.Tuple[int, int],
                 goal: tp.Optional[tp.Tuple[int, int]] = None,
                 observation_type: str = OBS_AGENT_POS, discount: float = 1.0,
                 penalty_for_walls: float = 0.0, reward_goal: float = 1.0,
                 max_episode_length: int = 200, randomize_goals: bool = False) -> None:
        if observation_type not in OBSERVATION_TYPES:
            raise ValueError(f"Unknown observation type {observation_type!r}; "
                             f"known: {list(OBSERVATION_TYPES)}")
        self.layout = np.array(layout, np.int32)
        self.shape = tuple(self.layout.shape)
        self.start = np.array(start, np.int32)
        self.observation_type = observation_type
        self.discount = discount
        self.penalty_for_walls = penalty_for_walls
        self.reward_goal = reward_goal
        self.max_episode_length = max_episode_length
        self.randomize_goals = randomize_goals
        self.n_states = int(np.prod(self.shape))
        free = np.argwhere(self.layout == 0)
        # candidate goal cells exclude the start cell
        self.free_cells = free[~np.all(free == self.start, axis=1)].astype(np.int32)
        self.default_goal = np.array(goal if goal is not None else self.free_cells[0], np.int32)
        self._consts: tp.Dict[torch.device, tp.Dict[str, Tensor]] = {}
        obs_dim = {OBS_AGENT_POS: 2, OBS_AGENT_ONEHOT: self.n_states, OBS_STATE_INDEX: 1,
                   OBS_GRID: 3 * self.n_states, OBS_AGENT_GOAL_POS: 4}[observation_type]
        self.spec = EnvSpec(obs_dim=obs_dim, action_dim=1, discrete_actions=True, n_actions=5,
                            physics_dim=4, goal_dim=obs_dim, episode_length=max_episode_length)

    def _on(self, device: torch.device) -> tp.Dict[str, Tensor]:
        """The constants on ``device``, placed once: a captured step copies
        nothing from the host."""
        if device not in self._consts:
            def put(x: np.ndarray) -> Tensor:
                return torch.from_numpy(np.ascontiguousarray(x)).to(device)

            self._consts[device] = {
                "layout": put(self.layout.reshape(-1)),
                "walls": put((self.layout < 0).astype(np.float32).reshape(-1)),
                "deltas": put(_DELTAS), "free": put(self.free_cells),
                "start": put(self.start), "goal": put(self.default_goal),
                "shape": put(np.array(self.shape, np.float32)),
                "cells": torch.arange(self.n_states, device=device)}
        return self._consts[device]

    # -- observations ----------------------------------------------------
    def _index(self, pos: Tensor) -> Tensor:
        return pos[:, 0].long() * self.shape[1] + pos[:, 1].long()

    def _obs_from_pos(self, pos: Tensor, goal: Tensor) -> Tensor:
        c = self._on(pos.device)
        kind = self.observation_type
        if kind == OBS_AGENT_POS:
            return pos.float() / c["shape"]
        if kind == OBS_AGENT_GOAL_POS:
            return torch.cat([pos, goal], -1).float()
        idx = self._index(pos)
        if kind == OBS_STATE_INDEX:
            return idx.float()[:, None]
        agent = (idx[:, None] == c["cells"]).float()
        if kind == OBS_AGENT_ONEHOT:
            return agent
        goal_ch = (self._index(goal)[:, None] == c["cells"]).float()
        walls = c["walls"].expand_as(agent)
        return torch.stack([walls, agent, goal_ch], -1).reshape(pos.shape[0], -1)

    def get_obs(self, state: GridState) -> Tensor:
        return self._obs_from_pos(state.pos, state.goal)

    def get_goal_obs(self, state: GridState) -> Tensor:
        """[E, obs_dim]: the observation the agent would see standing on the
        goal cell."""
        return self._obs_from_pos(state.goal, state.goal)

    @staticmethod
    def _physics(state: GridState) -> Tensor:
        return torch.cat([state.pos, state.goal], -1).float()

    def render(self, state: GridState, index: int = 0, cell_px: int = 24) -> np.ndarray:
        """RGB frame of environment ``index``: walls dark, start outlined,
        goal green, agent orange. Host-side, for visualization only."""
        h, w = self.shape
        img = np.full((h, w, 3), 255, np.uint8)
        img[self.layout < 0] = (40, 40, 40)  # walls
        sy, sx = (int(v) for v in self.start)
        img[sy, sx] = (180, 200, 255)  # start cell
        gy, gx = (int(v) for v in state.goal[index].cpu())
        img[gy, gx] = (60, 180, 75)  # goal
        ay, ax = (int(v) for v in state.pos[index].cpu())
        img[ay, ax] = (235, 137, 33)  # agent
        img = np.repeat(np.repeat(img, cell_px, axis=0), cell_px, axis=1)
        img[::cell_px, :] = 200  # thin grid lines
        img[:, ::cell_px] = 200
        return img

    # -- dynamics --------------------------------------------------------
    def reset(self, generator: torch.Generator, num_envs: int
              ) -> tp.Tuple[GridState, TimeStep]:
        """Every episode at the start cell; ``simple`` draws each goal
        uniformly over the free cells other than the start."""
        c = self._on(generator.device)
        if self.randomize_goals:
            i = torch.randint(len(self.free_cells), (num_envs,), generator=generator,
                              device=generator.device)
            goal = c["free"][i]
        else:
            goal = c["goal"].expand(num_envs, 2)
        return self.reset_with_goals(goal)

    def reset_with_goals(self, goal: Tensor) -> tp.Tuple[GridState, TimeStep]:
        """``reset`` with the goals [E, 2] handed in."""
        n = goal.shape[0]
        goal = goal.to(torch.int32).contiguous()
        state = GridState(pos=self._on(goal.device)["start"].expand(n, 2).clone(), goal=goal,
                          t=torch.zeros(n, dtype=torch.int32, device=goal.device))
        zeros = torch.zeros(n, device=goal.device)
        ts = TimeStep(step_type=torch.full_like(state.t, StepType.FIRST), reward=zeros,
                      discount=torch.ones_like(zeros), observation=self.get_obs(state),
                      action=zeros[:, None], physics=self._physics(state))
        return state, ts

    def step(self, state: GridState, action: Tensor) -> tp.Tuple[GridState, TimeStep]:
        c = self._on(state.pos.device)
        # out-of-range indices clamp, as JAX's gather clamps them
        a = action.reshape(state.pos.shape[0]).to(torch.int64).clamp(0, len(_DELTAS) - 1)
        new_pos = state.pos + c["deltas"][a]
        hit_wall = c["layout"][self._index(new_pos)] == -1
        on_goal = (new_pos == state.goal).all(-1) & ~hit_wall
        pos = torch.where(hit_wall[:, None], state.pos, new_pos)
        reward = torch.where(hit_wall, self.penalty_for_walls,
                             torch.where(on_goal, self.reward_goal, 0.0)).float()
        t = state.t + 1
        new_state = GridState(pos=pos, goal=state.goal, t=t)
        ts = TimeStep(
            step_type=torch.where(t >= self.max_episode_length, StepType.LAST,
                                  StepType.MID).to(torch.int32),
            reward=reward, discount=torch.full_like(reward, self.discount),
            observation=self.get_obs(new_state), action=a.float()[:, None],
            physics=self._physics(new_state))
        return new_state, ts


def build_gridworld_task(task: str = "simple", discount: float = 1.0,
                         penalty_for_walls: float = 0.0,
                         observation_type: str = OBS_AGENT_POS,
                         max_episode_length: int = 200) -> GridWorld:
    """The gridworld of ``task`` (``simple``, ``obstacle`` or ``random_goal``)."""
    if task not in TASKS:
        raise ValueError(f"Unknown gridworld task {task!r}; known: {sorted(TASKS)}")
    spec = TASKS[task]
    return GridWorld(layout=spec["layout"], start=spec["start"], goal=spec["goal"],
                     observation_type=observation_type, discount=discount,
                     penalty_for_walls=penalty_for_walls,
                     max_episode_length=max_episode_length,
                     randomize_goals=spec["randomize_goals"])
