"""Custom reward functions for zero-shot evaluation (mirror of
``controllable_agent_tpu/goals/rewards.py``).

Seeded ``BaseReward`` with ``from_physics``, the named-task factory
``get_reward_function``, MazeMultiGoal's 20-goal battery, the WalkerEquation
user-equation reward (its tokenizer whitelist guards a public demo against
code injection) and WalkerRandomReward.

``from_physics`` is batched and stays on its input's device: it maps a
``[..., physics_dim]`` tensor to ``[...]`` rewards, so relabeling a whole
buffer is one pass where the buffer lives. ``QuadrupedReward`` and
``QuadrupedPosReward`` draw the numpy random numbers of the JAX package's in
the same order, so one seed gives the same case and targets.
"""

from __future__ import annotations

import functools
import io
import token
import tokenize
import typing as tp

import numpy as np
import torch

from ..ops.tolerance import tolerance
from . import spaces as _spaces  # noqa: F401  (populates the registries)
from .registry import goal_spaces

Tensor = torch.Tensor

# feature layouts per domain (see goals/spaces.py docstring)
WALKER_FEATURES = ("x", "z", "up", "vx", "vz", "am")


def get_goal_space_dim(name: str) -> int:
    """Dim lookup without instantiating envs: probe the registered space fn
    with a dummy feature vector."""
    domain, fn = goal_spaces.lookup(name)
    # quadruped probe is 11: base features (8) + ball columns the fetch
    # env appends for the quadruped_positions space
    probe_dim = {"point_mass_maze": 4, "walker": 6, "quadruped": 11,
                 "grid": 4, "jaco": 3}[domain]
    return int(fn(torch.zeros(probe_dim)).numel())


class BaseReward:
    """Seeded custom reward."""

    def __init__(self, seed: tp.Optional[int] = None) -> None:
        self._rng = np.random.RandomState(seed)

    def get_goal(self, goal_space: str) -> np.ndarray:
        raise NotImplementedError

    def from_physics(self, physics: Tensor) -> Tensor:
        """Batched: [..., physics_dim] -> [...]."""
        raise NotImplementedError

    def __call__(self, physics: Tensor) -> Tensor:
        return self.from_physics(physics)


class PointMassReachReward(BaseReward):
    """Native point-mass-maze reach reward. At relabel time the stored
    control is unknown, so the small-control factor is 1."""

    def __init__(self, task: str, seed: tp.Optional[int] = None) -> None:
        super().__init__(seed)
        from ..envs.pointmass import TASKS
        self.task = task
        self.target = np.asarray(TASKS[task])

    def get_goal(self, goal_space: str) -> np.ndarray:
        if goal_space != "simplified_point_mass_maze":
            raise ValueError(f"Goal space {goal_space} not supported")
        return self.target.astype(np.float32)

    def from_physics(self, physics: Tensor) -> Tensor:
        pos = torch.as_tensor(physics)[..., :2]
        target_size = 0.015
        target = torch.as_tensor(self.target, dtype=pos.dtype, device=pos.device)
        dist = torch.linalg.vector_norm(pos - target, dim=-1)
        return tolerance(dist, bounds=(0.0, target_size), margin=target_size)


class MazeMultiGoal(BaseReward):
    """20 goals in the 4 maze rooms + tolerance reward + distance."""

    def __init__(self, seed: tp.Optional[int] = None) -> None:
        super().__init__(seed)
        self.goals = np.array([
            [-0.15, 0.15], [-0.22, 0.22], [-0.08, 0.08], [-0.22, 0.08], [-0.08, 0.22],
            [0.15, 0.15], [0.22, 0.22], [0.08, 0.08], [0.22, 0.08], [0.08, 0.22],
            [-0.15, -0.15], [-0.22, -0.22], [-0.08, -0.08], [-0.22, -0.08], [-0.08, -0.22],
            [0.15, -0.15], [0.22, -0.22], [0.08, -0.08], [0.22, -0.08], [0.08, -0.22],
        ], dtype=np.float32)

    def from_goal(self, achieved_goal: Tensor, desired_goal: Tensor
                  ) -> tp.Tuple[Tensor, Tensor]:
        """returns (reward, distance); batched over leading dims."""
        target_size = 0.03
        achieved = torch.as_tensor(achieved_goal)
        d = achieved - torch.as_tensor(desired_goal).to(achieved.device)
        distance = torch.linalg.vector_norm(d, dim=-1)
        reward = tolerance(distance, bounds=(0.0, target_size), margin=target_size)
        return reward, distance


@functools.cache
def _quadruped_env() -> tp.Any:
    from ..envs import quadruped  # deferred: the reward zoo imports without the environments
    return quadruped.make("quadruped_stand")


def _quad_features(physics: Tensor) -> Tensor:
    """[up, 0, x, y, z, vx, vy, vz] of quadruped physics, batched."""
    return _quadruped_env().goal_features(torch.as_tensor(physics))


def _inv(distance: Tensor) -> Tensor:
    return 1.0 / (1.0 + torch.abs(distance))


class QuadrupedReward(BaseReward):
    """One of 7 random mixed rewards over the quadruped's position, speed
    and quadrant, drawn by the seed, on the feature layout [up, 0, x, y, z,
    vx, vy, vz]."""

    NUM_CASES = 7

    def __init__(self, seed: tp.Optional[int] = None) -> None:
        super().__init__(seed)
        self.x = self._rng.uniform(-5, 5, size=2)
        self.vx = self._rng.uniform(-3, 3, size=2)
        self.quadrant = self._rng.choice([1, -1], size=2, replace=True)
        self.speed = float(np.linalg.norm(self.vx))
        self._case = self._rng.randint(self.NUM_CASES)

    def from_physics(self, physics: Tensor) -> Tensor:
        feats = _quad_features(physics)

        def const(value: tp.Any) -> Tensor:
            return torch.as_tensor(np.asarray(value, np.float32), device=feats.device)

        up = feats[..., 0].clamp_min(0.0)
        x, vx = feats[..., 2:4], feats[..., 5:7]
        speed = torch.linalg.vector_norm(vx, dim=-1)
        in_quadrant = (x * const(self.quadrant) > const(self.x)).all(-1).float()
        case = self._case
        if case == 0:
            return up * _inv(speed - self.speed)
        if case == 1:
            return up * _inv(torch.linalg.vector_norm(x - const(self.x), dim=-1))
        if case == 2:
            return up * in_quadrant
        if case == 3:
            return up * in_quadrant * _inv(self.speed - speed)
        if case == 4:
            return up * _inv(torch.linalg.vector_norm(const(self.vx) - vx, dim=-1)
                             / float(np.sqrt(2)))
        if case == 5:
            return up * in_quadrant * (speed > self.speed).float()
        return up * (speed > self.speed).float()


class QuadrupedPosReward(BaseReward):
    """A fixed position to reach, upright."""

    def __init__(self, seed: tp.Optional[int] = None) -> None:
        super().__init__(seed)
        self.x = np.array([2.0, 2.0, 0.8], np.float32)

    def get_goal(self, goal_space: str) -> np.ndarray:
        if goal_space != "quad_pos_speed":
            raise ValueError(
                f"Goal space {goal_space} not supported with this reward")
        return np.concatenate([[1.0], self.x, [0.0] * 3]).astype(np.float32)

    def from_physics(self, physics: Tensor) -> Tensor:
        feats = _quad_features(physics)
        up = (feats[..., 0] + 1.0) / 2.0
        target = torch.as_tensor(self.x, device=feats.device)
        dist = torch.linalg.vector_norm(feats[..., 2:5] - target, dim=-1)
        return 0.5 * up + 0.5 / (1.0 + torch.abs(dist))


class WalkerPosReward(BaseReward):
    """Random positional reward: tolerance(|x - X|, r=1) with a random
    integer target X in [-20, 20) drawn from the seeded rng."""

    def __init__(self, seed: tp.Optional[int] = None) -> None:
        super().__init__(seed)
        self.x = int(self._rng.randint(-20, 20))

    def get_goal(self, goal_space: str) -> np.ndarray:
        if goal_space != "walker_pos_speed_z":
            raise ValueError(
                f"Goal space {goal_space} not supported with this reward")
        # [z, up, vx, x, vz, am]
        return np.array([1, 1, 0, self.x, 0, 0], dtype=np.float32)

    def from_physics(self, physics: Tensor) -> Tensor:
        feats = _walker_features_fn(torch.as_tensor(physics))
        d = torch.abs(feats[..., 0] - self.x)  # feature 0 = torso x
        return tolerance(d, (0.0, 1.0), margin=1.0)


class EquationReward(BaseReward):
    """User-supplied Python expression over named physics features,
    tokenizer-whitelisted then eval'd. Generic over the feature layout."""

    _FUNCS = ("sin", "cos", "tan", "abs", "exp", "sqrt")

    def __init__(self, string: str, feature_names: tp.Sequence[str],
                 features_fn: tp.Callable[[Tensor], Tensor],
                 seed: tp.Optional[int] = None) -> None:
        super().__init__(seed)
        self.feature_names = tuple(feature_names)
        self._features_fn = features_fn
        allowed = set(self.feature_names) | set(self._FUNCS)
        not_allowed = extract_names(string) - allowed
        if not_allowed:
            # safety measure: guards the public demo against injection
            raise ValueError(
                f"The following variables are not allowed: {not_allowed}\n"
                f"Please only use {sorted(allowed)}")
        self.string = string

    def _eval(self, feats: Tensor) -> Tensor:
        variables: tp.Dict[str, tp.Any] = {
            name: feats[..., i] for i, name in enumerate(self.feature_names)}
        for name in self._FUNCS:
            variables[name] = getattr(torch, name)
        out = eval(self.string, {"__builtins__": {}}, variables)  # pylint: disable=eval-used
        ones = torch.ones(feats.shape[:-1], dtype=torch.float32, device=feats.device)
        return torch.as_tensor(out, dtype=torch.float32).to(feats.device) * ones

    def from_physics(self, physics: Tensor) -> Tensor:
        return self._eval(self._features_fn(torch.as_tensor(physics)))

    def from_features(self, feats: Tensor) -> Tensor:
        return self._eval(torch.as_tensor(feats))


@functools.cache
def _walker_env() -> tp.Any:
    from ..envs import locomotion  # deferred: the equation machinery imports without it
    return locomotion.make("walker_stand")


def _walker_features_fn(physics: Tensor) -> Tensor:
    return _walker_env().goal_features(physics)


class WalkerEquation(EquationReward):
    """Variables x, z, vx, vz, up, am over the walker physics."""

    def __init__(self, string: str, seed: tp.Optional[int] = None) -> None:
        super().__init__(string, WALKER_FEATURES, _walker_features_fn, seed)


class WalkerRandomReward(WalkerEquation):
    """Weighted random eval equations."""

    def __init__(self, seed: tp.Optional[int] = None) -> None:
        rng = np.random.RandomState(seed)
        x = rng.uniform(3, 15)
        nx = rng.uniform(3, 8)
        cases = [
            (f"exp(-(x-{x:.1f})**2)", 5),
            (f"exp(-(x-{x:.1f})**2) * up", 5),
            (f"exp(-(x+{nx:.1f})**2)", 2),
            ("vx > 1", 1),
            ("vx > 3", 1),
            ("vx < -1", 1),
        ]
        p = np.array([float(c[1]) for c in cases])
        p /= p.sum()
        selected = cases[rng.choice(range(p.size), p=p)][0]
        super().__init__(selected)
        self._rng = rng


def extract_names(string: str) -> tp.Set[str]:
    """All NAME tokens in an expression."""
    rl = io.BytesIO(string.encode("utf-8")).readline
    tokens = list(tokenize.tokenize(rl))
    return {t.string for t in tokens if t.type == token.NAME}


def get_reward_function(name: str, seed: tp.Optional[int] = None) -> BaseReward:
    """String -> reward factory."""
    if name == "maze_multi_goal":
        return MazeMultiGoal(seed)
    if name == "quadruped_mix":
        return QuadrupedReward(seed)
    if name == "quadruped_position":
        return QuadrupedPosReward(seed)
    if name.startswith("walker_yoga_"):
        from .yoga import WalkerYogaReward
        return WalkerYogaReward(name[len("walker_yoga_"):], seed)
    if name == "walker_random_equation":
        return WalkerRandomReward(seed)
    if name == "walker_position":
        return WalkerPosReward(seed)
    if name.startswith("point_mass_maze_"):
        return PointMassReachReward(name[len("point_mass_maze_"):], seed)
    if (name.startswith("walker_") or name.startswith("quadruped_")
            or name.startswith("jaco_") or name.startswith("cheetah_")
            or name.startswith("hopper_")):
        # native env task rewards; resolved lazily
        from ..envs import dmc_tasks
        return dmc_tasks.make_task_reward(name, seed)
    raise ValueError(f"Unknown reward function {name!r}")
