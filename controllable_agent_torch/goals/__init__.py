from .registry import Register, goal_spaces, goals
from .rewards import (
    BaseReward,
    MazeMultiGoal,
    PointMassReachReward,
    WalkerEquation,
    get_goal_space_dim,
    get_reward_function,
)
