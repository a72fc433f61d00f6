"""Bridge to the real dm_control/MuJoCo stack (the port's copy of the root
``tools/mujoco_bridge.py``, which it does not import).

The port's environments run on its own engines (``envs/physics2d.py``,
``envs/physics3d.py``). This module drives dm_control's environments, the
suite's tasks and, where a checkout of the reference repository
(facebookresearch/controllable_agent) is at hand, its custom task XMLs, and
exposes:

  * matched-state collection (MuJoCo [qpos, qvel] rows from rollouts),
  * the reference's named goal features (the physics reads behind
    url_benchmark/goals.py:66-112),
  * physics-replay reward relabeling (the semantics of
    url_benchmark/in_memory_replay_buffer.py:40-55),

so that the port's evaluator, collector and parity report can hold its
engines to MuJoCo on the same states. The physics runs on the host, in
numpy and MuJoCo; nothing here imports torch.

Two predicates say what can run: ``dm_control_available()`` for the suite,
``custom_tasks_available()`` for the reference's XMLs, looked for under
``$CONTROLLABLE_AGENT_REFERENCE/url_benchmark/custom_dmc_tasks`` (the
reference checked out at ``~/reference`` when the variable is unset).
"""

from __future__ import annotations

import importlib.util
import os
import sys
import typing as tp
from pathlib import Path

import numpy as np


def reference_root() -> Path:
    """Where the reference repository is looked for."""
    return Path(os.environ.get("CONTROLLABLE_AGENT_REFERENCE",
                               Path.home() / "reference")).expanduser()


def custom_tasks_dir() -> Path:
    return reference_root() / "url_benchmark" / "custom_dmc_tasks"


def dm_control_available() -> bool:
    """True when dm_control (and with it MuJoCo) can be imported."""
    return importlib.util.find_spec("dm_control") is not None


def custom_tasks_available() -> bool:
    """True when the reference's custom task XMLs are at hand as well."""
    return dm_control_available() and custom_tasks_dir().is_dir()


def split_name(name: str) -> tp.Tuple[str, str]:
    """'walker_flip' -> ('walker', 'flip'); the maze's domain has underscores."""
    if name.startswith("point_mass_maze"):
        return "point_mass_maze", name[len("point_mass_maze_"):]
    domain, task = name.split("_", 1)
    return domain, task


def is_suite_task(name: str) -> bool:
    """True when dm_control's own suite has the task (no reference needed)."""
    from dm_control import suite
    return split_name(name) in suite.ALL_TASKS


def _cdmc() -> tp.Any:
    if not custom_tasks_available():
        raise FileNotFoundError(
            f"the reference's custom task XMLs are not in {custom_tasks_dir()}: point "
            f"CONTROLLABLE_AGENT_REFERENCE at a checkout of facebookresearch/controllable_agent")
    root = str(reference_root())
    if root not in sys.path:
        sys.path.insert(0, root)
    from url_benchmark import custom_dmc_tasks  # type: ignore
    return custom_dmc_tasks


def make_env(name: str, seed: int = 1) -> tp.Any:
    """The dm_control environment of e.g. 'walker_walk': the suite's task
    where it has one, the reference's custom task XML otherwise (the
    dispatch of url_benchmark/dmc.py:353-385)."""
    from dm_control import suite
    domain, task = split_name(name)
    if (domain, task) in suite.ALL_TASKS:
        return suite.load(domain, task, task_kwargs={"random": seed})
    return _cdmc().make(domain, task, task_kwargs={"random": seed})


def mj_state(env: tp.Any) -> np.ndarray:
    """[qpos, qvel] row: the layout ExORL buffers store per step."""
    p = env.physics
    return np.concatenate([p.data.qpos, p.data.qvel]).astype(np.float64)


def reward_from_state(env: tp.Any, state: np.ndarray) -> float:
    """Physics-replay reward: the relabel semantics of the reference buffer
    (in_memory_replay_buffer.py:44-48: reset_context + set_state +
    task.get_reward)."""
    p = env.physics
    full = np.zeros(p.get_state().shape)
    full[:state.shape[0]] = state
    with p.reset_context():
        p.set_state(full)
    return float(env.task.get_reward(p))


def walker_features(env: tp.Any) -> np.ndarray:
    """[x, z, up, vx, vz, am]: the named physics reads behind the
    reference's walker goal spaces (goals.py:66-94): torso xpos, height and
    upright, torso subtree_linvel x/z, torso subtree_angmom y."""
    p = env.physics
    d = p.named.data
    return np.array([
        d.xpos["torso", "x"],
        d.xpos["torso", "z"],
        p.torso_upright(),
        d.subtree_linvel["torso", "x"],
        d.subtree_linvel["torso", "z"],
        d.subtree_angmom["torso", "y"],
    ], dtype=np.float64)


def cheetah_features(env: tp.Any) -> np.ndarray:
    """The same layout for the cheetah: its reward reads the torso's subtree
    linvel x and the flip tasks its subtree_angmom y
    (custom_dmc_tasks/cheetah.py)."""
    p = env.physics
    d = p.named.data
    return np.array([
        d.xpos["torso", "x"],
        d.xpos["torso", "z"],
        float(np.cos(d.qpos["rooty"].item())),
        d.subtree_linvel["torso", "x"],
        d.subtree_linvel["torso", "z"],
        d.subtree_angmom["torso", "y"],
    ], dtype=np.float64)


hopper_features = cheetah_features  # the same named reads (hopper.py rewards)


def quadruped_features(env: tp.Any) -> np.ndarray:
    """[up, com_z, x, y, z, vx, vy, vz]: the reference's quadruped reads,
    torso_upright, com_height, torso xpos and torso_velocity
    (custom_dmc_tasks/quadruped.py:222-231, goals.py:97-112). Entries 2:8
    line up with the native layout (``envs/quadruped.py:quad_features``);
    index 1 carries the COM height that the jump reward reads, where the
    native layout keeps the root z (the parity report gives the offset)."""
    p = env.physics
    d = p.named.data
    return np.array([
        float(p.torso_upright()),
        # the whole robot's COM height, the custom Physics' com_height read;
        # subtree_com works on both the suite's and the custom models
        float(d.subtree_com["torso", "z"]),
        d.xpos["torso", "x"],
        d.xpos["torso", "y"],
        d.xpos["torso", "z"],
        *p.torso_velocity(),
    ], dtype=np.float64)


def collect_rollout(env: tp.Any, n_steps: int, seed: int = 0,
                    feature_fn: tp.Optional[tp.Callable[[tp.Any], np.ndarray]] = None,
                    ) -> tp.Dict[str, np.ndarray]:
    """Random-action rollout: per-step MuJoCo states, rewards and (with
    ``feature_fn``) reference goal features, all read at the post-step state
    as the reference's wrappers see them."""
    rng = np.random.RandomState(seed)
    spec = env.action_spec()
    env.reset()
    states, rewards, feats = [], [], []
    for _ in range(n_steps):
        action = rng.uniform(spec.minimum, spec.maximum, spec.shape)
        ts = env.step(action)
        states.append(mj_state(env))
        rewards.append(0.0 if ts.reward is None else float(ts.reward))
        if feature_fn is not None:
            feats.append(feature_fn(env))
        if ts.last():
            env.reset()
    out = {"physics": np.array(states), "reward": np.array(rewards)}
    if feature_fn is not None:
        out["features"] = np.array(feats)
    return out
