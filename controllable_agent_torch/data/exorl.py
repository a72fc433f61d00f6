"""ExORL-format episode files (mirror of ``controllable_agent_tpu/data/exorl.py``).

One ``.npz`` per episode with keys observation, action, reward, discount
(and physics), arrays [T+1, ...]. ``physics_format`` converts foreign
physics layouts (dm_control's MuJoCo states) to the native planar engine's,
so that relabeling and goal extraction work on real ExORL data; the
adapters are numpy, applied per episode on the host while loading.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np

from .replay import ReplayState

def load_episode(fn: Path) -> tp.Dict[str, np.ndarray]:
    with fn.open("rb") as f:
        episode = np.load(f)
        return {k: episode[k].astype(np.float32) for k in episode.keys()}


_MJ_WALKER_TORSO_Z = 1.3  # torso body offset, custom_dmc_tasks/walker.xml:24
_MJ_CHEETAH_TORSO_Z = 0.7  # custom_dmc_tasks/cheetah.xml torso pos
_MJ_HOPPER_TORSO_Z = 1.0  # custom_dmc_tasks/hopper.xml torso pos


def mujoco_walker_physics_to_native(physics: np.ndarray) -> np.ndarray:
    """Map dm_control walker MuJoCo states onto the planar engine's layout.

    Real ExORL walker physics rows are MuJoCo ``[qpos(9), qvel(9)]`` with
    qpos = [rootz, rootx, rooty, r_hip, r_knee, r_ankle, l_hip, l_knee,
    l_ankle] and the torso's 1.3 m body offset baked into the model
    (reference custom_dmc_tasks/walker.xml:24-30). The native engine stores
    q = [x, z, theta, same 6 joints] with absolute torso height:

      x = qpos[rootx]   z = qpos[rootz] + 1.3   theta = -qpos[rooty]

    The root angle is NEGATED: rooty rotates about the +y axis (x tips
    toward -z for positive angle) while the native hinge convention is CCW
    in the x-z plane. The walker's six LEG joints rotate about the -y axis
    (walker.xml jnt_axis "0 -1 0"), which IS the native convention, so
    they pass through unchanged. Verified against dm_control: per-body
    COM positions match xipos to <1e-5 and the COM-velocity/angular-
    momentum goal features correlate >0.998/0.994 with the model's
    subtree_linvel/subtree_angmom on shared rollouts
    (tests/test_mujoco_parity.py).
    """
    q_mj, qd_mj = physics[..., :9], physics[..., 9:18]
    perm = [1, 0] + list(range(2, 9))
    q = q_mj[..., perm].copy()
    q[..., 1] += _MJ_WALKER_TORSO_Z
    q[..., 2] = -q[..., 2]
    qd = qd_mj[..., perm].copy()
    qd[..., 2] = -qd[..., 2]
    return np.concatenate([q, qd], axis=-1).astype(np.float32)


def _planar_all_y_adapter(torso_z: float, ndof: int
                          ) -> tp.Callable[[np.ndarray], np.ndarray]:
    """Adapter for planar MuJoCo models whose hinges are ALL on the +y
    axis (cheetah, hopper): qpos = [rootx, rootz, rooty, joints...] maps
    to native [x, z + torso_z, -rooty, -joints...] — every angular dof is
    negated because native positive rotation (CCW x→z) is the opposite
    physical direction of a +y MuJoCo hinge."""
    def adapt(physics: np.ndarray) -> np.ndarray:
        q_mj, qd_mj = physics[..., :ndof], physics[..., ndof:2 * ndof]
        q = q_mj.copy()
        q[..., 1] += torso_z
        q[..., 2:] = -q[..., 2:]
        qd = qd_mj.copy()
        qd[..., 2:] = -qd[..., 2:]
        return np.concatenate([q, qd], axis=-1).astype(np.float32)
    return adapt


mujoco_cheetah_physics_to_native = _planar_all_y_adapter(_MJ_CHEETAH_TORSO_Z, 9)
mujoco_hopper_physics_to_native = _planar_all_y_adapter(_MJ_HOPPER_TORSO_Z, 7)


PHYSICS_ADAPTERS: tp.Dict[str, tp.Optional[tp.Callable[[np.ndarray], np.ndarray]]] = {
    "native": None,
    "mujoco_walker": mujoco_walker_physics_to_native,
    "mujoco_cheetah": mujoco_cheetah_physics_to_native,
    "mujoco_hopper": mujoco_hopper_physics_to_native,
}


def _quat_rot(quat: np.ndarray) -> np.ndarray:
    """Rotation matrices [..., 3, 3] from MuJoCo wxyz quaternions."""
    q = quat / np.maximum(
        np.linalg.norm(quat, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    rot[..., 0, 0] = 1 - 2 * (y * y + z * z)
    rot[..., 0, 1] = 2 * (x * y - w * z)
    rot[..., 0, 2] = 2 * (x * z + w * y)
    rot[..., 1, 0] = 2 * (x * y + w * z)
    rot[..., 1, 1] = 1 - 2 * (x * x + z * z)
    rot[..., 1, 2] = 2 * (y * z - w * x)
    rot[..., 2, 0] = 2 * (x * z - w * y)
    rot[..., 2, 1] = 2 * (y * z + w * x)
    rot[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return rot


def mujoco_quadruped_features(physics: np.ndarray,
                              nq: int = 23) -> np.ndarray:
    """dm_control quadruped MuJoCo states -> native goal-FEATURE rows.

    The dm_control quadruped (reference custom_dmc_tasks/quadruped.xml:
    4 legs x yaw/pitch/knee/ankle/2 toes, nq=23/nv=22 with a free root)
    is a different morphology from the native 8-joint model, so there is
    no state-level adapter; every reference quadruped goal space and
    task reward is a function of TORSO-level reads only (goals.py:97-112,
    custom_dmc_tasks/quadruped.py:352-536), which map exactly:

      up       = R[2,2] of the root quaternion  (= xmat['torso','zz'])
      x, y, z  = qpos[0:3]                      (= xpos['torso'])
      vx,vy,vz = R^T qvel[0:3]                  (= the torso velocimeter,
                  body-frame; MuJoCo free-joint linear qvel is world-frame)

    Output layout matches ``envs/quadruped.quad_features_single``:
    [up, 0, x, y, z, vx, vy, vz]. The Jump reward's height read is the
    ONE approximation: the reference uses the whole-robot COM height
    (com_height sensor) where the native layout carries the root z;
    PARITY.md quantifies the difference.
    """
    qpos = physics[..., :nq]
    qvel = physics[..., nq:]
    rot = _quat_rot(qpos[..., 3:7])
    up = rot[..., 2, 2]
    v_body = np.einsum("...ij,...i->...j", rot, qvel[..., 0:3])
    zero = np.zeros_like(up)
    return np.stack([up, zero,
                     qpos[..., 0], qpos[..., 1], qpos[..., 2],
                     v_body[..., 0], v_body[..., 1], v_body[..., 2]],
                    axis=-1).astype(np.float32)


# foreign-state -> native goal-feature adapters, for domains whose
# morphologies differ (no state-level adapter possible, so these do NOT
# appear in PHYSICS_ADAPTERS / load_exorl_episodes: a foreign quadruped
# buffer cannot be replayed through the native engine at all — parity
# tools and tests call the feature fn directly on stored MuJoCo states)
FEATURE_ADAPTERS: tp.Dict[str, tp.Callable[[np.ndarray], np.ndarray]] = {
    "mujoco_quadruped": mujoco_quadruped_features,
}


def load_exorl_episodes(replay_dir: Path, limit: tp.Optional[int] = None,
                        shard: int = 0, num_shards: int = 1,
                        physics_format: str = "native",
                        ) -> tp.Iterator[tp.Dict[str, np.ndarray]]:
    """Yield episodes in file-name order. ``limit`` is a global cap applied
    before ``shard``/``num_shards`` round-robin the files. ``physics_format``
    names the adapter applied to each episode's physics (PHYSICS_ADAPTERS)."""
    try:
        adapter = PHYSICS_ADAPTERS[physics_format]
    except KeyError:
        raise ValueError(f"Unknown physics_format {physics_format!r}; "
                         f"known: {sorted(PHYSICS_ADAPTERS)}") from None
    eps_fns = sorted(Path(replay_dir).glob("*.npz"))
    if limit is not None:
        eps_fns = eps_fns[:limit]
    if num_shards > 1:
        eps_fns = eps_fns[shard::num_shards]
    for fn in eps_fns:
        ep = load_episode(fn)
        if adapter is not None and "physics" in ep:
            ep["physics"] = adapter(ep["physics"])
        yield ep


def synthetic_episodes(n_episodes: int, length: int, obs_dim: int,
                       action_dim: int, seed: int = 0
                       ) -> tp.List[tp.Dict[str, np.ndarray]]:
    """Random episodes in the ExORL layout (the JAX bench's synthetic data,
    ``bench.py:42-52``): normal observations, uniform actions in [-1, 1],
    uniform rewards in [0, 1), discount 1."""
    rng = np.random.RandomState(seed)
    t = length + 1
    return [{"observation": rng.randn(t, obs_dim).astype(np.float32),
             "action": rng.uniform(-1, 1, (t, action_dim)).astype(np.float32),
             "reward": rng.rand(t, 1).astype(np.float32),
             "discount": np.ones((t, 1), np.float32)} for _ in range(n_episodes)]


def save_exorl_episodes(replay_state: ReplayState, out_dir: Path) -> int:
    """Write a ReplayState's committed episodes as ExORL-format ``.npz`` files
    (one per episode, padding past each episode's length trimmed). Returns
    the number of episodes written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    storage = {k: v.cpu().numpy() for k, v in replay_state.storage.items()}
    lengths = replay_state.ep_lengths.cpu().numpy()
    n = replay_state.n_episodes
    for i in range(n):
        t = int(lengths[i]) + 1
        np.savez(out_dir / f"episode_{i:06d}_{t - 1}.npz",
                 **{k: v[i, :t] for k, v in storage.items()})
    return n
