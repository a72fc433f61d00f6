"""The port's dm_control bridge (``controllable_agent_torch/tools/mujoco_bridge.py``)
against the root ``tools/mujoco_bridge.py``, and the port's engines against
dm_control on shared suite states (``tools/gen_parity_report.py``'s
comparisons, at ``tests/test_mujoco_parity.py``'s tolerances: atol 2e-4 on
x/z/up; corr > 0.98 and mean |err| < 0.15 on vx/vz; corr > 0.98 on am;
rewards mean |err| < 0.05 and corr > 0.95; the quadruped's features at atol
2e-4 and its suite rewards as that file's, mean |err| < 1e-4 and corr >
0.99). Cases that need the reference's custom task XMLs skip one by one."""

import numpy as np
import pytest

pytest.importorskip("dm_control")

import torch  # noqa: E402

from controllable_agent_torch.data import exorl  # noqa: E402
from controllable_agent_torch.envs import locomotion  # noqa: E402
from controllable_agent_torch.tools import gen_parity_report as parity  # noqa: E402
from controllable_agent_torch.tools import mujoco_bridge as bridge  # noqa: E402
from tools import mujoco_bridge as root_bridge  # noqa: E402

CPU = torch.device("cpu")
SUITE_FEATURES = {"walker_walk": "walker_features", "cheetah_run": "cheetah_features",
                  "hopper_stand": "hopper_features", "quadruped_walk": "quadruped_features"}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _needs(name: str) -> None:
    if not parity.runnable(name):
        pytest.skip(f"{name} is a custom task of the reference, whose XMLs are not in "
                    f"{bridge.custom_tasks_dir()}")


@pytest.mark.parametrize("name", sorted(SUITE_FEATURES))
def test_bridge_equals_the_root_bridge_to_the_bit(name) -> None:
    """make_env, collect_rollout with the domain's feature reads, mj_state and
    reward_from_state: the same values as the root bridge's on the same env
    and seed."""
    fn = SUITE_FEATURES[name]
    ours_env, root_env = bridge.make_env(name, seed=12), root_bridge.make_env(name, seed=12)
    ours = bridge.collect_rollout(ours_env, 60, seed=0, feature_fn=getattr(bridge, fn))
    want = root_bridge.collect_rollout(root_env, 60, seed=0,
                                       feature_fn=getattr(root_bridge, fn))
    assert set(ours) == set(want) == {"physics", "reward", "features"}
    for key in want:
        assert ours[key].dtype == want[key].dtype
        np.testing.assert_array_equal(ours[key], want[key], key)
    np.testing.assert_array_equal(bridge.mj_state(ours_env), root_bridge.mj_state(root_env))
    for state in want["physics"][::7]:
        assert bridge.reward_from_state(ours_env, state) == \
            root_bridge.reward_from_state(root_env, state)


def test_predicates_and_a_custom_task_without_its_xmls(tmp_path, monkeypatch) -> None:
    """The suite needs dm_control alone; a custom task without the
    reference's XMLs raises, naming the directory it looked in."""
    monkeypatch.setenv("CONTROLLABLE_AGENT_REFERENCE", str(tmp_path / "reference"))
    assert bridge.dm_control_available()
    assert not bridge.custom_tasks_available()
    assert bridge.custom_tasks_dir() == tmp_path / "reference" / "url_benchmark" / \
        "custom_dmc_tasks"
    assert bridge.is_suite_task("walker_run") and not bridge.is_suite_task("walker_flip")
    assert bridge.split_name("point_mass_maze_reach_top_left") == ("point_mass_maze",
                                                                   "reach_top_left")
    assert bridge.make_env("hopper_hop", seed=2).action_spec().shape == (4,)
    with pytest.raises(FileNotFoundError, match=str(bridge.custom_tasks_dir())):
        bridge.make_env("walker_flip")


@pytest.mark.parametrize("domain", ["walker", "cheetah", "hopper"])
def test_feature_parity(domain) -> None:
    """The port's goal features on adapted states track the reference's
    named physics reads on a shared random rollout."""
    name = f"{domain}_{parity.FEATURE_TASKS[domain]}"
    roll = bridge.collect_rollout(bridge.make_env(name, seed=12), 150, seed=0,
                                  feature_fn=getattr(bridge, f"{domain}_features"))
    ours, ref = parity.native_features(domain, roll["physics"], CPU), roll["features"]
    np.testing.assert_allclose(ours[:, :3], ref[:, :3], atol=2e-4)
    for col in (3, 4):
        corr = np.corrcoef(ours[:, col], ref[:, col])[0, 1]
        assert corr > 0.98, f"{domain} col {col} corr {corr}"
        assert np.abs(ours[:, col] - ref[:, col]).mean() < 0.15
    corr = np.corrcoef(ours[:, 5], ref[:, 5])[0, 1]
    assert corr > 0.98, f"{domain} am corr {corr}"


@pytest.mark.parametrize("name", [
    "walker_stand", "walker_walk", "walker_run", "walker_flip", "cheetah_walk", "cheetah_run",
    "cheetah_walk_backward", "cheetah_flip", "hopper_stand", "hopper_hop"])
def test_reward_parity(name) -> None:
    """The port's reward functions on adapted states reproduce the
    reference's physics-replay relabel."""
    _needs(name)
    src = bridge.make_env(name, seed=3)
    roll = bridge.collect_rollout(src, 120, seed=1)
    ref = np.array([bridge.reward_from_state(src, s) for s in roll["physics"]])
    ours = parity.native_rewards(name, roll["physics"], CPU)
    err = np.abs(ours - ref)
    assert err.mean() < 0.05, f"{name} mean|err| {err.mean():.4f}"
    if ref.std() > 1e-3:
        corr = np.corrcoef(ours, ref)[0, 1]
        assert corr > 0.95, f"{name} corr {corr:.4f}"


def test_point_mass_maze_reward_parity() -> None:
    """The maze's reach reward against the reference's maze task (with zero
    control, as the replay path has)."""
    _needs("point_mass_maze_reach_top_left")
    env = bridge.make_env("point_mass_maze_reach_top_left", seed=2)
    roll = bridge.collect_rollout(env, 150, seed=4)
    ref = np.array([bridge.reward_from_state(env, s) for s in roll["physics"]])
    ours = parity.native_rewards("point_mass_maze_reach_top_left", roll["physics"], CPU)
    assert np.abs(ours - ref).mean() < 0.02


def test_walker_obs_recompute_on_mujoco_states() -> None:
    """The port's observation recomputed from adapted dm_control states
    agrees with dm_control's own in every convention-free component: the
    cos entries of the orientations, the torso height and the joint
    velocities (the sin entries and the root rate are mirrored by design)."""
    env = bridge.make_env("walker_stand", seed=3)
    roll = bridge.collect_rollout(env, 60, seed=3)
    mj_obs = []
    for s in roll["physics"]:
        p = env.physics
        full = np.zeros(p.get_state().shape)
        full[:s.shape[0]] = s
        with p.reset_context():
            p.set_state(full)
        orient = p.named.data.xmat[1:, ["xx", "xz"]].ravel()
        mj_obs.append(np.concatenate([orient, [p.named.data.xpos["torso", "z"]],
                                      p.velocity()]))
    mj_obs = np.asarray(mj_obs)
    adapted = exorl.PHYSICS_ADAPTERS["mujoco_walker"](roll["physics"].astype(np.float32))
    ours = locomotion.make("walker_stand").obs_from_physics(torch.from_numpy(adapted)).numpy()
    cos_idx = list(range(0, 14, 2))
    np.testing.assert_allclose(ours[:, cos_idx], mj_obs[:, cos_idx], atol=2e-3)
    np.testing.assert_allclose(ours[:, 14], mj_obs[:, 14], atol=2e-3)
    np.testing.assert_allclose(ours[:, 18:], mj_obs[:, 18:], atol=2e-3)


def test_quadruped_feature_parity() -> None:
    """``data/exorl.py:mujoco_quadruped_features`` reproduces the reference's
    torso reads (up, x, y, z and the body-frame velocity) on a shared
    rollout; the COM height against the root z is reported, not held: the
    offset is the layout's by design."""
    env = bridge.make_env("quadruped_walk", seed=12)
    roll = bridge.collect_rollout(env, 120, seed=0, feature_fn=bridge.quadruped_features)
    ours = exorl.mujoco_quadruped_features(roll["physics"])
    ref = roll["features"]
    for name, col in zip(parity.QUAD_FEAT_NAMES, parity.QUAD_FEAT_COLS):
        np.testing.assert_allclose(ours[:, col], ref[:, col], atol=2e-4, err_msg=name)
    print(f"quadruped com_z against root z: mean |diff| "
          f"{np.abs(ref[:, 1] - ours[:, 4]).mean():.5f}")


@pytest.mark.parametrize("task", parity.QUAD_REWARD_TASKS)
def test_quadruped_reward_parity(task) -> None:
    """The port's quadruped rewards from the adapted features against the
    reference's relabel: walk and run are the suite's tasks; the rest are the
    reference's custom model and skip without it."""
    _needs(f"quadruped_{task}")
    states = parity.quadruped_states(120)
    env = bridge.make_env(f"quadruped_{task}", seed=3)
    ref = np.array([bridge.reward_from_state(env, s) for s in states])
    ours = parity.native_rewards(f"quadruped_{task}", states, CPU)
    err = np.abs(ours - ref)
    tol = 0.03 if task == "jump" else 1e-4
    assert err.mean() < tol, f"quadruped_{task} mean|err| {err.mean():.4f}"
    if ref.std() > 1e-3:
        assert np.corrcoef(ours, ref)[0, 1] > 0.99


def test_parity_report(tmp_path) -> None:
    """The report: every feature row, each suite reward row within the
    tolerances above, each custom row marked as not run."""
    out = tmp_path / "PARITY_TORCH.md"
    text = parity.main(["--device", "cpu", "--out", str(out)])
    assert out.read_text() == text
    table = {}
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if line.startswith("| ") and len(cells) == 6 and cells[0] not in ("domain", "task"):
            # a feature row is keyed by (domain, feature), a reward row by its task
            table[cells[0] if "_" in cells[0] else (cells[0], cells[1])] = cells
    for domain in parity.FEATURE_DOMAINS:
        for name in ("x", "z", "up"):
            assert float(table[(domain, name)][3]) <= 2e-4
        for name in ("vx", "vz"):
            assert float(table[(domain, name)][2]) < 0.15
            assert float(table[(domain, name)][5]) > 0.98
        assert float(table[(domain, "am")][5]) > 0.98
    for name in parity.QUAD_FEAT_NAMES:
        assert float(table[("quadruped", name)][3]) <= 2e-4
    names = [f"{d}_{t}" for d, t in parity.REWARD_TASKS] + [
        f"quadruped_{t}" for t in parity.QUAD_REWARD_TASKS]
    for name in names:
        row = table[name]
        if not parity.runnable(name):
            assert row[1] == parity.NOT_RUN
            continue
        assert float(row[1]) < 0.05 and (row[5] == "n/a" or float(row[5]) > 0.95), row
