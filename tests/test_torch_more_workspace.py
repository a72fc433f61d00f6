"""The entry points with APS, NEWAPS, SMM, Proto, UVF, GoalTD3 and GoalSM.

``pretrain`` for each at small width (the four explorers on
``walker_walk``, the three goal agents on the point-mass maze with the
20-goal ``maze_multi_goal`` battery), resumed from its folder;
``train_offline`` for NEWAPS (the final battery through its least-squares
z) and GoalTD3; ``load_model=`` of folders that the JAX package's
``train/checkpoint.py`` wrote for APS, Proto (its candidate queue included)
and UVF, whose policies must give JAX's actions at rtol 1e-4.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents import registry as jax_registry
from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch import pretrain, train_offline
from controllable_agent_torch.agents import AGENTS, NOT_PORTED

SMALL = ["device=cpu", "episode_length=10", "num_envs=2", "replay_buffer_episodes=8",
         "agent.hidden_dim=32", "agent.batch_size=16", "num_seed_frames=20",
         "use_console=false", "save_eval_video=false"]
WALKER = ["task=walker_walk", "eval_every_steps=60", "num_eval_episodes=2"]
MAZE = ["task=point_mass_maze_reach_top_left", "goal_space=simplified_point_mass_maze",
        "custom_reward=maze_multi_goal", "eval_every_steps=0"]
EXPLORERS = ("aps", "new_aps", "smm", "proto")
GOAL_AGENTS = ("uvf", "goal_td3", "goal_sm")
NARROW = {"new_aps": ["agent.backward_hidden_dim=16", "agent.feature_dim=16"],
          "proto": ["agent.pred_dim=8", "agent.proj_dim=16", "agent.num_protos=8",
                    "agent.queue_size=24"],
          "uvf": ["agent.backward_hidden_dim=16", "agent.feature_dim=16", "agent.z_dim=8"]}


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _args(agent: str, folder, frames: int, final_tests: int = 2):
    task = WALKER if agent in EXPLORERS else MAZE
    return [f"agent={agent}", *SMALL, *task, *NARROW.get(agent, []),
            f"num_train_frames={frames}", f"final_tests={final_tests}", f"folder={folder}"]


@pytest.mark.parametrize("agent", EXPLORERS + GOAL_AGENTS)
def test_pretrain_each_agent_and_resume(tmp_path, agent) -> None:
    """A seed cycle and two training cycles: finite train rows, the
    walker's evaluation (the goal agents' maze has no per-step reward, so
    their battery is ``finalize``'s 20-goal sweep), the meta column each
    agent's policy reads in the replay, then a resume for one more cycle."""
    folder = tmp_path / "run"
    ws = pretrain.main(_args(agent, folder, 60))
    rows = _rows(folder / "train.csv")
    assert [int(float(r["step"])) for r in rows] == [20, 40, 60] and ws.agent.step == 20
    assert all(np.isfinite(float(v)) for r in rows for v in r.values() if v != "")
    storage = ws.buffer.state.storage
    if agent in EXPLORERS:
        assert len(_rows(folder / "eval.csv")) == 1
    else:
        evals = _rows(folder / "eval.csv")
        assert len(evals) == 1 and 0.0 <= float(evals[0]["reward"]) <= 1.0
    meta_key = {"aps": "task", "new_aps": "z", "smm": "z", "uvf": "z", "goal_td3": "g",
                "goal_sm": "g"}.get(agent)
    if meta_key is not None:
        column = storage[meta_key][:len(ws.buffer)]
        width = {"task": 10, "z": {"new_aps": 10, "smm": 4, "uvf": 8}.get(agent), "g": 2}
        assert column.shape[-1] == width[meta_key] and bool(torch.isfinite(column).all())
    if agent == "aps":  # the task changes only at steps that are multiples of 5
        task = storage["task"][:len(ws.buffer)]
        where = (task[:, 1:] != task[:, :-1]).any(-1).nonzero()[:, 1]
        assert len(where) and bool((where % 5 == 0).all())
    if agent == "smm":
        z = storage["z"][:len(ws.buffer)]
        assert bool((z.sum(-1) == 1).all())
    if agent == "goal_sm":  # init_meta is zeros, as in JAX
        assert bool((storage["g"][:len(ws.buffer)] == 0).all())
    if agent == "new_aps":
        battery = json.loads((folder / "test_rewards.json").read_text())
        assert len(battery) == 4 and all(np.isfinite(v) for r in battery.values() for v in r)
    if agent in GOAL_AGENTS:
        rewards = json.loads((folder / "test_rewards.json").read_text())["rewards"]
        assert len(rewards) == 1 and 0.0 <= rewards[0] <= 1.0
    if agent == "proto":
        assert int(ws.agent.queue_ptr) == (20 * 8) % 24
    again = pretrain.main(_args(agent, folder, 80, final_tests=0))
    assert again.global_step == 80 and again.agent.step == 30 and len(again.buffer) == 8
    if agent == "proto":
        assert int(again.agent.queue_ptr) == (30 * 8) % 24


@pytest.mark.parametrize("agent", ["new_aps", "goal_td3"])
def test_train_offline_on_a_pretrain_replay(tmp_path, agent) -> None:
    """``train_offline`` on the replay of a ``pretrain`` run: NEWAPS on the
    walker, relabeled for ``walker_run``, with the final battery through its
    least-squares z; GoalTD3 on the maze with the 20-goal sweep."""
    pretrain.main(_args(agent, tmp_path / "online", 40, final_tests=0))
    task = ["task=walker_run", "eval_every_steps=5", "num_eval_episodes=2"] \
        if agent == "new_aps" else MAZE
    ws = train_offline.main([f"agent={agent}", *SMALL, *task, *NARROW.get(agent, []),
                             f"load_replay={tmp_path}/online/models/latest",
                             "num_grad_steps=10", "steps_per_call=5", "log_every_steps=5",
                             "final_tests=2", f"folder={tmp_path}/offline"])
    assert ws.global_step == 10 and ws.agent.step == 10  # the replay alone was loaded
    assert all(np.isfinite(v) for v in ws.last_row.values())
    out = tmp_path / "offline"
    if agent == "new_aps":
        assert len(_rows(out / "eval.csv")) == 2
        z = ws.inferred_z
        assert z.shape == (10,) and float(z.norm()) == pytest.approx(1.0, rel=1e-5)
        assert (out / "test_rewards.json").exists()
    else:
        assert 0.0 <= float(_rows(out / "eval.csv")[-1]["reward"]) <= 1.0


JAX_ARGS = {"aps": ["task=walker_walk", "agent.sf_dim=5"],
            "proto": ["task=walker_walk", *NARROW["proto"]],
            "uvf": ["task=point_mass_maze_reach_top_left",
                    "goal_space=simplified_point_mass_maze", *NARROW["uvf"]]}


@pytest.mark.parametrize("agent", sorted(JAX_ARGS))
def test_a_jax_folder_loads_into_the_port(tmp_path, agent) -> None:
    """``load_model=`` of a checkpoint folder that the JAX package wrote:
    the counters, every network (Proto's queue and pointer too), and the
    evaluation policy's actions on the same observations and meta."""
    args = [f"agent={agent}", *JAX_ARGS[agent], "episode_length=10", "use_console=false",
            "agent.hidden_dim=32", "agent.batch_size=16", "final_tests=0"]
    jws = jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    if agent == "proto":  # a queue and pointer as an update would leave them
        params = dict(jws.agent_state.module_params)
        params["queue"] = jax.random.normal(jax.random.key(1), params["queue"].shape)
        params["queue_ptr"] = jnp.asarray(5, jnp.int32)
        jws.agent_state = jws.agent_state.replace(module_params=params)
    jws.global_step, jws.global_episode = 60, 6
    jws.save_checkpoint(tmp_path / "jax_ckpt")
    tws = pretrain.build_workspace(args + ["device=cpu", f"load_model={tmp_path}/jax_ckpt",
                                           f"folder={tmp_path}/torch"])
    assert tws.global_step == 60 and tws.global_episode == 6
    rng = np.random.RandomState(0)
    obs = rng.randn(8, tws.spec.obs_dim).astype(np.float32)
    meta = {k: np.asarray(v) for k, v in jws.agent.init_meta(jws.agent_state,
                                                            jax.random.key(2)).items()}
    meta = {k: np.broadcast_to(v, (8,) + v.shape).copy() for k, v in meta.items()}
    want = jws.agent.policy_act(jws.agent_state, jnp.asarray(obs),
                                {k: jnp.asarray(v) for k, v in meta.items()}, jnp.asarray(0),
                                jax.random.key(3), eval_mode=True)
    got = tws.agent.policy_act(torch.from_numpy(obs),
                               {k: torch.from_numpy(v) for k, v in meta.items()}, 0,
                               eval_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    if agent == "proto":
        np.testing.assert_array_equal(tws.agent.queue.numpy(),
                                      np.asarray(jws.agent_state.module_params["queue"]))
        assert int(tws.agent.queue_ptr) == 5
    if agent == "uvf":
        goal = np.array([0.1, -0.2], np.float32)
        np.testing.assert_allclose(
            tws.agent.get_goal_meta(torch.from_numpy(goal)).numpy(),
            np.asarray(jws.agent.get_goal_meta(jws.agent_state, jnp.asarray(goal))),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("agent", sorted(AGENTS))
def test_every_agent_of_the_registry_builds_a_workspace(tmp_path, agent) -> None:
    """The port's registry is the JAX one, and ``pretrain`` builds a
    workspace for each of its agents (the discrete ones on the grid)."""
    assert sorted(AGENTS) == sorted(jax_registry.AGENTS) and NOT_PORTED == ()
    task = "grid_simple" if getattr(AGENTS[agent][1], "takes_n_actions", False) \
        else "walker_walk"
    ws = pretrain.build_workspace([f"agent={agent}", f"task={task}", "device=cpu",
                                   "agent.hidden_dim=32", "use_console=false",
                                   f"folder={tmp_path}"])
    assert ws.agent.cfg.name == agent and ws.agent.device.type == "cpu"
