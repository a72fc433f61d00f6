"""The entry points on pixels and with the explorers, on the CPU at small
widths: ``pretrain obs_type=pixels`` for DDPG on the walker and the
point-mass maze (the replay stays uint8, evaluation, resume), ``load_model=``
of a JAX pixel DDPG folder, ``agent=fb_ddpg obs_type=pixels`` against the
JAX workspace's agent on the same weights and batch (FB takes the frames as
flat columns; tolerances of ``tests/test_torch_fb_ddpg.py``), the
``ValueError`` of an agent that has no pixel path, and ``pretrain`` with each
explorer (DIAYN's skill in the replay, one-hot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch import pretrain
from controllable_agent_torch.agents import NOT_PORTED
from controllable_agent_torch.convert import flax_to_state_dict, load_train_state
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.pretrain import build_workspace

import test_torch_fb_ddpg
from test_torch_fb_ddpg import SMALL as FB_SMALL

FRAMES = 84 * 84 * 9
PIXELS = ["obs_type=pixels", "episode_length=10", "num_envs=2", "replay_buffer_episodes=8",
          "agent.hidden_dim=32", "agent.batch_size=8", "use_console=false"]
EXPLORERS = ("diayn", "icm", "icm_apt", "disagreement", "max_ent")


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread in these tests: the suite runs in several
    processes at once, and an OpenMP pool of every core in each of them
    spins against the others (the pixel pretrain runs took 80x their time
    alone with it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pretrain(folder, *extra: str):
    return pretrain.main(["agent=ddpg", "device=cpu", *PIXELS, "num_seed_frames=20",
                          "eval_every_steps=40", "num_eval_episodes=2", "final_tests=2",
                          f"folder={folder}", *extra])


@pytest.mark.parametrize("task", ["walker_walk", "point_mass_maze_reach_top_left"])
def test_pixel_pretrain_evaluates_and_resumes(tmp_path, task) -> None:
    """Three cycles of 2 x 10 steps: uint8 frames in the collector and the
    replay, an evaluation (no per-step frames kept), updates after the seed
    frames, the video from the physics; then the same command with more
    frames continues the saved run."""
    ws = _pretrain(tmp_path, f"task={task}", "num_train_frames=60")
    storage = ws.buffer.state.storage["observation"]
    assert storage.dtype == torch.uint8 and storage.shape[-1] == FRAMES
    assert ws.agent.encoder is not None and ws.agent.step == 20 and len(ws.buffer) == 6
    assert ws.spec.obs_shape == (84, 84, 9)
    rows = (tmp_path / "eval.csv").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(v) for v in ws.last_row.values())
    assert (tmp_path / "eval_video" / "40.png").stat().st_size > 0
    assert ws.finalize() == {}  # DDPG infers no z: no battery
    resumed = _pretrain(tmp_path, f"task={task}", "num_train_frames=80")
    assert resumed.global_step == 80 and resumed.agent.step == 30 and len(resumed.buffer) == 8
    assert resumed.buffer.state.storage["observation"].dtype == torch.uint8


def test_a_jax_pixel_ddpg_folder_loads_into_the_port(tmp_path) -> None:
    """``load_model=`` of a JAX ``agent=ddpg obs_type=pixels`` folder: the
    encoder and its Adam state come across with the actor and critics."""
    args = ["agent=ddpg", "task=walker_walk", *PIXELS]
    jws = jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    jws.global_step = 20
    jws.save_checkpoint(tmp_path / "jax_ckpt")
    tws = build_workspace(args + ["device=cpu", f"load_model={tmp_path}/jax_ckpt",
                                  f"folder={tmp_path}/torch"])
    assert tws.global_step == 20
    state = jws.agent_state
    for module, tree in ((tws.agent.encoder, state.encoder_params),
                         (tws.agent.actor, state.actor_params),
                         (tws.agent.target_critic, state.target_critic_params)):
        want = flax_to_state_dict(tree)
        assert all(torch.equal(v, want[k]) for k, v in module.state_dict().items())
    assert tws.agent.encoder.Conv_0.weight.shape == (32, 9, 3, 3)
    assert tws.agent.actor.mlps[0].Dense_0.weight.shape[1] == 39200


def test_fb_on_pixels_matches_the_jax_workspace(tmp_path, monkeypatch) -> None:
    """``agent=fb_ddpg obs_type=pixels``: both workspaces build FB on the
    63,504 flat uint8 columns (its ``obs_type`` is read by nothing), and one
    update on the same weights, batch and draws agrees."""
    fb = [f"agent.{k}={v}" for k, v in FB_SMALL.items()]
    args = ["agent=fb_ddpg", "task=walker_walk", "obs_type=pixels", "episode_length=10",
            "use_console=false", *fb]
    jws = jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    tws = build_workspace(args + ["device=cpu", f"folder={tmp_path}/torch"])
    assert tws.agent.obs_dim == jws.agent.obs_dim == FRAMES
    assert tws.agent_cfg.obs_type == "pixels"
    state = jws.agent_state
    load_train_state(tws.agent, jax.tree.map(np.asarray, state))
    n = FB_SMALL["batch_size"]
    rng = np.random.RandomState(0)
    frames = lambda: (rng.rand(n, FRAMES) * 255).astype(np.uint8)  # noqa: E731
    arrays = dict(obs=frames(), action=rng.uniform(-1, 1, (n, 6)).astype(np.float32),
                  reward=rng.rand(n, 1).astype(np.float32), next_obs=frames(),
                  discount=np.full((n, 1), 0.98, np.float32), future_obs=frames())
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tbatch = EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    key = jax.random.key(1)
    new_state, want = jax.jit(jws.agent._update)(state, jbatch, key)
    monkeypatch.setattr(test_torch_fb_ddpg, "ACT", 6)  # the walker's actions
    got = tws.agent._update(tbatch, test_torch_fb_ddpg.jax_update_noise(jws.agent.cfg, key))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    lr = jws.agent.cfg.lr
    for module, tree in ((tws.agent.forward_net, new_state.forward_params),
                         (tws.agent.backward_net, new_state.backward_params),
                         (tws.agent.actor, new_state.actor_params)):
        want_params = flax_to_state_dict(tree)
        for name, value in module.state_dict().items():
            assert float((value - want_params[name]).abs().max()) <= 2 * lr + 1e-6, name


@pytest.mark.parametrize("agent", ["rnd", "icm"])
def test_an_agent_without_pixels_raises_as_jax(tmp_path, agent) -> None:
    """The intrinsic agents build their DDPG without the frames' shape, so
    both packages raise the same ``ValueError``."""
    args = [f"agent={agent}", "task=walker_walk", "obs_type=pixels", "use_console=false",
            "agent.hidden_dim=32"]
    with pytest.raises(ValueError) as jax_error:
        jax_build_workspace(args + [f"folder={tmp_path}/jax"])
    with pytest.raises(ValueError) as port_error:
        build_workspace(args + ["device=cpu", f"folder={tmp_path}/torch"])
    assert str(port_error.value) == str(jax_error.value)
    assert "obs_shape" in str(port_error.value)


def test_pixels_of_an_unrendered_task_raise(tmp_path) -> None:
    """The JAX package renders no 3-D body: the port raises its ValueError."""
    with pytest.raises(ValueError, match="No pixel renderer"):
        build_workspace(["agent=ddpg", "task=quadruped_walk", "obs_type=pixels", "device=cpu",
                         "use_console=false", f"folder={tmp_path}"])


@pytest.mark.parametrize("agent", EXPLORERS)
def test_pretrain_with_each_explorer(tmp_path, agent) -> None:
    """A seed cycle and two training cycles on the walker's states: finite
    train rows with the agent's metrics, an evaluation, and for DIAYN a
    one-hot skill column in the replay that the collector resampled."""
    assert agent not in NOT_PORTED
    ws = pretrain.main([f"agent={agent}", "device=cpu", "task=walker_walk", "episode_length=10",
                        "num_envs=2", "replay_buffer_episodes=8", "agent.hidden_dim=32",
                        "agent.batch_size=16", "num_train_frames=60", "num_seed_frames=20",
                        "eval_every_steps=60", "num_eval_episodes=2", "final_tests=0",
                        "use_console=false", f"folder={tmp_path}"])
    row = ws.last_row
    assert ws.agent.step == 20 and all(np.isfinite(v) for v in row.values())
    assert row["intr_reward"] == pytest.approx(row["batch_reward"])
    assert len((tmp_path / "eval.csv").read_text().splitlines()) == 2
    if agent == "diayn":
        skill = ws.buffer.state.storage["skill"][:len(ws.buffer)]
        assert skill.shape[-1] == 16 and bool((skill.sum(-1) == 1).all())
        assert np.isfinite(row["diayn_acc"]) and 0.0 <= row["diayn_acc"] <= 1.0
        # resampled at step 0 of each episode (index 1 holds the collector's
        # draw), then held: the episodes are shorter than update_skill_every_step
        assert bool((skill[:, 1:11] == skill[:, 1:2]).all())
