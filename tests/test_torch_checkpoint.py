"""The port's checkpoints (``train/checkpoint.py`` and the workspace's
save/load/resume): round trips, ``only``/``exclude``, and the staging rules
of the JAX module (``<name>.tmp`` then rename; only a stale ``.tmp`` is
removed on load)."""

import os
import time

import numpy as np
import pytest
import torch

from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import synthetic_episodes
from controllable_agent_torch.train import checkpoint as ckpt
from controllable_agent_torch.train.workspace import OfflineWorkspace, WorkspaceConfig
from torch_threads import one_thread  # noqa: F401

OBS, ACT = 4, 2  # the default task's environment, the point-mass maze
SMALL = dict(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8, batch_size=16)
SMALL_ARGS = [f"{k}={v}" for k, v in SMALL.items()]


def _agent(seed: int = 0) -> FBDDPGAgent:
    return FBDDPGAgent(FBDDPGConfig(**SMALL), OBS, ACT, device="cpu", seed=seed)


def _buffer(n: int = 3, length: int = 20) -> ReplayBuffer:
    buf = ReplayBuffer(n + 1, discount=0.98, future=0.99, device="cpu")
    buf.load_episodes(synthetic_episodes(n, length, OBS, ACT, seed=1))
    return buf


def _trained(steps: int = 2):
    agent, buf = _agent(), _buffer()
    gen = torch.Generator().manual_seed(3)
    for _ in range(steps):
        agent.update(buf.sample(gen, 16), gen)
    return agent, buf, gen


def _workspace(folder, **overrides) -> OfflineWorkspace:
    fields = dict(folder=str(folder), device="cpu", eval_every_steps=0, final_tests=0,
                  checkpoint_every=0, replay_buffer_episodes=4, steps_per_call=2,
                  log_every_steps=2, use_console=False)
    cfg = WorkspaceConfig(**{**fields, **overrides})
    return OfflineWorkspace(cfg, agent_cfg_overrides=SMALL_ARGS)


def test_train_state_names_every_tensor_an_update_changes() -> None:
    agent, buf, gen = _trained(0)
    before = {k: v.clone() for k, v in agent.train_state().items()}
    agent.update(buf.sample(gen, 16), gen)
    changed = {k for k, v in agent.train_state().items() if not torch.equal(v, before[k])}
    assert {"step_t", "fw_opt.count", "actor_opt.count", "bw_opt.count"} <= changed
    nets = ("actor.", "forward_net.", "backward_net.", "target_forward_net.",
            "target_backward_net.")
    moments = ("fw_opt.mu.", "fw_opt.nu.", "bw_opt.mu.", "actor_opt.nu.")
    for prefix in nets + moments:
        assert any(k.startswith(prefix) for k in changed), prefix
    assert int(agent.train_state()["step_t"]) == agent.step == 1


def test_round_trip(tmp_path) -> None:
    agent, buf, gen = _trained()
    state = dict(agent.train_state(), generator=gen.get_state())
    ckpt.save_checkpoint(tmp_path / "latest", {"agent": state, "replay": buf.state,
                                               "global_step": 40, "global_episode": 2})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["latest"]  # no .tmp left
    out = ckpt.load_checkpoint(tmp_path / "latest")
    assert out["global_step"] == 40 and out["global_episode"] == 2
    fresh = _agent(seed=9)
    loaded = dict(out["agent"])
    gen2 = torch.Generator()
    gen2.set_state(loaded.pop("generator"))
    fresh.load_train_state(loaded)
    for k, v in agent.train_state().items():
        assert torch.equal(fresh.train_state()[k], v), k
        assert fresh.train_state()[k].dtype == v.dtype, k
    assert fresh.step == 2 and fresh.fw_opt.count == 2
    replay = out["replay"]
    assert (replay.n_episodes, replay.idx, replay.max_episodes, replay.max_episode_length) == (
        3, 3, 4, 20)
    assert torch.equal(replay.ep_lengths, buf.state.ep_lengths)
    for k, v in buf.state.storage.items():
        assert torch.equal(replay.storage[k], v), k
    # the next update is the same bits on both sides
    batch = buf.sample(gen, 16)
    clone = torch.Generator()
    clone.set_state(gen.get_state())
    m1, m2 = agent.update(batch, gen), fresh.update(batch, clone)
    assert float(m1["fb_loss"]) == float(m2["fb_loss"])
    for k, v in agent.train_state().items():
        assert torch.equal(fresh.train_state()[k], v), k


def test_load_train_state_rejects_another_agent() -> None:
    agent = _agent()
    state = dict(agent.train_state())
    with pytest.raises(ValueError, match="missing"):
        agent.load_train_state({k: v for k, v in state.items() if k != "step_t"})
    wide = FBDDPGAgent(FBDDPGConfig(**{**SMALL, "z_dim": 4}), OBS, ACT, device="cpu")
    with pytest.raises(ValueError, match="saved shape"):
        wide.load_train_state(state)


@pytest.mark.parametrize("kwargs,want", [
    (dict(only=["replay"]), {"replay"}),
    (dict(only=["agent"]), {"agent"}),
    (dict(exclude=["replay"]), {"agent"}),
    (dict(), {"agent", "replay"}),
    (dict(only=["agent", "replay"], exclude=["agent"]), {"replay"}),
], ids=["only_replay", "only_agent", "exclude_replay", "all", "only_and_exclude"])
def test_only_and_exclude_on_load(tmp_path, kwargs, want) -> None:
    agent, buf, gen = _trained(1)
    ckpt.save_checkpoint(tmp_path / "c", {"agent": agent.train_state(), "replay": buf.state,
                                          "global_step": 7, "global_episode": 1})
    out = ckpt.load_checkpoint(tmp_path / "c", **kwargs)
    assert set(out) == want | {"global_step", "global_episode"}
    assert out["global_step"] == 7


def test_exclude_on_save_and_missing_replay(tmp_path) -> None:
    agent, buf, _ = _trained(1)
    payload = {"agent": agent.train_state(), "replay": buf.state, "global_step": 1}
    ckpt.save_checkpoint(tmp_path / "a", payload, exclude=["replay"])
    assert not (tmp_path / "a" / "replay.pt").exists()
    assert set(ckpt.load_checkpoint(tmp_path / "a")) == {"agent", "global_step", "global_episode"}
    ckpt.save_checkpoint(tmp_path / "b", {**payload, "replay": None})
    assert "replay" not in ckpt.load_checkpoint(tmp_path / "b")
    # a second save over an existing checkpoint replaces it
    ckpt.save_checkpoint(tmp_path / "a", {**payload, "global_step": 5})
    assert ckpt.load_checkpoint(tmp_path / "a")["global_step"] == 5
    assert "replay" in ckpt.load_checkpoint(tmp_path / "a")


@pytest.mark.parametrize("age,kept", [(10, True), (ckpt.STALE_TMP_SECONDS + 60, False)],
                         ids=["fresh_tmp_kept", "stale_tmp_removed"])
def test_tmp_left_by_another_save(tmp_path, age, kept) -> None:
    """A ``.tmp`` beside the checkpoint is a live writer's unless it is older
    than 900 s: only then does a load remove it."""
    agent, _, _ = _trained(0)
    ckpt.save_checkpoint(tmp_path / "latest", {"agent": agent.train_state(), "global_step": 3})
    orphan = tmp_path / "latest.tmp"
    orphan.mkdir()
    (orphan / "agent.pt").write_bytes(b"half written")
    then = time.time() - age
    os.utime(orphan, (then, then))
    assert ckpt.load_checkpoint(tmp_path / "latest")["global_step"] == 3
    assert orphan.exists() is kept
    # the next save stages over whatever is there
    ckpt.save_checkpoint(tmp_path / "latest", {"agent": agent.train_state(), "global_step": 4})
    assert not orphan.exists()
    assert ckpt.load_checkpoint(tmp_path / "latest")["global_step"] == 4


def test_workspace_saves_snapshots_and_resumes(tmp_path) -> None:
    """train() saves periodic, milestone and final checkpoints; a second
    workspace on the folder resumes at the saved step with the same agent,
    replay and generator, and continues from there."""
    ws = _workspace(tmp_path / "run", num_grad_steps=6, checkpoint_every=4, snapshot_at=(3, 100))
    ws.buffer.load_episodes(synthetic_episodes(3, 20, OBS, ACT, seed=1))
    ws.train()
    models = tmp_path / "run" / "models"
    assert sorted(p.name for p in models.iterdir()) == ["latest", "snapshot_3"]
    assert ckpt.load_checkpoint(models / "snapshot_3", only=[])["global_step"] == 4
    assert ckpt.load_checkpoint(models / "latest", only=[])["global_step"] == 6

    again = _workspace(tmp_path / "run", num_grad_steps=10)
    assert again.global_step == 6 and again.agent.step == 6 and len(again.buffer) == 3
    for k, v in ws.agent.train_state().items():
        assert torch.equal(again.agent.train_state()[k], v), k
    assert torch.equal(again.generator.get_state(), ws.generator.get_state())
    # both continue with the same bits
    ws.cfg = again.cfg
    row_a, row_b = ws.train(), again.train()
    assert again.global_step == 10 and again.agent.step == 10
    assert row_a["fb_loss"] == row_b["fb_loss"] and row_b["step"] == 10


def test_load_model_warm_starts_without_the_replay(tmp_path) -> None:
    ws = _workspace(tmp_path / "a", num_grad_steps=2)
    ws.buffer.load_episodes(synthetic_episodes(3, 20, OBS, ACT, seed=1))
    ws.train()
    warm = _workspace(tmp_path / "b", load_model=str(tmp_path / "a" / "models" / "latest"))
    assert warm.global_step == 2 and len(warm.buffer) == 0
    for k, v in ws.agent.train_state().items():
        assert torch.equal(warm.agent.train_state()[k], v), k
    np.testing.assert_array_equal(warm.generator.get_state().numpy(),
                                  ws.generator.get_state().numpy())


def test_generator_state_of_another_device_type_raises(tmp_path) -> None:
    """A generator state of another kind (a CUDA generator's is 16 bytes, a
    CPU generator's thousands) cannot continue the run's random sequence:
    the load raises instead of training on from a reseeded generator."""
    ws = _workspace(tmp_path / "a", num_grad_steps=2)
    ws.buffer.load_episodes(synthetic_episodes(3, 20, OBS, ACT, seed=1))
    ws.train()
    latest = tmp_path / "a" / "models" / "latest"
    state = torch.load(latest / "agent.pt", weights_only=True)
    state["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(state, latest / "agent.pt")
    with pytest.raises(ValueError, match="another device type"):
        _workspace(tmp_path / "b", load_model=str(latest))
    # without the agent nothing of the generator is read
    fresh = _workspace(tmp_path / "c")
    fresh.load_checkpoint(latest, only=["replay"])
    assert len(fresh.buffer) == 3
