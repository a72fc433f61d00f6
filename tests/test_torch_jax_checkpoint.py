"""The port's reader of JAX checkpoints (``train/jax_checkpoint.py``): its own
msgpack decoder against ``flax.serialization.msgpack_restore`` on a checkpoint
written by the JAX ``save_checkpoint`` (with a bfloat16 leaf and a chunked
array), and ``load_model=`` of such a folder into the port's workspace."""

import json
import struct

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.pretrain import build_workspace as jax_build_workspace
from controllable_agent_torch import train_offline
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import save_exorl_episodes
from controllable_agent_torch.envs import locomotion
from controllable_agent_torch.pretrain import build_workspace
from controllable_agent_torch.train import jax_checkpoint
from torch_threads import one_thread  # noqa: F401

SMALL = ["agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
         "agent.z_dim=8", "agent.batch_size=16"]
ARGS = ["agent=fb_ddpg", "task=walker_walk", "episode_length=10", "save_eval_video=false",
        "use_console=false", "final_tests=0", *SMALL]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (key,))
    else:
        yield prefix, tree


def _as_float64(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.double().numpy()
    return np.asarray(leaf).astype(np.float64)


def _assert_same_tree(got, want) -> None:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, leaf in want.items():
        if isinstance(leaf, (np.ndarray, np.generic)) or hasattr(leaf, "dtype"):
            assert isinstance(got[path], torch.Tensor), path
            assert tuple(got[path].shape) == tuple(np.shape(leaf)), path
            assert str(got[path].dtype).split(".")[1] == np.asarray(leaf).dtype.name, path
            np.testing.assert_array_equal(_as_float64(got[path]), _as_float64(leaf), str(path))
        else:
            assert got[path] == leaf, path


@pytest.fixture
def jax_folder(tmp_path):
    """A small JAX FB workspace after one update, saved by the JAX
    ``save_checkpoint``."""
    ws = jax_build_workspace(ARGS + [f"folder={tmp_path}/jax"])
    rng = np.random.RandomState(0)
    ws.buffer.load_episodes([{
        "observation": rng.randn(11, 24).astype(np.float32),
        "action": rng.uniform(-1, 1, (11, 6)).astype(np.float32),
        "reward": rng.rand(11, 1).astype(np.float32),
        "discount": np.ones((11, 1), np.float32)} for _ in range(3)])
    batch = ws.buffer.sample(jax.random.key(0), 16)
    ws.agent_state, _ = ws.agent.update(ws.agent_state, batch, jax.random.key(1))
    ws.global_step, ws.global_episode = 7, 3
    ws.save_checkpoint()
    return ws, tmp_path / "jax" / "models" / "latest"


def test_decoder_matches_flax_on_a_checkpoint(jax_folder) -> None:
    """Every tensor of ``agent.msgpack``, bfloat16 Adam moments included."""
    _, folder = jax_folder
    data = (folder / "agent.msgpack").read_bytes()
    want = flax.serialization.msgpack_restore(data)
    got = jax_checkpoint.restore(data)
    _assert_same_tree(got, want)
    leaves = dict(_leaves(got))
    assert any(t.dtype == torch.bfloat16 for t in leaves.values())  # Adam's first moment
    assert any(t.dtype == torch.int32 and t.ndim == 0 for t in leaves.values())  # counters
    assert len(leaves) > 60


def test_decoder_reads_chunked_arrays_and_scalars(monkeypatch) -> None:
    """flax splits arrays above MAX_CHUNK_SIZE into chunks; here the limit is
    lowered so that small arrays take that form."""
    tree = {"big": np.arange(4000, dtype=np.float32).reshape(40, 100),
            "bf16": jnp.linspace(-2, 2, 600).astype(jnp.bfloat16).reshape(20, 30),
            "small": np.arange(6, dtype=np.int64), "scalar": np.float32(2.5),
            "empty": np.zeros((0, 3), np.float32), "flag": True, "none": None,
            "name": "walker", "count": 12, "negative": -70000, "ratio": 0.25,
            "nested": {"0": np.ones((2, 2), np.float64), "1": {}}}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1000)
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = jax_checkpoint.restore(data)
    _assert_same_tree(got, flax.serialization.msgpack_restore(data))
    assert got["big"].shape == (40, 100) and got["bf16"].dtype == torch.bfloat16
    assert got["scalar"].item() == 2.5 and got["count"] == 12 and got["negative"] == -70000
    assert got["none"] is None and got["flag"] is True and got["name"] == "walker"
    got["big"][0, 0] = 1.0  # the tensors are writable copies


@pytest.mark.parametrize("data,message", [
    (b"\x81\xa1a", "ends inside"),
    (b"\x01\x02", "bytes left"),
    (b"\xc1", "not one that flax writes"),
    (b"\xd4\x07\x00", "extension type 7"),
    (b"\xc7" + bytes([len(payload := b"\x93\x91\x02\xa9complex64\xc4\x00")]) + b"\x01" + payload,
     "dtype 'complex64'"),
], ids=["truncated", "trailing", "reserved_byte", "unknown_extension", "unknown_dtype"])
def test_decoder_refuses_what_it_does_not_know(data, message) -> None:
    with pytest.raises(ValueError, match=message):
        jax_checkpoint.restore(data)


def test_decoder_reads_every_integer_and_float_width() -> None:
    cases = [(b"\xcc\xff", 255), (b"\xcd\xff\xff", 65535), (b"\xce" + struct.pack(">I", 2**31), 2**31),
             (b"\xcf" + struct.pack(">Q", 2**40), 2**40), (b"\xd0\x80", -128),
             (b"\xd1" + struct.pack(">h", -300), -300), (b"\xd2" + struct.pack(">i", -70000), -70000),
             (b"\xd3" + struct.pack(">q", -2**40), -2**40), (b"\xca" + struct.pack(">f", 0.5), 0.5),
             (b"\xcb" + struct.pack(">d", 0.1), 0.1), (b"\xe0", -32), (b"\x7f", 127),
             (b"\x92\x01\xa2hi", [1, "hi"]), (b"\xc4\x02ab", b"ab"), (b"\xc2", False)]
    for data, want in cases:
        assert jax_checkpoint.restore(data) == want, data


def test_load_model_takes_a_jax_checkpoint(jax_folder, tmp_path) -> None:
    """``load_model=`` of a JAX folder: the counters, every network, the
    Adam states, and the same policy output for the same observation."""
    jws, folder = jax_folder
    tws = build_workspace(ARGS + ["device=cpu", f"load_model={folder}",
                                  f"folder={tmp_path}/torch"])
    assert tws.global_step == 7 and tws.global_episode == 3 and len(tws.buffer) == 0
    assert tws.agent.step == 1 and tws.agent.fw_opt.count == 1
    rng = np.random.RandomState(1)
    obs = rng.randn(5, 24).astype(np.float32)
    z = rng.randn(5, 8).astype(np.float32)
    want = jws.agent.act(jws.agent_state, jnp.asarray(obs), jnp.asarray(z), jnp.asarray(0),
                         jax.random.key(0), eval_mode=True)
    got = tws.agent.act(torch.from_numpy(obs), torch.from_numpy(z), 0, eval_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # Adam's first moment after the one update: nonzero, and the same largest entry
    mu = dict(_leaves(jax.tree.map(np.asarray, jws.agent_state.fw_opt_state[0].mu)))
    want_mu = max(float(np.abs(v.astype(np.float32)).max()) for v in mu.values())
    got_mu = max(float(v.abs().max()) for v in tws.agent.fw_opt.mu.values())
    assert got_mu == want_mu > 0.0
    # a folder without an agent is refused
    (folder / "meta.json").write_text('{"keys": ["replay"], "global_step": 0, "global_episode": 0}')
    with pytest.raises(ValueError, match="holds no agent"):
        jax_checkpoint.load_agent(folder, tws.agent)


def test_only_and_exclude_hold_for_a_jax_folder(jax_folder, tmp_path) -> None:
    """``load_checkpoint`` of a JAX folder honours ``exclude`` and ``only``:
    an excluded agent is left alone, an excluded replay is not read, and
    ``only=["replay"]`` reads the replay and neither the agent nor the
    counters."""
    _, folder = jax_folder
    tws = build_workspace(ARGS + ["device=cpu", f"folder={tmp_path}/torch"])
    before = {k: v.clone() for k, v in tws.agent.train_state().items()}
    tws.load_checkpoint(folder, exclude=["agent", "replay"])
    tws.load_checkpoint(folder, only=["global_step"])
    assert tws.global_step == 0 and tws.agent.step == 0 and len(tws.buffer) == 0
    assert all(torch.equal(v, before[k]) for k, v in tws.agent.train_state().items())
    tws.load_checkpoint(folder, only=["replay"])
    assert len(tws.buffer) == 3 and tws.global_step == 0 and tws.agent.step == 0
    assert all(torch.equal(v, before[k]) for k, v in tws.agent.train_state().items())
    tws.buffer.state = None
    tws.load_checkpoint(folder, only=["agent", "replay"], exclude=["replay"])
    assert tws.global_step == 7 and tws.agent.step == 1 and len(tws.buffer) == 0


def test_jax_replay_reads_back_to_the_bit_and_trains(jax_folder, tmp_path) -> None:
    """``replay.msgpack`` of a JAX folder as the port's ``ReplayState``: every
    storage array, ``ep_lengths``, ``n_episodes`` and ``idx`` equal to the
    JAX replay's to the bit; then ``train_offline load_replay=`` of the
    folder trains on it (its stored rewards: the episodes have no physics)."""
    jws, folder = jax_folder
    want = jax.tree.map(np.asarray, jws.buffer.state)
    got = jax_checkpoint.load_replay(folder, "cpu")
    assert set(got.storage) == set(want.storage) == {"observation", "action", "reward",
                                                     "discount"}
    for name, values in want.storage.items():
        assert str(got.storage[name].dtype).split(".")[1] == values.dtype.name, name
        np.testing.assert_array_equal(got.storage[name].numpy(), values, name)
    np.testing.assert_array_equal(got.ep_lengths.numpy(), want.ep_lengths)
    assert got.ep_lengths.dtype == torch.int64
    assert (got.n_episodes, got.idx) == (int(want.n_episodes), int(want.idx)) == (3, 3)
    assert (got.max_episodes, got.max_episode_length) == (want.max_episodes,
                                                          want.max_episode_length)
    ws = train_offline.main(ARGS + [
        f"load_replay={folder}", "relabel=false", "device=cpu", "num_grad_steps=4",
        "steps_per_call=2", "log_every_steps=2", "eval_every_steps=0",
        "agent.num_inference_steps=32", f"folder={tmp_path}/offline"])
    assert ws.global_step == 4 and ws.agent.step == 4 and len(ws.buffer) == 3
    for name, values in want.storage.items():
        np.testing.assert_array_equal(ws.buffer.state.storage[name].numpy(), values, name)
    assert all(np.isfinite(v) for v in ws.last_row.values())


def test_cli_scores_a_jax_checkpoint(jax_folder, tmp_path) -> None:
    """The offline CLI with ``load_model=`` of a JAX folder and no updates to
    run: the JAX agent's final test battery, from the port's environments."""
    _, folder = jax_folder
    rng = np.random.RandomState(2)
    env = locomotion.make("walker_walk")
    store = ReplayBuffer(3, discount=0.98, future=0.99, device="cpu")
    episodes = []
    for _ in range(3):
        q = rng.uniform(-1.0, 1.0, (11, 9))
        q[:, 1] = rng.uniform(0.6, 1.5, 11)
        physics = np.concatenate([q, rng.randn(11, 9)], -1).astype(np.float32)
        episodes.append({"observation": env.obs_from_physics(torch.from_numpy(physics)).numpy(),
                         "action": rng.uniform(-1, 1, (11, 6)).astype(np.float32),
                         "reward": np.zeros((11, 1), np.float32),
                         "discount": np.ones((11, 1), np.float32), "physics": physics})
    store.load_episodes(episodes)
    save_exorl_episodes(store.state, tmp_path / "episodes")
    ws = train_offline.main([a for a in ARGS if a != "final_tests=0"] + [
        f"replay_dir={tmp_path}/episodes", f"load_model={folder}", "device=cpu",
        "num_grad_steps=0", "eval_every_steps=0", "final_tests=2", "z_inference_draws=2",
        "agent.num_inference_steps=32", "replay_buffer_episodes=3", f"folder={tmp_path}/score"])
    assert ws.agent.step == 1 and ws.global_step == 7  # as loaded: nothing was trained
    rewards = json.loads((tmp_path / "score" / "test_rewards.json").read_text())
    assert list(rewards) == ["walker_stand", "walker_walk", "walker_run", "walker_flip"]
    assert all(len(v) == 2 and all(np.isfinite(v)) for v in rewards.values())
