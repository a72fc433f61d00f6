"""The port's replay (controllable_agent_torch/data/replay.py, data/exorl.py),
checked on its sampling distribution rather than bit for bit, and against
the JAX package's file format."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from controllable_agent_tpu.data import ReplayBuffer as JaxReplayBuffer
from controllable_agent_tpu.data.exorl import load_exorl_episodes as jax_load_exorl
from controllable_agent_tpu.envs import locomotion as jax_locomotion
from controllable_agent_tpu.goals import get_reward_function as jax_get_reward_function
from controllable_agent_tpu.goals import goal_spaces as jax_goal_spaces
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import (load_exorl_episodes, save_exorl_episodes,
                                                 synthetic_episodes)
from controllable_agent_torch.data.replay import SampleConfig, sample
from controllable_agent_torch.envs import locomotion
from controllable_agent_torch.goals import get_reward_function, goal_spaces
from torch_threads import one_thread  # noqa: F401


def _episode(ep: int, length: int, obs_dim: int = 2):
    """observation[t] = (1000 * ep + t, ...) so a sample names its (ep, t)."""
    t = np.arange(length + 1, dtype=np.float32)
    return {"observation": np.stack([1000 * ep + t] * obs_dim, -1).astype(np.float32),
            "action": (1000 * ep + t)[:, None].astype(np.float32),
            "reward": (t % 3)[:, None].astype(np.float32),
            "discount": np.ones((length + 1, 1), np.float32)}


def _buffer(lengths, future=0.99, max_len=None):
    buf = ReplayBuffer(len(lengths), discount=0.9, future=future,
                       max_episode_length=max_len or max(lengths), device="cpu")
    buf.load_episodes([_episode(i, n) for i, n in enumerate(lengths)])
    return buf


def test_bulk_load_matches_per_episode_adds() -> None:
    lengths = [7, 12, 5]
    bulk = _buffer(lengths)
    ring = ReplayBuffer(3, discount=0.9, future=0.99, max_episode_length=12, device="cpu")
    for i, n in enumerate(lengths):
        ring.add_episode(_episode(i, n))
    assert len(bulk) == len(ring) == 3 and bulk.state.idx == ring.state.idx == 0
    assert torch.equal(bulk.state.ep_lengths, ring.state.ep_lengths)
    for k in bulk.state.storage:
        assert torch.equal(bulk.state.storage[k], ring.state.storage[k]), k


def test_ring_wraps_and_rejects_long_episodes() -> None:
    buf = ReplayBuffer(2, discount=0.9, future=0.99, max_episode_length=10, device="cpu")
    for i in range(3):
        buf.add_episode(_episode(i, 4 + i))
    assert len(buf) == 2 and buf.state.idx == 1
    assert buf.state.ep_lengths.tolist() == [6, 5]
    assert buf.state.storage["observation"][0, 6, 0] == 2006
    assert buf.state.storage["observation"][0, 7, 0] == 0  # old steps zeroed
    with pytest.raises(ValueError, match="sized for"):
        buf.add_episode(_episode(9, 11))


def test_sample_indices_and_alignment() -> None:
    lengths = [10, 30, 60]
    buf = _buffer(lengths)
    batch = buf.sample(torch.Generator().manual_seed(0), 4000)
    ep = (batch.obs[:, 0] // 1000).long()
    step = (batch.next_obs[:, 0] - 1000 * ep).long()
    length = torch.tensor(lengths)[ep]
    assert bool(((step >= 1) & (step <= length)).all())
    assert torch.equal(batch.obs[:, 0], batch.next_obs[:, 0] - 1)
    assert torch.equal(batch.action[:, 0], batch.next_obs[:, 0])  # action[t] leads into obs[t]
    future = (batch.future_obs[:, 0] - 1000 * ep).long() + 1
    assert bool(((future >= step) & (future <= length)).all())
    assert bool((batch.future_obs[:, 0] // 1000 == ep).all())
    torch.testing.assert_close(batch.discount, torch.full_like(batch.discount, 0.9))


def test_episodes_are_drawn_by_length() -> None:
    """P(episode) = length / total: 10 / 100 here; 40000 draws put the
    frequency within 5 binomial sigmas (0.0075) of it."""
    buf = _buffer([10, 90])
    batch = buf.sample(torch.Generator().manual_seed(1), 40000)
    frac = float((batch.obs[:, 0] < 1000).float().mean())
    assert abs(frac - 0.1) < 5 * np.sqrt(0.1 * 0.9 / 40000)


def test_steps_are_uniform_and_future_is_geometric() -> None:
    """Steps uniform in [1, len]; future - step ~ 1 + Geom with success
    1 - future (mean 1 / (1 - future) = 10 far from the episode end)."""
    buf = _buffer([1000], future=0.9)
    batch = buf.sample(torch.Generator().manual_seed(2), 50000)
    step = batch.next_obs[:, 0].long()
    hist = torch.bincount(step, minlength=1001)[1:].float()
    assert int(step.min()) >= 1 and int(step.max()) <= 1000
    assert abs(float(hist.mean()) - 50.0) < 1e-6 and float(hist.std()) < 3 * np.sqrt(50)
    gap = (batch.future_obs[:, 0].long() + 1 - step)[step < 800].float()
    assert int(gap.min()) >= 1
    assert abs(float(gap.mean()) - 10.0) < 0.2  # std of the mean ~ 9.5/sqrt(40000)


def test_future_is_clipped_to_the_episode_end() -> None:
    buf = _buffer([5], future=0.999)
    batch = buf.sample(torch.Generator().manual_seed(3), 2000)
    future = batch.future_obs[:, 0].long() + 1
    assert int(future.max()) == 5 and int(future.min()) >= 1


def test_no_future_when_future_is_one() -> None:
    buf = _buffer([8], future=1.0)
    assert buf.sample(torch.Generator().manual_seed(0), 16).future_obs is None


def test_nstep_returns() -> None:
    """reward = sum_i gamma^i r_{t+i}, discount = gamma^n, next_obs at
    t + n - 1, and the start step leaves room for the window."""
    buf = _buffer([20, 13])
    cfg = SampleConfig(discount=0.9, future=0.99, nstep=3)
    batch = sample(buf.state, torch.Generator().manual_seed(4), 3000, cfg)
    ep = (batch.obs[:, 0] // 1000).long()
    start = (batch.obs[:, 0] - 1000 * ep).long() + 1
    length = torch.tensor([20, 13])[ep]
    assert bool(((start >= 1) & (start <= length - 2)).all())
    torch.testing.assert_close(batch.next_obs[:, 0], batch.obs[:, 0] + 3)
    want = sum(0.9 ** i * ((start + i) % 3).float() for i in range(3))
    torch.testing.assert_close(batch.reward[:, 0], want)
    torch.testing.assert_close(batch.discount, torch.full_like(batch.discount, 0.9 ** 3))


def test_exorl_files_round_trip_and_read_by_the_jax_loader(tmp_path) -> None:
    buf = _buffer([7, 4], max_len=9)
    assert save_exorl_episodes(buf.state, tmp_path) == 2
    ours = list(load_exorl_episodes(tmp_path))
    theirs = list(jax_load_exorl(tmp_path))
    for i, n in enumerate([7, 4]):
        for k, v in _episode(i, n).items():
            np.testing.assert_array_equal(ours[i][k], v)
            np.testing.assert_array_equal(theirs[i][k], v)
    assert len(list(load_exorl_episodes(tmp_path, limit=2, shard=1, num_shards=2))) == 1
    with pytest.raises(ValueError, match="Unknown physics_format"):
        list(load_exorl_episodes(tmp_path, physics_format="mujoco_nope"))
    # an adapter leaves episodes without physics alone
    adapted = list(load_exorl_episodes(tmp_path, physics_format="mujoco_walker"))
    np.testing.assert_array_equal(adapted[0]["observation"], ours[0]["observation"])


def test_bench_buffer_equals_the_jax_bench_buffer() -> None:
    """``synthetic_episodes`` committed into a ``ReplayBuffer(discount=0.98,
    future=0.99)`` equals the replay of the JAX ``bench.py:42-52``, filled
    its way at 4 x 50 steps, to the bit."""
    episodes, length, obs_dim, action_dim = 4, 50, 24, 6
    jbuf = JaxReplayBuffer(max_episodes=episodes, discount=0.98, future=0.99)
    rng = np.random.RandomState(0)
    for _ in range(episodes):
        jbuf.add_episode({
            "observation": rng.randn(length + 1, obs_dim).astype(np.float32),
            "action": rng.uniform(-1, 1, (length + 1, action_dim)).astype(np.float32),
            "reward": rng.rand(length + 1, 1).astype(np.float32),
            "discount": np.ones((length + 1, 1), np.float32),
        })
    buf = ReplayBuffer(episodes, discount=0.98, future=0.99, device="cpu")
    buf.load_episodes(synthetic_episodes(episodes, length, obs_dim, action_dim, 0))
    assert (buf.cfg.discount, buf.cfg.future) == (jbuf.cfg.discount, jbuf.cfg.future)
    assert sorted(buf.state.storage) == sorted(jbuf.state.storage)
    for k, v in buf.state.storage.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbuf.state.storage[k]), err_msg=k)
    np.testing.assert_array_equal(buf.state.ep_lengths.numpy(),
                                  np.asarray(jbuf.state.ep_lengths))


def _physics_buffers(lengths=(9, 6, 12)):
    """The same walker-shaped episodes with physics in a JAX buffer and in
    the port's."""
    rng = np.random.RandomState(5)
    episodes = []
    for i, n in enumerate(lengths):
        q = rng.uniform(-1, 1, (n + 1, 9))
        q[:, 1] = rng.uniform(0.6, 1.5, n + 1)
        episodes.append({**_episode(i, n), "physics": np.concatenate(
            [q, rng.randn(n + 1, 9) * 2], -1).astype(np.float32)})
    jbuf = JaxReplayBuffer(len(lengths), discount=0.9, future=0.99,
                           max_episode_length=max(lengths))
    jbuf.load_episodes(episodes)
    tbuf = ReplayBuffer(len(lengths), discount=0.9, future=0.99,
                        max_episode_length=max(lengths), device="cpu")
    tbuf.load_episodes(episodes)
    return jbuf, tbuf


@pytest.mark.parametrize("task", ["walker_walk", "walker_flip", "walker_yoga_kneel"])
def test_relabel_matches_the_jax_buffer(task) -> None:
    """Every stored reward, padding rows included, after relabeling for the
    task (atol 1e-5, as the reward functions' own tests)."""
    jbuf, tbuf = _physics_buffers()
    before = tbuf.state.storage["reward"]
    jbuf.relabel(jax_get_reward_function(task).from_physics)
    tbuf.relabel(get_reward_function(task).from_physics)
    assert tbuf.state.storage["reward"] is before  # relabeled in place
    np.testing.assert_allclose(before.numpy(), np.asarray(jbuf.state.storage["reward"]),
                               rtol=1e-5, atol=1e-5)
    assert before.shape == (3, 13, 1) and float(before.std()) > 0


@pytest.mark.parametrize("space", ["simplified_walker", "walker_pos_speed", "walker_pos_speed_z"])
def test_set_goals_matches_the_jax_buffer(space) -> None:
    jbuf, tbuf = _physics_buffers()
    jenv, tenv = jax_locomotion.make("walker_walk"), locomotion.make("walker_walk")
    jfn, tfn = jax_goal_spaces.funcs["walker"][space], goal_spaces.funcs["walker"][space]
    jbuf.set_goals(lambda p: jfn(jenv.goal_features(p)))
    tbuf.set_goals(lambda p: tfn(tenv.goal_features(p)))
    np.testing.assert_allclose(tbuf.state.storage["goal"].numpy(),
                               np.asarray(jbuf.state.storage["goal"]), rtol=1e-4, atol=1e-5)
    batch = tbuf.sample(torch.Generator().manual_seed(0), 32)
    assert batch.goal.shape == batch.next_goal.shape == batch.future_goal.shape == (
        32, tbuf.state.storage["goal"].shape[-1])


def test_sample_with_custom_reward_and_physics() -> None:
    """custom_reward replaces the batch's rewards by that function of the
    sampled physics rows, as the JAX buffer's does; physics comes back only
    when asked for."""
    jbuf, tbuf = _physics_buffers()
    reward = get_reward_function("walker_run")
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    plain = tbuf.sample(gen, 64, with_physics=True)
    gen.set_state(state)
    batch = tbuf.sample(gen, 64, custom_reward=reward.from_physics)
    assert batch.physics is None and plain.physics.shape == (64, 18)
    torch.testing.assert_close(batch.reward, reward.from_physics(plain.physics).reshape(-1, 1))
    assert torch.equal(batch.obs, plain.obs) and not torch.equal(batch.reward, plain.reward)
    jbatch = jbuf.sample(jax.random.key(0), 64, with_physics=True)
    jrelabeled = jbuf.sample(jax.random.key(0), 64,
                             custom_reward=jax_get_reward_function("walker_run").from_physics)
    np.testing.assert_allclose(
        np.asarray(jrelabeled.reward),
        reward.from_physics(torch.from_numpy(np.array(jbatch.physics))).reshape(-1, 1).numpy(),
        rtol=1e-5, atol=1e-5)
    assert jrelabeled.physics is None
    assert tbuf.avg_episode_length == jbuf.avg_episode_length == 9
    empty = ReplayBuffer(2, discount=0.9, future=0.99, device="cpu")
    assert empty.avg_episode_length == 0
    with pytest.raises(ValueError, match="no physics"):
        _buffer([4]).relabel(reward.from_physics)


def test_buffer_needs_a_card_unless_asked_for_cpu(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplayBuffer(2, discount=0.9, future=0.99)
