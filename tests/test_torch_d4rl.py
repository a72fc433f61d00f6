"""d4rl in the port against the JAX package: the dataset converter, the
length filter, ``ignore_terminals``, the replay load and the normalized
score on the same seeded dicts (equal arrays); the replay environment's
resets and steps on the same episodes (equal timesteps); and
``train_offline task=d4rl_*`` with its ``normalized_score`` column beside
the JAX run of ``tests/test_d4rl.py`` on the same dict."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu import train_offline as jax_train_offline
from controllable_agent_tpu.data import d4rl as jax_d4rl
from controllable_agent_tpu.data.replay import ReplayBuffer as JaxReplayBuffer
from controllable_agent_tpu.envs.d4rl_replay import D4RLReplayEnv as JaxEnv
from controllable_agent_tpu.envs.d4rl_replay import D4RLReplayState as JaxState
from controllable_agent_torch import train_offline
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data import d4rl
from controllable_agent_torch.envs import benchmark
from controllable_agent_torch.envs.d4rl_replay import D4RLReplayEnv

SMALL = ["agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
         "agent.z_dim=8", "agent.batch_size=16", "agent.num_inference_steps=32"]


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dataset(seed: int = 0, n: int = 200) -> dict:
    """Episodes of random lengths, ended by terminals and timeouts, and a few
    trailing rows of no episode; one 1-row episode."""
    rng = np.random.RandomState(seed)
    ends = np.cumsum(rng.randint(2, 30, size=n))
    ends = ends[ends < n - 3]
    terminals = np.zeros(n, bool)
    timeouts = np.zeros(n, bool)
    kinds = rng.rand(len(ends)) < 0.5
    terminals[ends[kinds]] = True
    timeouts[ends[~kinds]] = True
    timeouts[ends[-1] + 1] = True  # a 1-row episode: no transition
    return {"observations": rng.randn(n, 5).astype(np.float32),
            "actions": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            "rewards": rng.rand(n).astype(np.float32),
            "terminals": terminals, "timeouts": timeouts}


@pytest.mark.parametrize("cfg", [None, dict(ignore_terminals=True),
                                 dict(minimum_episode_length=10),
                                 dict(minimum_episode_length=10, ignore_terminals=True)],
                         ids=["default", "ignore_terminals", "min_length", "both"])
def test_episodes_equal_jax(cfg) -> None:
    ds = _dataset(1)
    got = list(d4rl.d4rl_to_episodes(ds, None if cfg is None else d4rl.D4RLConfig(**cfg)))
    want = list(jax_d4rl.d4rl_to_episodes(
        ds, None if cfg is None else jax_d4rl.D4RLConfig(**cfg)))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("minimum", [None, 1, 5, 12])
def test_length_filter_equals_jax(minimum) -> None:
    ds = _dataset(2)
    got = d4rl.filter_dataset_by_episode_length(dict(ds), minimum)
    want = jax_d4rl.filter_dataset_by_episode_length(dict(ds), minimum)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_into_the_replay_equals_jax() -> None:
    ds = _dataset(3)
    longest = max(e["observation"].shape[0] for e in d4rl.d4rl_to_episodes(ds)) - 1
    got = ReplayBuffer(max_episodes=64, discount=0.99, future=0.99,
                       max_episode_length=longest, device="cpu")
    want = JaxReplayBuffer(max_episodes=64, discount=0.99, future=0.99,
                           max_episode_length=longest)
    assert d4rl.load_d4rl_dataset(got, ds) == jax_d4rl.load_d4rl_dataset(want, ds)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.state.ep_lengths.numpy(),
                                  np.asarray(want.state.ep_lengths))
    for k, v in want.state.storage.items():
        np.testing.assert_array_equal(got.state.storage[k].numpy(), np.asarray(v), err_msg=k)


def test_a_full_ring_keeps_the_last_episodes_as_jax() -> None:
    ds = _dataset(4)
    longest = max(e["observation"].shape[0] for e in d4rl.d4rl_to_episodes(ds)) - 1
    got = ReplayBuffer(max_episodes=4, discount=0.99, future=0.99,
                       max_episode_length=longest, device="cpu")
    want = JaxReplayBuffer(max_episodes=4, discount=0.99, future=0.99,
                           max_episode_length=longest)
    assert d4rl.load_d4rl_dataset(got, ds) == jax_d4rl.load_d4rl_dataset(want, ds)
    # the same four episodes, wherever the ring put them
    order = np.argsort(np.asarray(want.state.ep_lengths), kind="stable")
    mine = np.argsort(got.state.ep_lengths.numpy(), kind="stable")
    for k, v in want.state.storage.items():
        np.testing.assert_array_equal(np.sort(got.state.storage[k].numpy()[mine], 0),
                                      np.sort(np.asarray(v)[order], 0), err_msg=k)


def test_normalized_score_equals_jax() -> None:
    for domain, (lo, hi) in jax_d4rl.REF_SCORES.items():
        assert d4rl.REF_SCORES[domain] == (lo, hi)
        for r in (lo, hi, 0.5 * (lo + hi), 1234.5):
            assert d4rl.normalized_score(domain, r) == jax_d4rl.normalized_score(domain, r)
    assert d4rl.normalized_score("x", 5.0, {"x": (0.0, 10.0)}) == pytest.approx(50.0)
    with pytest.raises(KeyError):
        d4rl.normalized_score("unknown_domain", 1.0)


def test_benchmark_lists_equal_jax() -> None:
    from controllable_agent_tpu.envs import benchmark as jax_benchmark
    for name in ("DOMAINS", "WALKER_TASKS", "CHEETAH_TASKS", "QUADRUPED_TASKS", "JACO_TASKS",
                 "POINT_MASS_MAZE_TASKS", "TASKS", "PRIMAL_TASKS"):
        assert getattr(benchmark, name) == getattr(jax_benchmark, name), name


def test_replay_env_equals_jax() -> None:
    """Resets of three environments onto chosen episodes and a replay of the
    whole horizon: every field of every timestep equals the JAX
    environment's on the same episodes, past each episode's end included."""
    ds = _dataset(5)
    env = D4RLReplayEnv.from_dataset("hopper", ds, device="cpu")
    jenv = JaxEnv.from_dataset("hopper", ds)
    assert env.spec.obs_dim == jenv.spec.obs_dim and env.spec.action_dim == jenv.spec.action_dim
    assert env.spec.physics_dim == 1 and env.spec.episode_length == jenv.spec.episode_length
    episodes = [0, env.num_episodes // 2, env.num_episodes - 1]
    u = (torch.tensor(episodes, dtype=torch.float64) + 0.5) / env.num_episodes
    state, ts = env.reset_from_uniform(u.float())
    assert state.episode.tolist() == episodes
    jstates = [JaxState(episode=jnp.int32(e), t=jnp.int32(0)) for e in episodes]
    jts = [jenv._timestep(s, first=True) for s in jstates]
    step = jax.jit(jenv.step)
    for t in range(env.spec.episode_length + 2):
        for i in range(len(episodes)):
            for field in ("step_type", "reward", "discount", "observation", "action",
                          "physics"):
                np.testing.assert_array_equal(getattr(ts, field)[i].numpy(),
                                              np.asarray(getattr(jts[i], field)),
                                              err_msg=f"{field} at t={t}")
        state, ts = env.step(state, torch.zeros(len(episodes), env.spec.action_dim))
        for i in range(len(episodes)):
            jstates[i], jts[i] = step(jstates[i], jnp.zeros(env.spec.action_dim))
    assert env.get_normalized_score(12.5) == jenv.get_normalized_score(12.5)
    np.testing.assert_allclose(env.episode_returns(torch.tensor(episodes)).numpy(),
                               [float(np.asarray(jenv._rewards[e, 1:, 0]).sum())
                                for e in episodes], rtol=1e-6)


def test_reset_draws_every_episode() -> None:
    env = D4RLReplayEnv.from_dataset("walker2d", _dataset(6), device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(0), 4096)
    assert set(state.episode.tolist()) == set(range(env.num_episodes))


def _offline_dataset(path) -> None:
    """The dict of ``tests/test_d4rl.py:test_offline_run_logs_normalized_score``."""
    rng = np.random.RandomState(1)
    n, T = 124, 30
    timeouts = np.zeros(n, bool)
    timeouts[T - 1::T] = True
    np.savez(path, observations=rng.randn(n, 6).astype(np.float32),
             actions=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
             rewards=rng.rand(n).astype(np.float32), terminals=np.zeros(n, bool),
             timeouts=timeouts)


def _rows(path) -> list:
    with path.open() as f:
        return list(csv.DictReader(f))


def test_train_offline_on_d4rl_beside_jax(tmp_path) -> None:
    """``train_offline task=d4rl_walker2d`` on the CPU: the replay holds the
    dataset's episodes, every evaluation row has ``normalized_score``, which
    is d4rl's score of the returns of the episodes the resets drew; the JAX
    run on the same dict writes the same columns at the same steps."""
    path = tmp_path / "dataset.npz"
    _offline_dataset(path)
    common = ["agent=fb_ddpg", "task=d4rl_walker2d", f"d4rl_dataset={path}",
              "num_grad_steps=6", "eval_every_steps=3", "num_eval_episodes=2",
              "log_every_steps=3", "final_tests=0", "checkpoint_every=100000",
              "save_eval_video=false", "steps_per_call=3", *SMALL]
    ws = train_offline.main([*common, "device=cpu", f"folder={tmp_path}/port"])
    jax_train_offline.main([*common, f"folder={tmp_path}/jax"])
    assert len(ws.buffer) == 4 and ws.buffer.state.max_episode_length == 29
    got, want = _rows(tmp_path / "port" / "eval.csv"), _rows(tmp_path / "jax" / "eval.csv")
    assert [r["frame"] for r in got] == [r["frame"] for r in want] == ["3", "6"]
    assert set(want[0]) <= set(got[0]) and "normalized_score" in got[0]
    for rows in (got, want):
        for r in rows:
            np.testing.assert_allclose(
                float(r["normalized_score"]),
                d4rl.normalized_score("walker2d", float(r["episode_reward"])), rtol=1e-5)
    # the last evaluation's episodes, scored on the host from the dataset
    rollout = ws._rollouts[2]
    returns = ws.env.episode_returns(rollout._state.episode)
    np.testing.assert_allclose(rollout.totals.numpy(), returns.numpy(), rtol=1e-6)
    want_score = np.mean([d4rl.normalized_score("walker2d", r) for r in returns.tolist()])
    np.testing.assert_allclose(float(got[-1]["normalized_score"]), want_score, rtol=1e-6)
