"""UVF, GoalTD3 and GoalSM of the port against the JAX agents.

As in ``tests/test_torch_explorers.py``: the port's agent loads the JAX
train state through ``convert.py``; the update's draws are the JAX update's
own, re-derived from the four keys its ``_update`` splits: UVF's
permutation, mix mask, target policy's and actor's noise (``uvf.py:186``);
GoalTD3's and GoalSM's maze-goal ``randint`` or permutation, future mask,
target policy's and actor's noise (``goal_agents.py:170``, ``:287``).
Metrics at rtol 1e-4 / atol 1e-6, parameters after Adam within 2*lr, the
gradients (read back from Adam's moments after one step) at rtol 1e-3
with an atol of 1e-5 of the tensor's largest |g|; z = B(g) and the maze
reward at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents import goal_agents as jgoal
from controllable_agent_tpu.agents import uvf as juvf
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_torch.agents import (GoalNoise, GoalSMAgent, GoalSMConfig, GoalTD3Agent,
                                             GoalTD3Config, UVFAgent, UVFConfig, UVFNoise)
from controllable_agent_torch.agents.goal_agents import MAZE_GOALS, maze_goal_reward
from controllable_agent_torch.convert import flax_to_state_dict, load_train_state
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.goals.rewards import MazeMultiGoal
from test_torch_ddpg import _close_params

N, OBS, ACT, GOAL = 16, 6, 3, 2
RTOL, ATOL = 1e-4, 1e-6
MAZE = "simplified_point_mass_maze"


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _batch(seed: int, goal_dim: int, meta: dict = ()):
    """Goals near the maze goals (so that the tolerance reward bites),
    next goals partly equal to each other (UVF's indicator)."""
    rng = np.random.RandomState(seed)
    next_goal = (MAZE_GOALS[rng.randint(0, 20, N)] + rng.randn(N, GOAL) * 0.02
                 if goal_dim == GOAL else rng.randn(N, goal_dim))
    next_goal[1] = next_goal[0]
    arrays = dict(obs=rng.randn(N, OBS), action=rng.uniform(-1, 1, (N, ACT)),
                  reward=rng.rand(N, 1), next_obs=rng.randn(N, OBS),
                  discount=np.full((N, 1), 0.98), future_obs=rng.randn(N, OBS),
                  goal=rng.randn(N, goal_dim) * 0.1, next_goal=next_goal,
                  future_goal=MAZE_GOALS[rng.randint(0, 20, N)]
                  + rng.randn(N, GOAL) * 0.01 if goal_dim == GOAL else rng.randn(N, goal_dim))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    meta = dict(meta)
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()},
                     meta={k: jnp.asarray(v) for k, v in meta.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                         meta={k: torch.from_numpy(v) for k, v in meta.items()}))


def _close_metrics(got, want) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _close_grads(opt, adam_state, what: str) -> None:
    adam = adam_state[0]
    assert opt.count == int(adam.count) == 1
    scale = 1.0 / (1.0 - opt.b2)
    for name, nu in flax_to_state_dict(adam.nu).items():
        want = (nu * scale).sqrt().numpy()
        np.testing.assert_allclose((opt.nu[name] * scale).sqrt().numpy(), want, rtol=1e-3,
                                   atol=1e-5 * float(want.max()), err_msg=f"{what} |g| {name}")
    for name, mu in flax_to_state_dict(adam.mu).items():
        want = mu.numpy() / (1.0 - opt.b1)
        np.testing.assert_allclose(opt.mu[name].numpy() / (1.0 - opt.b1), want, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=f"{what} g {name}")


def _pair(jcls, jcfg_cls, tcls, tcfg_cls, goal_dim, **cfg):
    jagent = jcls(jcfg_cls(**cfg), OBS, ACT, goal_dim)
    state = jagent.init(jax.random.key(0))
    agent = tcls(tcfg_cls(**cfg), OBS, ACT, goal_dim=goal_dim, device="cpu")
    load_train_state(agent, jax.tree.map(np.asarray, state))
    return jagent, state, agent


UVF_SMALL = dict(hidden_dim=32, backward_hidden_dim=16, feature_dim=16, z_dim=8, batch_size=N)


def test_maze_goal_reward_matches_jax() -> None:
    rng = np.random.RandomState(0)
    desired = MAZE_GOALS[rng.randint(0, 20, 256)]
    achieved = desired + rng.randn(256, 2).astype(np.float32) * 0.03
    want = np.asarray(jgoal.maze_goal_reward(jnp.asarray(achieved), jnp.asarray(desired)))
    got = maze_goal_reward(torch.from_numpy(achieved), torch.from_numpy(desired)).numpy()
    assert got.shape == want.shape == (256, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert 0.0 < got.min() and got.max() == 1.0
    np.testing.assert_array_equal(MAZE_GOALS, np.asarray(jgoal._MAZE_GOALS))
    np.testing.assert_array_equal(MAZE_GOALS, MazeMultiGoal().goals)


@pytest.mark.parametrize("goal_space", [None, MAZE], ids=["states", "maze_goals"])
def test_uvf_update_matches_jax(goal_space) -> None:
    """z = B(desired) with the permuted, half-mixed next goals; F and B
    stepped on the indicator-reward TD loss; the actor on the new F and B."""
    goal_dim = GOAL if goal_space else OBS
    jagent, state, agent = _pair(juvf.UVFAgent, juvf.UVFConfig, UVFAgent, UVFConfig, goal_dim,
                                 goal_space=goal_space, **UVF_SMALL)
    jbatch, tbatch = _batch(2, goal_dim)
    if goal_space is None:
        jbatch = jbatch.replace(next_obs=jbatch.next_obs.at[1].set(jbatch.next_obs[0]))
        tbatch.next_obs[1] = tbatch.next_obs[0]
    key = jax.random.key(3)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    k_perm, k_mix, k_fb, k_actor = jax.random.split(key, 4)
    noise = UVFNoise(_t(jax.random.permutation(k_perm, N)).long(),
                     _t(jax.random.uniform(k_mix, (N, 1))),
                     _t(jax.random.normal(k_fb, (N, ACT))),
                     _t(jax.random.normal(k_actor, (N, ACT))))
    got = agent._update(tbatch, noise)
    _close_metrics(got, want)
    lr = agent.cfg.lr
    for module, tree, what in (
            (agent.actor, new_state.actor_params, "actor"),
            (agent.forward_net, new_state.forward_params, "forward"),
            (agent.backward_net, new_state.backward_params, "backward"),
            (agent.target_forward_net, new_state.target_forward_params, "target")):
        _close_params(module, tree, lr, what)
    assert agent.step == int(new_state.step) == 1
    _close_grads(agent.fw_opt, new_state.fw_opt_state, "forward")
    _close_grads(agent.bw_opt, new_state.bw_opt_state, "backward")


def test_uvf_goal_meta_matches_jax() -> None:
    """z = B(g), normalised inside B and again after it (norm_z)."""
    jagent, state, agent = _pair(juvf.UVFAgent, juvf.UVFConfig, UVFAgent, UVFConfig, GOAL,
                                 goal_space=MAZE, **UVF_SMALL)
    for goal in MAZE_GOALS[:4]:
        want = np.asarray(jagent.get_goal_meta(state, jnp.asarray(goal)))
        got = agent.get_goal_meta(torch.from_numpy(goal)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(got), np.sqrt(8), rtol=1e-5)


GOAL_SMALL = dict(hidden_dim=32, batch_size=N)
GOAL_CASES = {  # id: (JAX agent, JAX config, port agent, port config, overrides, meta g)
    "td3_supervised": (jgoal.GoalTD3Agent, jgoal.GoalTD3Config, GoalTD3Agent, GoalTD3Config,
                       dict(goal_space=MAZE), False),
    "td3_replay_future": (jgoal.GoalTD3Agent, jgoal.GoalTD3Config, GoalTD3Agent,
                          GoalTD3Config,
                          dict(goal_space=MAZE, supervised=False, future_ratio=0.5), False),
    "td3_states_future": (jgoal.GoalTD3Agent, jgoal.GoalTD3Config, GoalTD3Agent,
                          GoalTD3Config, dict(future_ratio=0.5), False),
    "sm_meta_g": (jgoal.GoalSMAgent, jgoal.GoalSMConfig, GoalSMAgent, GoalSMConfig,
                  dict(goal_space=MAZE), True),
    "sm_permuted_future": (jgoal.GoalSMAgent, jgoal.GoalSMConfig, GoalSMAgent, GoalSMConfig,
                           dict(goal_space=MAZE, future_ratio=0.5), False),
}


@pytest.mark.parametrize("case", sorted(GOAL_CASES))
def test_goal_agent_update_matches_jax(case) -> None:
    """GoalTD3 on uniform maze goals, on permuted achieved goals with the
    hindsight mix, and without a goal space (the future state's first
    columns); GoalSM on the batch's ``g`` meta and on permuted achieved
    goals with the mix."""
    jcls, jcfg_cls, tcls, tcfg_cls, overrides, with_g = GOAL_CASES[case]
    jagent, state, agent = _pair(jcls, jcfg_cls, tcls, tcfg_cls, GOAL, **GOAL_SMALL,
                                 **overrides)
    meta = {"g": MAZE_GOALS[np.random.RandomState(7).randint(0, 20, N)]} if with_g else {}
    jbatch, tbatch = _batch(4, GOAL, meta)
    if overrides.get("goal_space") is None:  # achieved goals are the next goals, if any
        jbatch = jbatch.replace(future_goal=None)
        tbatch.future_goal = None
    key = jax.random.key(5)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    k_goal, k_fut, k_c, k_a = jax.random.split(key, 4)
    noise = GoalNoise(_t(jax.random.normal(k_c, (N, ACT))), _t(jax.random.normal(k_a, (N, ACT))),
                      perm=_t(jax.random.permutation(k_goal, N)).long(),
                      goal_index=_t(jax.random.randint(k_goal, (N,), 0, 20)).long(),
                      future_uniform=_t(jax.random.uniform(k_fut, (N, 1))))
    got = agent._update(tbatch, noise)
    _close_metrics(got, want)
    if "batch_reward" in got:
        assert float(got["batch_reward"]) > 0.0
    lr = agent.cfg.lr
    for module, tree, what in ((agent.actor, new_state.actor_params, "actor"),
                               (agent.critic, new_state.critic_params, "critic"),
                               (agent.target_critic, new_state.target_critic_params, "target")):
        _close_params(module, tree, lr, what)
    assert agent.step == int(new_state.step) == 1
    _close_grads(agent.critic_opt, new_state.critic_opt_state, "critic")


def test_goal_agents_meta() -> None:
    """GoalTD3's ``init_meta`` is a maze goal, GoalSM's zeros (as in JAX);
    ``get_goal_meta`` is the identity; the meta ``g`` is goal_dim wide and
    the collector never resamples it."""
    gen = torch.Generator().manual_seed(0)
    td3 = GoalTD3Agent(GoalTD3Config(**GOAL_SMALL), OBS, ACT, goal_dim=GOAL, device="cpu")
    goals = torch.stack([td3.init_meta(gen)["g"] for _ in range(200)])
    assert {tuple(g) for g in goals.tolist()} <= {tuple(g) for g in MAZE_GOALS.tolist()}
    assert len({tuple(g) for g in goals.tolist()}) == 20
    assert td3.meta_dims == {"g": GOAL}
    goal = torch.tensor([0.1, -0.2])
    assert td3.get_goal_meta(goal) is goal
    meta = {"g": goals[:4]}
    assert td3.rollout_update_meta(meta, torch.tensor(0), td3.step_noise(4, gen)) is meta
    sm = GoalSMAgent(GoalSMConfig(**GOAL_SMALL), OBS, ACT, goal_dim=GOAL, device="cpu")
    assert torch.equal(sm.init_meta(gen)["g"], torch.zeros(GOAL))
