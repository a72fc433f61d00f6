"""The cases of the data-parallel agent tests (not a test module).

Each case is one agent of the port in a small configuration, with the JAX
agent it mirrors: a global batch of ``N`` rows made from a seed with numpy
for both packages, and the JAX update's draws re-derived from its key as
the port's noise (the splits of each agent's parity test:
``test_torch_ddpg.py``, ``test_torch_explorers.py``, ``test_torch_aps.py``,
``test_torch_smm_proto.py``, ``test_torch_goal_agents.py``,
``test_torch_sf_learners.py``, ``test_torch_sf.py``,
``test_torch_discrete_fb.py`` and ``test_torch_discrete_sf.py``).

``Tol`` holds the tolerances of the agent's own parity test file, and
``close_states`` applies them to two train states of the port, one of them
JAX's converted (``convert.load_train_state``): metrics at ``rtol`` /
``atol``; parameters after Adam within 2 lr, at most one entry per tensor (or
1e-3 of it) past 1e-3 lr; Adam's moments as that file compares them (the
raw moments, or the gradients read back from them); the running statistics
at rtol 1e-4; the counters equal.
"""

from __future__ import annotations

import dataclasses
import re
import typing as tp

import jax
import jax.numpy as jnp
import numpy as np
import torch

from controllable_agent_tpu.agents import aps as japs
from controllable_agent_tpu.agents import ddpg as jddpg
from controllable_agent_tpu.agents import discrete_fb as jdfb
from controllable_agent_tpu.agents import discrete_sf as jdsf
from controllable_agent_tpu.agents import exploration as jex
from controllable_agent_tpu.agents import fb_ddpg as jfb
from controllable_agent_tpu.agents import goal_agents as jgoal
from controllable_agent_tpu.agents import proto as jproto
from controllable_agent_tpu.agents import sf as jsf
from controllable_agent_tpu.agents import sf_svd as jsfsvd
from controllable_agent_tpu.agents import smm as jsmm
from controllable_agent_tpu.agents import uvf as juvf
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_tpu.parallel import make_dp_trainer as jax_make_dp_trainer
from controllable_agent_tpu.parallel import make_mesh
from controllable_agent_tpu.parallel import shard_batch as jax_shard_batch
from controllable_agent_torch.agents import (AGENTS, DDPGNoise, GoalNoise, NEWAPSNoise,
                                             ProtoNoise, SFNoise, SMMNoise, UpdateNoise,
                                             UVFNoise)
from controllable_agent_torch.agents.goal_agents import MAZE_GOALS
from controllable_agent_torch.convert import load_train_state
from controllable_agent_torch.parallel import make_dp_trainer
from controllable_agent_torch.data.episode_batch import EpisodeBatch

N, OBS, ACT, GOAL, ACTIONS = 16, 6, 3, 2, 5
SKILLS, SMM_Z, SF_DIM, CODE = 5, 4, 5, 8
MAZE = "simplified_point_mass_maze"


@dataclasses.dataclass(frozen=True)
class Tol:
    """A parity test file's tolerances: metrics at ``rtol``/``atol``; Adam's
    moments raw (mu at ``mu``, nu at ``nu``, each (rtol, atol)) or, with
    ``grad_share``, as the gradients read back from them at rtol 1e-3 and an
    atol of ``grad_share`` of the tensor's largest |g|."""

    rtol: float = 1e-4
    atol: float = 1e-5
    mu: tp.Tuple[float, float] = (1e-4, 1e-6)
    nu: tp.Tuple[float, float] = (1e-3, 1e-12)
    grad_share: tp.Optional[float] = None


DDPG_TOL = Tol()  # test_torch_ddpg.py
EXPLORER_TOL = Tol(grad_share=1e-4)  # test_torch_explorers.py, _aps.py, _smm_proto.py
GOAL_TOL = Tol(atol=1e-6, grad_share=1e-5)  # test_torch_goal_agents.py
SF_TOL = Tol(atol=1e-6)  # test_torch_sf_learners.py, test_torch_sf.py
DISCRETE_TOL = Tol(rtol=2e-4, mu=(1e-3, 1e-7), nu=(2e-3, 1e-12))  # test_torch_discrete_*.py


def _t(x: tp.Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _normal(key: jax.Array, *shape: int) -> torch.Tensor:
    return _t(jax.random.normal(key, shape))


def ddpg_noise(cfg: tp.Any, key: jax.Array, n: int) -> DDPGNoise:
    """``ddpg.py:305``: the target policy's and the actor's noise from the
    first two of four keys."""
    k_critic, k_actor, _, _ = jax.random.split(key, 4)
    return DDPGNoise(_normal(k_critic, n, ACT), _normal(k_actor, n, ACT))


def intrinsic_noise(cfg: tp.Any, key: jax.Array, n: int) -> DDPGNoise:
    """``exploration.py:150``: DDPG's draws from the third of three keys."""
    return ddpg_noise(cfg, jax.random.split(key, 3)[2], n)


def smm_noise(cfg: tp.Any, key: jax.Array, n: int) -> SMMNoise:
    k_mod, k_intr, k_ddpg = jax.random.split(key, 3)
    ddpg = ddpg_noise(cfg, k_ddpg, n)
    return SMMNoise(ddpg.critic_normal, ddpg.actor_normal,
                    loss_eps=_normal(k_mod, n, cfg.code_dim),
                    reward_eps=_normal(k_intr, n, cfg.code_dim))


def proto_noise(cfg: tp.Any, key: jax.Array, n: int) -> ProtoNoise:
    k_cand, k_ddpg = jax.random.split(key)
    ddpg = ddpg_noise(cfg, k_ddpg, n)
    return ProtoNoise(ddpg.critic_normal, ddpg.actor_normal,
                      candidate_gumbel=_t(jax.random.gumbel(k_cand, (cfg.num_protos, n))))


def aps_noise(cfg: tp.Any, key: jax.Array, n: int) -> DDPGNoise:
    k_c, k_a = jax.random.split(key)
    return DDPGNoise(_normal(k_c, n, ACT), _normal(k_a, n, ACT))


def new_aps_noise(cfg: tp.Any, key: jax.Array, n: int) -> NEWAPSNoise:
    k_z, k_c, k_a, k_f = jax.random.split(key, 4)
    return NEWAPSNoise(_normal(k_z, n, cfg.z_dim), _normal(k_c, n, ACT), _normal(k_a, n, ACT),
                       _t(jax.random.uniform(k_f, (n, 1))) if cfg.future_ratio > 0 else None)


def uvf_noise(cfg: tp.Any, key: jax.Array, n: int) -> UVFNoise:
    k_perm, k_mix, k_fb, k_actor = jax.random.split(key, 4)
    return UVFNoise(_t(jax.random.permutation(k_perm, n)).long(),
                    _t(jax.random.uniform(k_mix, (n, 1))), _normal(k_fb, n, ACT),
                    _normal(k_actor, n, ACT))


def goal_noise(cfg: tp.Any, key: jax.Array, n: int) -> GoalNoise:
    k_goal, k_fut, k_c, k_a = jax.random.split(key, 4)
    return GoalNoise(_normal(k_c, n, ACT), _normal(k_a, n, ACT),
                     perm=_t(jax.random.permutation(k_goal, n)).long(),
                     goal_index=_t(jax.random.randint(k_goal, (n,), 0, 20)).long(),
                     future_uniform=_t(jax.random.uniform(k_fut, (n, 1))))


def sf_noise(cfg: tp.Any, key: jax.Array, n: int) -> SFNoise:
    """``sf.py:562``'s five keys."""
    k_z, k_perm, k_mix, k_sf, k_actor = jax.random.split(key, 5)
    mix = cfg.mix_ratio > 0
    return SFNoise(z_normal=_normal(k_z, n, cfg.z_dim), next_action_normal=_normal(k_sf, n, ACT),
                   actor_normal=_normal(k_actor, n, ACT),
                   perm=_t(jax.random.permutation(k_perm, n)).long() if mix else None,
                   mix_uniform=_t(jax.random.uniform(k_mix, (n, 1))) if mix else None)


def sf_svd_noise(cfg: tp.Any, key: jax.Array, n: int) -> SFNoise:
    k_z, k_sf, k_actor = jax.random.split(key, 3)
    return SFNoise(z_normal=_normal(k_z, n, cfg.z_dim), next_action_normal=_normal(k_sf, n, ACT),
                   actor_normal=_normal(k_actor, n, ACT))


def _fb_z_noise(cfg: tp.Any, k_z: jax.Array, n: int) -> UpdateNoise:
    """The draws of FB's and discrete FB's ``_build_train_z`` from its key."""
    kz, k_perm, k_mix, k_w, k_u, k_fut = jax.random.split(k_z, 6)
    k1, k2 = jax.random.split(kz)
    rand_weight = cfg.rand_weight and cfg.mix_ratio > 0
    return UpdateNoise(
        z_normal=_normal(k1, n, cfg.z_dim), perm=_t(jax.random.permutation(k_perm, n)).long(),
        mix_uniform=_t(jax.random.uniform(k_mix, (n, 1))),
        z_uniform=None if cfg.norm_z else _t(jax.random.uniform(k2, (n, cfg.z_dim))),
        w_uniform=_t(jax.random.uniform(k_w, (n, n))) if rand_weight else None,
        w_scale=_t(jax.random.uniform(k_u, (n, 1))) if rand_weight else None,
        future_uniform=_t(jax.random.uniform(k_fut, (n, 1))) if cfg.future_ratio > 0 else None)


def fb_noise(cfg: tp.Any, key: jax.Array, n: int) -> UpdateNoise:
    """``fb_ddpg.py``'s three keys: z's, the target policy's, the actor's."""
    k_z, k_fb, k_actor = jax.random.split(key, 3)
    return dataclasses.replace(_fb_z_noise(cfg, k_z, n), next_action_normal=_normal(k_fb, n, ACT),
                               actor_normal=_normal(k_actor, n, ACT))


def discrete_fb_noise(cfg: tp.Any, key: jax.Array, n: int) -> UpdateNoise:
    return _fb_z_noise(cfg, jax.random.split(key)[0], n)


def discrete_sf_noise(cfg: tp.Any, key: jax.Array, n: int) -> SFNoise:
    return SFNoise(z_normal=_normal(jax.random.split(key)[0], n, cfg.z_dim))


@dataclasses.dataclass(frozen=True)
class Case:
    """One agent in one configuration. ``meta`` names the batch's meta column
    ("skill", "z", "task", "g"); ``goal_dim`` adds goal columns;
    ``discrete`` makes actions indices in [0, ACTIONS)."""

    agent: str
    jax_agent: tp.Callable[..., tp.Any]
    jax_cfg: tp.Callable[..., tp.Any]
    cfg: tp.Dict[str, tp.Any]
    noise: tp.Callable[[tp.Any, jax.Array, int], tp.Any]
    tol: Tol
    meta: tp.Optional[str] = None
    meta_dim: int = 0
    goal_dim: tp.Optional[int] = None
    discrete: bool = False


SMALL = dict(hidden_dim=32, batch_size=N)
FB_SMALL = dict(hidden_dim=32, backward_hidden_dim=16, feature_dim=16, z_dim=8, batch_size=N)
SF_SMALL = dict(hidden_dim=32, backward_hidden_dim=32, feature_dim=16, z_dim=8, batch_size=N)
PROTO = dict(SMALL, pred_dim=8, proj_dim=16, num_protos=8, queue_size=20, topk=3)


def _explorer(agent: str, jcls: type, jcfg: type, **cfg: tp.Any) -> Case:
    return Case(agent, jcls, jcfg, dict(SMALL, **cfg), intrinsic_noise, EXPLORER_TOL)


CASES: tp.Dict[str, Case] = {
    "fb_ddpg": Case("fb_ddpg", jfb.FBDDPGAgent, jfb.FBDDPGConfig, SF_SMALL, fb_noise, SF_TOL),
    "ddpg": Case("ddpg", jddpg.DDPGAgent, jddpg.DDPGConfig, SMALL, ddpg_noise, DDPG_TOL),
    "rnd": Case("rnd", jex.RNDAgent, jex.RNDConfig, dict(SMALL, rnd_rep_dim=8),
                intrinsic_noise, DDPG_TOL),
    "diayn": Case("diayn", jex.DIAYNAgent, jex.DIAYNConfig, dict(SMALL, skill_dim=SKILLS),
                  intrinsic_noise, EXPLORER_TOL, meta="skill", meta_dim=SKILLS),
    "icm": _explorer("icm", jex.ICMAgent, jex.ICMConfig),
    "icm_apt_avg": _explorer("icm_apt", jex.ICMAPTAgent, jex.ICMAPTConfig, icm_rep_dim=8),
    "icm_apt_kth": _explorer("icm_apt", jex.ICMAPTAgent, jex.ICMAPTConfig, icm_rep_dim=8,
                             knn_avg=False),
    "disagreement": _explorer("disagreement", jex.DisagreementAgent, jex.DisagreementConfig,
                              n_models=3),
    "max_ent_avg": _explorer("max_ent", jex.MaxEntAgent, jex.MaxEntConfig),
    "max_ent_kth": _explorer("max_ent", jex.MaxEntAgent, jex.MaxEntConfig, knn_avg=False),
    "smm": Case("smm", jsmm.SMMAgent, jsmm.SMMConfig, dict(SMALL, code_dim=CODE), smm_noise,
                EXPLORER_TOL, meta="z", meta_dim=SMM_Z),
    "proto": Case("proto", jproto.ProtoAgent, jproto.ProtoConfig, PROTO, proto_noise,
                  EXPLORER_TOL),
    "aps": Case("aps", japs.APSAgent, japs.APSConfig, dict(SMALL, sf_dim=SF_DIM), aps_noise,
                EXPLORER_TOL, meta="task", meta_dim=SF_DIM),
    "new_aps_future": Case("new_aps", japs.NEWAPSAgent, japs.NEWAPSConfig,
                           dict(FB_SMALL, z_dim=SF_DIM, future_ratio=0.5), new_aps_noise,
                           EXPLORER_TOL),
    "uvf": Case("uvf", juvf.UVFAgent, juvf.UVFConfig, FB_SMALL, uvf_noise, GOAL_TOL),
    "goal_td3_replay": Case("goal_td3", jgoal.GoalTD3Agent, jgoal.GoalTD3Config,
                            dict(SMALL, goal_space=MAZE, supervised=False, future_ratio=0.5),
                            goal_noise, GOAL_TOL, goal_dim=GOAL),
    "goal_sm_permuted": Case("goal_sm", jgoal.GoalSMAgent, jgoal.GoalSMConfig,
                             dict(SMALL, goal_space=MAZE, future_ratio=0.5), goal_noise,
                             GOAL_TOL, goal_dim=GOAL),
    "sf_lap": Case("sf", jsf.SFAgent, jsf.SFConfig, dict(SF_SMALL, feature_learner="lap"),
                   sf_noise, SF_TOL),
    "sf_contrastive": Case("sf", jsf.SFAgent, jsf.SFConfig,
                           dict(SF_SMALL, feature_learner="contrastive"), sf_noise, SF_TOL),
    "sf_svd_sr": Case("sf", jsf.SFAgent, jsf.SFConfig, dict(SF_SMALL, feature_learner="svd_sr"),
                      sf_noise, SF_TOL),
    "sf_svd_p": Case("sf", jsf.SFAgent, jsf.SFConfig, dict(SF_SMALL, feature_learner="svd_p"),
                     sf_noise, SF_TOL),
    "sf_mix": Case("sf", jsf.SFAgent, jsf.SFConfig,
                   dict(SF_SMALL, feature_learner="icm", mix_ratio=0.5), sf_noise, SF_TOL),
    "sf_svd": Case("sf_svd", jsfsvd.SFSVDAgent, jsfsvd.SFSVDConfig, SF_SMALL, sf_svd_noise,
                   SF_TOL),
    "discrete_fb": Case("discrete_fb", jdfb.DiscreteFBAgent, jdfb.DiscreteFBConfig, SF_SMALL,
                        discrete_fb_noise, DISCRETE_TOL, discrete=True),
    "discrete_fb_q_loss": Case("discrete_fb", jdfb.DiscreteFBAgent, jdfb.DiscreteFBConfig,
                               dict(SF_SMALL, q_loss=True), discrete_fb_noise, DISCRETE_TOL,
                               discrete=True),
    "discrete_sf": Case("discrete_sf", jdsf.DiscreteSFAgent, jdsf.DiscreteSFConfig,
                        dict(SF_SMALL, feature_learner="lap"), discrete_sf_noise, DISCRETE_TOL,
                        discrete=True),
}


# the first case of each agent
AGENT_CASES = {case.agent: name for name, case in reversed(list(CASES.items()))}


def batch_arrays(case: Case, seed: int = 0, n: int = N) -> tp.Dict[str, tp.Any]:
    """The global batch of ``case`` as numpy arrays (the meta under "meta")."""
    rng = np.random.RandomState(seed)
    action = (rng.randint(0, ACTIONS, (n, 1)) if case.discrete
              else rng.uniform(-1, 1, (n, ACT)))
    arrays = dict(obs=rng.randn(n, OBS), action=action, reward=rng.rand(n, 1),
                  next_obs=rng.randn(n, OBS), discount=np.full((n, 1), 0.98),
                  future_obs=rng.randn(n, OBS))
    arrays["next_obs"][1] = arrays["next_obs"][0]  # UVF's indicator reward bites
    if case.goal_dim is not None:
        arrays.update(goal=rng.randn(n, GOAL) * 0.1,
                      next_goal=MAZE_GOALS[rng.randint(0, 20, n)] + rng.randn(n, GOAL) * 0.02,
                      future_goal=MAZE_GOALS[rng.randint(0, 20, n)] + rng.randn(n, GOAL) * 0.01)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    meta: tp.Dict[str, np.ndarray] = {}
    if case.meta in ("skill", "z"):
        meta[case.meta] = np.eye(case.meta_dim, dtype=np.float32)[rng.randint(0, case.meta_dim, n)]
    elif case.meta == "task":
        task = rng.randn(n, case.meta_dim).astype(np.float32)
        meta["task"] = task / np.linalg.norm(task, axis=1, keepdims=True)
    arrays["meta"] = meta
    return arrays


def torch_batch(arrays: tp.Dict[str, tp.Any]) -> EpisodeBatch:
    return EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items() if k != "meta"},
                        meta={k: torch.from_numpy(v) for k, v in arrays["meta"].items()})


def jax_batch(arrays: tp.Dict[str, tp.Any]) -> JaxBatch:
    return JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items() if k != "meta"},
                    meta={k: jnp.asarray(v) for k, v in arrays["meta"].items()})


def agent_args(case: Case) -> tp.Tuple[tp.Tuple[int, int], tp.Dict[str, tp.Any]]:
    """The port agent's positional and keyword arguments besides the config."""
    kwargs: tp.Dict[str, tp.Any] = {"device": "cpu"}
    if case.goal_dim is not None:
        kwargs["goal_dim"] = case.goal_dim
    return (OBS, ACTIONS if case.discrete else ACT), kwargs


def port_agent(case: Case) -> tp.Any:
    """The port's agent of ``case`` (weights from seed 0)."""
    cfg_cls, cls = AGENTS[case.agent]
    args, kwargs = agent_args(case)
    return cls(cfg_cls(**case.cfg), *args, **kwargs)


def jax_pair(case: Case) -> tp.Tuple[tp.Any, tp.Any, tp.Any]:
    """(the JAX agent, its state from key 0, the port's agent loaded from it)."""
    args, _ = agent_args(case)
    goal = () if case.agent == "ddpg" else (case.goal_dim,)  # DDPG's fourth is meta_dim
    jagent = case.jax_agent(case.jax_cfg(**case.cfg), *args, *goal)
    state = jagent.init(jax.random.key(0))
    agent = port_agent(case)
    load_train_state(agent, jax.tree.map(np.asarray, state))
    return jagent, state, agent


def jax_dp_update(jagent: tp.Any, state: tp.Any, arrays: tp.Dict[str, tp.Any],
                  key: jax.Array, devices: int = 2) -> tp.Tuple[tp.Any, tp.Dict[str, tp.Any]]:
    """JAX's ``make_dp_trainer`` on a mesh of ``devices``: the new state (as
    numpy) and the metrics."""
    mesh = make_mesh(devices)
    with mesh:
        new_state, metrics = jax_make_dp_trainer(jagent, mesh)(
            state, jax_shard_batch(jax_batch(arrays), mesh), key)
    return jax.tree.map(np.asarray, new_state), {k: np.asarray(v) for k, v in metrics.items()}


def close_metrics(got: tp.Mapping[str, tp.Any], want: tp.Mapping[str, tp.Any], tol: Tol,
                  what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), np.asarray(want[k], np.float32),
                                   rtol=tol.rtol, atol=tol.atol, err_msg=f"{what} {k}")


def close_states(got: tp.Mapping[str, torch.Tensor], want: tp.Mapping[str, torch.Tensor],
                 lr: float, tol: Tol, what: str) -> None:
    """Two train states of the port after one update from the same state."""
    assert set(got) == set(want), what
    for name, w in want.items():
        g, msg = got[name], f"{what} {name}"
        if g.dtype in (torch.int64, torch.int32) or name.endswith("count"):
            assert torch.equal(g, w), msg
            continue
        g, w = g.float().numpy(), w.float().numpy()
        leaf = name.rsplit(".", 1)[-1]
        moment = re.search(r"_opt\.(mu|nu)\.", name)
        if moment and tol.grad_share is not None:
            # one Adam step: g = mu / (1 - b1), |g| = sqrt(nu / (1 - b2))
            if moment.group(1) == "mu":
                g, w = g / 0.1, w / 0.1
            else:
                g, w = np.sqrt(g / 1e-3), np.sqrt(w / 1e-3)
            np.testing.assert_allclose(g, w, rtol=1e-3,
                                       atol=tol.grad_share * float(np.abs(w).max(initial=0.0)),
                                       err_msg=f"{msg} (gradient)")
        elif moment:
            rtol, atol = tol.mu if moment.group(1) == "mu" else tol.nu
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=msg)
        elif leaf.startswith("rms_") or leaf == "queue":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=msg)
        else:
            diff = np.abs(g - w)
            assert float(diff.max(initial=0.0)) <= 2 * lr + 1e-6, msg
            flipped = int((diff > 1e-3 * lr).sum())
            assert flipped <= max(1, 1e-3 * diff.size), f"{msg}: {flipped}"


def jax_state_as_port(case: Case, jax_state: tp.Any) -> tp.Dict[str, torch.Tensor]:
    """JAX's train state converted into the port's agent, as its
    ``train_state``."""
    agent = port_agent(case)
    load_train_state(agent, jax_state)
    return {k: v.clone() for k, v in agent.train_state().items()}


def job(case: Case, state: tp.Mapping[str, torch.Tensor], batch: EpisodeBatch,
        noise: tp.Any) -> tp.Dict[str, tp.Any]:
    """What ``tests/torch_dp_worker.py`` needs for one ``make_dp_trainer``
    update of ``case`` from ``state``."""
    args, kwargs = agent_args(case)
    return {"agent": case.agent, "cfg": case.cfg, "args": args, "kwargs": kwargs,
            "state": {k: v.clone() for k, v in state.items()}, "batch": batch, "noise": noise}


def two_process_refs(folder: tp.Any, names: tp.Sequence[str]) -> tp.Dict[str, tp.Any]:
    """Write the jobs of ``names`` into ``folder``; (the references: JAX's
    data-parallel update, the port's single-process update)."""
    jobs, refs = {}, {}
    for name in names:
        case = CASES[name]
        jagent, state, agent = jax_pair(case)
        arrays = batch_arrays(case)
        key = jax.random.key(11)
        noise = case.noise(jagent.cfg, key, N)
        jobs[name] = job(case, agent.train_state(), torch_batch(arrays), noise)
        jax_state, jax_metrics = jax_dp_update(jagent, state, arrays, key)
        single_metrics = agent._update(torch_batch(arrays), noise)
        refs[name] = dict(jax_state=jax_state, jax_metrics=jax_metrics,
                          initial_state=jobs[name]["state"],
                          single_metrics=single_metrics,
                          single_state={k: v.clone() for k, v in agent.train_state().items()})
    torch.save(jobs, folder / "agent_updates.pt")
    return refs


def check_two_processes(outs: tp.Sequence[tp.Any], refs: tp.Mapping[str, tp.Any],
                        name: str) -> None:
    """Both processes equal to the bit; JAX's and the single-process update
    within the case's tolerances."""
    case = CASES[name]
    got = [out["agent_updates"][name] for out in outs]
    for key in got[0]["state"]:
        assert torch.equal(got[0]["state"][key], got[1]["state"][key]), key
    ref = refs[name]
    lr = case.cfg.get("lr", 1e-4)
    close_metrics(got[0]["metrics"], ref["jax_metrics"], case.tol, "vs JAX")
    close_states(got[0]["state"], jax_state_as_port(case, ref["jax_state"]), lr, case.tol,
                 "vs JAX")
    close_metrics(got[0]["metrics"], ref["single_metrics"], case.tol, "vs port")
    close_states(got[0]["state"], ref["single_state"], lr, case.tol, "vs port")


def check_one_process(group: tp.Any, name: str) -> None:
    """The update through a one-process group (noise drawn from generators
    seeded alike) equals the plain update to the bit."""
    case = CASES[name]
    arrays = batch_arrays(case, seed=1)
    plain, dp = port_agent(case), port_agent(case)
    want = plain.update(torch_batch(arrays), torch.Generator().manual_seed(3))
    got = make_dp_trainer(dp, group)(torch_batch(arrays), torch.Generator().manual_seed(3))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for key, value in plain.train_state().items():
        assert torch.equal(dp.train_state()[key], value), key
