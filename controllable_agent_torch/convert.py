"""Carry weights and optimizer state from the JAX package to the port.

A flax param tree (nested dicts of arrays, e.g. ``{"params": {"MLP_0":
{"Dense_1": {"kernel", "bias"}, "LayerNorm_0": {"scale", "bias"}}}}``)
becomes a state dict of the port's networks by name alone: ``MLP_i`` ->
``mlps.i``; ``Dense_k.kernel`` [in, out] -> ``Dense_k.weight`` [out, in]
(a vmapped stack of them, [n, in, out] -> [n, out, in]); ``Conv_k.kernel``
[3, 3, in, out] -> ``Conv_k.weight`` [out, in, 3, 3]; ``LayerNorm_k.scale``
-> ``LayerNorm_k.weight``; biases keep their name.

A whole ``FBTrainState`` (``controllable_agent_tpu/agents/fb_ddpg.py:102``)
loads into an ``FBDDPGAgent``: the networks, the target networks, the step
counter and the three Adam states (optax ``ScaleByAdamState`` mu, nu,
count). A ``DDPGTrainState`` (``agents/ddpg.py:99``) loads into a
``DDPGAgent`` the same way (on pixels with the encoder and its Adam
state), and an ``IntrinsicTrainState`` (``agents/exploration.py:48``: the
DDPG state, the module, its Adam state and the running statistics) into an
``IntrinsicDDPGAgent`` (RND, DIAYN, ICM, ICM-APT, Disagreement, MaxEnt), an
``SFTrainState`` (``agents/sf.py:326``: the networks, the φ learner's tree
with its target subtrees, three Adam states and ``inv_cov``) into an
``SFAgent``, an ``SFSVDTrainState`` (``agents/sf_svd.py:92``) into an
``SFSVDAgent``, a ``DiscreteFBTrainState`` (``agents/discrete_fb.py:69``)
into a ``DiscreteFBAgent`` and a ``DiscreteSFTrainState``
(``agents/discrete_sf.py:40``) into a ``DiscreteSFAgent``, an
``APSTrainState`` and a ``NEWAPSTrainState`` (``agents/aps.py:88``,
``:312``) into an ``APSAgent`` and a ``NEWAPSAgent``, a ``UVFTrainState``
(``agents/uvf.py:65``) into a ``UVFAgent``, a ``GoalTrainState``
(``agents/goal_agents.py:82``) into a ``GoalTD3Agent`` or ``GoalSMAgent``;
SMM's and Proto's are ``IntrinsicTrainState``s, Proto's ``module_params``
holding the nets under ``"net"`` beside the candidate queue and its pointer
(``agents/proto.py:125-130``). ``load_train_state`` picks by the agent's
class. This module reads those
objects by attribute, or by key when the
state is the nested dict of a decoded checkpoint
(``train/jax_checkpoint.py``: fields by name, tuples by position), and
converts their leaves with numpy or torch, so it imports nothing of JAX:
pass the state as it is or after ``jax.tree.map(np.asarray, state)``.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .agents.aps import APSAgent, NEWAPSAgent
from .agents.ddpg import DDPGAgent
from .agents.discrete_fb import DiscreteFBAgent
from .agents.discrete_sf import DiscreteSFAgent
from .agents.exploration import IntrinsicDDPGAgent
from .agents.fb_ddpg import FBDDPGAgent
from .agents.goal_agents import GoalTD3Agent
from .agents.proto import ProtoAgent
from .agents.sf import SFAgent
from .agents.sf_svd import SFSVDAgent
from .agents.uvf import UVFAgent
from .optim import Adam


def _flatten(tree: tp.Any, prefix: tp.Tuple[str, ...] = ()
             ) -> tp.Iterator[tp.Tuple[tp.Tuple[str, ...], tp.Any]]:
    if hasattr(tree, "items"):
        for key, value in tree.items():
            yield from _flatten(value, prefix + (str(key),))
    else:
        yield prefix, tree


def flax_to_state_dict(tree: tp.Any) -> tp.Dict[str, torch.Tensor]:
    """Flax param tree (or a tree of the same shape, such as Adam moments)
    -> float32 state dict in the port's names and layouts."""
    out: tp.Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        parts = path[1:] if path and path[0] == "params" else path
        *modules, leaf_name = parts
        names = [f"mlps.{m.rpartition('_')[2]}" if m.startswith("MLP_") else m
                 for m in modules]
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.float().numpy()
        x = np.array(leaf, dtype=np.float32)  # a writable copy; bf16 widens exactly
        if leaf_name == "kernel":
            # Dense [in, out], a vmapped stack [n, in, out], Conv [kh, kw, in, out]
            axes = {2: (1, 0), 3: (0, 2, 1), 4: (3, 2, 0, 1)}[x.ndim]
            leaf_name, x = "weight", x.transpose(axes)
        elif leaf_name == "scale":
            leaf_name = "weight"
        out[".".join(names + [leaf_name])] = torch.from_numpy(np.ascontiguousarray(x))
    return out


def _get(node: tp.Any, name: str) -> tp.Any:
    """A field of a state object, or of its decoded dict."""
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _tensor(x: tp.Any) -> torch.Tensor:
    """A leaf as a float32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _load_adam(opt: Adam, opt_state: tp.Any, skip: tp.Sequence[str] = ()) -> None:
    """optax's ``ScaleByAdamState`` into ``opt``; moments of parameters
    under the submodules ``skip`` are dropped (the JAX φ learners keep their
    target networks in the optimized tree, where their moments stay 0; the
    port's Adam leaves them out)."""
    parts = opt_state.values() if isinstance(opt_state, dict) else opt_state
    adam = next(s for s in parts if hasattr(s, "mu") or (isinstance(s, dict) and "mu" in s))
    mu, nu = (
        {k: v for k, v in flax_to_state_dict(_get(adam, key)).items()
         if not any(k.startswith(f"{prefix}.") for prefix in skip)}
        for key in ("mu", "nu"))
    if set(mu) != set(opt.params) or set(nu) != set(opt.params):
        raise ValueError(f"Adam state names {sorted(mu)} do not match the "
                         f"parameters {sorted(opt.params)}")
    for name in opt.params:
        opt.mu[name].copy_(mu[name])
        opt.nu[name].copy_(nu[name])
    opt.count = int(np.asarray(_get(adam, "count")))


def load_fb_train_state(agent: FBDDPGAgent, state: tp.Any) -> None:
    """Load a JAX ``FBTrainState``, or its decoded dict, into ``agent`` (in
    place)."""
    for module, name in ((agent.actor, "actor_params"),
                         (agent.forward_net, "forward_params"),
                         (agent.backward_net, "backward_params"),
                         (agent.target_forward_net, "target_forward_params"),
                         (agent.target_backward_net, "target_backward_params")):
        module.load_state_dict(flax_to_state_dict(_get(state, name)))
    agent.step = int(np.asarray(_get(state, "step")))
    _load_adam(agent.actor_opt, _get(state, "actor_opt_state"))
    _load_adam(agent.fw_opt, _get(state, "fw_opt_state"))
    _load_adam(agent.bw_opt, _get(state, "bw_opt_state"))


def load_ddpg_train_state(agent: DDPGAgent, state: tp.Any) -> None:
    """Load a JAX ``DDPGTrainState``, or its decoded dict, into ``agent`` (in
    place); the reward model and the pixel encoder, with their Adam states,
    when the agent has them."""
    for module, name in ((agent.actor, "actor_params"), (agent.critic, "critic_params"),
                         (agent.target_critic, "target_critic_params")):
        module.load_state_dict(flax_to_state_dict(_get(state, name)))
    agent.step = int(np.asarray(_get(state, "step")))
    _load_adam(agent.actor_opt, _get(state, "actor_opt_state"))
    _load_adam(agent.critic_opt, _get(state, "critic_opt_state"))
    if agent.reward_model is not None:
        assert agent.reward_opt is not None
        agent.reward_model.mlps[0].load_state_dict(
            flax_to_state_dict(_get(state, "reward_params")))
        _load_adam(agent.reward_opt, _get(state, "reward_opt_state"))
    if agent.encoder is not None:
        assert agent.encoder_opt is not None
        agent.encoder.load_state_dict(flax_to_state_dict(_get(state, "encoder_params")))
        _load_adam(agent.encoder_opt, _get(state, "encoder_opt_state"))


def _load_rms(agent: tp.Any, rms: tp.Any) -> None:
    with torch.no_grad():
        for name in ("mean", "var", "n"):
            getattr(agent, f"rms_{name}").copy_(_tensor(_get(rms, name)))


def load_intrinsic_train_state(agent: IntrinsicDDPGAgent, state: tp.Any) -> None:
    """Load a JAX ``IntrinsicTrainState``, or its decoded dict, into
    ``agent`` (in place): the DDPG state, the module and its Adam state, and
    the running statistics; Proto's candidate queue and pointer too."""
    load_ddpg_train_state(agent.ddpg, _get(state, "ddpg"))
    if agent.module is not None:
        assert agent.module_opt is not None
        params = _get(state, "module_params")
        if isinstance(agent, ProtoAgent):
            with torch.no_grad():
                agent.queue.copy_(_tensor(_get(params, "queue")))
                agent.queue_ptr.fill_(int(np.asarray(_get(params, "queue_ptr"))))
            params = _get(params, "net")
        agent.module.load_state_dict(flax_to_state_dict(params))
        _load_adam(agent.module_opt, _get(state, "module_opt_state"))
    _load_rms(agent, _get(state, "rms"))


def _load_networks(agent: tp.Any, state: tp.Any, networks: tp.Mapping[str, str],
                   optimizers: tp.Mapping[str, str]) -> None:
    """The networks (attribute -> state field), the step and the Adam
    states (attribute -> state field) of a JAX train state."""
    for module, name in networks.items():
        getattr(agent, module).load_state_dict(flax_to_state_dict(_get(state, name)))
    agent.step = int(np.asarray(_get(state, "step")))
    for opt, name in optimizers.items():
        _load_adam(getattr(agent, opt), _get(state, name))


def load_aps_train_state(agent: APSAgent, state: tp.Any) -> None:
    """Load a JAX ``APSTrainState``, or its decoded dict, into ``agent``."""
    _load_networks(agent, state, {"actor": "actor_params", "critic": "critic_params",
                                  "target_critic": "target_critic_params",
                                  "aps_net": "aps_params"},
                   {"actor_opt": "actor_opt_state", "critic_opt": "critic_opt_state",
                    "aps_opt": "aps_opt_state"})
    _load_rms(agent, _get(state, "rms"))


def load_new_aps_train_state(agent: NEWAPSAgent, state: tp.Any) -> None:
    """Load a JAX ``NEWAPSTrainState``, or its decoded dict, into ``agent``."""
    _load_networks(agent, state, {"actor": "actor_params", "successor_net": "sf_params",
                                  "target_successor_net": "target_sf_params",
                                  "phi_net": "phi_params"},
                   {"actor_opt": "actor_opt_state", "sf_opt": "sf_opt_state",
                    "phi_opt": "phi_opt_state"})
    _load_rms(agent, _get(state, "rms"))


def load_uvf_train_state(agent: UVFAgent, state: tp.Any) -> None:
    """Load a JAX ``UVFTrainState``, or its decoded dict, into ``agent``."""
    _load_networks(agent, state, {"actor": "actor_params", "forward_net": "forward_params",
                                  "backward_net": "backward_params",
                                  "target_forward_net": "target_forward_params"},
                   {"actor_opt": "actor_opt_state", "fw_opt": "fw_opt_state",
                    "bw_opt": "bw_opt_state"})


def load_goal_train_state(agent: GoalTD3Agent, state: tp.Any) -> None:
    """Load a JAX ``GoalTrainState`` (GoalTD3's or GoalSM's), or its decoded
    dict, into ``agent``."""
    _load_networks(agent, state, {"actor": "actor_params", "critic": "critic_params",
                                  "target_critic": "target_critic_params"},
                   {"actor_opt": "actor_opt_state", "critic_opt": "critic_opt_state"})


def load_sf_train_state(agent: SFAgent, state: tp.Any) -> None:
    """Load a JAX ``SFTrainState``, or its decoded dict, into ``agent`` (in
    place)."""
    for module, name in ((agent.actor, "actor_params"), (agent.successor_net, "sf_params"),
                         (agent.target_successor_net, "target_sf_params"),
                         (agent.feature_learner, "feature_params")):
        module.load_state_dict(flax_to_state_dict(_get(state, name)))
    agent.step = int(np.asarray(_get(state, "step")))
    _load_adam(agent.actor_opt, _get(state, "actor_opt_state"))
    _load_adam(agent.sf_opt, _get(state, "sf_opt_state"))
    if agent.phi_opt is not None:
        targets = [target for _, target in type(agent.feature_learner).TARGET_PAIRS]
        _load_adam(agent.phi_opt, _get(state, "phi_opt_state"), skip=targets)
    with torch.no_grad():
        agent.inv_cov.copy_(_tensor(_get(state, "inv_cov")))


def load_sf_svd_train_state(agent: SFSVDAgent, state: tp.Any) -> None:
    """Load a JAX ``SFSVDTrainState``, or its decoded dict, into ``agent``
    (in place)."""
    for module, name in ((agent.actor, "actor_params"), (agent.successor_net, "sf_params"),
                         (agent.target_successor_net, "target_sf_params"),
                         (agent.svd, "svd_params")):
        module.load_state_dict(flax_to_state_dict(_get(state, name)))
    agent.step = int(np.asarray(_get(state, "step")))
    _load_adam(agent.actor_opt, _get(state, "actor_opt_state"))
    _load_adam(agent.sf_opt, _get(state, "sf_opt_state"))
    _load_adam(agent.svd_opt, _get(state, "svd_opt_state"))


def load_discrete_fb_train_state(agent: DiscreteFBAgent, state: tp.Any) -> None:
    """Load a JAX ``DiscreteFBTrainState``, or its decoded dict, into
    ``agent`` (in place)."""
    for module, name in ((agent.forward_net, "forward_params"),
                         (agent.backward_net, "backward_params"),
                         (agent.target_forward_net, "target_forward_params"),
                         (agent.target_backward_net, "target_backward_params")):
        module.load_state_dict(flax_to_state_dict(_get(state, name)))
    agent.step = int(np.asarray(_get(state, "step")))
    _load_adam(agent.fw_opt, _get(state, "fw_opt_state"))
    _load_adam(agent.bw_opt, _get(state, "bw_opt_state"))


def load_discrete_sf_train_state(agent: DiscreteSFAgent, state: tp.Any) -> None:
    """Load a JAX ``DiscreteSFTrainState``, or its decoded dict, into
    ``agent`` (in place); the φ targets' zero moments are dropped, as for SF."""
    for module, name in ((agent.successor_net, "sf_params"),
                         (agent.target_successor_net, "target_sf_params"),
                         (agent.feature_learner, "feature_params")):
        module.load_state_dict(flax_to_state_dict(_get(state, name)))
    agent.step = int(np.asarray(_get(state, "step")))
    _load_adam(agent.sf_opt, _get(state, "sf_opt_state"))
    if agent.phi_opt is not None:
        targets = [target for _, target in type(agent.feature_learner).TARGET_PAIRS]
        _load_adam(agent.phi_opt, _get(state, "phi_opt_state"), skip=targets)


def load_train_state(agent: tp.Any, state: tp.Any) -> None:
    """Load the JAX train state of ``agent``'s kind into it."""
    if isinstance(agent, DiscreteFBAgent):
        load_discrete_fb_train_state(agent, state)
    elif isinstance(agent, DiscreteSFAgent):
        load_discrete_sf_train_state(agent, state)
    elif isinstance(agent, SFAgent):
        load_sf_train_state(agent, state)
    elif isinstance(agent, SFSVDAgent):
        load_sf_svd_train_state(agent, state)
    elif isinstance(agent, FBDDPGAgent):
        load_fb_train_state(agent, state)
    elif isinstance(agent, APSAgent):
        load_aps_train_state(agent, state)
    elif isinstance(agent, NEWAPSAgent):
        load_new_aps_train_state(agent, state)
    elif isinstance(agent, UVFAgent):
        load_uvf_train_state(agent, state)
    elif isinstance(agent, GoalTD3Agent):
        load_goal_train_state(agent, state)
    elif isinstance(agent, IntrinsicDDPGAgent):
        load_intrinsic_train_state(agent, state)
    elif isinstance(agent, DDPGAgent):
        load_ddpg_train_state(agent, state)
    else:
        raise TypeError(f"no JAX train state converts into a {type(agent).__name__}")
