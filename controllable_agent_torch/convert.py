"""Carry weights and optimizer state from the JAX package to the port.

A flax param tree (nested dicts of arrays, e.g. ``{"params": {"MLP_0":
{"Dense_1": {"kernel", "bias"}, "LayerNorm_0": {"scale", "bias"}}}}``)
becomes a state dict of the port's networks by name alone: ``MLP_i`` ->
``mlps.i``; ``Dense_k.kernel`` [in, out] -> ``Dense_k.weight`` [out, in];
``LayerNorm_k.scale`` -> ``LayerNorm_k.weight``; biases keep their name.

A whole ``FBTrainState`` (``controllable_agent_tpu/agents/fb_ddpg.py:102``)
loads into an ``FBDDPGAgent``: the networks, the target networks, the step
counter and the three Adam states (optax ``ScaleByAdamState`` mu, nu,
count). This module reads those objects by attribute and converts their
leaves with numpy, so it imports nothing of JAX: pass the state as it is or
after ``jax.tree.map(np.asarray, state)``.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .agents.fb_ddpg import FBDDPGAgent
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
        x = np.array(leaf, dtype=np.float32)  # a writable copy; bf16 widens exactly
        if leaf_name == "kernel":
            leaf_name, x = "weight", x.T
        elif leaf_name == "scale":
            leaf_name = "weight"
        out[".".join(names + [leaf_name])] = torch.from_numpy(np.ascontiguousarray(x))
    return out


def _load_adam(opt: Adam, opt_state: tp.Any) -> None:
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    mu, nu = flax_to_state_dict(adam.mu), flax_to_state_dict(adam.nu)
    if set(mu) != set(opt.params) or set(nu) != set(opt.params):
        raise ValueError(f"Adam state names {sorted(mu)} do not match the "
                         f"parameters {sorted(opt.params)}")
    for name, p in opt.params.items():
        opt.mu[name] = mu[name].to(p.device, opt.mu[name].dtype)
        opt.nu[name] = nu[name].to(p.device)
    opt.count = int(np.asarray(adam.count))


def load_fb_train_state(agent: FBDDPGAgent, state: tp.Any) -> None:
    """Load a JAX ``FBTrainState`` into ``agent`` (in place)."""
    for module, params in ((agent.actor, state.actor_params),
                           (agent.forward_net, state.forward_params),
                           (agent.backward_net, state.backward_params),
                           (agent.target_forward_net, state.target_forward_params),
                           (agent.target_backward_net, state.target_backward_params)):
        module.load_state_dict(flax_to_state_dict(params))
    agent.step = int(np.asarray(state.step))
    _load_adam(agent.actor_opt, state.actor_opt_state)
    _load_adam(agent.fw_opt, state.fw_opt_state)
    _load_adam(agent.bw_opt, state.bw_opt_state)
