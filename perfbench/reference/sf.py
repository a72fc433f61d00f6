"""The successor-feature agent with Laplacian features (the SF baseline of
arXiv:2209.14935, the repository's JAX ``SFAgent(feature_learner="lap")``)
in plain PyTorch, float32.

One update: z on the sphere of radius sqrt(d); the TD target
φ(s') + γ F_target(s', a', z), F_target the twin with the smaller F·z; the
successor loss in Q space (F·z against the target's ·z) and its Adam step;
the Laplacian loss of φ, |φ(s) - φ(s')|² plus the orthonormality loss of
φ(s), and its Adam step (φ reads the goal columns where the configuration
names a goal space, the observation where it names none); the actor's loss through the updated successor
net and its Adam step; the successor target's soft update.
"""

from __future__ import annotations

import typing as tp

import torch

from .. import flops
from . import nets
from .fb import _off_sum
from .nets import Params, Products, Shapes
from .train import Adam, grads_of, soft_update, with_grad

Tensor = torch.Tensor

OPTIMIZERS = {"sf_opt": "successor_net", "phi_opt": "feature_learner",
              "actor_opt": "actor"}
TARGETS = {"target_successor_net": "successor_net"}
LOSSES = ("sf_loss", "phi_loss", "actor_loss")
PHI = "feature_learner.feature_net"


def leaves(s: Shapes) -> tp.List[tp.Tuple[str, tp.Tuple[int, ...]]]:
    online = (nets.actor_shapes(s) + nets.forward_shapes(s, "successor_net")
              + nets.backward_shapes(s, PHI))
    return online + [("target_successor_net" + name[len("successor_net"):], shape)
                     for name, shape in online if name.startswith("successor_net.")]


def phi(p: Params, s: Shapes, goal: Tensor, prod: Products) -> Tensor:
    return nets.mlp(p, PHI, goal, nets.backward_layers(s, l2=True), prod)


def update(p: Params, opts: tp.Mapping[str, Adam], cfg: tp.Mapping[str, tp.Any], s: Shapes,
           batch: tp.Mapping[str, Tensor], noise: tp.Mapping[str, Tensor], prod: Products
           ) -> tp.Tuple[tp.Dict[str, float], tp.Dict[str, float], tp.Dict[str, Tensor]]:
    """One update of ``p`` in place; the losses, their scales (the sum of
    the magnitudes of their terms: of the rows' Q for the actor's) and the
    gradients by leaf."""
    std, clip = cfg["stddev"], cfg["stddev_clip"]
    obs, next_obs, action = batch["obs"], batch["next_obs"], batch["action"]
    goal, next_goal = ((batch["goal"], batch["next_goal"]) if cfg["goal_space"]
                       else (obs, next_obs))
    z = nets.l2_normalize(noise["z_normal"])
    with torch.no_grad():
        target_phi = phi(p, s, next_goal, prod)
        mu = nets.actor(p, s, next_obs, z, prod)
        next_action = nets.truncated_sample(mu, noise["next_action_normal"], std, clip)
        nf1, nf2 = nets.forward_map(p, s, "target_successor_net", next_obs, z, next_action,
                                    prod)
        next_f = torch.where((nets.dot(nf1, z) < nets.dot(nf2, z))[:, None], nf1, nf2)
        target_q = nets.dot(target_phi + batch["discount"] * next_f, z)

    sf = opts["sf_opt"]
    q = with_grad(p, sf.names)
    f1, f2 = nets.forward_map(q, s, "successor_net", obs, z, action, prod)
    sf_loss = (((nets.dot(f1, z) - target_q) ** 2).mean()
               + ((nets.dot(f2, z) - target_q) ** 2).mean())
    sf_grads = grads_of(sf_loss, q, sf.names)
    sf.step(p, sf_grads)

    ph = opts["phi_opt"]
    q = with_grad(p, ph.names)
    now, nxt = phi(q, s, goal, prod), phi(q, s, next_goal, prod)
    n = now.shape[0]
    cov = prod.mm(now, now.T)
    orth_off, orth_diag = _off_sum(cov ** 2) / (n * (n - 1)), -2.0 * cov.diagonal().sum() / n
    moved = ((now - nxt) ** 2).mean()
    phi_loss = moved + orth_off + orth_diag
    phi_grads = grads_of(phi_loss, q, ph.names)
    ph.step(p, phi_grads)

    act = opts["actor_opt"]
    q = with_grad(p, act.names)
    a = nets.truncated_sample(nets.actor(q, s, obs, z, prod), noise["actor_normal"], std, clip)
    f1, f2 = nets.forward_map(q, s, "successor_net", obs, z, a, prod)
    q_rows = torch.minimum(nets.dot(f1, z), nets.dot(f2, z))
    actor_loss = -q_rows.mean()
    actor_grads = grads_of(actor_loss, q, act.names)
    act.step(p, actor_grads)
    soft_update(p, TARGETS, cfg["tau"])
    by_leaf = dict(zip(sf.names + ph.names + act.names, sf_grads + phi_grads + actor_grads))
    return ({"sf_loss": float(sf_loss.detach()), "phi_loss": float(phi_loss.detach()),
             "actor_loss": float(actor_loss.detach())},
            {"sf_loss": float(sf_loss.detach()),
             "phi_loss": float((moved + orth_off.abs() + orth_diag.abs()).detach()),
             "actor_loss": float(q_rows.detach().abs().mean())}, by_leaf)


def settings(config: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """The update's numbers, read from the configuration's file."""
    a, replay = config["agent_config"], config["replay"]
    return {"lr": a["lr"], "batch_size": a["batch_size"], "tau": a["sf_target_tau"],
            "stddev": float(a["stddev_schedule"]), "stddev_clip": a["stddev_clip"],
            "goal_space": a["goal_space"], "discount": replay["discount"],
            "future": replay["future"]}


def update_flops(s: Shapes, n: int) -> int:
    """The model FLOPs of one update at batch ``n`` (``flops.py``)."""
    gram = 3 * 2 * n * n * s.z  # φ·φᵀ of the orthonormality loss, both gradients
    return (flops.backward_map(s, n, False)  # φ of the next goal
            + flops.actor_forward(s, n) + flops.forward_map(s, n, False, False)
            + flops.forward_map(s, n, True, True)
            + 2 * flops.backward_map(s, n, True) + gram
            + flops.actor_trained(s, n) + flops.forward_map(s, n, False, True))
