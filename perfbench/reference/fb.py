"""The Forward-Backward agent's update in plain PyTorch (arXiv:2209.14935,
the FB-DDPG update of the repository's JAX package), float32.

One update: z drawn on the sphere of radius sqrt(d), replaced with
probability ``mix_ratio`` by B of a permuted batch of goals; the target
measure min(F1ᵀ B', F2ᵀ B') of the target networks at the next state and
goal; the FB loss (off-diagonal squared residuals against the discounted
target, minus the diagonal) plus the orthonormality loss of B; one Adam
step of F and one of B; then the actor's loss -min(F1·z, F2·z) through the
updated F and its Adam step; then the targets' soft update.
"""

from __future__ import annotations

import typing as tp

import torch

import math

from .. import flops
from . import nets
from .nets import Params, Products, Shapes
from .train import Adam, grads_of, soft_update, with_grad

Tensor = torch.Tensor

OPTIMIZERS = {"fw_opt": "forward_net", "bw_opt": "backward_net", "actor_opt": "actor"}
TARGETS = {"target_forward_net": "forward_net", "target_backward_net": "backward_net"}
LOSSES = ("fb_loss", "actor_loss")


def leaves(s: Shapes) -> tp.List[tp.Tuple[str, tp.Tuple[int, ...]]]:
    online = (nets.actor_shapes(s) + nets.forward_shapes(s, "forward_net")
              + nets.backward_shapes(s, "backward_net.mlps.0"))
    targets = [(t + name[len(o):], shape) for t, o in TARGETS.items()
               for name, shape in online if name.startswith(o + ".")]
    return online + targets


def _off_sum(x: Tensor) -> Tensor:
    n = x.shape[0]
    return torch.where(~torch.eye(n, dtype=torch.bool, device=x.device), x, 0.0).sum()


def fb_loss(f1: Tensor, f2: Tensor, b: Tensor, tf1: Tensor, tf2: Tensor, tb: Tensor,
            discount: Tensor, ortho_coef: float, prod: Products) -> tp.Tuple[Tensor, float]:
    """The loss, and its scale: the sum of its terms' magnitudes."""
    n = f1.shape[0]
    tm = torch.minimum(prod.mm(tf1, tb.T), prod.mm(tf2, tb.T))
    m1, m2 = prod.mm(f1, b.T), prod.mm(f2, b.T)
    offdiag = 0.5 * (_off_sum((m1 - discount * tm) ** 2)
                     + _off_sum((m2 - discount * tm) ** 2)) / (n * (n - 1))
    diag = -(m1.diagonal().sum() + m2.diagonal().sum()) / n
    cov = prod.mm(b, b.T)
    orth_off, orth_diag = _off_sum(cov ** 2) / (n * (n - 1)), -2.0 * cov.diagonal().sum() / n
    terms = offdiag.abs() + diag.abs() + ortho_coef * (orth_off.abs() + orth_diag.abs())
    scale = float(terms.detach())
    return offdiag + diag + ortho_coef * (orth_off + orth_diag), scale


def update(p: Params, opts: tp.Mapping[str, Adam], cfg: tp.Mapping[str, tp.Any], s: Shapes,
           batch: tp.Mapping[str, Tensor], noise: tp.Mapping[str, Tensor], prod: Products
           ) -> tp.Tuple[tp.Dict[str, float], tp.Dict[str, float], tp.Dict[str, Tensor]]:
    """One update of ``p`` in place; the losses, their scales (the sum of
    the magnitudes of their terms: of the rows' Q for the actor's) and the
    gradients by leaf."""
    std, clip = cfg["stddev"], cfg["stddev_clip"]
    obs, next_obs, action = batch["obs"], batch["next_obs"], batch["action"]
    with torch.no_grad():
        z = nets.l2_normalize(noise["z_normal"])
        mix_z = nets.l2_normalize(nets.backward_map(p, s, "backward_net.mlps.0",
                                                    batch["goal"][noise["perm"]], prod))
        z = torch.where(noise["mix_uniform"] < cfg["mix_ratio"], mix_z, z)
        mu = nets.actor(p, s, next_obs, z, prod)
        next_action = nets.truncated_sample(mu, noise["next_action_normal"], std, clip)
        tf1, tf2 = nets.forward_map(p, s, "target_forward_net", next_obs, z, next_action, prod)
        tb = nets.backward_map(p, s, "target_backward_net.mlps.0", batch["next_goal"], prod)

    fw, bw = opts["fw_opt"], opts["bw_opt"]
    q = with_grad(p, fw.names + bw.names)
    f1, f2 = nets.forward_map(q, s, "forward_net", obs, z, action, prod)
    b = nets.backward_map(q, s, "backward_net.mlps.0", batch["next_goal"], prod)
    loss, scale = fb_loss(f1, f2, b, tf1, tf2, tb, batch["discount"], cfg["ortho_coef"], prod)
    grads = grads_of(loss, q, fw.names + bw.names)
    fw.step(p, grads[:len(fw.names)])
    bw.step(p, grads[len(fw.names):])

    act = opts["actor_opt"]
    q = with_grad(p, act.names)
    a = nets.truncated_sample(nets.actor(q, s, obs, z, prod), noise["actor_normal"], std, clip)
    f1, f2 = nets.forward_map(q, s, "forward_net", obs, z, a, prod)
    q_rows = torch.minimum(nets.dot(f1, z), nets.dot(f2, z))
    actor_loss = -q_rows.mean()
    actor_grads = grads_of(actor_loss, q, act.names)
    act.step(p, actor_grads)
    soft_update(p, TARGETS, cfg["tau"])
    by_leaf = dict(zip(fw.names + bw.names + act.names, grads + actor_grads))
    return ({"fb_loss": float(loss.detach()), "actor_loss": float(actor_loss.detach())},
            {"fb_loss": scale, "actor_loss": float(q_rows.detach().abs().mean())}, by_leaf)


def settings(config: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """The update's numbers, read from the configuration's file."""
    a, replay = config["agent_config"], config["replay"]
    return {"lr": a["lr"], "batch_size": a["batch_size"], "tau": a["fb_target_tau"],
            "stddev": float(a["stddev_schedule"]), "stddev_clip": a["stddev_clip"],
            "mix_ratio": a["mix_ratio"], "ortho_coef": a["ortho_coef"],
            "update_z_every_step": a["update_z_every_step"],
            "discount": replay["discount"], "future": replay["future"]}


def update_flops(s: Shapes, n: int) -> int:
    """The model FLOPs of one update at batch ``n`` (``flops.py``)."""
    return (flops.backward_map(s, n, False)  # B of the permuted goals for the z mix
            + flops.actor_forward(s, n) + flops.forward_map(s, n, False, False)
            + flops.backward_map(s, n, False)  # the targets
            + flops.forward_map(s, n, True, True) + flops.backward_map(s, n, True)
            + flops.fb_loss(n, s.z)
            + flops.actor_trained(s, n) + flops.forward_map(s, n, False, True))


def act(p: Params, s: Shapes, obs: Tensor, z: Tensor, t: int, draws: tp.Mapping[str, Tensor],
        cfg: tp.Mapping[str, tp.Any], prod: Products) -> tp.Tuple[Tensor, Tensor]:
    """One collector step's (z, action) from the observation, the previous
    z and the step's draws: z resampled at the steps inside an episode that
    are multiples of ``update_z_every_step``, then the actor's mean plus
    ``stddev`` of a normal draw, clamped into (-1, 1)."""
    if t % cfg["update_z_every_step"] == 0:
        new = math.sqrt(s.z) * draws["z_normal"] / torch.linalg.vector_norm(
            draws["z_normal"], dim=-1, keepdim=True).clamp_min(1e-12)
        z = torch.where(draws["meta_uniform"] < 1.0, new, z)
    with torch.no_grad():
        mu = nets.actor(p, s, obs, z, prod)
        return z, nets.truncated_sample(mu, draws["act_normal"], cfg["stddev"], None)
