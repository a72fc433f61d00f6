"""Model FLOPs of one update, from the configuration's shapes.

Every dense product counts 2·m·k·n for its forward pass, and as much again
for each gradient the update needs: the weights' where that network is
being trained, the input's where a gradient flows on to something trained.
The FB loss counts its products as the plain formulation computes them
(the target measure's two n×n products, F1·Bᵀ and F2·Bᵀ with their
backward, B·Bᵀ with its backward), so the count is the same whatever
implements the loss. Elementwise work, norms and the optimizer count
nothing. Each agent's reference module sums its update from these pieces
(``update_flops(shapes, n)``); at small widths the sum equals what
``torch.utils.flop_counter`` sees in one eager update of the program with
the plain loss (``tests/test_perfbench_flops.py``).
"""

from __future__ import annotations

import typing as tp

from .reference.nets import Shapes


def _dense(m: int, dims: tp.Sequence[int], weights: bool, first_input: bool,
           inputs: bool = True) -> int:
    """One MLP over ``m`` rows with layer widths ``dims``: forward, the
    weights' gradients if ``weights``, the inputs' gradients if ``inputs``
    (the first layer's only if ``first_input``)."""
    total = 0
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        per = 2 * m * k * n
        total += per
        total += per if weights else 0
        total += per if inputs and (i > 0 or first_input) else 0
    return total


def _towers(s: Shapes, first: int) -> tp.List[int]:
    return [first, s.hidden, s.feature]


def _head(s: Shapes, out: int) -> tp.List[int]:
    return [2 * s.feature, s.hidden, out]


def actor_forward(s: Shapes, m: int) -> int:
    return (_dense(m, _towers(s, s.obs + s.z), False, False, False)
            + _dense(m, _towers(s, s.obs), False, False, False)
            + _dense(m, _head(s, s.action), False, False, False))


def actor_trained(s: Shapes, m: int) -> int:
    """The actor with every weight's gradient (its inputs are data)."""
    return (_dense(m, _towers(s, s.obs + s.z), True, False)
            + _dense(m, _towers(s, s.obs), True, False)
            + _dense(m, _head(s, s.action), True, True))


def forward_map(s: Shapes, m: int, weights: bool, grad: bool) -> int:
    """The twin forward map. ``grad``: a gradient flows through it,
    to its weights (``weights``) and, from the actor's loss, back to the
    action alone (through the (obs, action) tower and both heads)."""
    if not grad:
        return (_dense(m, _towers(s, s.obs + s.action), False, False, False)
                + _dense(m, _towers(s, s.obs + s.z), False, False, False)
                + 2 * _dense(m, _head(s, s.z), False, False, False))
    if weights:
        return (_dense(m, _towers(s, s.obs + s.action), True, False)
                + _dense(m, _towers(s, s.obs + s.z), True, False)
                + 2 * _dense(m, _head(s, s.z), True, True))
    return (_dense(m, _towers(s, s.obs + s.action), False, True)
            + _dense(m, _towers(s, s.obs + s.z), False, False, False)
            + 2 * _dense(m, _head(s, s.z), False, True))


def backward_map(s: Shapes, m: int, weights: bool) -> int:
    return _dense(m, [s.goal, s.backward_hidden, s.backward_hidden, s.z], weights, False,
                  weights)


def fb_loss(n: int, d: int) -> int:
    """The plain FB loss: target measure (2 products), M1 and M2 with
    both gradients, B·Bᵀ with both gradients."""
    product = 2 * n * n * d
    return 2 * product + 2 * 3 * product + 3 * product


def fused_fb_loss(n: int, d: int) -> tp.Tuple[int, int]:
    """(FLOPs, bytes) that the fused FB loss's four kernels cannot do
    without, forward and backward together: the four n×n products of the
    forward (M1, M2 and the target's two), the four of the backward (dF1,
    dF2 and dB's two), the d×d Gram matrix; each [n, d] float32 input read
    once per pass (six in, the discount beside), the three gradients
    written once."""
    flops = 8 * 2 * n * n * d + 2 * n * d * d
    read = 2 * (6 * n * d + n) * 4
    written = 3 * n * d * 4 + 4 * 4
    return flops, read + written
