"""The port's networks (controllable_agent_torch/models/networks.py) against
the flax ones on converted weights, in float32 (and bf16 compute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.models import networks as jnets
from controllable_agent_torch.convert import flax_to_state_dict
from controllable_agent_torch.models import networks as tnets

OBS, Z, ACT, FEAT, HID = 6, 8, 3, 16, 32
RTOL, ATOL = 1e-5, 1e-5  # float32 products of width <= 64, summed in another order


def _data(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _port(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(flax_params))  # strict: names must match
    return module


def _close(got, want) -> None:
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32),
                                   rtol=RTOL, atol=ATOL)


def test_mlp_spec_language() -> None:
    layers = (16, "ntanh", 12, "irelu", 12, "relu", 10, "layernorm", "tanh", 8, "L2")
    (x,) = _data((5, 7))
    fm = jnets.MLP(layers=layers)
    params = fm.init(jax.random.key(0), jnp.asarray(x))
    tm = _port(tnets.MLP(7, layers), params)
    _close(tm(torch.from_numpy(x)), fm.apply(params, jnp.asarray(x)))
    with pytest.raises(ValueError, match="Unknown non-linearity"):
        tnets.MLP(7, (4, "gelu"))


@pytest.mark.parametrize("preprocess,add_trunk", [(True, False), (True, True), (False, False)])
def test_actor(preprocess, add_trunk) -> None:
    obs, z = _data((5, OBS), (5, Z))
    fa = jnets.Actor(z_dim=Z, action_dim=ACT, feature_dim=FEAT, hidden_dim=HID,
                     preprocess=preprocess, add_trunk=add_trunk)
    params = fa.init(jax.random.key(1), jnp.asarray(obs), jnp.asarray(z))
    ta = _port(tnets.Actor(OBS, Z, ACT, FEAT, HID, preprocess=preprocess,
                           add_trunk=add_trunk), params)
    _close(ta(torch.from_numpy(obs), torch.from_numpy(z)),
           fa.apply(params, jnp.asarray(obs), jnp.asarray(z)))


@pytest.mark.parametrize("preprocess,add_trunk", [(True, False), (True, True), (False, False)])
def test_forward_map(preprocess, add_trunk) -> None:
    obs, z, act = _data((5, OBS), (5, Z), (5, ACT))
    ff = jnets.ForwardMap(z_dim=Z, feature_dim=FEAT, hidden_dim=HID,
                          preprocess=preprocess, add_trunk=add_trunk)
    args = [jnp.asarray(v) for v in (obs, z, act)]
    params = ff.init(jax.random.key(2), *args)
    tf = _port(tnets.ForwardMap(OBS, Z, ACT, FEAT, HID, preprocess=preprocess,
                                add_trunk=add_trunk), params)
    _close(tf(*map(torch.from_numpy, (obs, z, act))), ff.apply(params, *args))


@pytest.mark.parametrize("norm_z", [True, False])
def test_backward_map(norm_z) -> None:
    (goal,) = _data((5, OBS))
    fb = jnets.BackwardMap(z_dim=Z, hidden_dim=HID, norm_z=norm_z)
    params = fb.init(jax.random.key(3), jnp.asarray(goal))
    tb = _port(tnets.BackwardMap(OBS, Z, HID, norm_z=norm_z), params)
    _close(tb(torch.from_numpy(goal)), fb.apply(params, jnp.asarray(goal)))


def test_diag_gaussian_actor() -> None:
    obs, z = _data((5, OBS), (5, Z))
    fa = jnets.DiagGaussianActor(z_dim=Z, action_dim=ACT, hidden_dim=HID,
                                 log_std_bounds=(-4.0, 1.5))
    params = fa.init(jax.random.key(4), jnp.asarray(obs), jnp.asarray(z))
    ta = _port(tnets.DiagGaussianActor(OBS, Z, ACT, HID, log_std_bounds=(-4.0, 1.5)), params)
    _close(ta(torch.from_numpy(obs), torch.from_numpy(z)),
           fa.apply(params, jnp.asarray(obs), jnp.asarray(z)))


def test_identity_map() -> None:
    (x,) = _data((3, 4))
    params = jnets.IdentityMap().init(jax.random.key(5), jnp.asarray(x))
    tm = _port(tnets.IdentityMap(), params)
    _close(tm(torch.from_numpy(x)), x)


def test_l2_normalize_clamps_the_norm() -> None:
    x = np.concatenate([_data((4, 6))[0], np.zeros((1, 6), np.float32)])
    _close(tnets.l2_normalize(torch.from_numpy(x)), jnets.l2_normalize(jnp.asarray(x)))
    _close(tnets.l2_normalize(torch.from_numpy(x), scale_sqrt_dim=False),
           jnets.l2_normalize(jnp.asarray(x), scale_sqrt_dim=False))


def test_init_is_orthogonal_with_zero_bias_and_unit_layernorm() -> None:
    torch.manual_seed(0)
    mlp = tnets.MLP(20, (10, "ntanh", 30))
    w0, w1 = mlp.Dense_0.weight, mlp.Dense_1.weight
    torch.testing.assert_close(w0 @ w0.T, torch.eye(10), atol=1e-5, rtol=0)
    torch.testing.assert_close(w1.T @ w1, torch.eye(10), atol=1e-5, rtol=0)
    assert not mlp.Dense_0.bias.any() and not mlp.Dense_1.bias.any()
    assert mlp.LayerNorm_0.eps == 1e-5 and bool((mlp.LayerNorm_0.weight == 1).all())


def test_bf16_compute_keeps_f32_params() -> None:
    """compute dtype bf16: the flax and port nets both return bf16 from f32
    parameters; they round at other places, so they agree to bf16 precision
    (rtol/atol 3e-2) rather than bit for bit."""
    obs, z, act = _data((5, OBS), (5, Z), (5, ACT))
    ff = jnets.ForwardMap(z_dim=Z, feature_dim=FEAT, hidden_dim=HID,
                          preprocess=True, dtype=jnp.bfloat16)
    args = [jnp.asarray(v) for v in (obs, z, act)]
    params = ff.init(jax.random.key(6), *args)
    tf = _port(tnets.ForwardMap(OBS, Z, ACT, FEAT, HID, preprocess=True,
                                dtype=torch.bfloat16), params)
    got = tf(*map(torch.from_numpy, (obs, z, act)))
    want = ff.apply(params, *args)
    assert all(p.dtype == torch.float32 for p in tf.parameters())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().detach().numpy(), np.asarray(w, np.float32),
                                   rtol=3e-2, atol=3e-2)
