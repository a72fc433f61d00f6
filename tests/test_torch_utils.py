"""The port's small modules against the JAX package's: schedules,
distributions, soft updates, cadence helpers, sample_z, the eager FB losses
and the config system."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu import config as jconfig
from controllable_agent_tpu.ops import fb as jfb
from controllable_agent_tpu.train.workspace import WorkspaceConfig as JaxWorkspaceConfig
from controllable_agent_tpu.utils import distributions as jdist
from controllable_agent_tpu.utils.schedules import schedule as jschedule
from controllable_agent_tpu.utils.steps import crossed as jcrossed
from controllable_agent_tpu.utils.tree import soft_update as jsoft_update
from controllable_agent_torch import config as tconfig
from controllable_agent_torch.agents import FBDDPGConfig
from controllable_agent_torch.convert import flax_to_state_dict
from controllable_agent_torch.models.networks import MLP
from controllable_agent_torch.ops import fb as tfb
from controllable_agent_torch.train.workspace import WorkspaceConfig
from controllable_agent_torch.utils import Stopwatch, crossed, resolve_device
from controllable_agent_torch.utils import distributions as tdist
from controllable_agent_torch.utils.schedules import schedule
from controllable_agent_torch.utils.tree import soft_update

RTOL, ATOL = 1e-5, 1e-6  # float32 elementwise math in another order


def _close(got, want, rtol=RTOL, atol=ATOL) -> None:
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("spec", ["0.2", "linear(1.0,0.1,100)",
                                  "step_linear(1.0,0.5,50,0.1,100)"])
def test_schedule(spec) -> None:
    for step in (0, 1, 25, 50, 51, 99, 100, 149, 150, 1000):
        assert schedule(spec)(step) == pytest.approx(float(jschedule(spec)(step)), rel=1e-6)
    with pytest.raises(NotImplementedError):
        schedule("cosine(1)")


def _normal_and_loc(seed: int = 0):
    key = jax.random.key(seed)
    k_loc, k_noise = jax.random.split(key)
    loc = jax.random.normal(k_loc, (7, 3)) * 0.8
    return loc, k_noise, np.array(jax.random.normal(k_noise, (7, 3)))


@pytest.mark.parametrize("clip", [None, 0.3])
def test_truncated_normal(clip) -> None:
    loc, key, normal = _normal_and_loc()
    jd = jdist.TruncatedNormal(loc, jnp.ones_like(loc) * 0.5)
    want = jd.sample(key, clip=clip)
    loc_t = torch.from_numpy(np.array(loc)).requires_grad_(True)
    td = tdist.TruncatedNormal(loc_t, 0.5)
    got = td.sample(torch.from_numpy(normal), clip=clip)
    _close(got, want)
    _close(td.log_prob(got), jd.log_prob(want))
    # straight-through clamp: the gradient of the sample w.r.t. loc is 1
    got.sum().backward()
    _close(loc_t.grad, jax.grad(lambda m: jdist.TruncatedNormal(
        m, jnp.ones_like(m) * 0.5).sample(key, clip=clip).sum())(loc))


def test_squashed_normal() -> None:
    loc, key, normal = _normal_and_loc(1)
    scale = jnp.exp(loc * 0.3)
    jd = jdist.SquashedNormal(loc, scale)
    td = tdist.SquashedNormal(torch.from_numpy(np.array(loc)),
                              torch.from_numpy(np.array(scale)))
    got, pre = td.sample_with_pre_tanh(torch.from_numpy(normal))
    want, want_pre = jd.sample_with_pre_tanh(key)
    _close(got, want)
    _close(td.sample(torch.from_numpy(normal)), jd.sample(key))
    _close(td.log_prob_from_pre_tanh(pre), jd.log_prob_from_pre_tanh(want_pre), atol=1e-5)
    _close(td.log_prob(got), jd.log_prob(want), rtol=1e-4, atol=1e-4)
    _close(td.mean, jd.mean)


def test_soft_update_in_place() -> None:
    torch.manual_seed(0)
    net, target = MLP(4, (5, "ntanh", 3)), MLP(4, (5, "ntanh", 3))
    flax = lambda m: {k: v.numpy().T if k.endswith("Dense_0.weight") or  # noqa: E731
                      k.endswith("Dense_1.weight") else v.numpy()
                      for k, v in m.state_dict().items()}
    want = jsoft_update(flax(net), flax(target), 0.01)
    soft_update(net, target, 0.01)
    for k, v in flax(target).items():
        _close(v, want[k])


def test_crossed_and_stopwatch() -> None:
    for step in range(0, 1200, 37):
        for every in (None, 0, 100, 250):
            for stride in (1, 50, 200):
                assert crossed(step, every, stride) == jcrossed(step, every, stride)
    sw = Stopwatch()
    lap, total = sw.lap()
    assert 0 <= lap <= total <= sw.total


@pytest.mark.parametrize("norm_z", [True, False])
def test_sample_z(norm_z) -> None:
    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)
    normal = torch.from_numpy(np.array(jax.random.normal(k1, (9, 5))))
    uniform = torch.from_numpy(np.array(jax.random.uniform(k2, (9, 5))))
    _close(tfb.sample_z(normal, uniform, norm_z), jfb.sample_z(key, 9, 5, norm_z))


def test_eager_fb_losses() -> None:
    rng = np.random.RandomState(0)
    f1, f2, b, tm = (rng.randn(12, 12 if i == 3 else 4).astype(np.float32)
                     for i in range(4))
    disc = rng.uniform(0.9, 1, (12, 1)).astype(np.float32)
    t = torch.from_numpy
    for got, want in zip(tfb.fb_loss_terms(t(f1), t(f2), t(b), t(tm), t(disc)),
                         jfb.fb_loss_terms(f1, f2, b, tm, disc)):
        _close(got, want)
    for got, want in zip(tfb.orthonormality_loss(t(b)), jfb.orthonormality_loss(b)):
        _close(got, want)


def test_config_overrides_match_the_jax_config() -> None:
    overrides = ["z_dim=16", "use_pallas_loss=true", "log_std_bounds=-4,1",
                 "goal_space=none", "stddev_schedule=linear(1,0.1,10)", "lr=3e-4"]
    got = tconfig.apply_overrides(FBDDPGConfig(), overrides)
    want = jconfig.apply_overrides(FBDDPGConfig(), overrides)
    assert tconfig.to_flat_dict(got, "agent.") == jconfig.to_flat_dict(want, "agent.")
    assert got.log_std_bounds == (-4.0, 1.0) and got.use_pallas_loss is True
    with pytest.raises(ValueError, match="Unknown override keys"):
        tconfig.apply_overrides(FBDDPGConfig(), ["nope=1"])
    with pytest.raises(ValueError, match="key=value"):
        tconfig.apply_overrides(FBDDPGConfig(), ["z_dim"])


def test_workspace_config_has_the_jax_fields_plus_device() -> None:
    ours = dataclasses.asdict(WorkspaceConfig())
    theirs = dataclasses.asdict(JaxWorkspaceConfig())
    assert ours.pop("device") == "cuda"
    assert ours == theirs


def test_flax_names_map_onto_the_port() -> None:
    tree = {"params": {"MLP_1": {"Dense_0": {"kernel": np.ones((3, 2)), "bias": np.zeros(2)},
                                 "LayerNorm_0": {"scale": np.ones(2), "bias": np.zeros(2)}}}}
    sd = flax_to_state_dict(tree)
    assert sorted(sd) == ["mlps.1.Dense_0.bias", "mlps.1.Dense_0.weight",
                          "mlps.1.LayerNorm_0.bias", "mlps.1.LayerNorm_0.weight"]
    assert sd["mlps.1.Dense_0.weight"].shape == (2, 3)


def test_resolve_device(monkeypatch) -> None:
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
