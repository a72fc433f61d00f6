"""The port's networks (controllable_agent_torch/models/networks.py) against
the flax ones on converted weights, in float32 (and bf16 compute); and the
bf16 compute copies of a bf16 network's Dense weights against the autocast
path they replace, bit for bit, after every way of writing the weights."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.models import networks as jnets
from controllable_agent_torch import optim
from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig
from controllable_agent_torch.agents.ddpg import DDPGActor, DDPGCritic, RewardModel
from controllable_agent_torch.convert import flax_to_state_dict
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.models import networks as tnets
from controllable_agent_torch.utils import graphs, trace
from test_torch_trace import fake_graphs  # noqa: F401
from torch_threads import one_thread  # noqa: F401

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


# -- bf16 compute copies of the Dense layers' weights ------------------------
# Every network class with Dense layers, with its inputs' widths. A bf16
# network runs each Dense layer on bf16 copies of its weight and bias; the
# baseline is computed here as nn.Linear computes it: F.linear on the float32
# parameters under the network's autocast.
NETS = {
    "actor": (lambda dtype: tnets.Actor(OBS, Z, ACT, FEAT, HID, preprocess=True,
                                        dtype=dtype), (OBS, Z)),
    "actor_trunk": (lambda dtype: tnets.Actor(OBS, Z, ACT, FEAT, HID, preprocess=True,
                                              add_trunk=True, dtype=dtype), (OBS, Z)),
    "actor_plain": (lambda dtype: tnets.Actor(OBS, Z, ACT, FEAT, HID, preprocess=False,
                                              dtype=dtype), (OBS, Z)),
    "diag_gaussian_actor": (lambda dtype: tnets.DiagGaussianActor(OBS, Z, ACT, HID,
                                                                  dtype=dtype), (OBS, Z)),
    "forward_map": (lambda dtype: tnets.ForwardMap(OBS, Z, ACT, FEAT, HID, preprocess=True,
                                                   dtype=dtype), (OBS, Z, ACT)),
    "forward_map_plain": (lambda dtype: tnets.ForwardMap(OBS, Z, ACT, FEAT, HID,
                                                         preprocess=False, dtype=dtype),
                          (OBS, Z, ACT)),
    "discrete_forward_map": (lambda dtype: tnets.DiscreteForwardMap(
        OBS, Z, 4, FEAT, HID, preprocess=True, dtype=dtype), (OBS, Z)),
    "backward_map": (lambda dtype: tnets.BackwardMap(OBS, Z, HID, dtype=dtype), (OBS,)),
    "ddpg_actor": (lambda dtype: DDPGActor(OBS, ACT, HID, dtype), (OBS,)),
    "ddpg_critic": (lambda dtype: DDPGCritic(OBS, ACT, HID, dtype), (OBS, ACT)),
    "reward_model": (lambda dtype: RewardModel(OBS, HID, dtype), (OBS,)),
}


def _net(name, dtype=torch.bfloat16, seed=0):
    make, widths = NETS[name]
    torch.manual_seed(seed)
    net = make(dtype)
    with torch.no_grad():  # non-zero biases and LayerNorm parameters
        for k, p in net.named_parameters():
            if not k.endswith("weight") or "LayerNorm" in k:
                p.copy_(0.1 * torch.randn_like(p) + (1.0 if "LayerNorm" in k else 0.0))
    inputs = [torch.randn(5, w) for w in widths]
    return net, inputs


def _outputs(net, inputs):
    out = net(*inputs)
    return list(out) if isinstance(out, tuple) else [out]


def _baseline(net, inputs, monkeypatch):
    """The outputs of ``net`` with every Dense layer computed by
    ``nn.Linear.forward``: F.linear on the float32 parameters, which autocast
    casts at the use and whose gradients it widens to float32."""
    with monkeypatch.context() as m:
        m.setattr(tnets.Dense, "forward", torch.nn.Linear.forward)
        return _outputs(net, inputs)


def _loss(outputs):
    gen = torch.Generator().manual_seed(7)
    return sum((o.float() * torch.randn(o.shape, generator=gen)).sum() for o in outputs)


def _leaves(net):
    """Each parameter's bf16 copy where its layer keeps one, else the parameter."""
    params = list(net.parameters())
    return [p if c is None else c.copy for p, c in zip(params, optim.copies_of(net, params))]


def _assert_equal(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{what}[{i}]"


@pytest.mark.parametrize("name", list(NETS))
def test_bf16_copies_give_the_autocast_outputs_and_gradients_to_the_bit(name,
                                                                       monkeypatch) -> None:
    """(a) A bf16 network on its copies: the outputs, and the Linear
    gradients widened to float32 (the LayerNorm ones as they are), equal the
    baseline's to the bit; one ``bf16_copy.uses`` a Dense call."""
    net, inputs = _net(name)
    want = _baseline(net, inputs, monkeypatch)
    want_grads = torch.autograd.grad(_loss(want), list(net.parameters()))
    uses = trace.counters["bf16_copy.uses"]
    got = _outputs(net, inputs)
    dense = [m for m in net.modules() if isinstance(m, tnets.Dense)]
    assert dense and all(m.bf16 is not None for m in dense)
    assert trace.counters["bf16_copy.uses"] - uses >= len(dense)
    _assert_equal(got, want, "output")
    leaves = _leaves(net)
    grads = torch.autograd.grad(_loss(got), leaves)
    assert {g.dtype for g, leaf in zip(grads, leaves) if leaf.dtype == torch.bfloat16} \
        == {torch.bfloat16}
    _assert_equal([g.float() for g in grads], list(want_grads), "gradient")


def _write_no_grad_copy(net):
    """As the benchmark's weight loader writes: ``copy_`` into each tensor of
    ``state_dict()`` under ``no_grad``."""
    with torch.no_grad():
        for v in net.state_dict().values():
            v.copy_(1.5 * v + 0.01)


def _write_load_state_dict(net):
    net.load_state_dict({k: 0.5 * v - 0.02 for k, v in net.state_dict().items()})


def _write_in_place(net):
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(0.75)


def _write_to(net):
    """A move: each copy allocated anew, holding nothing yet; in between,
    float64 parameters keep none."""
    net.to(torch.float64)
    assert all(m.bf16 is None for m in net.modules() if isinstance(m, tnets.Dense))
    return net.to("cpu", torch.float32)


def _write_deepcopy(net):
    twin = copy.deepcopy(net)
    _write_in_place(twin)
    return twin


def _write_untracked(net):
    """A write the version counter does not see (through ``.data``, or a
    collective into a parameter) followed by the bump it owes."""
    for p in net.parameters():
        p.data.mul_(1.25)
        torch.autograd.graph.increment_version(p)


WRITES = {"no_grad_copy": _write_no_grad_copy, "load_state_dict": _write_load_state_dict,
          "in_place": _write_in_place, "to": _write_to, "deepcopy": _write_deepcopy,
          "untracked_then_bumped": _write_untracked}


@pytest.mark.parametrize("write", list(WRITES))
@pytest.mark.parametrize("name", ["actor", "forward_map", "backward_map", "ddpg_critic"])
def test_a_written_parameter_is_seen_and_its_copy_refreshed(name, write, monkeypatch) -> None:
    """(b) After each way of writing the parameters, their copies are stale,
    and the next forward refreshes them (each layer its own, one launch a
    layer) and equals the baseline on the new parameters to the bit."""
    net, inputs = _net(name)
    _outputs(net, inputs)  # the copies written
    written = WRITES[write](net) or net
    dense = [m for m in written.modules() if isinstance(m, tnets.Dense)]
    assert dense and all(m.bf16 is not None for m in dense)
    copies = [c for m in dense for c in m.bf16]
    assert all(c.stale() for c in copies)
    refreshes = trace.counters["bf16_copy.refreshes"]
    got = _outputs(written, inputs)
    assert trace.counters["bf16_copy.refreshes"] == refreshes + len(dense)
    assert not any(c.stale() for c in copies)
    _assert_equal(got, _baseline(written, inputs, monkeypatch), "output")
    if write == "deepcopy":  # the original keeps its own parameters and copies
        assert not any(c.stale() for m in net.modules() if isinstance(m, tnets.Dense)
                       for c in m.bf16)
        _assert_equal(_outputs(net, inputs), _baseline(net, inputs, monkeypatch), "original")


def test_a_layer_used_alone_refreshes_its_own_copies() -> None:
    """A Dense layer of a bf16 network called outside its network's
    forward (under autocast, as the network runs it) after its weight was
    written: it refreshes its copies itself, and equals ``nn.Linear`` on the
    new float32 parameters to the bit."""
    net, inputs = _net("backward_map")
    layer = net.mlps[0].Dense_0
    _outputs(net, inputs)
    with torch.no_grad():
        layer.weight.mul_(1.5)
    assert layer.bf16[0].stale() and not layer.bf16[1].stale()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = layer(inputs[0])
        want = torch.nn.Linear.forward(layer, inputs[0])
    assert not any(c.stale() for c in layer.bf16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_a_converted_flax_tree_is_seen_and_its_copy_refreshed(monkeypatch) -> None:
    """(b) ``convert.py``'s state dict loaded into a bf16 network: the next
    forward reads copies of the converted weights."""
    obs, z, act = _data((5, OBS), (5, Z), (5, ACT))
    ff = jnets.ForwardMap(z_dim=Z, feature_dim=FEAT, hidden_dim=HID, preprocess=True)
    params = ff.init(jax.random.key(9), *[jnp.asarray(v) for v in (obs, z, act)])
    net = tnets.ForwardMap(OBS, Z, ACT, FEAT, HID, preprocess=True, dtype=torch.bfloat16)
    inputs = [torch.from_numpy(v) for v in (obs, z, act)]
    _outputs(net, inputs)
    _port(net, params)
    assert all(c.stale() for m in net.modules() if isinstance(m, tnets.Dense) for c in m.bf16)
    _assert_equal(_outputs(net, inputs), _baseline(net, inputs, monkeypatch), "output")
    state = flax_to_state_dict(params)
    assert torch.equal(net.mlps[0].Dense_0.bf16[0].copy,
                       torch.as_tensor(np.asarray(state["mlps.0.Dense_0.weight"])).bfloat16())


@pytest.mark.parametrize("name", list(NETS))
def test_float32_networks_hold_no_copies(name) -> None:
    """(d) A float32 network's Dense layers keep no copy and count no use;
    a bf16 network's copies are none of its parameters, buffers or state."""
    net, inputs = _net(name, torch.float32)
    assert all(m.bf16 is None for m in net.modules() if isinstance(m, tnets.Dense))
    uses = trace.counters["bf16_copy.uses"]
    _outputs(net, inputs)
    assert trace.counters["bf16_copy.uses"] == uses
    bf16, _ = _net(name)
    copies = {id(c.copy) for m in bf16.modules() if isinstance(m, tnets.Dense)
              for c in m.bf16}
    assert not copies & {id(t) for t in [*bf16.parameters(), *bf16.buffers()]}
    assert not copies & {id(t) for t in bf16.state_dict().values()}
    assert list(bf16.state_dict()) == list(net.state_dict())


def test_a_bf16_agent_keeps_its_copies_out_of_its_train_state(monkeypatch) -> None:
    """(b) ``load_train_state`` after updates, as a resume does: the actor's
    next use reads copies of the loaded weights, and acts as the baseline
    does to the bit; no copy is among the train state's tensors."""
    agent = FBDDPGAgent(FBDDPGConfig(hidden_dim=HID, backward_hidden_dim=HID, feature_dim=FEAT,
                                     z_dim=Z, batch_size=16, compute_dtype="bfloat16"),
                        OBS, ACT, device="cpu", seed=1)
    saved = {k: v.clone() for k, v in agent.train_state().items()}
    copies = {id(c.copy) for m in agent.modules() if isinstance(m, tnets.Dense)
              for c in m.bf16}
    assert copies and not copies & {id(t) for t in agent.train_state().values()}
    gen = torch.Generator().manual_seed(0)
    batch = EpisodeBatch(*[torch.randn(16, w) for w in (OBS, ACT)], reward=torch.randn(16, 1),
                         discount=torch.full((16, 1), 0.98), next_obs=torch.randn(16, OBS))
    for _ in range(2):
        agent.update(batch, gen)
    agent.load_train_state(saved)
    obs, z = torch.randn(4, OBS), torch.randn(4, Z)
    refreshes = trace.counters["bf16_copy.refreshes"]
    got = agent.act(obs, z, 0, eval_mode=True)
    actor_layers = [m for m in agent.actor.modules() if isinstance(m, tnets.Dense)]
    assert trace.counters["bf16_copy.refreshes"] == refreshes + len(actor_layers)
    with monkeypatch.context() as m:
        m.setattr(tnets.Dense, "forward", torch.nn.Linear.forward)
        want = agent.act(obs, z, 0, eval_mode=True)
    assert torch.equal(got, want)


def test_captured_update_refreshes_before_the_capture_and_each_replay(fake_graphs) -> None:
    """A captured bf16 FB update (``CapturedProgram`` over stand-ins for the
    CUDA graphs, which run ``fn`` eagerly at capture and nothing at a
    replay): one replay uses 45 copies (fb_walker's structure: B for z, the
    actor, target F and B, F and B, the actor and F), refreshes none; the
    warm-up's changes put back are refreshed once before the capture; a
    replay after an eager write refreshes first, a replay after none does
    not."""
    agent = FBDDPGAgent(FBDDPGConfig(hidden_dim=HID, backward_hidden_dim=HID, feature_dim=FEAT,
                                     z_dim=Z, batch_size=16, compute_dtype="bfloat16"),
                        OBS, ACT, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(0)
    batch = EpisodeBatch(*[torch.randn(16, w) for w in (OBS, ACT)], reward=torch.randn(16, 1),
                         discount=torch.full((16, 1), 0.98), next_obs=torch.randn(16, OBS))
    agent.update(batch, gen)  # every copy written
    saved = {k: v.clone() for k, v in agent.train_state().items()}
    trace.reset_counters()
    program = graphs.CapturedProgram(lambda: agent.update(batch, gen), torch.device("cpu"),
                                     agent.train_state().values(), [gen])
    held = dict(next(h for counts, h in program.held if counts is trace.counters))
    assert held == {"physics3d.substeps": 0, "bf16_copy.uses": 45, "bf16_copy.refreshes": 0}
    # the two warm-up updates' uses, the refresh before the capture
    assert trace.counters == {"physics3d.substeps": 0, "bf16_copy.uses": 2 * 45,
                              "bf16_copy.refreshes": 1}
    assert len(program._fresh) == 2 * 28  # weight and bias of the five networks' Dense layers
    program.replay(3)
    assert trace.counters["bf16_copy.uses"] == 5 * 45
    assert trace.counters["bf16_copy.refreshes"] == 1
    agent.load_train_state(saved)
    program.replay()
    assert trace.counters["bf16_copy.refreshes"] == 2
    assert not any(c.stale() for c in program._fresh.values())
    program.replay()
    assert trace.counters["bf16_copy.refreshes"] == 2
    trace.reset_counters()
