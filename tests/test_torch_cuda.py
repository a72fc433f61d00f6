"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card. This file imports nothing of JAX, so that it runs
on a machine that has PyTorch for CUDA and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from controllable_agent_torch import optim, pretrain
from controllable_agent_torch.agents import (AGENTS, DDPGAgent, DDPGConfig, DDPGNoise,
                                             DiscreteFBAgent, DiscreteFBConfig, DiscreteSFAgent,
                                             DiscreteSFConfig, FBDDPGAgent, FBDDPGConfig,
                                             RNDAgent, RNDConfig, SFAgent, SFConfig, SFSVDAgent,
                                             SFSVDConfig, UpdateNoise)
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data import replay as replay_lib
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.data.exorl import synthetic_episodes
from controllable_agent_torch.envs import (build_gridworld_task, gridworld, jaco, locomotion,
                                           pointmass, quadruped)
from controllable_agent_torch.envs.pixels import make_pixel_env
from controllable_agent_torch.envs.wrappers import (ActionRepeatWrapper, FrameStackWrapper,
                                                    StatefulEnv)
from controllable_agent_torch.models.networks import Dense, PixelEncoder
from controllable_agent_torch.goals import get_reward_function
from controllable_agent_torch.ops import fused_fb as ff
from controllable_agent_torch.ops.linalg import lstsq
from controllable_agent_torch.tools import dynamics_check
from controllable_agent_torch.train.loops import (WARMUP_RUNS, CapturedProgram,
                                                  EpisodeCollector, OnlineTrainer, Rollout,
                                                  init_meta_batched, make_offline_trainer)
from controllable_agent_torch.utils import trace


@pytest.fixture
def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


def _inputs(n: int, d: int, seed: int, device: torch.device):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(n, d).astype(np.float32) for _ in range(6)]
    xs.append(rng.uniform(0.9, 1.0, (n, 1)).astype(np.float32))
    return [torch.from_numpy(x).to(device) for x in xs]


def _cotangent(n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([0.5 / (n * (n - 1)), -1.0 / n, 1.0 / (n * (n - 1)), -2.0 / n],
                        device=device)


def _assert_sums_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """rtol 2e-4 (f32 sums in another order); atol 1e-3 for a diagonal sum of
    random inputs that cancels towards 0."""
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1024, 50), (300, 50), (2, 50), (4096, 50), (300, 13),
                                 (300, 64)],
                         ids=["batch", "ragged", "smallest", "large", "odd_width", "widest"])
def test_kernels_match_plain(cuda_device, n, d) -> None:
    """Sums at rtol 2e-4 (f32 sums in another order) and gradients at 1e-4 of
    their largest entry; each wrapper counts exactly one launch. An odd width
    takes the 4-byte staging path; 64 the kernels' widest instance."""
    args = _inputs(n, d, n, cuda_device)
    g = _cotangent(n, cuda_device)
    before = dict(ff.launches)
    _assert_sums_close(ff.fwd(*args), ff.fwd_plain(*args))
    for got, want in zip(ff.bwd(*args, g), ff.bwd_plain(*args, g)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    torch.cuda.synchronize()
    assert set(before) == {"fwd", "bwd"}
    assert all(ff.launches[k] == before[k] + 1 for k in before)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 300], ids=["batch", "ragged"])
def test_forward_is_bitwise_repeatable(cuda_device, n) -> None:
    """The forward sums its per-tile partials in a fixed order, so two calls
    on the same inputs give the same bits."""
    args = _inputs(n, 50, n + 2, cuda_device)
    first, second = ff.fwd(*args), ff.fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_forward_replays_in_a_cuda_graph(cuda_device) -> None:
    """Captured once and replayed twice, on inputs changed in between, the
    forward gives each input's own sums: nothing is left over from a replay."""
    first = _inputs(300, 50, 11, cuda_device)
    other = _inputs(300, 50, 12, cuda_device)
    want = [ff.fwd_plain(*first), ff.fwd_plain(*other)]
    args = [x.clone() for x in first]  # the graph's inputs, overwritten below
    ff.fwd(*args)  # builds the kernel and opts into its shared memory
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ff.fwd(*args)
    got = []
    for xs in (other, first, other):
        for dst, src in zip(args, xs):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        got.append(out.clone())
    _assert_sums_close(got[0], want[1])
    _assert_sums_close(got[1], want[0])
    assert torch.equal(got[0], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 300], ids=["batch", "ragged"])
def test_backward_is_bitwise_repeatable(cuda_device, n) -> None:
    """The backward sums its per-tile partials in a fixed order, so two calls
    on the same inputs give the same bits."""
    args = _inputs(n, 50, n + 1, cuda_device)
    g = _cotangent(n, cuda_device)
    first, second = ff.bwd(*args, g), ff.bwd(*args, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _shifted_by_one_float(xs, cuda_device):
    """Contiguous copies that start 4 bytes off an 8-byte boundary."""
    shifted = []
    for x in xs:
        buf = torch.empty(x.numel() + 1, device=cuda_device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        shifted.append(view)
    assert all(x.data_ptr() % 8 == 4 for x in shifted)
    return shifted


@pytest.mark.cuda
def test_forward_takes_rows_that_are_not_8_byte_aligned(cuda_device) -> None:
    """Contiguous views at an odd float offset take the 4-byte staging path."""
    args = _inputs(300, 50, 9, cuda_device)
    shifted = _shifted_by_one_float(args[:6], cuda_device)
    _assert_sums_close(ff.fwd(*shifted, args[6]), ff.fwd_plain(*args))


@pytest.mark.cuda
def test_backward_takes_rows_that_are_not_8_byte_aligned(cuda_device) -> None:
    """Contiguous views at an odd float offset take the 4-byte staging path."""
    n, d = 300, 50
    args = _inputs(n, d, 7, cuda_device)
    shifted = _shifted_by_one_float(args[:6], cuda_device)
    g = _cotangent(n, cuda_device)
    for got, want in zip(ff.bwd(*shifted, args[6], g), ff.bwd_plain(*args, g)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device) -> None:
    args = _inputs(16, 50, 0, cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        ff.fwd(*[x.double() for x in args])
    with pytest.raises(ValueError, match="contiguous float32"):
        ff.fwd(*args[:2], args[2].T.contiguous().T, *args[3:])
    with pytest.raises(ValueError, match="d <= 64"):
        ff.fwd(*[torch.zeros(16, 65, device=cuda_device)] * 6, args[6])


SMALL = dict(hidden_dim=64, backward_hidden_dim=64, feature_dim=32, z_dim=16, batch_size=128,
             use_pallas_loss=True, compute_dtype="bfloat16",
             stddev_schedule="linear(1.0,0.1,4)")


def _agent_and_buffer(cuda_device):
    agent = FBDDPGAgent(FBDDPGConfig(**SMALL), 24, 6, device=cuda_device, seed=0)
    buf = ReplayBuffer(8, discount=0.98, future=0.99, device=cuda_device)
    buf.load_episodes(synthetic_episodes(8, 50, 24, 6, seed=0))
    return agent, buf


@pytest.mark.cuda
def test_captured_update_matches_eager(cuda_device) -> None:
    """The same updates from the same state, batch and noise through a
    captured program and eagerly: the same kernels in the same order, so
    every tensor of the train state agrees to the bit (the step counter and
    Adam's counts advance inside the replays; the schedule follows them)."""
    agent, buf = _agent_and_buffer(cuda_device)
    twin = FBDDPGAgent(agent.cfg, 24, 6, device=cuda_device, seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    batch = buf.sample(gen, 128)
    noise = UpdateNoise.draw(agent.cfg, 128, 6, gen, cuda_device)
    ff.reset_launches()
    program = CapturedProgram(lambda: agent._update(batch, noise), agent.device,
                              agent.train_state().values())
    assert agent.step == 0 and ff.launches == {"fwd": WARMUP_RUNS, "bwd": WARMUP_RUNS}
    assert next(h for c, h in program.held if c is ff.launches) == {"fwd": 1, "bwd": 1}
    assert ff.device_runs() == ff.launches  # the capture itself ran nothing
    program.replay(3)
    assert ff.launches == {"fwd": WARMUP_RUNS + 3, "bwd": WARMUP_RUNS + 3}
    assert ff.device_runs() == ff.launches  # counted by the kernels inside the replays
    for _ in range(3):
        twin._update(batch, noise)
    torch.cuda.synchronize()
    assert agent.step == twin.step == 3 and agent.fw_opt.count == 3
    for k, v in twin.train_state().items():
        assert torch.equal(agent.train_state()[k], v), k


@pytest.mark.cuda
def test_replays_draw_fresh_noise_and_batches(cuda_device) -> None:
    """The generator is registered with the graph: each replay samples
    another batch and draws other noise, and the generator moves on as it
    would under eager draws."""
    agent, buf = _agent_and_buffer(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def draw():
        batch = replay_lib.sample(buf.state, gen, 128, buf.cfg)
        return batch.obs, UpdateNoise.draw(agent.cfg, 128, 6, gen, cuda_device).z_normal

    program = CapturedProgram(draw, agent.device, generators=[gen])
    seen = []
    for _ in range(3):
        program.replay()
        torch.cuda.synchronize()
        seen.append([x.clone() for x in program.out])
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert not torch.equal(seen[a][0], seen[b][0])
        assert not torch.equal(seen[a][1], seen[b][1])
    # the same seed replays the same stream
    gen.manual_seed(2)
    program.replay()
    torch.cuda.synchronize()
    assert torch.equal(program.out[0], seen[0][0]) and torch.equal(program.out[1], seen[0][1])


@pytest.mark.cuda
def test_captured_trainer_trains_and_counts(cuda_device) -> None:
    """The trainer on the card replays a graph: the counters move by the
    updates it replays, consecutive calls give different losses, the agent's
    step follows, and a grown buffer makes it capture anew."""
    agent, buf = _agent_and_buffer(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    trainer = make_offline_trainer(agent, buf.cfg, 128, steps_per_call=6)
    ff.reset_launches()
    first = float(trainer(buf.state, gen)["fb_loss"])
    assert ff.launches == {"fwd": WARMUP_RUNS + 6, "bwd": WARMUP_RUNS + 6} and agent.step == 6
    second = float(trainer(buf.state, gen)["fb_loss"])
    assert ff.launches["fwd"] == WARMUP_RUNS + 12 and agent.step == 12
    assert np.isfinite([first, second]).all() and first != second
    grown = ReplayBuffer(9, discount=0.98, future=0.99, device=cuda_device)
    grown.load_episodes(synthetic_episodes(9, 50, 24, 6, seed=1))
    trainer(grown.state, gen)
    assert ff.launches["fwd"] == 2 * WARMUP_RUNS + 18 and agent.step == 18
    assert ff.device_runs() == ff.launches
    eager = make_offline_trainer(agent, buf.cfg, 128, steps_per_call=2, capture=False)
    assert np.isfinite(float(eager(buf.state, gen)["fb_loss"])) and agent.step == 20


@pytest.mark.cuda
def test_traced_trainer_marks_every_replay(cuda_device) -> None:
    """Tracing on makes the trainer capture anew with its device spans'
    marks (``sample``, ``update`` and FB's five optimizer steps: seven
    pairs a replay), which every replay runs and the profiler sees; the
    updates are those of an untraced twin to the bit; tracing off captures
    again, without marks."""
    a, buf = _agent_and_buffer(cuda_device)
    b, _ = _agent_and_buffer(cuda_device)
    gen_a = torch.Generator(device=cuda_device).manual_seed(3)
    gen_b = torch.Generator(device=cuda_device).manual_seed(3)
    traced = make_offline_trainer(a, buf.cfg, 128, steps_per_call=3)
    plain = make_offline_trainer(b, buf.cfg, 128, steps_per_call=3)
    trace.reset_captures()
    try:
        traced(buf.state, gen_a)
        trace.enable()
        traced(buf.state, gen_a)  # captured anew, its warm-up runs marked too
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            traced(buf.state, gen_a)
            torch.cuda.synchronize()
    finally:
        trace.disable()
    traced(buf.state, gen_a)
    for _ in range(4):
        plain(buf.state, gen_b)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    spans = trace.device_span_names()
    assert sorted(spans.values()) == ["optimizer", "sample", "update"]
    for i, name in spans.items():
        per_update = 5 if name == "optimizer" else 1
        assert names.count(f"trace_begin_{i}") == names.count(f"trace_end_{i}") == 3 * per_update
    assert [(r.name, r.marks) for r in trace.captures()] == [
        ("trainer", 0), ("trainer", 14), ("trainer", 0), ("trainer", 0)]  # the last: plain's
    assert traced.captures == 3 and plain.captures == 1
    for k, v in b.train_state().items():
        assert torch.equal(a.train_state()[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["walker_walk", "walker_flip", "cheetah_run", "hopper_hop"])
def test_relabel_on_the_card_matches_the_cpu(cuda_device, task) -> None:
    """The same reward functions on the card and on the CPU (atol 1e-5: the
    device's sin, cos and exp differ from the host's in the last bits)."""
    ndof = 7 if task.startswith("hopper") else 9
    rng = np.random.RandomState(4)
    q = rng.uniform(-1, 1, (16, 101, ndof))
    q[..., 1] = rng.uniform(0.3, 1.6, (16, 101))
    physics = np.concatenate([q, rng.randn(16, 101, ndof) * 2], -1).astype(np.float32)
    episodes = [{"observation": np.zeros((101, 3), np.float32),
                 "action": np.zeros((101, 2), np.float32),
                 "reward": np.zeros((101, 1), np.float32),
                 "discount": np.ones((101, 1), np.float32), "physics": p} for p in physics]
    reward = get_reward_function(task)
    buf = ReplayBuffer(16, discount=0.98, future=0.99, device=cuda_device)
    buf.load_episodes(episodes)
    buf.relabel(reward.from_physics)
    want = reward.from_physics(torch.from_numpy(physics))
    got = buf.state.storage["reward"][:, :, 0]
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("domain", dynamics_check.DOMAINS)
def test_dynamics_on_the_card_match_the_cpu(cuda_device, domain) -> None:
    """``forward_dynamics`` and one control step on the card against float64
    on the CPU, by the comparison the smoke run shares: 1e-4 and 1e-3 of each
    output's largest entry (a float32 LU of the mass matrix, stiff contacts),
    with the share of states that may cross a contact gate in another substep
    and their bound as ``tools/dynamics_check.py`` states them."""
    _, held = dynamics_check.check_domain(domain, 4096, cuda_device, seed=0)
    assert all(h.ok for h in held), "; ".join(str(h) for h in held)


@pytest.mark.cuda
@pytest.mark.parametrize("domain", dynamics_check.DOMAINS_3D)
def test_3d_dynamics_on_the_card_match_the_cpu(cuda_device, domain) -> None:
    """The 3-D engine's ``forward_dynamics`` and one control step on the card
    against float64 on the CPU, by the comparison the smoke run shares, with
    each model's allowance as ``tools/dynamics_check.py`` states it."""
    pressed, held = dynamics_check.check_domain(domain, 4096, cuda_device, seed=0)
    assert 0.05 < pressed < 0.95
    assert all(h.ok for h in held), "; ".join(str(h) for h in held)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["quadruped_walk", "quadruped_escape", "quadruped_fetch",
                                  "jaco_reach_top_left"])
def test_captured_3d_control_step_equals_the_eager_one(cuda_device, task) -> None:
    """The quadruped's (flat, escape, fetch) and jaco's control step as
    replays of one captured step against the same steps run eagerly, in the
    greedy rollout and in the exploring collector: equal to the bit."""
    env = (jaco.make(task, 10) if task.startswith("jaco") else quadruped.make(task, 10))
    cfg = FBDDPGConfig(**ONLINE_SMALL, compute_dtype="bfloat16")
    agent = FBDDPGAgent(cfg, env.spec.obs_dim, env.spec.action_dim, device=cuda_device, seed=2)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    z = agent.sample_z(6, gen)
    state, ts = env.reset(gen, 6)
    captured = Rollout(env, agent, 6)
    got = [x.clone() for x in captured(z, state, ts)]
    want = Rollout(env, agent, 6, capture=False)(z, state, ts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(torch.isfinite(got[1]).all()) and float(got[1].abs().max()) > 0.0
    gens = [torch.Generator(device=cuda_device).manual_seed(9) for _ in range(2)]
    runs = []
    for capture, g in zip((True, False), gens):
        collector = EpisodeCollector(env, agent, 4, g, capture=capture)
        meta = init_meta_batched(agent, g, 4)
        state, ts = env.reset(g, 4)
        runs.append({k: v.clone() for k, v in collector(meta, state, ts, 0).items()})
    for name, want in runs[1].items():
        assert torch.equal(runs[0][name], want), name
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["walker_walk", "hopper_hop", "point_mass"])
def test_captured_rollout_equals_the_eager_one(cuda_device, task) -> None:
    """The rollout as replays of one captured step against the same steps run
    eagerly, from the same initial states under a z per episode: equal to the
    bit; a second run from other states and z gives other trajectories."""
    env = (pointmass.PointMassMaze("reach_top_left", 12) if task == "point_mass"
           else locomotion.make(task, 12))
    cfg = FBDDPGConfig(hidden_dim=64, backward_hidden_dim=64, feature_dim=32, z_dim=16,
                       compute_dtype="bfloat16")
    agent = FBDDPGAgent(cfg, env.spec.obs_dim, env.spec.action_dim, device=cuda_device, seed=2)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    captured, eager = Rollout(env, agent, 6), Rollout(env, agent, 6, capture=False)
    assert captured.capture and not eager.capture
    seen = []
    for _ in range(2):
        z = agent.sample_z(6, gen)
        state, ts = env.reset(gen, 6)
        got = [x.clone() for x in captured(z, state, ts)]
        want = eager(z, state, ts)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert bool(torch.isfinite(got[1]).all()) and float(got[1].abs().max()) > 0.0
        seen.append(got[1])
    assert not torch.equal(seen[0], seen[1])
    assert int(captured._index) == 12 and captured._program is not None


@pytest.mark.cuda
def test_captured_rollout_of_a_one_step_episode(cuda_device) -> None:
    """An episode shorter than the capture's usual warm-up: the warm-up stays
    inside the [E, T, .] buffers and the one replayed step equals the eager one."""
    env = locomotion.make("hopper_hop", 1)
    cfg = FBDDPGConfig(hidden_dim=64, backward_hidden_dim=64, feature_dim=32, z_dim=16)
    agent = FBDDPGAgent(cfg, env.spec.obs_dim, env.spec.action_dim, device=cuda_device, seed=2)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    z = agent.sample_z(4, gen)
    state, ts = env.reset(gen, 4)
    got = [x.clone() for x in Rollout(env, agent, 4)(z, state, ts)]
    want = Rollout(env, agent, 4, capture=False)(z, state, ts)
    assert got[1].shape == (4, 1, env.spec.physics_dim)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_wrappers_on_the_card(cuda_device) -> None:
    """The stateful adapter over frame stacking over action repeat over the
    walker, on its default device: every tensor on the card, the repeated
    step equal to the inner steps it stands for, the newest frame last."""
    inner = locomotion.make("walker_walk", 20)
    env = StatefulEnv(FrameStackWrapper(ActionRepeatWrapper(inner, 2), 3), seed=1, num_envs=5)
    first = env.reset()
    assert first.observation.device.type == "cuda"
    assert first.observation.shape == (5, 3 * inner.spec.obs_dim)
    state = env._state.inner
    action = torch.full((inner.spec.action_dim,), 0.5)
    ts = env.step(action)
    want_state, total = state, torch.zeros(5, device=cuda_device)
    for _ in range(2):
        want_state, want = inner.step(want_state, action.to(cuda_device).expand(5, -1))
        total = total + want.reward
    torch.testing.assert_close(ts.reward, total)
    assert torch.equal(ts.physics, want.physics)
    assert torch.equal(ts.observation[:, -inner.spec.obs_dim:], want.observation)
    assert torch.equal(ts.observation[:, :2 * inner.spec.obs_dim],
                       first.observation[:, inner.spec.obs_dim:])
    assert bool(torch.isfinite(ts.observation).all())


ONLINE_SMALL = dict(hidden_dim=64, backward_hidden_dim=64, feature_dim=32, z_dim=16,
                    batch_size=128)


@pytest.mark.cuda
def test_captured_collector_step_equals_the_eager_one(cuda_device) -> None:
    """The collector as replays of one captured control step against the same
    steps run eagerly, from the same states, meta and generator state, for
    two cycles on either side of num_expl_steps and along a stddev schedule
    that changes with the global step: equal to the bit. The meta is
    resampled inside the episode (every 7 steps)."""
    env = locomotion.make("walker_walk", 20)
    cfg = FBDDPGConfig(**ONLINE_SMALL, compute_dtype="bfloat16", num_expl_steps=30,
                       stddev_schedule="linear(1.0,0.1,100)", update_z_every_step=7)
    agent = FBDDPGAgent(cfg, env.spec.obs_dim, env.spec.action_dim, device=cuda_device, seed=3)
    gens = [torch.Generator(device=cuda_device).manual_seed(9) for _ in range(2)]
    captured = EpisodeCollector(env, agent, 4, gens[0], goal_fn=lambda p: p[..., :2])
    eager = EpisodeCollector(env, agent, 4, gens[1], goal_fn=lambda p: p[..., :2],
                             capture=False)
    for step in (0, 80):  # uniform exploration, then the policy at stddev 0.28
        runs = []
        for collector, gen in ((captured, gens[0]), (eager, gens[1])):
            meta = init_meta_batched(agent, gen, 4)
            state, ts = env.reset(gen, 4)
            runs.append({k: v.clone() for k, v in collector(meta, state, ts, step).items()})
        for name, want in runs[1].items():
            assert torch.equal(runs[0][name], want), (step, name)
        assert runs[0]["observation"].shape == (21, 4, env.spec.obs_dim)
        assert not torch.equal(runs[0]["z"][1], runs[0]["z"][20])  # resampled at t=7, 14
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.cuda
def test_update_program_is_captured_once_across_commits(cuda_device) -> None:
    """Three online cycles on the card: each commits its episodes into the
    same storage on the device and the update program, captured at the
    first update, serves them all; the fused kernels run once per update
    plus the capture's warm-up runs."""
    env = locomotion.make("walker_walk", 25)
    cfg = FBDDPGConfig(**ONLINE_SMALL, use_pallas_loss=True)
    agent = FBDDPGAgent(cfg, env.spec.obs_dim, env.spec.action_dim, device=cuda_device, seed=4)
    buf = ReplayBuffer(16, discount=0.98, future=0.99, device=cuda_device)
    trainer = OnlineTrainer(env, agent, buf, num_envs=4, updates_per_step=0.1,
                            max_steps_per_call=4)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    collect_gen = torch.Generator(device=cuda_device).manual_seed(2)
    ff.reset_launches()
    storage = None
    for cycle in range(3):
        metrics = trainer.run_cycle(gen, collect_gen)
        storage = storage or buf.state.storage["observation"].data_ptr()
        assert buf.state.storage["observation"].data_ptr() == storage
        assert len(buf) == 4 * (cycle + 1) and trainer.global_step == 100 * (cycle + 1)
        assert np.isfinite(list(metrics.values())).all()
    assert trainer.trainer.captures == 1 and agent.step == 30
    assert ff.launches == {"fwd": 30 + WARMUP_RUNS, "bwd": 30 + WARMUP_RUNS}
    assert ff.device_runs() == ff.launches


@pytest.mark.cuda
def test_two_graphs_on_one_generator_draw_as_eager_draws(cuda_device) -> None:
    """Two captured programs registered with one generator (the two
    collectors of a directed-rollout mix), replayed in turns: the numbers
    equal eager draws in the same order, so no replay repeats another's."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    programs = [CapturedProgram(lambda n=n: torch.randn(n, 5, generator=gen, device=cuda_device),
                                cuda_device, generators=[gen]) for n in (3, 7)]
    got = []
    for i in (0, 1, 1, 0, 1):
        programs[i].replay()
        got.append(programs[i].out.clone())
    gen.manual_seed(6)
    want = [torch.randn(n, 5, generator=gen, device=cuda_device) for n in (3, 7, 7, 3, 7)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[1], got[2])


@pytest.mark.cuda
def test_a_captured_program_keeps_what_its_function_holds(cuda_device) -> None:
    """A tensor that only the captured function's closure holds (as the
    cheetah's zero action in ``settle``) lives as long as the program, so
    tensors of its size allocated after the capture do not take its memory
    and change what the replays read."""
    held = torch.zeros(16, 6, device=cuda_device)

    def build() -> CapturedProgram:
        step = torch.full((16, 6), 2.0, device=cuda_device)
        return CapturedProgram(lambda: held.add_(step), cuda_device, [held])

    program = build()
    for _ in range(10):
        torch.full((16, 6), 7.0, device=cuda_device)  # freed at once, its block reused
    program.replay(3)
    torch.cuda.synchronize()
    assert torch.equal(held, torch.full((16, 6), 6.0, device=cuda_device))


@pytest.mark.cuda
def test_captured_cheetah_settle_equals_the_eager_one(cuda_device) -> None:
    """The cheetah's 200 settling steps as replays of one captured step
    against the same steps launched from the host: equal to the bit."""
    env = locomotion.make("cheetah_run", 10)
    u = torch.rand(16, env.spec.action_dim, device=cuda_device,
                   generator=torch.Generator(device=cuda_device).manual_seed(0))
    q = torch.cat([torch.tensor([0.0, env.init_z, 0.0], device=cuda_device).expand(16, 3),
                   u * 0.5], -1)
    qd = torch.zeros_like(q)
    got = env.settle(q, qd)
    want = env.settle(q, qd, capture=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float((got[0] - q).abs().max()) > 1e-3  # it moved
    again = env.settle(q, qd)  # the held program, replayed
    assert all(torch.equal(a, b) for a, b in zip(again, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ddpg", "rnd"])
def test_captured_ddpg_and_rnd_updates_equal_eager(cuda_device, name) -> None:
    """Updates of DDPG (n-step batch) and of RND (its running statistics in
    the train state) through a captured program and eagerly, from the same
    state, batch and noise: equal to the bit."""
    cfg_cls, agent_cls = {"ddpg": (DDPGConfig, DDPGAgent), "rnd": (RNDConfig, RNDAgent)}[name]
    cfg = cfg_cls(hidden_dim=64, batch_size=128, compute_dtype="bfloat16",
                  **({"rnd_rep_dim": 32} if name == "rnd" else {}))
    agents = [agent_cls(cfg, 24, 6, device=cuda_device, seed=0) for _ in range(2)]
    buf = ReplayBuffer(8, discount=0.98, future=0.99, device=cuda_device)
    buf.load_episodes(synthetic_episodes(8, 50, 24, 6, seed=0))
    buf.cfg = replay_lib.SampleConfig(discount=0.98, future=0.99, nstep=3)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    batch = buf.sample(gen, 128)
    noise = DDPGNoise.draw(128, 6, gen, cuda_device)
    program = CapturedProgram(lambda: agents[0]._update(batch, noise), cuda_device,
                              agents[0].train_state().values())
    program.replay(3)
    for _ in range(3):
        agents[1]._update(batch, noise)
    torch.cuda.synchronize()
    assert agents[0].step == agents[1].step == 3
    for k, v in agents[1].train_state().items():
        assert torch.equal(agents[0].train_state()[k], v), k


@pytest.mark.cuda
def test_a_resumed_online_run_equals_an_uninterrupted_one(cuda_device, tmp_path) -> None:
    """Two cycles of online pretraining in one run, and one cycle, a
    checkpoint and a second cycle in a fresh workspace on the folder: the
    replay, both generators, the counters and the agent come back, so the
    second cycle gives the same state to the bit."""
    common = ["task=walker_walk", "episode_length=25", "num_envs=4", "num_seed_frames=100",
              "eval_every_steps=0", "final_tests=0", "save_eval_video=false",
              "use_console=false", "replay_buffer_episodes=16", "checkpoint_every=0",
              *[f"agent.{k}={v}" for k, v in ONLINE_SMALL.items()]]
    whole = pretrain.main([*common, "num_train_frames=200", f"folder={tmp_path}/a"])
    pretrain.main([*common, "num_train_frames=100", f"folder={tmp_path}/b"])
    resumed = pretrain.main([*common, "num_train_frames=200", f"folder={tmp_path}/b"])
    assert resumed.global_step == whole.global_step == 200 and len(resumed.buffer) == 8
    for k, v in whole.agent.train_state().items():
        assert torch.equal(resumed.agent.train_state()[k], v), k
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
    assert torch.equal(resumed.collect_generator.get_state(),
                       whole.collect_generator.get_state())
    for k, v in whole.buffer.state.storage.items():
        assert torch.equal(resumed.buffer.state.storage[k], v), k


SF_SMALL = dict(hidden_dim=64, backward_hidden_dim=64, feature_dim=32, z_dim=16, batch_size=128)


def _sf_captured_and_eager(cuda_device, agent_cls, cfg, updates: int):
    """``updates`` through the captured trainer and through the eager one,
    from twin agents and generators in the same state."""
    buf = ReplayBuffer(8, discount=0.98, future=0.99, device=cuda_device)
    buf.load_episodes(synthetic_episodes(8, 50, 24, 6, seed=0))
    agents = [agent_cls(cfg, 24, 6, device=cuda_device, seed=0) for _ in range(2)]
    gens = [torch.Generator(device=cuda_device).manual_seed(5) for _ in range(2)]
    trainers = [make_offline_trainer(agents[0], buf.cfg, cfg.batch_size, updates),
                make_offline_trainer(agents[1], buf.cfg, cfg.batch_size, updates, capture=False)]
    metrics = [trainer(buf.state, gen) for trainer, gen in zip(trainers, gens)]
    torch.cuda.synchronize()
    return agents, gens, trainers, metrics


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["lap", "contrastive", "svd_sr", "sf_svd"])
def test_captured_sf_updates_equal_eager(cuda_device, learner) -> None:
    """SF with three φ learners (one reading the sampled future states, one
    with target networks) and SF-SVD: 4 updates through the captured trainer
    (one graph, sampling included) and eagerly from the same generator
    state, equal to the bit, metrics included."""
    agent_cls, cfg = ((SFSVDAgent, SFSVDConfig(**SF_SMALL)) if learner == "sf_svd"
                      else (SFAgent, SFConfig(**SF_SMALL, feature_learner=learner)))
    agents, gens, trainers, metrics = _sf_captured_and_eager(cuda_device, agent_cls, cfg, 4)
    assert trainers[0]._program is not None and len(trainers[0]._program.graphs) == 1
    assert agents[0].step == agents[1].step == 4
    for k, v in agents[1].train_state().items():
        assert torch.equal(agents[0].train_state()[k], v), k
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert set(metrics[0]) == set(metrics[1])
    for k, v in metrics[1].items():
        assert torch.equal(metrics[0][k], v), k


@pytest.mark.cuda
def test_captured_sf_mix_update_runs_its_pinv_between_two_graphs(cuda_device) -> None:
    """``mix_ratio`` > 0: the pseudo-inverse (an SVD checked on the host)
    runs eagerly between the two graphs of the update; 3 replays equal 3
    eager updates from the same generator state."""
    cfg = SFConfig(**SF_SMALL, feature_learner="svd_sr", mix_ratio=0.5)
    agents, gens, trainers, _ = _sf_captured_and_eager(cuda_device, SFAgent, cfg, 3)
    program = trainers[0]._program
    assert program is not None and len(program.graphs) == 2 and len(program.steps) == 1
    assert agents[0].step == agents[1].step == 3
    for k, v in agents[1].train_state().items():
        torch.testing.assert_close(agents[0].train_state()[k], v, rtol=0, atol=0, msg=k)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["full_rank", "rank_deficient"])
def test_lstsq_on_the_card_matches_float64(cuda_device, kind) -> None:
    """SF's inference regression, 5,120 samples x 100 features, in float32 on
    the card against float64 on the CPU with the same cutoff: the solution
    within 1e-4 of its norm (float32 on the CPU is 1.7e-6 off at this
    condition number, 28; a rank-deficient φ has a zero (dead) and a
    duplicated column, whose minimum-norm solution weighs the two alike)."""
    rng = np.random.RandomState(0)
    phi = rng.randn(5120, 100).astype(np.float32) * rng.uniform(0.1, 3.0, 100).astype(np.float32)
    if kind == "rank_deficient":
        phi[:, 1] = 0.0
        phi[:, 2] = phi[:, 3]
    reward = (phi @ rng.randn(100, 1) + 0.1 * rng.randn(5120, 1)).astype(np.float32)
    a, b = torch.from_numpy(phi), torch.from_numpy(reward)
    rcond = torch.finfo(torch.float32).eps * 5120
    want = lstsq(a.double(), b.double(), rcond=rcond)
    got = lstsq(a.to(cuda_device), b.to(cuda_device)).cpu().double()
    assert float((got - want).norm() / want.norm()) < 1e-4
    if kind == "rank_deficient":
        assert abs(float(got[2] - got[3])) < 1e-4 * float(want.norm())


def _grid_buffer(device: torch.device, episodes: int = 8, horizon: int = 50):
    """``grid_simple`` and a buffer of ``episodes`` random-policy episodes
    of it, collected on ``device``."""
    env = build_gridworld_task("simple", max_episode_length=horizon)
    gen = torch.Generator(device=device).manual_seed(0)
    state, ts = env.reset(gen, episodes)
    steps = [ts.to_buffer_dict()]
    for _ in range(horizon):
        action = torch.randint(0, 5, (episodes,), generator=gen, device=device).float()
        state, ts = env.step(state, action)
        steps.append(ts.to_buffer_dict())
    buf = ReplayBuffer(episodes, discount=0.98, future=0.99, device=device)
    buf.add_trajectory({k: torch.stack([s[k] for s in steps]) for k in steps[0]}, horizon)
    return env, buf


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["simple", "obstacle", "random_goal"])
def test_gridworld_on_the_card_equals_the_cpu(cuda_device, layout) -> None:
    """Every observation type, 256 environments, 60 steps of the same
    actions on the card and on the CPU: equal to the bit."""
    actions = torch.from_numpy(np.random.RandomState(1).randint(0, 5, (60, 256))).float()
    for obs_type in gridworld.OBSERVATION_TYPES:
        env = build_gridworld_task(layout, observation_type=obs_type, max_episode_length=40,
                                   penalty_for_walls=-0.5)
        goals, _ = env.reset(torch.Generator().manual_seed(2), 256)
        runs = []
        for device in (cuda_device, torch.device("cpu")):
            state, ts = env.reset_with_goals(goals.goal.to(device))
            out = [ts]
            for a in actions:
                state, ts = env.step(state, a.to(device))
                out.append(ts)
            runs.append(out + [env.get_goal_obs(state)])
        for got, want in zip(*runs):
            if isinstance(want, torch.Tensor):
                assert torch.equal(got.cpu(), want), obs_type
                continue
            for field in ("observation", "reward", "discount", "physics", "step_type", "action"):
                assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), (obs_type,
                                                                                     field)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["discrete_fb", "discrete_sf"])
def test_captured_grid_rollout_and_collector_equal_eager(cuda_device, name) -> None:
    """The evaluation rollout (greedy) and the collector (ε-greedy, z
    resampled inside the episode) of a discrete agent on the gridworld, as
    replays of one captured control step against the same steps run
    eagerly: equal to the bit."""
    env = build_gridworld_task("simple", max_episode_length=24)
    agent = (DiscreteFBAgent(DiscreteFBConfig(**ONLINE_SMALL, update_z_every_step=7), 2, 5,
                             device=cuda_device, seed=1) if name == "discrete_fb" else
             DiscreteSFAgent(DiscreteSFConfig(**ONLINE_SMALL, update_z_every_step=7), 2, 5,
                             device=cuda_device, seed=1))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    z = agent.sample_z(6, gen)
    state, ts = env.reset(gen, 6)
    got = [x.clone() for x in Rollout(env, agent, 6)(z, state, ts)]
    want = Rollout(env, agent, 6, capture=False)(z, state, ts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    gens = [torch.Generator(device=cuda_device).manual_seed(9) for _ in range(2)]
    runs = []
    for collector, g in ((EpisodeCollector(env, agent, 4, gens[0]), gens[0]),
                         (EpisodeCollector(env, agent, 4, gens[1], capture=False), gens[1])):
        meta = init_meta_batched(agent, g, 4)
        state, ts = env.reset(g, 4)
        runs.append({k: v.clone() for k, v in collector(meta, state, ts, 0).items()})
    for key, value in runs[1].items():
        assert torch.equal(runs[0][key], value), key
    actions = runs[0]["action"][1:]
    assert bool((actions == actions.round()).all()) and len(actions.unique()) > 1
    assert not torch.equal(runs[0]["z"][1], runs[0]["z"][20])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fb", "fb_argmax", "fb_q_loss", "sf_icm", "sf_identity"])
def test_captured_discrete_updates_equal_eager(cuda_device, case) -> None:
    """Four updates of each discrete agent through the captured trainer and
    eagerly from the same generator state: equal to the bit; discrete FB's
    ``q_loss`` runs its pseudo-inverse eagerly between two graphs."""
    _, buf = _grid_buffer(cuda_device)
    small = dict(hidden_dim=64, backward_hidden_dim=64, feature_dim=32, z_dim=16, batch_size=128)
    cfg = {"fb": DiscreteFBConfig(**small),
           "fb_argmax": DiscreteFBConfig(**small, boltzmann=False),
           "fb_q_loss": DiscreteFBConfig(**small, q_loss=True),
           "sf_icm": DiscreteSFConfig(**small),
           "sf_identity": DiscreteSFConfig(**small, feature_learner="identity")}[case]
    agent_cls = DiscreteFBAgent if case.startswith("fb") else DiscreteSFAgent
    agents = [agent_cls(cfg, 2, 5, device=cuda_device, seed=0) for _ in range(2)]
    gens = [torch.Generator(device=cuda_device).manual_seed(5) for _ in range(2)]
    trainers = [make_offline_trainer(agents[0], buf.cfg, cfg.batch_size, 4),
                make_offline_trainer(agents[1], buf.cfg, cfg.batch_size, 4, capture=False)]
    metrics = [trainer(buf.state, gen) for trainer, gen in zip(trainers, gens)]
    program = trainers[0]._program
    assert program is not None and len(program.graphs) == (2 if case == "fb_q_loss" else 1)
    assert agents[0].step == agents[1].step == 4
    for k, v in agents[1].train_state().items():
        assert torch.equal(agents[0].train_state()[k], v), k
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    for k, v in metrics[1].items():
        assert torch.equal(metrics[0][k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["walker_walk", "cheetah_run", "hopper_hop",
                                  "point_mass_maze_reach_top_left"])
def test_pixel_frames_on_the_card_match_the_cpu(cuda_device, task) -> None:
    """84 x 84 frames, a stack of 3, over a reset and five steps on the card
    against the CPU's render of the same physics rows: uint8 within 1, equal
    on at least 99.9%."""
    env = make_pixel_env(task)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state, ts = env.reset(gen, 64)
    for step in range(6):
        if step:
            action = torch.rand((64, env.spec.action_dim), generator=gen, device=cuda_device)
            state, ts = env.step(state, action * 2 - 1)
        assert ts.observation.dtype == torch.uint8
        newest = ts.observation.reshape(64, 84, 84, 3, 3)[..., -1, :].cpu().int()
        want = env.frame_fn(ts.physics.cpu()).to(torch.uint8).int()
        diff = (newest - want).abs()
        assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999, step


@pytest.mark.cuda
def test_pixel_encoder_on_the_card_matches_the_cpu(cuda_device) -> None:
    """The encoder's features on the card (cuDNN, TF32 off) against the CPU
    at rtol 1e-4."""
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    encoder = PixelEncoder(9)
    frames = torch.randint(0, 256, (16, 84, 84, 9), dtype=torch.uint8)
    with torch.no_grad():
        want = encoder(frames)
        got = encoder.to(cuda_device)(frames.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_captured_pixel_update_equals_eager(cuda_device) -> None:
    """Pixel DDPG updates (the shifts, the encoder's own Adam step, cuDNN's
    deterministic algorithms) through a captured program and eagerly, from
    the same state, batch and draws: equal to the bit."""
    cfg = DDPGConfig(hidden_dim=64, batch_size=32, obs_type="pixels")
    shape = (84, 84, 9)
    agents = [DDPGAgent(cfg, 84 * 84 * 9, 6, device=cuda_device, seed=0, obs_shape=shape)
              for _ in range(2)]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    frames = lambda: torch.randint(0, 256, (32, 84 * 84 * 9), generator=gen,  # noqa: E731
                                   device=cuda_device, dtype=torch.uint8)
    batch = EpisodeBatch(
        obs=frames(), next_obs=frames(), action=torch.rand(32, 6, device=cuda_device) * 2 - 1,
        reward=torch.rand(32, 1, device=cuda_device),
        discount=torch.full((32, 1), 0.98, device=cuda_device))
    noise = DDPGNoise.draw(32, 6, gen, cuda_device, aug_pad=cfg.aug_pad)
    program = CapturedProgram(lambda: agents[0]._update(batch, noise), cuda_device,
                              agents[0].train_state().values())
    program.replay(3)
    for _ in range(3):
        agents[1]._update(batch, noise)
    torch.cuda.synchronize()
    assert agents[0].step == agents[1].step == 3 and agents[0].encoder_opt.count == 3
    for k, v in agents[1].train_state().items():
        assert torch.equal(agents[0].train_state()[k], v), k


EXPLORER_SMALL = dict(hidden_dim=64, batch_size=128)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["diayn", "icm", "icm_apt", "disagreement", "max_ent"])
def test_captured_explorer_updates_equal_eager(cuda_device, name) -> None:
    """Four updates of each explorer through the captured trainer and
    eagerly from the same generator state: equal to the bit (DIAYN on
    episodes with a one-hot skill column)."""
    cfg_cls, agent_cls = AGENTS[name]
    cfg = cfg_cls(**EXPLORER_SMALL)
    episodes = synthetic_episodes(8, 50, 24, 6, seed=0)
    if name == "diayn":
        eye = np.eye(cfg.skill_dim, dtype=np.float32)
        episodes = [{**ep, "skill": np.repeat(eye[i % cfg.skill_dim][None], 51, 0)}
                    for i, ep in enumerate(episodes)]
    buf = ReplayBuffer(8, discount=0.98, future=0.99, device=cuda_device)
    buf.load_episodes(episodes)
    buf.cfg = replay_lib.SampleConfig(discount=0.98, future=0.99, nstep=3)
    agents = [agent_cls(cfg, 24, 6, device=cuda_device, seed=0) for _ in range(2)]
    gens = [torch.Generator(device=cuda_device).manual_seed(5) for _ in range(2)]
    trainers = [make_offline_trainer(agents[0], buf.cfg, cfg.batch_size, 4),
                make_offline_trainer(agents[1], buf.cfg, cfg.batch_size, 4, capture=False)]
    metrics = [trainer(buf.state, gen) for trainer, gen in zip(trainers, gens)]
    assert trainers[0]._program is not None and agents[0].step == agents[1].step == 4
    for k, v in agents[1].train_state().items():
        assert torch.equal(agents[0].train_state()[k], v), k
    for k, v in metrics[1].items():
        assert torch.equal(metrics[0][k], v), k
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.cuda
def test_captured_diayn_collector_resamples_the_skill(cuda_device) -> None:
    """DIAYN's collector over 60 steps, captured and eager: equal to the
    bit, the skill resampled from the registered generator at steps 0 and
    50 and held between."""
    cfg_cls, agent_cls = AGENTS["diayn"]
    agent = agent_cls(cfg_cls(**EXPLORER_SMALL), 24, 6, device=cuda_device, seed=0)
    env = locomotion.make("walker_walk", 60)
    gens = [torch.Generator(device=cuda_device).manual_seed(6) for _ in range(2)]
    runs = []
    for collector, g in ((EpisodeCollector(env, agent, 16, gens[0]), gens[0]),
                         (EpisodeCollector(env, agent, 16, gens[1], capture=False), gens[1])):
        meta = init_meta_batched(agent, g, 16)
        state, ts = env.reset(g, 16)
        runs.append({k: v.clone() for k, v in collector(meta, state, ts, 0).items()})
    for key, value in runs[1].items():
        assert torch.equal(runs[0][key], value), key
    skill = runs[0]["skill"]  # [T + 1, E, K]; index i holds the skill of step i - 1
    changed = (skill[1:] != skill[:-1]).any(-1).any(-1).nonzero().flatten().tolist()
    assert set(changed) <= {0, 50} and 50 in changed
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


ITEM13_SMALL = {"aps": dict(sf_dim=5), "new_aps": dict(backward_hidden_dim=64, feature_dim=32),
                "smm": dict(code_dim=16), "proto": dict(num_protos=64, queue_size=200),
                "uvf": dict(backward_hidden_dim=64, feature_dim=32, z_dim=16,
                            goal_space="simplified_point_mass_maze"),
                "goal_td3": dict(goal_space="simplified_point_mass_maze"),
                "goal_sm": dict(goal_space="simplified_point_mass_maze")}


def _item13_episodes(name: str, cfg) -> list:
    """Walker-shaped episodes with the columns the agent's update reads: its
    meta (``task``, ``z``, ``g``), and for the goal agents 2-D goals."""
    rng = np.random.RandomState(1)
    episodes = synthetic_episodes(8, 50, 24, 6, seed=0)
    for ep in episodes:
        if name == "aps":
            task = rng.randn(cfg.sf_dim).astype(np.float32)
            ep["task"] = np.repeat((task / np.linalg.norm(task))[None], 51, 0)
        elif name == "new_aps":
            z = rng.randn(cfg.z_dim).astype(np.float32)
            ep["z"] = np.repeat((z / np.linalg.norm(z))[None], 51, 0)
        elif name == "smm":
            ep["z"] = np.repeat(np.eye(cfg.z_dim, dtype=np.float32)[rng.randint(cfg.z_dim)][None],
                                51, 0)
        if name in ("uvf", "goal_td3", "goal_sm"):
            ep["goal"] = rng.uniform(-0.3, 0.3, (51, 2)).astype(np.float32)
        if name in ("goal_td3", "goal_sm"):
            ep["g"] = np.repeat(rng.uniform(-0.3, 0.3, (1, 2)).astype(np.float32), 51, 0)
    return episodes


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["aps", "new_aps", "new_aps_future", "smm", "proto", "uvf",
                                  "goal_td3", "goal_sm"])
def test_captured_item13_updates_equal_eager(cuda_device, name) -> None:
    """Four updates of each of the last seven agents through the captured
    trainer and eagerly from the same generator state: equal to the bit,
    metrics and Proto's candidate queue included; NEWAPS with
    ``future_ratio=0.5`` as two graphs with the pseudo-inverse between."""
    agent = name.replace("_future", "")
    cfg_cls, agent_cls = AGENTS[agent]
    overrides = dict(ITEM13_SMALL[agent], future_ratio=0.5) if name.endswith("_future") \
        else ITEM13_SMALL[agent]
    cfg = cfg_cls(hidden_dim=64, batch_size=128, **overrides)
    buf = ReplayBuffer(8, discount=0.98, future=0.99, device=cuda_device)
    buf.load_episodes(_item13_episodes(agent, cfg))
    goal_dim = 2 if "goal_space" in overrides else None
    agents = [agent_cls(cfg, 24, 6, goal_dim=goal_dim, device=cuda_device, seed=0)
              for _ in range(2)]
    gens = [torch.Generator(device=cuda_device).manual_seed(5) for _ in range(2)]
    trainers = [make_offline_trainer(agents[0], buf.cfg, cfg.batch_size, 4),
                make_offline_trainer(agents[1], buf.cfg, cfg.batch_size, 4, capture=False)]
    metrics = [trainer(buf.state, gen) for trainer, gen in zip(trainers, gens)]
    torch.cuda.synchronize()
    program = trainers[0]._program
    assert program is not None and len(program.graphs) == (2 if name.endswith("_future") else 1)
    assert agents[0].step == agents[1].step == 4
    for k, v in agents[1].train_state().items():
        assert torch.equal(agents[0].train_state()[k], v), k
    for k, v in metrics[1].items():
        assert torch.equal(metrics[0][k], v), k
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    if agent == "proto":
        assert int(agents[0].queue_ptr) == 4 * cfg.num_protos % cfg.queue_size


@pytest.fixture
def nccl_group(cuda_device, tmp_path):
    """A one-process NCCL group on the card."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "rand_weight_future", "q_loss"])
def test_captured_dp_update_at_one_process_equals_plain(nccl_group, case) -> None:
    """The data-parallel update through a one-process NCCL group, captured
    with its collectives in one CUDA graph, equals the plain captured update
    from the same state, batches and noise to the bit (fused loss, bf16)."""
    from controllable_agent_torch.parallel import make_dp_offline_trainer
    overrides = {"default": {}, "rand_weight_future": dict(rand_weight=True, future_ratio=0.5),
                 "q_loss": dict(q_loss=True, use_pallas_loss=False)}[case]
    cfg = FBDDPGConfig(**{"use_pallas_loss": True, "compute_dtype": "bfloat16",
                          "hidden_dim": 256, "batch_size": 256, **overrides})
    buf = ReplayBuffer(8, discount=0.98, future=0.99, device="cuda")
    buf.load_episodes(synthetic_episodes(8, 200, 24, 6, seed=0))
    agents = [FBDDPGAgent(cfg, 24, 6, device="cuda", seed=0) for _ in range(2)]
    gens = [torch.Generator(device="cuda").manual_seed(1) for _ in range(2)]
    plain = make_offline_trainer(agents[0], buf.cfg, cfg.batch_size, 5)
    dp = make_dp_offline_trainer(agents[1], buf.cfg, cfg.batch_size, 5, nccl_group)
    want = plain(buf.state, gens[0])
    got = dp(buf.state, gens[1])
    assert dp.captures == 1
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for name, value in agents[0].train_state().items():
        assert torch.equal(agents[1].train_state()[name], value), name
    del plain, dp


# -- the optimizer layer: csrc/fused_optim.cu against the _foreach versions ----------
OPTIM_SIZES = (6, 50, 526, 276_676, 1_048_576)
OPTIM_OFFSETS = (0, 1, 3, 0, 2)  # elements past a 16-byte boundary: 1-3 misalign
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def _misaligned(sizes, offsets, device, dtype=torch.float32, fill=None, gen=None):
    """A tensor of each size, ``offset`` elements into a buffer of its own."""
    out = []
    for n, off in zip(sizes, offsets):
        buf = torch.zeros(n + off, device=device, dtype=dtype)
        if fill == "randn":
            buf.normal_(generator=gen)
        out.append(buf[off:])
    return out


class _Grads:
    """Gradients of every step as views into one flat tensor, as the
    data-parallel update's all-reduce leaves them: each step draws a fresh
    source on the host's side of a capture, and the views are made from it
    by one product (inside a capture, in the graph's pool)."""

    def __init__(self, sizes, offsets, device, seed):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.starts, at = [], 0
        for n, off in zip(sizes, offsets):
            self.starts.append(at + off)
            at += n + off
        self.sizes = sizes
        self.src = torch.empty(at, device=device)
        scales = np.repeat(10.0 ** np.arange(-3, 2, dtype=np.float64)[
            np.arange(len(sizes)) % 5], [n + off for n, off in zip(sizes, offsets)])
        self.scale = torch.tensor(scales, dtype=torch.float32, device=device)

    def draw(self):
        self.src.normal_(generator=self.gen)

    def __call__(self):
        flat = self.src * self.scale
        return [flat[s:s + n] for s, n in zip(self.starts, self.sizes)]


def _adam_state(sizes, offsets, mu_dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    params = _misaligned(sizes, offsets, device, fill="randn", gen=gen)
    mus = _misaligned(sizes, offsets, device, dtype=mu_dtype)
    nus = _misaligned(sizes, offsets, device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    ticket = torch.zeros((), dtype=torch.int32, device=device)
    return params, mus, nus, count, ticket


def _assert_bitwise(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (f"{what}[{i}] ({a.numel()} elements): "
                                   f"{int((a != b).sum())} differ")


@pytest.mark.cuda
@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_fused_adam_equals_foreach_to_the_bit(cuda_device, mu_dtype, captured) -> None:
    """200 steps of ``adam_multi_tensor_apply_kernel`` against ``adam_plain``
    (the _foreach calls) from the same state on the same gradients: p, mu,
    nu and the count equal to the bit at every 50th step, eagerly and as
    replays of one captured step whose gradients live in the graph's pool;
    tensors of 6 to 1,048,576 elements, some misaligned for 16-byte access.
    One launch a step, replays included; the fused FB counts untouched."""
    kernel = _adam_state(OPTIM_SIZES, OPTIM_OFFSETS, mu_dtype, cuda_device)
    plain = [[x.clone() for x in xs] for xs in kernel[:3]] + [kernel[3].clone()]
    grads = _Grads(OPTIM_SIZES, OPTIM_OFFSETS, cuda_device, seed=1)
    params, mus, nus, count, ticket = kernel
    step = lambda: optim.adam(params, grads(), mus, nus, count, ticket,  # noqa: E731
                              LR, B1, B2, EPS)
    fb_before, before = dict(ff.launches), dict(optim.launches)
    program = None
    if captured:
        grads.draw()
        program = CapturedProgram(step, cuda_device, [*params, *mus, *nus, count])
        assert next(h for c, h in program.held if c is optim.launches) == {"adam": 1, "lerp": 0}
        assert optim.launches["adam"] == before["adam"] + WARMUP_RUNS
        before = dict(optim.launches)
    for i in range(1, 201):
        grads.draw()
        if program is None:
            step()
        else:
            program.replay()
        optim.adam_plain(plain[0], grads(), plain[1], plain[2], plain[3], LR, B1, B2, EPS)
        if i % 50 == 0:
            torch.cuda.synchronize()
            for name, got, want in zip(("p", "mu", "nu"), kernel[:3], plain[:3]):
                _assert_bitwise(got, want, f"{name} at step {i}")
            assert int(count) == int(plain[3]) == i and int(ticket) == 0
    assert optim.launches == {"adam": before["adam"] + 200, "lerp": before["lerp"]}
    assert ff.launches == fb_before


@pytest.mark.cuda
@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("tau", [0.01, 0.7])
def test_fused_soft_update_equals_foreach_lerp_to_the_bit(cuda_device, tau, captured) -> None:
    """200 soft-updates by ``lerp_multi_tensor_apply_kernel`` against
    ``torch._foreach_lerp_`` (both of PyTorch's formulas: tau below and
    above 0.5), eagerly and captured, misaligned tensors included: equal to
    the bit; one launch a soft-update."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    targets = _misaligned(OPTIM_SIZES, OPTIM_OFFSETS, cuda_device, fill="randn", gen=gen)
    sources = _misaligned(OPTIM_SIZES, OPTIM_OFFSETS[::-1], cuda_device, fill="randn", gen=gen)
    twin = [t.clone() for t in targets]
    step = lambda: optim.lerp_(targets, sources, tau)  # noqa: E731
    program = CapturedProgram(step, cuda_device, targets) if captured else None
    before = dict(optim.launches)
    for i in range(1, 201):
        for s in sources:
            s.normal_(generator=gen)
        step() if program is None else program.replay()
        torch._foreach_lerp_(twin, sources, tau)
        if i % 50 == 0:
            torch.cuda.synchronize()
            _assert_bitwise(targets, twin, f"target at step {i}")
    assert optim.launches == {"adam": before["adam"], "lerp": before["lerp"] + 200}


@pytest.mark.cuda
def test_lists_longer_than_an_argument_block_split_and_stay_exact(cuda_device) -> None:
    """150 tensors of 0 to 5,000 elements (and one of 300,000): Adam takes
    three launches a step (64 + 64 + 22 tensors) and advances the count
    once; the soft-update two (96 + 54); both equal the _foreach versions
    to the bit."""
    rng = np.random.RandomState(0)
    sizes = tuple(int(n) for n in rng.randint(0, 5001, 150))
    sizes = sizes[:70] + (300_000,) + sizes[71:]
    offsets = tuple(int(o) for o in rng.randint(0, 4, 150))
    assert len(optim.plan(len(sizes), 64)) == 3 and len(optim.plan(len(sizes), 128)) == 2
    for mu_dtype in (torch.bfloat16, torch.float32):
        kernel = _adam_state(sizes, offsets, mu_dtype, cuda_device)
        plain = [[x.clone() for x in xs] for xs in kernel[:3]] + [kernel[3].clone()]
        grads = _Grads(sizes, offsets, cuda_device, seed=4)
        before = dict(optim.launches)
        for _ in range(5):
            grads.draw()
            optim.adam(kernel[0], grads(), kernel[1], kernel[2], kernel[3], kernel[4],
                       LR, B1, B2, EPS)
            optim.adam_plain(plain[0], grads(), plain[1], plain[2], plain[3], LR, B1, B2, EPS)
        torch.cuda.synchronize()
        assert optim.launches["adam"] == before["adam"] + 15
        assert int(kernel[3]) == int(plain[3]) == 5 and int(kernel[4]) == 0
        for name, got, want in zip(("p", "mu", "nu"), kernel[:3], plain[:3]):
            _assert_bitwise(got, want, f"{name} ({mu_dtype})")
    targets = _misaligned(sizes, offsets, cuda_device, fill="randn",
                          gen=torch.Generator(device=cuda_device).manual_seed(5))
    sources = [torch.randn(n, device=cuda_device) for n in sizes]
    twin = [t.clone() for t in targets]
    before = optim.launches["lerp"]
    optim.lerp_(targets, sources, 0.01)
    torch._foreach_lerp_(twin, sources, 0.01)
    assert optim.launches["lerp"] == before + 2
    _assert_bitwise(targets, twin, "target")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_lerp_kernel_covers_every_element_once(cuda_device, seed) -> None:
    """One soft-update at weight 0.5 from 0 towards 1 leaves every element
    at 0.5: an element no block took stays 0 and one taken twice reads
    0.75. 300 tensors of 0 to 9,000 elements (one of 2,000,000) over four
    launches, the blocks mapped to (tensor, chunk) by the kernel's table."""
    rng = np.random.RandomState(seed)
    sizes = [int(n) for n in rng.randint(0, 9001, 300)]
    sizes[rng.randint(300)] = 2_000_000
    targets = [torch.zeros(n, device=cuda_device) for n in sizes]
    optim.lerp_(targets, [torch.ones(n, device=cuda_device) for n in sizes], 0.5)
    flat = torch.cat(targets)
    assert flat.numel() == sum(sizes) and bool((flat == 0.5).all()), (
        f"{int((flat == 0).sum())} elements untouched, {int((flat == 0.75).sum())} taken twice")


@pytest.mark.cuda
def test_the_kernels_refuse_what_they_do_not_take(cuda_device) -> None:
    """On a card the wrappers launch the kernels or raise: a non-contiguous
    or bfloat16 parameter, a bfloat16 target, each a ``ValueError`` that
    names it, with nothing launched and no state changed. A gradient in
    another layout (a transposed view, as cuDNN's channels-last weight
    gradients are) is copied and read: one launch, equal to ``adam_plain``
    to the bit."""
    net = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Linear(7, 3)).to(cuda_device)
    opt = optim.Adam(net, 1e-3, torch.bfloat16)
    grads = [torch.randn_like(p) for p in opt.params.values()]
    grads[2] = grads[2].t().contiguous().t()
    assert not grads[2].is_contiguous()
    params, mus, nus = ([x.clone() for x in d.values()] for d in (opt.params, opt.mu, opt.nu))
    count = opt.count_t.clone()
    before = dict(optim.launches)
    opt.step(grads)
    optim.adam_plain(params, grads, mus, nus, count, 1e-3, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert optim.launches["adam"] == before["adam"] + 1 and opt.count == int(count) == 1
    for name, got, want in (("p", opt.params, params), ("mu", opt.mu, mus), ("nu", opt.nu, nus)):
        _assert_bitwise(list(got.values()), want, name)

    before = dict(optim.launches)
    net[1].weight.data = net[1].weight.data.t().contiguous().t()
    opt = optim.Adam(net, 1e-3, torch.bfloat16)
    with pytest.raises(ValueError, match=r"adam: params\[2\] is not contiguous"):
        opt.step(grads)
    net[1].weight.data = net[1].weight.data.contiguous().bfloat16()
    opt = optim.Adam(net, 1e-3, torch.bfloat16)
    with pytest.raises(ValueError, match=r"adam: params\[2\] is torch.bfloat16"):
        opt.step(grads)
    targets = [torch.zeros(4, device=cuda_device, dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match=r"lerp: targets\[0\] is torch.bfloat16"):
        optim.lerp_(targets, [torch.ones(4, device=cuda_device)], 0.01)
    torch.cuda.synchronize()
    assert optim.launches == before and opt.count == 0


@pytest.mark.cuda
def test_every_optimizer_step_of_an_update_goes_through_the_kernels(cuda_device) -> None:
    """The captured FB trainer: three Adam launches and two soft-update
    launches an update (forward, backward and actor; both targets), by the
    counts held through the capture and added back at each replay; the
    fused FB loss's counts as before, one of each an update."""
    agent, buf = _agent_and_buffer(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    trainer = make_offline_trainer(agent, buf.cfg, 128, steps_per_call=4)
    ff.reset_launches()
    optim.reset_launches()
    trainer(buf.state, gen)
    trainer(buf.state, gen)
    runs = WARMUP_RUNS + 8
    assert optim.launches == {"adam": 3 * runs, "lerp": 2 * runs}
    assert ff.launches == {"fwd": runs, "bwd": runs}


# -- bf16 compute copies: the kernels' copies, the launches and uses of an update --
COPY_OF = (True, False, True, True, False)  # which of OPTIM_SIZES have a copy and a bf16 g


def _mixed_grads(grads):
    """``grads``' gradients, bf16 where the tensor has a copy: views into
    one flat bf16 tensor at the same offsets (misaligned as the float32
    ones), made by one cast (in the graph's pool inside a capture)."""
    flat = grads.src * grads.scale
    half = flat.bfloat16()
    return [(half if bf16 else flat)[s:s + n]
            for s, n, bf16 in zip(grads.starts, grads.sizes, COPY_OF)]


@pytest.mark.cuda
@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_fused_adam_takes_bf16_gradients_and_writes_copies(cuda_device, mu_dtype,
                                                           captured) -> None:
    """100 steps of the Adam kernel with bf16 gradients and copies on three
    of five tensors (misaligned, as the others) against ``adam_plain`` on
    the gradients widened by ``.float()``: p, mu, nu and the count equal to
    the bit, and each copy equal to ``.to(torch.bfloat16)`` of its new
    parameter, eagerly and as replays of one captured step; one launch a
    step."""
    kernel = _adam_state(OPTIM_SIZES, OPTIM_OFFSETS, mu_dtype, cuda_device)
    plain = [[x.clone() for x in xs] for xs in kernel[:3]] + [kernel[3].clone()]
    copies = [c if has else None for c, has in zip(
        _misaligned(OPTIM_SIZES, OPTIM_OFFSETS[::-1], cuda_device, dtype=torch.bfloat16),
        COPY_OF)]
    grads = _Grads(OPTIM_SIZES, OPTIM_OFFSETS, cuda_device, seed=6)
    params, mus, nus, count, ticket = kernel
    step = lambda: optim.adam(params, _mixed_grads(grads), mus, nus, count, ticket,  # noqa: E731
                              LR, B1, B2, EPS, copies)
    program = None
    if captured:
        grads.draw()
        program = CapturedProgram(step, cuda_device, [*params, *mus, *nus, count])
    before = dict(optim.launches)
    for i in range(1, 101):
        grads.draw()
        step() if program is None else program.replay()
        optim.adam_plain(plain[0], [g.float() for g in _mixed_grads(grads)], plain[1],
                         plain[2], plain[3], LR, B1, B2, EPS)
        if i % 25 == 0:
            torch.cuda.synchronize()
            for name, got, want in zip(("p", "mu", "nu"), kernel[:3], plain[:3]):
                _assert_bitwise(got, want, f"{name} at step {i}")
            _assert_bitwise([c for c in copies if c is not None],
                            [p.bfloat16() for p, c in zip(params, copies) if c is not None],
                            f"copy at step {i}")
            assert int(count) == int(plain[3]) == i and int(ticket) == 0
    assert optim.launches == {"adam": before["adam"] + 100, "lerp": before["lerp"]}


@pytest.mark.cuda
@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
def test_fused_soft_update_writes_the_targets_copies(cuda_device, captured) -> None:
    """100 soft-updates by the lerp kernel with copies on three of five
    targets: the targets equal ``torch._foreach_lerp_``'s to the bit and
    each copy ``.to(torch.bfloat16)`` of its new target; one launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    targets = _misaligned(OPTIM_SIZES, OPTIM_OFFSETS, cuda_device, fill="randn", gen=gen)
    sources = _misaligned(OPTIM_SIZES, OPTIM_OFFSETS[::-1], cuda_device, fill="randn", gen=gen)
    copies = [c if has else None for c, has in zip(
        _misaligned(OPTIM_SIZES, (1, 0, 2, 3, 0), cuda_device, dtype=torch.bfloat16), COPY_OF)]
    twin = [t.clone() for t in targets]
    step = lambda: optim.lerp_(targets, sources, 0.01, copies)  # noqa: E731
    program = CapturedProgram(step, cuda_device, targets) if captured else None
    before = dict(optim.launches)
    for i in range(1, 101):
        for s in sources:
            s.normal_(generator=gen)
        step() if program is None else program.replay()
        torch._foreach_lerp_(twin, sources, 0.01)
    torch.cuda.synchronize()
    _assert_bitwise(targets, twin, "target")
    _assert_bitwise([c for c in copies if c is not None],
                    [t.bfloat16() for t, c in zip(twin, copies) if c is not None], "copy")
    assert optim.launches == {"adam": before["adam"], "lerp": before["lerp"] + 100}


@pytest.mark.cuda
def test_the_refresh_kernel_casts_as_to_bfloat16(cuda_device) -> None:
    """``optim.cast_``, one launch of ``bf16_copy_refresh_kernel`` a list:
    equal to ``.to(torch.bfloat16)`` to the bit over misaligned tensors and
    150 small ones (two launches, each counted in ``bf16_copy.refreshes``),
    ties to even, signed zeros, infinities, subnormals and the largest
    finite values included."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    sources = _misaligned(OPTIM_SIZES, OPTIM_OFFSETS, cuda_device, fill="randn", gen=gen)
    special = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0, float("inf"),
                            -float("inf"), 1e-40, -3e-39, 3.389e38, -3.4e38, 65504.0],
                           device=cuda_device)
    sources[2][:special.numel()] = special
    rng = np.random.RandomState(9)
    sources += [torch.randn(int(n), device=cuda_device, generator=gen) * 10.0 ** (i % 7 - 3)
                for i, n in enumerate(rng.randint(0, 3000, 150))]
    copies = [torch.empty_like(s, dtype=torch.bfloat16) for s in sources]
    before = trace.counters["bf16_copy.refreshes"]
    optim.cast_(copies, sources)
    torch.cuda.synchronize()
    assert trace.counters["bf16_copy.refreshes"] - before == 2
    _assert_bitwise(copies, [s.bfloat16() for s in sources], "copy")


@pytest.mark.cuda
def test_a_bf16_gradient_without_a_copy_is_refused_on_the_card(cuda_device) -> None:
    """A bf16 gradient for a parameter with no copy, or a copy of another
    dtype: a ``ValueError`` naming it, nothing launched, nothing changed."""
    net = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Linear(7, 3)).to(cuda_device)
    opt = optim.Adam(net, 1e-3, torch.bfloat16)
    grads = [torch.randn_like(p) for p in opt.params.values()]
    grads[1] = grads[1].bfloat16()
    before, params = dict(optim.launches), [p.clone() for p in opt.params.values()]
    with pytest.raises(ValueError, match=r"adam: grads\[1\] is torch.bfloat16 and params\[1\] "
                                         r"has no bfloat16 copy"):
        opt.step(grads)
    targets = [torch.zeros(4, device=cuda_device)]
    with pytest.raises(ValueError, match=r"lerp: copies\[0\] is torch.float32"):
        optim.lerp_(targets, [torch.ones(4, device=cuda_device)], 0.01,
                    [torch.zeros(4, device=cuda_device)])
    torch.cuda.synchronize()
    assert optim.launches == before and opt.count == 0
    _assert_bitwise(list(opt.params.values()), params, "p")


def _kernels_per_update(agent, buf, device, steps=4):
    """Device operations per update in one call of the captured trainer, by
    the profiler."""
    gen = torch.Generator(device=device).manual_seed(3)
    trainer = make_offline_trainer(agent, buf.cfg, 128, steps_per_call=steps)
    trainer(buf.state, gen)  # the capture
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        trainer(buf.state, gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")]
    return len(kernels) / steps


@pytest.mark.cuda
def test_a_captured_fb_update_launches_124_fewer_kernels(cuda_device, monkeypatch) -> None:
    """fb_walker's structure (preprocess, no trunk, mix_ratio 0.5): a
    captured update on the copies runs exactly 124 device operations fewer
    than the same update with each Dense layer as ``nn.Linear`` computes it
    under autocast and its gradients taken by the float32 parameters: 90
    casts of a weight or a bias at its use (45 Linear calls) and 34 widenings
    of a gradient (17 Linear layers take one)."""
    agent, buf = _agent_and_buffer(cuda_device)
    ours = _kernels_per_update(agent, buf, cuda_device)
    with monkeypatch.context() as m:
        m.setattr(Dense, "forward", torch.nn.Linear.forward)
        m.setattr(optim.Adam, "leaves", property(lambda opt: list(opt.params.values())))
        m.setattr(optim.Bf16Copy, "refresh", staticmethod(lambda copies: None))
        autocast_path = _kernels_per_update(*_agent_and_buffer(cuda_device), cuda_device)
    assert autocast_path - ours == 124, (autocast_path, ours)


@pytest.mark.cuda
def test_copies_are_used_45_times_an_update_6_a_control_step_and_never_refreshed(
        cuda_device) -> None:
    """``bf16_copy.uses`` and ``bf16_copy.refreshes`` through the captured
    FB trainer and the captured collector: 45 uses a replayed update, 6 a
    replayed control step (the actor's six Linear layers), no refresh over
    the replays; a checkpoint loaded between calls is refreshed once, before
    the next replay."""
    agent, buf = _agent_and_buffer(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    trainer = make_offline_trainer(agent, buf.cfg, 128, steps_per_call=5)
    trainer(buf.state, gen)  # the capture
    counts = dict(trace.counters)
    trainer(buf.state, gen)
    assert trace.counters["bf16_copy.uses"] - counts["bf16_copy.uses"] == 5 * 45
    assert trace.counters["bf16_copy.refreshes"] == counts["bf16_copy.refreshes"]
    env = pointmass.PointMassMaze("reach_top_left", 8)
    walker = FBDDPGAgent(agent.cfg, env.spec.obs_dim, env.spec.action_dim,
                         device=cuda_device, seed=1)
    collector = EpisodeCollector(env, walker, 4, gen)
    collector(init_meta_batched(walker, gen, 4), *env.reset(gen, 4), 0)  # the capture
    counts = dict(trace.counters)
    collector(init_meta_batched(walker, gen, 4), *env.reset(gen, 4), 0)
    assert trace.counters["bf16_copy.uses"] - counts["bf16_copy.uses"] == 6 * 8
    assert trace.counters["bf16_copy.refreshes"] == counts["bf16_copy.refreshes"]
    agent.load_train_state({k: v.clone() for k, v in agent.train_state().items()})
    counts = dict(trace.counters)
    trainer(buf.state, gen)
    assert trace.counters["bf16_copy.refreshes"] - counts["bf16_copy.refreshes"] == 1
    assert trace.counters["bf16_copy.uses"] - counts["bf16_copy.uses"] == 5 * 45


@pytest.mark.cuda
def test_quadruped_control_step_spans_and_substeps(cuda_device) -> None:
    """The collector's captured quadruped control step: with tracing off it
    holds no mark; with it on, each replay runs the pairs of ``act``,
    ``env_step`` and the engine's three spans in each of its 8 substeps, and
    the marks are all it adds to the unmarked replay's kernels. The substep
    counter adds 8 at each replay. (Last in this file: it adds span names
    that ``test_traced_trainer_marks_every_replay`` does not expect.)"""
    env = quadruped.QuadrupedEnv("stand", episode_length=6)
    agent = FBDDPGAgent(FBDDPGConfig(**{**SMALL, "goal_space": "quad_pos_speed"}), 37, 8,
                        goal_dim=7, device=cuda_device, seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    collector = EpisodeCollector(env, agent, 4, gen)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    # the host spans' shadows on the device's timeline
    shadows = {"graph_replay", "act", "env_step", "p3d_kinematics", "p3d_contacts", "p3d_solve"}

    def episode():
        """The device operations of an episode's replays by name, and the
        counter's advance over it."""
        state, ts = env.reset(gen, 4)
        meta = init_meta_batched(agent, gen, 4)
        before = trace.counters["physics3d.substeps"]
        with torch.profiler.profile(activities=acts) as prof:
            collector(meta, state, ts, 0)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA") and e.name() not in shadows]
        return names, trace.counters["physics3d.substeps"] - before

    trace.reset_captures()
    collector(init_meta_batched(agent, gen, 4), *env.reset(gen, 4), 0)  # the capture
    plain, counted = episode()
    assert counted == 8 * 6
    try:
        trace.enable()
        collector(init_meta_batched(agent, gen, 4), *env.reset(gen, 4), 0)  # captured anew
        marked, counted = episode()
        spans = trace.device_span_names()
    finally:
        trace.disable()
    assert counted == 8 * 6
    assert [(r.name, r.marks) for r in trace.captures()] == [
        ("collector", 0), ("collector", 2 * (2 + 3 * 8))]
    # a pair a step of the collector's spans, of the engine's one a substep (the
    # process may know other spans from earlier tests)
    per_step = {"act": 1, "env_step": 1, "p3d_kinematics": 8, "p3d_contacts": 8, "p3d_solve": 8}
    assert set(per_step) <= set(spans.values())
    for i, name in spans.items():
        runs = 6 * per_step.get(name, 0)
        assert marked.count(f"trace_begin_{i}") == marked.count(f"trace_end_{i}") == runs, name
    # a capture made again runs a few of the first capture's copy kernels on the
    # copy engine, so the operations are counted, not named
    assert len([n for n in marked if not n.startswith("trace_")]) == len(plain)
