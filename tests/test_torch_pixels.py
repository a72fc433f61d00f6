"""The pixel path of the port against the JAX package: the rendered frames,
the frame stack, DrQ's random shifts, the pixel encoder, one pixel DDPG
update (with and without the encoder's step) and acting on frames.

Frames: float frames at atol 1e-3 and rtol 2e-5 on the 0-255 scale (a
float32 unit of the pixel grid through a soft edge's slope moves a value by
up to 1.5e-3, 9e-6 of it, measured on the hopper); the uint8
observations within 1 everywhere and equal on at least 99.9% of the pixels
(the pixel grid is ``linspace`` in float64 rounded to float32 in the port,
float32 arithmetic in JAX, one float32 unit apart on some pixels; a frame
value that lands on an integer may then truncate to the other side).
The shifts are exact. The encoder's features at rtol 1e-4 / atol 1e-5
(float32 sums of 81 x 32 products in another order). The update as
``tests/test_torch_ddpg.py``: the JAX update's own draws replayed from its
``jax.random.split`` (``ddpg.py:305``; the shifts from ``k_aug1`` and
``k_aug2``), metrics at rtol 1e-4 / atol 1e-5, parameters after Adam within
2*lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_agent_tpu.agents.ddpg import DDPGAgent as JaxDDPG
from controllable_agent_tpu.agents.ddpg import DDPGConfig as JaxDDPGConfig
from controllable_agent_tpu.agents.ddpg import _conv_repr_dim
from controllable_agent_tpu.data.episode_batch import EpisodeBatch as JaxBatch
from controllable_agent_tpu.envs import pixels as jpixels
from controllable_agent_tpu.models.networks import PixelEncoder as JaxEncoder
from controllable_agent_tpu.ops.augment import random_shift_aug as jax_shift
from controllable_agent_torch.agents import DDPGAgent, DDPGConfig, DDPGNoise
from controllable_agent_torch.agents.base import StepNoise
from controllable_agent_torch.convert import flax_to_state_dict, load_ddpg_train_state
from controllable_agent_torch.data.episode_batch import EpisodeBatch
from controllable_agent_torch.envs import pixels as tpixels
from controllable_agent_torch.models.networks import PixelEncoder, conv_repr_dim
from controllable_agent_torch.ops.augment import random_shift_aug

SIZE, STACK, PAD = 24, 3, 4
SHAPE = (SIZE, SIZE, 3 * STACK)
N, ACT = 8, 6
SMALL = dict(hidden_dim=32, batch_size=N, obs_type="pixels", aug_pad=PAD)
EQUAL_SHARE = 0.999
TASKS = ("walker_walk", "cheetah_run", "hopper_hop", "point_mass_maze_reach_top_left")


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread in these tests: the suite runs in several
    processes at once, and an OpenMP pool of every core in each of them
    spins against the others (the pixel pretrain runs took 80x their time
    alone with it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _physics(task: str, n: int = 6, steps: int = 4) -> torch.Tensor:
    """Physics rows of the port's environment: resets and a few random
    steps (the point-mass mass anywhere in the arena)."""
    env = tpixels.make_pixel_env(task, size=SIZE, episode_length=steps + 1).env
    gen = torch.Generator().manual_seed(0)
    if task.startswith("point_mass"):
        xy = torch.rand((n, 2), generator=gen) * 0.58 - 0.29
        return torch.cat([xy, torch.zeros(n, 2)], -1)
    state, ts = env.reset(gen, n)
    rows = [ts.physics]
    for _ in range(steps):
        action = torch.rand((n, env.spec.action_dim), generator=gen) * 2 - 1
        state, ts = env.step(state, action)
        rows.append(ts.physics)
    return torch.cat(rows)


def _frame_fns(task: str, size: int = SIZE):
    jenv = jpixels.make_pixel_env(task, size=size)
    tenv = tpixels.make_pixel_env(task, size=size)
    return jax.jit(jax.vmap(jenv.frame_fn)), tenv.frame_fn, jenv, tenv


def _assert_uint8_close(got: torch.Tensor, want, what: str) -> None:
    got, want = got.numpy().astype(np.int32), np.asarray(want).astype(np.int32)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    assert diff.max() <= 1, what
    assert (diff == 0).mean() >= EQUAL_SHARE, f"{what}: {(diff == 0).mean()}"


@pytest.mark.parametrize("task", TASKS)
def test_frames_match_jax(task) -> None:
    """Float frames and their uint8 casts of the same physics rows."""
    jframe, tframe, _, _ = _frame_fns(task)
    phys = _physics(task)
    want = np.asarray(jframe(jnp.asarray(phys.numpy())))
    got = tframe(phys)
    assert got.shape == want.shape == (phys.shape[0], SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-3)
    _assert_uint8_close(got.to(torch.uint8), want.astype(np.uint8), task)
    assert float(got.std()) > 1.0  # not a blank frame


def test_frames_at_84_and_the_encoder_width() -> None:
    """The default 84 x 84 frames of the walker, and the 39,200 features of
    the encoder on them, as the JAX package sizes them."""
    jframe, tframe, jenv, tenv = _frame_fns("walker_walk", 84)
    phys = _physics("walker_walk", n=2, steps=1)
    _assert_uint8_close(tframe(phys).to(torch.uint8),
                        np.asarray(jframe(jnp.asarray(phys.numpy()))).astype(np.uint8), "84")
    assert tenv.spec.obs_shape == jenv.spec.obs_shape == (84, 84, 9)
    assert tenv.spec.obs_dim == jenv.spec.obs_dim == 84 * 84 * 9
    assert tenv.spec.obs_dtype == torch.uint8
    assert conv_repr_dim(84, 84) == _conv_repr_dim(84, 84) == 32 * 35 * 35
    enc = PixelEncoder(9)
    assert enc(torch.zeros((1, 84, 84, 9), dtype=torch.uint8)).shape == (1, 39200)


@pytest.mark.parametrize("task", ["walker_walk", "point_mass_maze_reach_top_left"])
def test_frame_stack_matches_jax(task) -> None:
    """Reset tiles the first frame, each step drops the oldest: the port's
    observations over a reset and three steps against JAX's ``_obs`` of the
    JAX frames of the same physics, stacked as its wrapper stacks them."""
    jframe, _, jenv, tenv = _frame_fns(task)
    gen = torch.Generator().manual_seed(1)
    state, ts = tenv.reset(gen, 3)
    got, physics = [ts.observation], [ts.physics]
    for _ in range(3):
        action = torch.rand((3, tenv.spec.action_dim), generator=gen) * 2 - 1
        state, ts = tenv.step(state, action)
        got.append(ts.observation)
        physics.append(ts.physics)
    assert all(o.dtype == torch.uint8 and o.shape == (3, tenv.spec.obs_dim) for o in got)
    frames = None
    for step, phys in enumerate(physics):
        new = jframe(jnp.asarray(phys.numpy()))  # [E, H, W, C]
        frames = (jnp.tile(new[:, None], (1, STACK, 1, 1, 1)) if frames is None
                  else jnp.concatenate([frames[:, 1:], new[:, None]], 1))
        want = jax.vmap(jenv._obs)(frames)
        _assert_uint8_close(got[step], want, f"step {step}")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_random_shift_matches_jax(dtype) -> None:
    """The same shifts give the same images, to the bit, in the input's dtype."""
    rng = np.random.RandomState(2)
    imgs = (rng.rand(N, SIZE, SIZE, 9) * 255).astype(dtype)
    key = jax.random.key(3)
    want = np.asarray(jax_shift(key, jnp.asarray(imgs), PAD))
    shifts = torch.from_numpy(np.array(jax.random.randint(key, (N, 2), 0, 2 * PAD + 1)))
    got = random_shift_aug(torch.from_numpy(imgs), shifts.long(), PAD)
    assert got.dtype == torch.from_numpy(imgs).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # an explicit crop of the edge-padded images
    padded = np.pad(imgs, ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)), mode="edge")
    for b, (r, c) in enumerate(shifts.tolist()):
        np.testing.assert_array_equal(got[b].numpy(), padded[b, r:r + SIZE, c:c + SIZE])


def test_pixel_encoder_matches_jax() -> None:
    """The flax encoder's weights through ``convert.py``; features in the
    JAX (height, width, channel) order."""
    rng = np.random.RandomState(4)
    imgs = (rng.rand(4, 32, 32, 9) * 255).astype(np.uint8)
    jenc = JaxEncoder()
    params = jenc.init(jax.random.key(5), jnp.zeros((1, 32, 32, 9)))
    enc = PixelEncoder(9)
    enc.load_state_dict(flax_to_state_dict(params))
    want = np.asarray(jenc.apply(params, jnp.asarray(imgs)))
    got = enc(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == want.shape == (4, conv_repr_dim(32, 32))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)


def _pixel_pair(**overrides):
    jcfg = JaxDDPGConfig(**SMALL, **overrides)
    jagent = JaxDDPG(jcfg, int(np.prod(SHAPE)), ACT, obs_shape=SHAPE)
    state = jagent.init(jax.random.key(6))
    agent = DDPGAgent(DDPGConfig(**SMALL, **overrides), int(np.prod(SHAPE)), ACT, device="cpu",
                      obs_shape=SHAPE)
    load_ddpg_train_state(agent, jax.tree.map(np.asarray, state))
    return jcfg, jagent, state, agent


def _pixel_batch(seed: int = 7):
    rng = np.random.RandomState(seed)
    frames = lambda: (rng.rand(N, int(np.prod(SHAPE))) * 255).astype(np.uint8)  # noqa: E731
    arrays = dict(obs=frames(), action=rng.uniform(-1, 1, (N, ACT)).astype(np.float32),
                  reward=rng.rand(N, 1).astype(np.float32), next_obs=frames(),
                  discount=np.full((N, 1), 0.98, np.float32))
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            EpisodeBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def jax_pixel_noise(key: jax.Array) -> DDPGNoise:
    """The draws of the JAX pixel update: its four keys give the target
    policy's noise, the actor's, and the two shifts."""
    k_critic, k_actor, k_aug1, k_aug2 = jax.random.split(key, 4)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    shifts = lambda k: t(jax.random.randint(k, (N, 2), 0, 2 * PAD + 1)).long()  # noqa: E731
    return DDPGNoise(critic_normal=t(jax.random.normal(k_critic, (N, ACT))),
                     actor_normal=t(jax.random.normal(k_actor, (N, ACT))),
                     obs_shifts=shifts(k_aug1), next_obs_shifts=shifts(k_aug2))


def _close_params(module: torch.nn.Module, flax_params, lr: float, what: str) -> None:
    want = flax_to_state_dict(flax_params)
    got = module.state_dict()
    assert set(got) == set(want), what
    for name in want:
        diff = float((got[name].float() - want[name]).abs().max())
        assert diff <= 2 * lr + 1e-6, f"{what}.{name}: {diff}"


@pytest.mark.parametrize("update_encoder", [True, False], ids=["encoder_step", "frozen"])
def test_pixel_update_matches_jax(update_encoder) -> None:
    """One pixel DDPG update: the metrics, every network after Adam, the
    encoder's Adam moments; ``update_encoder=False`` leaves the encoder as
    it was."""
    jcfg, jagent, state, agent = _pixel_pair(update_encoder=update_encoder)
    jbatch, tbatch = _pixel_batch()
    key = jax.random.key(8)
    new_state, want = jax.jit(jagent._update)(state, jbatch, key)
    got = agent._update(tbatch, jax_pixel_noise(key))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for module, tree, what in ((agent.actor, new_state.actor_params, "actor"),
                               (agent.critic, new_state.critic_params, "critic"),
                               (agent.target_critic, new_state.target_critic_params, "target"),
                               (agent.encoder, new_state.encoder_params, "encoder")):
        _close_params(module, tree, jcfg.lr, what)
    before = flax_to_state_dict(state.encoder_params)
    moved = any(not torch.equal(v, before[k]) for k, v in agent.encoder.state_dict().items())
    assert moved == update_encoder
    adam = new_state.encoder_opt_state[0]
    assert agent.encoder_opt.count == int(adam.count) == int(update_encoder)
    for name, mu in flax_to_state_dict(adam.mu).items():
        np.testing.assert_allclose(agent.encoder_opt.mu[name].numpy(), mu.numpy(), rtol=1e-3,
                                   atol=1e-7, err_msg=name)


def test_pixel_act_matches_jax() -> None:
    """``act`` encodes the frames first: the eval-mode mean and the
    exploring sample from the JAX draws."""
    _, jagent, state, agent = _pixel_pair()
    jbatch, tbatch = _pixel_batch(9)
    key = jax.random.key(10)
    want = jagent._act(state, jbatch.obs, {}, jnp.asarray(0), key, eval_mode=True)
    got = agent.act(tbatch.obs, {}, 0, eval_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    want = jagent._act(state, jbatch.obs, {}, jnp.asarray(0), key)
    k_sample, k_expl = jax.random.split(key)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    noise = StepNoise(act_normal=t(jax.random.normal(k_sample, (N, ACT))),
                      act_uniform=t(jax.random.uniform(k_expl, (N, ACT))))
    got = agent.act(tbatch.obs, {}, 0, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
