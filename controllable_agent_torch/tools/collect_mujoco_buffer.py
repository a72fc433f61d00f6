"""Collect a real dm_control exploration buffer in ExORL episode format (the
port's counterpart of the root ``tools/collect_mujoco_buffer.py``).

The data half of the reference's offline recipe (reference README.md:63-78:
an ExORL RND walker buffer, then offline FB), made locally: an exploration
agent (RND by default) trains online while the real dm_control environment
steps on the host, and every episode is saved as an ExORL-format ``.npz``
(observation / action / reward / discount / physics, arrays [T+1, ...]),
the format that ``train_offline`` reads with ``physics_format=mujoco_<domain>``.

The work is split in two. The device half (``Collector``) holds the agent,
its replay and its captured trainer on ``--device`` (the card unless
``--device cpu``), and acts from a copy of the actor's parameters on the same
device, refreshed every ``--policy-refresh-every`` episodes: one observation
goes up and one action comes down per step. The host loop (``collect``)
steps MuJoCo, writes the files, commits each episode to the replay and runs
bursts of ``UPDATES_PER_CALL`` updates between episodes (one update per two
frames by default). The first ``--random-episodes`` act uniformly at random
from ``np.random.RandomState(seed)``, so at a seed their files are the JAX
tool's to the bit.

    python -m controllable_agent_torch.tools.collect_mujoco_buffer --task walker_stand \\
        --episodes 300 --out exorl_data/walker_rnd [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..agents import agent_classes
from ..config import apply_overrides
from ..data import ReplayBuffer
from ..data.exorl import load_exorl_episodes
from ..envs.base import EnvSpec
from ..train.loops import make_offline_trainer
from ..utils.device import DeviceLike, resolve_device
from . import mujoco_bridge as bridge

UPDATES_PER_CALL = 100  # updates per trainer call, as the JAX tool's steps_per_call
Episode = tp.Dict[str, np.ndarray]


def flat_obs(ts: tp.Any) -> np.ndarray:
    """dm_control's observation dict, flattened in its order, float32."""
    return np.concatenate(
        [np.asarray(v, np.float32).ravel() for v in ts.observation.values()])


class Collector:
    """The collector's device half: the exploration agent (``agent_name`` at
    its defaults, ``batch_size``, ``num_expl_steps = random_episodes × T``,
    then ``overrides``), a replay of ``max_episodes`` episodes of
    ``spec.episode_length`` steps sampled with the agent's n-step returns,
    the captured trainer, and a copy of the agent that acts from its own
    copy of the actor's parameters (``refresh_policy`` copies them over)."""

    def __init__(self, agent_name: str, spec: EnvSpec, max_episodes: int, *,
                 batch_size: int, random_episodes: int,
                 overrides: tp.Sequence[str] = (), seed: int = 1,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.spec = spec
        cfg_cls, agent_cls = agent_classes(agent_name)
        cfg = dataclasses.replace(cfg_cls(), batch_size=batch_size,
                                  num_expl_steps=random_episodes * spec.episode_length)
        cfg = apply_overrides(cfg, list(overrides))
        self.agent = agent_cls(cfg, spec.obs_dim, spec.action_dim, device=self.device,
                               seed=seed)
        self.buffer = ReplayBuffer(max_episodes, discount=0.99, future=0.99,
                                   max_episode_length=spec.episode_length, device=self.device)
        nstep = int(getattr(cfg, "nstep", 1) or 1)
        if nstep > 1:  # ExORL's exploration agents train on n-step returns
            self.buffer.cfg = dataclasses.replace(self.buffer.cfg, nstep=nstep)
        self.trainer = make_offline_trainer(self.agent, self.buffer.cfg, batch_size,
                                            UPDATES_PER_CALL)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.policy = copy.deepcopy(self.agent)
        self.updates = 0

    @staticmethod
    def _actor(agent: tp.Any) -> torch.nn.Module:
        return getattr(agent, "ddpg", agent).actor

    @torch.no_grad()
    def refresh_policy(self) -> None:
        """The acting copy takes the trained actor's parameters (device copies)."""
        self._actor(self.policy).load_state_dict(self._actor(self.agent).state_dict())

    @torch.no_grad()
    def act(self, obs: np.ndarray, step: int) -> np.ndarray:
        """The exploration policy's action for one observation at the global
        ``step`` (its stddev schedule, uniform before ``num_expl_steps``)."""
        obs_t = torch.as_tensor(obs, dtype=torch.float32, device=self.device).unsqueeze(0)
        action = self.policy.policy_act(obs_t, {}, step, self.generator, eval_mode=False)
        return action[0].float().cpu().numpy()

    def add_episode(self, episode: Episode) -> None:
        self.buffer.add_episode(episode)

    def preload(self, load_dir: Path) -> int:
        """Every ExORL episode of ``load_dir`` into the (empty) replay, in one
        transfer per array; returns the replay's episodes."""
        self.buffer.load_episodes(load_exorl_episodes(Path(load_dir)))
        return len(self.buffer)

    def train(self, calls: int) -> tp.Dict[str, float]:
        """``calls`` bursts of ``UPDATES_PER_CALL`` updates; the last
        burst's mean metrics."""
        metrics: tp.Dict[str, torch.Tensor] = {}
        for _ in range(calls):
            metrics = self.trainer(self.buffer.state, self.generator)
        self.updates += calls * UPDATES_PER_CALL
        return {k: float(v) for k, v in metrics.items()}


def collect(env: tp.Any, collector: Collector, out_dir: Path, episodes: int, *,
            random_episodes: int, updates_per_episode: int, policy_refresh_every: int,
            start_ep: int = 0, seed: int = 1) -> tp.Dict[str, float]:
    """The host loop: ``episodes`` episodes of ``env`` (T steps each), each
    saved as ``episode_{start_ep + ep:06d}_{T}.npz`` and committed to the
    replay. Episodes before ``random_episodes`` take uniform actions from
    ``np.random.RandomState(seed)``, the others the collector's policy, which
    is refreshed every ``policy_refresh_every`` episodes; from the last
    random episode on, each is followed by ``updates_per_episode`` updates in
    bursts. Returns the seconds spent per part."""
    spec = env.action_spec()
    action_dim = int(np.prod(spec.shape))
    horizon = collector.spec.episode_length
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    global_step = 0
    seconds = {"env": 0.0, "act": 0.0, "train": 0.0, "refresh": 0.0}
    started = time.time()
    for ep in range(episodes):
        if ep % max(policy_refresh_every, 1) == 0:
            t0 = time.time()
            collector.refresh_policy()
            seconds["refresh"] += time.time() - t0
        ts = env.reset()
        rows: tp.Dict[str, tp.List[np.ndarray]] = {
            "observation": [flat_obs(ts)], "action": [np.zeros(action_dim, np.float32)],
            "reward": [np.zeros(1, np.float32)], "discount": [np.ones(1, np.float32)],
            "physics": [bridge.mj_state(env).astype(np.float32)]}
        ep_reward = 0.0
        for _ in range(horizon):
            if ep < random_episodes:
                action = rng.uniform(spec.minimum, spec.maximum, spec.shape).astype(np.float32)
            else:
                t0 = time.time()
                action = collector.act(rows["observation"][-1], global_step)
                seconds["act"] += time.time() - t0
            t0 = time.time()
            ts = env.step(action)
            seconds["env"] += time.time() - t0
            global_step += 1
            reward = 0.0 if ts.reward is None else float(ts.reward)
            ep_reward += reward
            rows["observation"].append(flat_obs(ts))
            rows["action"].append(action)
            rows["reward"].append(np.full(1, reward, np.float32))
            rows["discount"].append(np.ones(1, np.float32))
            rows["physics"].append(bridge.mj_state(env).astype(np.float32))
        episode = {k: np.stack(v) for k, v in rows.items()}
        np.savez(out_dir / f"episode_{start_ep + ep:06d}_{horizon}.npz", **episode)
        collector.add_episode(episode)
        if ep >= random_episodes - 1:  # bursts of updates (1 per 2 frames by default)
            t0 = time.time()
            collector.train(max(updates_per_episode // UPDATES_PER_CALL, 1))
            seconds["train"] += time.time() - t0
        if (ep + 1) % 10 == 0 or ep == 0:
            elapsed = time.time() - started
            print(f"ep {ep + 1}/{episodes} task_reward {ep_reward:.1f} ({elapsed:.0f}s, "
                  f"{(ep + 1) * horizon / elapsed:.0f} fps; env {seconds['env']:.0f}s act "
                  f"{seconds['act']:.0f}s train {seconds['train']:.0f}s refresh "
                  f"{seconds['refresh']:.0f}s)", flush=True)
    return seconds


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> Collector:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--task", default="walker_stand")
    p.add_argument("--episodes", type=int, default=300)
    p.add_argument("--out", default="exorl_data/walker_rnd")
    p.add_argument("--agent", default="rnd")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--random-episodes", type=int, default=10,
                   help="initial uniform-random episodes (seed frames)")
    p.add_argument("--updates-per-episode", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--episode-length", type=int, default=1000)
    p.add_argument("--policy-refresh-every", type=int, default=5,
                   help="episodes between refreshes of the acting copy of the actor's "
                        "parameters (a slightly stale exploration policy, as the JAX tool's)")
    p.add_argument("--load-dir", default=None,
                   help="preload existing ExORL episodes into the replay buffer and warm "
                        "up the explorer on them before collecting (continue a previous "
                        "collection run)")
    p.add_argument("--warmup-updates", type=int, default=0,
                   help="gradient updates on the preloaded buffer before the first new "
                        "episode")
    p.add_argument("--start-ep", type=int, default=0,
                   help="episode-file numbering offset (append to an existing directory)")
    p.add_argument("--agent-override", action="append", default=[], metavar="KEY=VALUE",
                   help="agent config overrides (repeatable), e.g. --agent-override "
                        "rnd_scale=2.0 for a tuned exploration attempt")
    p.add_argument("--device", default="cuda",
                   help="where the agent, its replay and its updates run (the card "
                        "unless cpu); MuJoCo steps on the host")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    env = bridge.make_env(args.task, seed=args.seed)
    ts = env.reset()
    obs_dim = flat_obs(ts).shape[0]
    action_dim = int(np.prod(env.action_spec().shape))
    horizon = args.episode_length
    print(f"{args.task}: obs_dim={obs_dim} action_dim={action_dim} T={horizon} on {device}")
    spec = EnvSpec(obs_dim=obs_dim, action_dim=action_dim,
                   physics_dim=bridge.mj_state(env).shape[0], goal_dim=0,
                   episode_length=horizon)
    # the ring is sized by the preloaded episodes actually there: a fixed
    # headroom would evict the oldest of them once it overflowed
    n_preload = (len(list(Path(args.load_dir).glob("*.npz")))
                 if args.load_dir is not None else 0)
    collector = Collector(args.agent, spec, args.episodes + n_preload,
                          batch_size=args.batch_size, random_episodes=args.random_episodes,
                          overrides=args.agent_override, seed=args.seed, device=device)
    if args.load_dir is not None:
        print(f"preloaded {collector.preload(Path(args.load_dir))} episodes from "
              f"{args.load_dir}", flush=True)
    if args.warmup_updates > 0:
        if n_preload == 0:
            raise SystemExit("--warmup-updates needs a non-empty --load-dir "
                             "(updates against an empty buffer sample garbage)")
        collector.train(max(args.warmup_updates // UPDATES_PER_CALL, 1))
        print(f"warmed up {args.warmup_updates} updates", flush=True)
    collect(env, collector, Path(args.out), args.episodes,
            random_episodes=args.random_episodes,
            updates_per_episode=args.updates_per_episode,
            policy_refresh_every=args.policy_refresh_every, start_ep=args.start_ep,
            seed=args.seed)
    print(f"done: {args.episodes} episodes -> {args.out}")
    return collector


if __name__ == "__main__":
    main()
