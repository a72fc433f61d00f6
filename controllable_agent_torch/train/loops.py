"""Training loops (mirror of ``controllable_agent_tpu/train/loops.py``).

All of it is ported: the offline trainer, the evaluation rollout, the
episode collector and the online trainer. The trainers also run
data-parallel over a ``torch.distributed`` process group (``group=``; the
JAX package's ``mesh=``): each process updates on its rows of the batch
and every process's parameters stay equal (``utils/dist.py``).

The JAX trainer is one compiled program of ``steps_per_call`` updates with
the replay sampling inside it (``jit`` over ``lax.scan``). Its counterpart
on a CUDA device is a CUDA graph (``utils.graphs.CapturedProgram``): sample
-> ``agent.update`` -> metric sums are captured once and replayed, so an
update costs the host one graph launch instead of a thousand kernel
launches. The rollout and the collector capture one control step the same
way. On the CPU the same functions run eagerly.
"""

from __future__ import annotations

import dataclasses
import time
import typing as tp

import torch

from ..agents.base import MetaDict, StepNoise
from ..data import replay as replay_lib
from ..data.replay import ReplayState, SampleConfig
from ..utils import trace
from ..utils.dist import Shard
from ..utils.graphs import WARMUP_RUNS, CapturedProgram

class OfflineTrainer:
    """``trainer(replay_state, generator, steps=None) -> metrics`` runs
    ``steps`` (default ``steps_per_call``) updates of ``agent`` in place, each
    sampling its batch on the replay's device. Metrics are the mean over the
    call, left on the device (no host sync inside the call).

    ``capture`` (default: whether the agent is on a CUDA device) runs the
    updates as replays of a CUDA graph of one update, sampling included
    (deeper graphs measured no faster). The graph is bound to the replay's
    tensors and the generator it was captured with, not to its fill level
    (the sampler reads none): episodes committed in place keep it serving,
    and it is captured anew only for another generator or another storage,
    or after the tracing switch flipped (``captures`` counts the captures).
    ``capture=False`` on a CUDA device is the eager loop, kept to be
    measured beside the captured one. Each update is the device spans
    ``sample`` and ``update`` (``utils/trace.py``).

    With a process ``group`` the updates are data-parallel (the JAX
    ``make_dp_offline_trainer``): every process draws the same global batch
    of ``batch_size`` rows from a generator seeded alike, keeps its rows,
    and takes the agent's data-parallel update, whose noise is drawn for the
    global batch from the same generator. The collectives are captured with
    the rest of the update (the warm-up runs create the communicator first).
    """

    def __init__(self, agent: tp.Any, sample_cfg: SampleConfig, batch_size: int,
                 steps_per_call: int, with_future: bool = True,
                 capture: tp.Optional[bool] = None, group: tp.Any = None) -> None:
        on_cuda = agent.device.type == "cuda"
        self.capture = on_cuda if capture is None else capture
        if self.capture and not on_cuda:
            raise ValueError("a CUDA graph needs the agent on a CUDA device")
        self.agent, self.sample_cfg, self.batch_size = agent, sample_cfg, batch_size
        self.steps_per_call, self.with_future = steps_per_call, with_future
        self.group, self.shard = group, Shard(group)
        self.captures = 0
        self._sums: tp.Dict[str, torch.Tensor] = {}  # fixed buffers, summed into in place
        self._program: tp.Optional[CapturedProgram] = None
        self._bound_to: tp.Optional[tp.Tuple] = None

    def _sample(self, replay_state: ReplayState, generator: torch.Generator) -> tp.Any:
        """This process's batch: the whole batch, or its rows of it."""
        batch = replay_lib.sample(replay_state, generator, self.batch_size,
                                  self.sample_cfg, with_future=self.with_future)
        return self.shard.batch(batch)

    def _generators(self, generator: torch.Generator) -> tp.List[torch.Generator]:
        """Every generator an update draws from."""
        return [generator]

    def release(self) -> None:
        """Free the captured program (its graphs and their pool); the next
        call captures anew. A program that holds a group's collectives must go
        before the group: destroying an NCCL group waits for it."""
        self._program, self._bound_to = None, None

    def _run_updates(self, replay_state: ReplayState, generator: torch.Generator,
                     count: int) -> None:
        device = self.agent.device
        for _ in range(count):
            with trace.device_span("sample", device):
                batch = self._sample(replay_state, generator)
            with trace.device_span("update", device):
                if self.group is None:
                    metrics = self.agent.update(batch, generator)
                else:
                    metrics = self.agent.update(batch, generator, group=self.group)
            for k, v in metrics.items():
                if k in self._sums:
                    self._sums[k] += v.float()
                else:
                    self._sums[k] = v.float().clone()

    def __call__(self, replay_state: ReplayState, generator: torch.Generator,
                 steps: tp.Optional[int] = None) -> tp.Dict[str, torch.Tensor]:
        steps = self.steps_per_call if steps is None else steps
        if self.capture:
            binding = (generator, replay_state.ep_lengths.data_ptr(),
                       tuple(v.data_ptr() for v in replay_state.storage.values()),
                       trace.enabled())
            if self._bound_to is None or self._bound_to[0] is not generator \
                    or self._bound_to[1:] != binding[1:]:
                self._program = CapturedProgram(
                    lambda: self._run_updates(replay_state, generator, 1),
                    self.agent.device, self.agent.train_state().values(),
                    self._generators(generator), name="trainer")
                self._bound_to = binding
                self.captures += 1
        if self._sums:
            torch._foreach_zero_(list(self._sums.values()))
        if self._program is not None:
            self._program.replay(steps)
        else:
            self._run_updates(replay_state, generator, steps)
        return {k: v / steps for k, v in self._sums.items()}


# the JAX package's name for the trainer
make_offline_trainer = OfflineTrainer


def _tensors_of(tree: tp.Any) -> tp.List[torch.Tensor]:
    """The tensors of an environment state (a dataclass of tensors and of
    further states), in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _tensors_of(getattr(tree, f.name))]
    return []


def _cloned(tree: tp.Any) -> tp.Any:
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _cloned(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def _meta_dims(agent: tp.Any) -> tp.Dict[str, int]:
    """The width of each meta entry of ``agent``'s policy, as the agent names
    them (``meta_dims``: a task vector's, DIAYN's skill, APS's task, a goal
    agent's ``g``); none for an agent without a meta (DDPG)."""
    return dict(getattr(agent, "meta_dims", {}))


class Rollout:
    """``num_envs`` evaluation episodes of ``env`` under ``agent``'s policy in
    ``eval_mode``, advanced together one control step at a time.

    The JAX package ``vmap``s one episode's ``lax.scan`` over the episodes;
    here the step is batched and its program (policy -> ``env.step`` ->
    reward sum -> trajectory writes at a step index that lives on the
    device) touches only fixed tensors, so that on a CUDA device it is
    captured once (``CapturedProgram``) and replayed ``episode_length``
    times, and a step costs the host one graph launch. ``capture`` defaults
    to whether the agent is on a CUDA device; on the CPU, or with
    ``capture=False``, the same function runs eagerly.

    ``rollout(z, state, timestep)`` takes z as [z_dim] or, for a task per
    episode, [E, z_dim] (None for an agent without a meta, such as DDPG; a
    meta dict for an agent whose meta is not a task vector, such as DIAYN's
    skill), and the state and first timestep of a ``reset`` of ``num_envs``
    instances. It returns (totals [E], physics [E, T, P], observations
    [E, T, O]): the trajectories after each step, in buffers that the next
    run overwrites. Pixel observations are not kept (None), as in JAX: ten
    episodes of 84 x 84 x 9 frames would be 6.4 GB. ``rewards`` [E, T] holds
    each step's reward. ``horizon`` (the environment's episode length by
    default) is the number of steps of a run: the demo rolls out its own
    number of steps. ``capture_seconds`` is the seconds its captured
    program's build took (its warm-up steps included; ``trace.captures()``),
    None before then. A step is the device spans ``act`` and ``env_step``;
    the step is captured anew after the tracing switch flipped.
    """

    def __init__(self, env: tp.Any, agent: tp.Any, num_envs: int,
                 capture: tp.Optional[bool] = None,
                 horizon: tp.Optional[int] = None) -> None:
        on_cuda = agent.device.type == "cuda"
        self.capture = on_cuda if capture is None else capture
        if self.capture and not on_cuda:
            raise ValueError("a CUDA graph needs the agent on a CUDA device")
        self.env, self.agent, self.num_envs = env, agent, num_envs
        spec, device = env.spec, agent.device
        self.horizon = spec.episode_length if horizon is None else horizon
        self.meta = {key: torch.zeros((num_envs, dim), device=device)
                     for key, dim in _meta_dims(agent).items()}
        self.totals = torch.zeros(num_envs, device=device)
        self.rewards = torch.zeros((num_envs, self.horizon), device=device)
        self.physics = torch.zeros((num_envs, self.horizon, spec.physics_dim), device=device)
        self.observations = (None if spec.obs_shape else torch.zeros(
            (num_envs, self.horizon, spec.obs_dim), device=device))
        self._index = torch.zeros(1, dtype=torch.int64, device=device)
        self._obs = torch.zeros((num_envs, spec.obs_dim), dtype=spec.obs_dtype, device=device)
        self._state: tp.Any = None
        self._program: tp.Optional[CapturedProgram] = None

    @property
    def capture_seconds(self) -> tp.Optional[float]:
        return None if self._program is None else self._program.record.seconds

    @torch.no_grad()
    def _step(self) -> None:
        device = self.agent.device
        with trace.device_span("act", device):
            action = self.agent.policy_act(self._obs, self.meta, 10 ** 9, eval_mode=True)
        with trace.device_span("env_step", device):
            state, ts = self.env.step(self._state, action.float())
        for held, new in zip(_tensors_of(self._state), _tensors_of(state)):
            held.copy_(new)
        self._obs.copy_(ts.observation)
        self.totals += ts.reward
        self.rewards.index_copy_(1, self._index, ts.reward.to(self.rewards.dtype).unsqueeze(1))
        self.physics.index_copy_(1, self._index, ts.physics.unsqueeze(1))
        if self.observations is not None:
            self.observations.index_copy_(1, self._index, ts.observation.unsqueeze(1))
        self._index += 1

    def _set_inputs(self, z: tp.Union[None, torch.Tensor, MetaDict], state: tp.Any,
                    ts: tp.Any) -> None:
        for held, new in zip(_tensors_of(self._state), _tensors_of(state)):
            held.copy_(new)
        self._obs.copy_(ts.observation)
        metas = z if isinstance(z, dict) else {key: z for key in self.meta}
        for key, held in self.meta.items():
            assert metas.get(key) is not None, f"this agent's policy takes {key!r}"
            held.copy_(metas[key].expand_as(held))
        self.totals.zero_()
        self._index.zero_()

    def __call__(self, z: tp.Union[None, torch.Tensor, MetaDict], state: tp.Any, ts: tp.Any
                 ) -> tp.Tuple[torch.Tensor, torch.Tensor, tp.Optional[torch.Tensor]]:
        if ts.observation.shape != self._obs.shape:
            raise ValueError(f"the rollout was built for observations {tuple(self._obs.shape)}, "
                             f"the reset gave {tuple(ts.observation.shape)}")
        if self._state is None:
            self._state = _cloned(state)
        self._set_inputs(z, state, ts)
        if self.capture and (self._program is None
                             or self._program.traced != trace.enabled()):
            # the capture's warm-up steps run from these inputs, which are set again
            # below; each writes its column of the buffers, so an episode of one step
            # warms up once
            self._program = CapturedProgram(self._step, self.agent.device,
                                            warmup_runs=min(WARMUP_RUNS, self.horizon),
                                            name="rollout")
            self._set_inputs(z, state, ts)
        if self._program is not None:
            self._program.replay(self.horizon)
        else:
            for _ in range(self.horizon):
                self._step()
        return self.totals, self.physics, self.observations


def init_meta_batched(agent: tp.Any, generator: torch.Generator,
                      n: int) -> MetaDict:
    """Per-environment meta dict [n, ...]: ``init_meta`` drawn ``n`` times."""
    metas = [agent.init_meta(generator) for _ in range(n)]
    return {k: torch.stack([m[k] for m in metas]) for k in metas[0]} if metas else {}


class EpisodeCollector:
    """``num_envs`` training episodes of ``env`` under ``agent``'s exploring
    policy (``eval_mode=False``), the counterpart of the JAX
    ``make_episode_collector``.

    One control step is: ``rollout_update_meta`` (the in-episode z
    resampling; skipped under ``hold_meta``, so the caller's meta drives the
    whole episode) -> ``policy_act`` with its noise -> ``env.step`` -> writes
    into the collector's own ``[T+1, E, .]`` buffers at the step index, which
    lives on the device. Everything the step reads is a fixed tensor: the
    environments' state, the meta, the index inside the episode and the
    global step that the exploration schedules take. So on a CUDA device the
    step is captured once (``CapturedProgram``, its draws from ``generator``,
    which is registered with the graph; again after the tracing switch
    flipped) and replayed ``T`` times; on the CPU the same function runs
    eagerly. A step is the device spans ``act`` (the noise, the meta and the
    policy) and ``env_step``; the rest is the writes.

    ``collector(meta, state, timestep, step)`` takes the initial meta
    ([E, ...] per key), the state and first timestep of a ``reset`` of
    ``num_envs`` instances and the global step. It returns the trajectory as
    the JAX collector lays it out: observation, action, reward [.., 1],
    discount [.., 1], physics, the meta columns and, with ``goal_fn``, goal,
    each [T+1, E, ...] with the episode's first dummy transition and the
    initial meta at index 0. The tensors are the collector's buffers (the
    goal excepted): the next run overwrites them. ``noise`` (a sequence of
    ``T`` ``StepNoise``) replaces the generator's draws, eagerly; the parity
    tests hand in the JAX collector's draws through it.
    """

    def __init__(self, env: tp.Any, agent: tp.Any, num_envs: int,
                 generator: torch.Generator,
                 goal_fn: tp.Optional[tp.Callable[[torch.Tensor], torch.Tensor]] = None,
                 hold_meta: bool = False, capture: tp.Optional[bool] = None) -> None:
        on_cuda = agent.device.type == "cuda"
        self.capture = on_cuda if capture is None else capture
        if self.capture and not on_cuda:
            raise ValueError("a CUDA graph needs the agent on a CUDA device")
        self.env, self.agent, self.num_envs = env, agent, num_envs
        self.generator, self.goal_fn, self.hold_meta = generator, goal_fn, hold_meta
        spec, device = env.spec, agent.device
        self.horizon = horizon = spec.episode_length

        def buffer(*shape: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
            return torch.zeros((horizon + 1, num_envs) + shape, dtype=dtype, device=device)

        # pixel frames stay uint8, so the replay stores them as uint8
        self.buffers = {"observation": buffer(spec.obs_dim, dtype=spec.obs_dtype),
                        "action": buffer(spec.action_dim), "reward": buffer(1),
                        "discount": buffer(1), "physics": buffer(spec.physics_dim)}
        self.meta: MetaDict = {}  # the meta of the current step, [E, ...] per key
        self._t = torch.zeros((), dtype=torch.int64, device=device)
        self._step_t = torch.zeros((), dtype=torch.int64, device=device)
        self._obs = torch.zeros((num_envs, spec.obs_dim), dtype=spec.obs_dtype, device=device)
        self._state: tp.Any = None
        self._noise: tp.Optional[tp.Sequence[StepNoise]] = None
        self._program: tp.Optional[CapturedProgram] = None

    def _write(self, name: str, value: torch.Tensor) -> None:
        self.buffers[name].index_copy_(0, (self._t + 1).reshape(1), value.unsqueeze(0))

    @torch.no_grad()
    def _step(self) -> None:
        agent = self.agent
        with trace.device_span("act", agent.device):
            if self._noise is not None:
                noise = self._noise[int(self._t)]
            else:
                noise = agent.step_noise(self.num_envs, self.generator)
            meta = self.meta if self.hold_meta else agent.rollout_update_meta(
                self.meta, self._t, noise)
            action = agent.policy_act(self._obs, meta, self._step_t, eval_mode=False,
                                      noise=noise)
        with trace.device_span("env_step", agent.device):
            state, ts = self.env.step(self._state, action.float())
        for held, new in zip(_tensors_of(self._state), _tensors_of(state)):
            held.copy_(new)
        self._obs.copy_(ts.observation)
        for name, value in meta.items():
            self.meta[name].copy_(value)
            self._write(name, value)
        for name, value in ts.to_buffer_dict().items():
            if name in self.buffers:
                self._write(name, value.to(self.buffers[name].dtype))
        self._t += 1

    def _set_inputs(self, meta: MetaDict, state: tp.Any, ts: tp.Any, step: int) -> None:
        for held, new in zip(_tensors_of(self._state), _tensors_of(state)):
            held.copy_(new)
        self._obs.copy_(ts.observation)
        first = ts.to_buffer_dict()
        for name in ("observation", "action", "reward", "discount", "physics"):
            self.buffers[name][0].copy_(first[name])
        for name, value in meta.items():
            self.meta[name].copy_(value)
            self.buffers[name][0].copy_(value)
        self._t.zero_()
        self._step_t.fill_(step)

    def _held(self) -> tp.List[torch.Tensor]:
        """What a step changes in place, buffers aside."""
        return [*_tensors_of(self._state), self._obs, *self.meta.values(), self._t]

    def __call__(self, meta: MetaDict, state: tp.Any, ts: tp.Any, step: int,
                 noise: tp.Optional[tp.Sequence[StepNoise]] = None
                 ) -> tp.Dict[str, torch.Tensor]:
        if ts.observation.shape != self._obs.shape:
            raise ValueError(f"the collector was built for observations "
                             f"{tuple(self._obs.shape)}, the reset gave "
                             f"{tuple(ts.observation.shape)}")
        if self._state is None:
            self._state = _cloned(state)
            for name, value in meta.items():
                self.meta[name] = value.clone()
                self.buffers[name] = torch.zeros((self.horizon + 1,) + tuple(value.shape),
                                                 device=value.device)
        if set(meta) != set(self.meta):
            raise ValueError(f"meta keys {sorted(meta)}, the collector holds {sorted(self.meta)}")
        self._set_inputs(meta, state, ts, step)
        if noise is not None:
            if self.capture:
                raise ValueError("noise is handed in only to the eager collector")
            if len(noise) != self.horizon:
                raise ValueError(f"{len(noise)} steps of noise for {self.horizon} steps")
            self._noise = noise
            try:
                for _ in range(self.horizon):
                    self._step()
            finally:
                self._noise = None
        elif self.capture:
            if self._program is None or self._program.traced != trace.enabled():
                # the warm-up steps change the held tensors and the generator;
                # the capture puts both back
                self._program = CapturedProgram(self._step, self.agent.device, self._held(),
                                                [self.generator],
                                                warmup_runs=min(WARMUP_RUNS, self.horizon),
                                                name="collector")
            self._program.replay(self.horizon)
        else:
            for _ in range(self.horizon):
                self._step()
        traj = dict(self.buffers)
        if self.goal_fn is not None:
            traj["goal"] = self.goal_fn(traj["physics"]).float()
        return traj


class OnlineTrainer:
    """Episode-granular online cycles, vectorised over environments (the
    counterpart of the JAX ``OnlineTrainer``).

    Each cycle collects ``num_envs`` episodes (``EpisodeCollector``), commits
    them to the replay on the device (``ReplayBuffer.add_trajectory``; the
    JAX trainer goes through numpy and one ``add_episode`` per environment),
    then runs ``int(T * num_envs * updates_per_step)`` updates through one
    ``OfflineTrainer``, in calls of at most ``max_steps_per_call``. The
    collector draws from ``collect_generator``, the updates from
    ``generator``: each is registered with its own graph. ``timings`` holds
    the last cycle's seconds of collection (reset included; ``collect``), of
    the commit (``commit``, the host's time: the commit's device work
    finishes inside the updates') and of commit and updates (``update``),
    and the number of updates (``updates``); the host spans ``collect``,
    ``commit`` and ``updates`` cover the same intervals.

    With a process ``group`` (the JAX trainer's ``mesh``), each process steps
    ``num_envs / world`` of the environments (from its own
    ``collect_generator``), the trajectories are gathered, every process
    commits all ``num_envs`` episodes in rank order, as one buffer would hold
    them, and the updates are the data-parallel ``OfflineTrainer``'s.
    """

    def __init__(self, env: tp.Any, agent: tp.Any, buffer: tp.Any, num_envs: int = 1,
                 goal_fn: tp.Optional[tp.Callable[[torch.Tensor], torch.Tensor]] = None,
                 updates_per_step: float = 0.5, max_steps_per_call: int = 200,
                 hold_meta: bool = False, group: tp.Any = None) -> None:
        self.env, self.agent, self.buffer, self.num_envs = env, agent, buffer, num_envs
        self.goal_fn, self.hold_meta = goal_fn, hold_meta
        self.updates_per_step = updates_per_step
        self.max_steps_per_call = max_steps_per_call
        self.shard = Shard(group)
        rows = self.shard.rows(num_envs)
        self.local_envs = rows.stop - rows.start
        self.trainer = OfflineTrainer(agent, buffer.cfg, agent.cfg.batch_size,
                                      steps_per_call=max_steps_per_call, group=group)
        self.collector: tp.Optional[EpisodeCollector] = None
        self.global_step = 0
        self.global_episode = 0
        self.timings: tp.Dict[str, float] = {}

    def _sync(self) -> None:
        if self.agent.device.type == "cuda":
            torch.cuda.synchronize(self.agent.device)

    def run_cycle(self, generator: torch.Generator, collect_generator: torch.Generator,
                  meta: tp.Optional[MetaDict] = None) -> tp.Dict[str, float]:
        """One collect + commit + update cycle. ``meta`` overrides the
        per-environment rollout meta ([num_envs, ...] per key, e.g. task z's
        for a directed-rollout mix); the default is ``init_meta`` drawn per
        environment."""
        if self.collector is None or self.collector.generator is not collect_generator:
            self.collector = EpisodeCollector(self.env, self.agent, self.local_envs,
                                              collect_generator, self.goal_fn,
                                              self.hold_meta)
        started = time.perf_counter()
        with trace.span("collect"):
            if meta is None:
                meta = init_meta_batched(self.agent, collect_generator, self.local_envs)
            else:
                meta = {k: v[self.shard.rows(self.num_envs)] for k, v in meta.items()}
            state, ts = self.env.reset(collect_generator, self.local_envs)
            traj = self.collector(meta, state, ts, self.global_step)
            if self.shard.group is not None:
                # [T+1, E/world, ...] on each process -> [T+1, E, ...] in rank order
                with torch.no_grad():
                    traj = {k: self.shard.gather(v.transpose(0, 1)).transpose(0, 1)
                            for k, v in traj.items()}
            episode_reward = traj["reward"][1:].sum(0).mean()
            self._sync()
        collected = time.perf_counter()
        horizon = self.collector.horizon
        with trace.span("commit"):
            self.buffer.add_trajectory(traj, horizon)
            self.global_step += horizon * self.num_envs
            self.global_episode += self.num_envs
        committed = time.perf_counter()

        n_updates = int(horizon * self.num_envs * self.updates_per_step)
        metrics: tp.Dict[str, float] = {}
        with trace.span("updates"):
            if n_updates > 0 and len(self.buffer) > 0:
                done = 0
                while done < n_updates:
                    chunk = min(self.max_steps_per_call, n_updates - done)
                    last = self.trainer(self.buffer.state, generator, steps=chunk)
                    done += chunk
                metrics = {k: float(v) for k, v in last.items()}
            metrics["episode_reward"] = float(episode_reward)
            self._sync()
        self.timings = {"collect": collected - started, "commit": committed - collected,
                        "update": time.perf_counter() - collected, "updates": n_updates}
        return metrics
