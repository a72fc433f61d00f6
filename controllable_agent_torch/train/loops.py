"""Training loops (mirror of ``controllable_agent_tpu/train/loops.py``).

The offline trainer and the evaluation rollout are ported: the episode
collector and the online trainer come with the online path (ROADMAP Queue A
item 10).

The JAX trainer is one compiled program of ``steps_per_call`` updates with
the replay sampling inside it (``jit`` over ``lax.scan``). Its counterpart
on a CUDA device is a CUDA graph: sample -> ``agent.update`` -> metric sums
are captured once and replayed, so an update costs the host one graph launch
instead of a thousand kernel launches. On the CPU the same function runs
eagerly.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..data import replay as replay_lib
from ..data.replay import ReplayState, SampleConfig
from ..ops import fused_fb

# eager runs before a capture: they build the kernels, opt into their shared
# memory and let cuBLAS and the allocator reach their steady state
WARMUP_RUNS = 2


class CapturedProgram:
    """``fn()`` captured in a CUDA graph on ``device``.

    ``fn`` is warmed up eagerly on a side stream, then everything the
    warm-up changed is put back: ``state``, the tensors that ``fn`` changes
    in place (an agent's ``train_state()`` for an update, a rollout's
    environment state and buffers), and the state of every generator in
    ``generators``. So building the program leaves no trace but the kernels'
    launch counts. Every generator that ``fn`` draws from must be listed: it
    is registered with the graph, which makes each replay draw fresh numbers
    and advances the generator as eager draws would. Whatever ``fn`` returns
    is kept in ``out``; its tensors are overwritten by each replay.
    ``warmup_runs`` is at least 1. A failure to capture raises.
    """

    def __init__(self, fn: tp.Callable[[], tp.Any], device: torch.device,
                 state: tp.Iterable[torch.Tensor] = (),
                 generators: tp.Sequence[torch.Generator] = (),
                 warmup_runs: int = WARMUP_RUNS) -> None:
        state = list(state)
        saved = [t.clone() for t in state]
        gen_states = [g.get_state() for g in generators]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup_runs):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, before in zip(state, saved):
                t.copy_(before)
        for g, before in zip(generators, gen_states):
            g.set_state(before)
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        with fused_fb.held_by_capture() as self.held, torch.cuda.graph(self.graph):
            self.out = fn()

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self.graph.replay()
        fused_fb.count_replay(self.held, times)


def make_offline_trainer(agent: tp.Any, sample_cfg: SampleConfig,
                         batch_size: int, steps_per_call: int,
                         with_future: bool = True,
                         capture: tp.Optional[bool] = None) -> tp.Callable:
    """Returns ``train_n(replay_state, generator) -> metrics`` running
    ``steps_per_call`` updates of ``agent`` in place, each sampling its batch
    on the replay's device. Metrics are the mean over the call, left on the
    device (no host sync inside the call).

    ``capture`` (default: whether the agent is on a CUDA device) runs the
    updates as replays of a CUDA graph of one update, sampling included
    (deeper graphs measured no faster). The graph is bound to the replay storage
    and the generator it was captured with; ``train_n`` captures anew when
    it is handed another generator or a buffer that has grown or moved.
    ``capture=False`` on a CUDA device is the eager loop, kept to be
    measured beside the captured one.
    """
    on_cuda = agent.device.type == "cuda"
    capture = on_cuda if capture is None else capture
    if capture and not on_cuda:
        raise ValueError("a CUDA graph needs the agent on a CUDA device")
    sums: tp.Dict[str, torch.Tensor] = {}  # fixed buffers, summed into in place

    def run_updates(replay_state: ReplayState, generator: torch.Generator,
                    count: int) -> None:
        for _ in range(count):
            batch = replay_lib.sample(replay_state, generator, batch_size,
                                      sample_cfg, with_future=with_future)
            for k, v in agent.update(batch, generator).items():
                if k in sums:
                    sums[k] += v.float()
                else:
                    sums[k] = v.float().clone()

    program: tp.Optional[CapturedProgram] = None
    bound_to: tp.Optional[tp.Tuple] = None

    def train_n(replay_state: ReplayState,
                generator: torch.Generator) -> tp.Dict[str, torch.Tensor]:
        nonlocal program, bound_to
        if capture:
            binding = (generator, replay_state.n_episodes,
                       tuple(v.data_ptr() for v in replay_state.storage.values()))
            if bound_to is None or bound_to[0] is not generator or bound_to[1:] != binding[1:]:
                program = CapturedProgram(
                    lambda: run_updates(replay_state, generator, 1), agent.device,
                    agent.train_state().values(), [generator])
                bound_to = binding
        if sums:
            torch._foreach_zero_(list(sums.values()))
        if capture:
            assert program is not None
            program.replay(steps_per_call)
        else:
            run_updates(replay_state, generator, steps_per_call)
        return {k: v / steps_per_call for k, v in sums.items()}

    return train_n


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
    episode, [E, z_dim], and the state and first timestep of a ``reset`` of
    ``num_envs`` instances. It returns (totals [E], physics [E, T, P],
    observations [E, T, O]): the trajectories after each step, in buffers
    that the next run overwrites.
    """

    def __init__(self, env: tp.Any, agent: tp.Any, num_envs: int,
                 capture: tp.Optional[bool] = None) -> None:
        on_cuda = agent.device.type == "cuda"
        self.capture = on_cuda if capture is None else capture
        if self.capture and not on_cuda:
            raise ValueError("a CUDA graph needs the agent on a CUDA device")
        self.env, self.agent, self.num_envs = env, agent, num_envs
        spec, device = env.spec, agent.device
        self.horizon = spec.episode_length
        self.z = torch.zeros((num_envs, agent.cfg.z_dim), device=device)
        self.totals = torch.zeros(num_envs, device=device)
        self.physics = torch.zeros((num_envs, self.horizon, spec.physics_dim), device=device)
        self.observations = torch.zeros((num_envs, self.horizon, spec.obs_dim), device=device)
        self._index = torch.zeros(1, dtype=torch.int64, device=device)
        self._obs = torch.zeros((num_envs, spec.obs_dim), device=device)
        self._state: tp.Any = None
        self._program: tp.Optional[CapturedProgram] = None

    @torch.no_grad()
    def _step(self) -> None:
        action = self.agent.act(self._obs, self.z, 10 ** 9, eval_mode=True)
        state, ts = self.env.step(self._state, action.float())
        for held, new in zip(_tensors_of(self._state), _tensors_of(state)):
            held.copy_(new)
        self._obs.copy_(ts.observation)
        self.totals += ts.reward
        self.physics.index_copy_(1, self._index, ts.physics.unsqueeze(1))
        self.observations.index_copy_(1, self._index, ts.observation.unsqueeze(1))
        self._index += 1

    def _set_inputs(self, z: torch.Tensor, state: tp.Any, ts: tp.Any) -> None:
        for held, new in zip(_tensors_of(self._state), _tensors_of(state)):
            held.copy_(new)
        self._obs.copy_(ts.observation)
        self.z.copy_(z.expand_as(self.z))
        self.totals.zero_()
        self._index.zero_()

    def __call__(self, z: torch.Tensor, state: tp.Any, ts: tp.Any
                 ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if ts.observation.shape != self._obs.shape:
            raise ValueError(f"the rollout was built for observations {tuple(self._obs.shape)}, "
                             f"the reset gave {tuple(ts.observation.shape)}")
        if self._state is None:
            self._state = _cloned(state)
        self._set_inputs(z, state, ts)
        if self.capture and self._program is None:
            # the capture's warm-up steps run from these inputs, which are set again
            # below; each writes its column of the buffers, so an episode of one step
            # warms up once
            self._program = CapturedProgram(self._step, self.agent.device,
                                            warmup_runs=min(WARMUP_RUNS, self.horizon))
            self._set_inputs(z, state, ts)
        if self._program is not None:
            self._program.replay(self.horizon)
        else:
            for _ in range(self.horizon):
                self._step()
        return self.totals, self.physics, self.observations
