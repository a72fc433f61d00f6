"""Training loops (mirror of ``controllable_agent_tpu/train/loops.py``).

Only the offline trainer is ported so far: the episode collector and the
online trainer come with the online path (ROADMAP Queue A item 10).

The JAX trainer is one compiled program of ``steps_per_call`` updates with
the replay sampling inside it (``jit`` over ``lax.scan``). Its counterpart
on a CUDA device is a CUDA graph: sample -> ``agent.update`` -> metric sums
are captured once and replayed, so an update costs the host one graph launch
instead of a thousand kernel launches. On the CPU the same function runs
eagerly.
"""

from __future__ import annotations

import typing as tp

import torch

from ..data import replay as replay_lib
from ..data.replay import ReplayState, SampleConfig
from ..ops import fused_fb

# eager runs before a capture: they build the kernels, opt into their shared
# memory and let cuBLAS and the allocator reach their steady state
WARMUP_RUNS = 2


class CapturedProgram:
    """``fn()`` captured in a CUDA graph.

    ``fn`` is warmed up eagerly on a side stream, then everything the
    warm-up changed is put back (``agent.train_state()`` and the state of
    every generator in ``generators``), so that building the program leaves
    no trace but the kernels' launch counts. Every generator that ``fn``
    draws from must be listed: it is registered with the graph, which makes
    each replay draw fresh numbers and advances the generator as eager
    draws would. Whatever ``fn`` returns is kept in ``out``; its tensors are
    overwritten by each replay. A failure to capture raises.
    """

    def __init__(self, fn: tp.Callable[[], tp.Any], agent: tp.Any,
                 generators: tp.Sequence[torch.Generator] = ()) -> None:
        device = agent.device
        saved = {k: v.clone() for k, v in agent.train_state().items()}
        gen_states = [g.get_state() for g in generators]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        agent.load_train_state(saved)
        for g, state in zip(generators, gen_states):
            g.set_state(state)
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
                    lambda: run_updates(replay_state, generator, 1),
                    agent, [generator])
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
