"""A function captured once in a CUDA graph and replayed.

The updates, the evaluation rollout, the episode collector and the
cheetah's settle all run this way on a CUDA device, so that a step costs
the host one graph launch instead of hundreds of kernel launches.
"""

from __future__ import annotations

import typing as tp

import torch

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
    is kept in ``out``; its tensors are overwritten by each replay. ``fn``
    itself is kept too: the graph reads the tensors its closure holds (a
    constant input such as a zero action) at their addresses, so they must
    live as long as the graph, or the allocator hands their memory to
    other tensors and the replays read whatever those hold.
    ``warmup_runs`` is at least 1. A failure to capture raises.
    """

    def __init__(self, fn: tp.Callable[[], tp.Any], device: torch.device,
                 state: tp.Iterable[torch.Tensor] = (),
                 generators: tp.Sequence[torch.Generator] = (),
                 warmup_runs: int = WARMUP_RUNS) -> None:
        self.fn = fn
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
