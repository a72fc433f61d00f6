"""Updates/s of the captured update by the number of updates in one CUDA
graph (NVIDIA GPU with nvcc only).

    python -m controllable_agent_torch.tools.graph_depth

The offline trainer replays a graph of one update. This study is the
record of that choice: at the production geometry (walker-sized
observations and actions, batch 1024, bf16 compute, fused loss) it captures
sample -> update 1, 5 and 20 times over in one ``CapturedProgram`` each and
times 200 updates through each, in turns (1, 5, 20, 20, 5, 1), each timed
stretch ending in one read of a metric. It prints the updates/s of both
turns, the seconds each capture took and the device memory each holds. The
card's name and power limit come first.
"""

from __future__ import annotations

import sys
import time
import typing as tp

import torch

from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data import replay as replay_lib
from controllable_agent_torch.data.exorl import synthetic_episodes
from controllable_agent_torch.utils.graphs import CapturedProgram
from controllable_agent_torch.utils.device import card_name_and_power_limit

DEPTHS, UPDATES = (1, 5, 20), 200
OBS_DIM, ACTION_DIM, EPISODES, EPISODE_LENGTH, SEED = 24, 6, 64, 1000, 0


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_depth: no CUDA device is available", file=sys.stderr)
        return 1
    cfg = FBDDPGConfig(use_pallas_loss=True, compute_dtype="bfloat16")
    agent = FBDDPGAgent(cfg, OBS_DIM, ACTION_DIM, device="cuda", seed=SEED)
    buf = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cuda")
    buf.load_episodes(synthetic_episodes(EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def updates(depth: int) -> torch.Tensor:
        for _ in range(depth):
            batch = replay_lib.sample(buf.state, gen, cfg.batch_size, buf.cfg)
            loss = agent.update(batch, gen)["fb_loss"]
        return loss

    print(f"card: {card_name_and_power_limit()}")
    programs: tp.Dict[int, CapturedProgram] = {}
    notes = {}
    for depth in DEPTHS:
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        programs[depth] = CapturedProgram(lambda: updates(depth), agent.device,
                                          agent.train_state().values(), [gen])
        torch.cuda.synchronize()
        notes[depth] = (f"captured in {time.perf_counter() - t0:.2f} s, "
                        f"{(torch.cuda.memory_allocated() - held) / 2**20:.0f} MiB held")
        programs[depth].replay(UPDATES // depth)  # warm-up
    rates: tp.Dict[int, tp.List[float]] = {depth: [] for depth in DEPTHS}
    for depth in DEPTHS + DEPTHS[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        programs[depth].replay(UPDATES // depth)
        float(programs[depth].out)
        rates[depth].append(UPDATES / (time.perf_counter() - t0))
    for depth in DEPTHS:
        print(f"{depth} update(s) per graph: {rates[depth][0]:.1f} / {rates[depth][1]:.1f} "
              f"updates/s over {UPDATES} updates ({notes[depth]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
