"""Which batched solver of small positive-definite systems a CUDA graph can
hold, and what each costs per replay.

    python -m controllable_agent_torch.tools.solve_capture

The planar dynamics solve one [ndof, ndof] system (ndof = 9 for the walker)
for each environment in every substep, inside the captured rollout. This
tool captures ``torch.linalg.solve_ex`` (LU), ``cholesky_ex`` +
``cholesky_solve`` and ``torch.linalg.solve`` (which checks its result on
the host) in a graph of ``CALLS`` solves each, at 10, 1,024 and 16,384
walker mass matrices of random poses, and prints whether the capture held,
the largest error against a float64 solve on the CPU and the device time
per solve. Needs a CUDA device.
"""

from __future__ import annotations

import typing as tp

import torch

from controllable_agent_torch.envs import locomotion
from controllable_agent_torch.envs import physics2d as p2d
from controllable_agent_torch.utils.device import card_name_and_power_limit

CALLS = 50
REPLAYS = 20


def _solvers() -> tp.Dict[str, tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]:
    def lu(m: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        return torch.linalg.solve_ex(m, rhs)[0]

    def cholesky(m: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        factor = torch.linalg.cholesky_ex(m)[0]
        return torch.cholesky_solve(rhs.unsqueeze(-1), factor).squeeze(-1)

    return {"solve_ex": lu, "cholesky_ex+cholesky_solve": cholesky,
            "solve (checked)": torch.linalg.solve}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("solve_capture needs a CUDA device")
    model = locomotion.walker_model()
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"card: {card_name_and_power_limit()}")
    for envs in (10, 1024, 16384):
        q = torch.rand((envs, model.ndof), generator=gen, device="cuda") * 2 - 1
        m = p2d.mass_matrix(model, q)
        rhs = torch.randn((envs, model.ndof), generator=gen, device="cuda") * 100
        want = torch.linalg.solve(m.double().cpu(), rhs.double().cpu())
        for name, solver in _solvers().items():
            try:
                for _ in range(3):
                    solver(m, rhs)
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(CALLS):
                        out = solver(m, rhs)
                graph.replay()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(REPLAYS):
                    graph.replay()
                end.record()
                torch.cuda.synchronize()
            except RuntimeError as err:
                torch.cuda.synchronize()
                print(f"E={envs} {name}: capture FAILED: {str(err).splitlines()[0][:160]}")
                continue
            err = float((out.double().cpu() - want).abs().max() / want.abs().max())
            print(f"E={envs} {name}: captured; {1e3 * start.elapsed_time(end) / (REPLAYS * CALLS):.2f} "
                  f"us per solve in the graph; max err {err:.2e} of the largest entry")


if __name__ == "__main__":
    main()
