"""Demo engine: user-typed reward equations -> zero-shot behavior (mirror of
``controllable_agent_tpu/demo/core.py``).

  1. PRECOMPUTE once: sample ``num_inference_steps`` states from the replay
     with their physics, keep B(goal state) and the named physics features
     on the workspace's device;
  2. per query: tokenizer-whitelist the equation, evaluate it over the
     cached features, z = Bᵀr scaled to norm sqrt(d), roll the policy out,
     render a video.

The rollout is one environment advanced by the captured control step of
``train/loops.py:Rollout`` (a CUDA graph replayed ``num_steps`` times on the
card; the same step eagerly on the CPU). The JAX engine steps in a Python
loop and stops at the first step ``t > 10`` whose physics is close to that
of five steps before (``np.allclose``, atol 1e-7, rtol 1e-5); here all
``num_steps`` steps run on the device, the first such step is found there
(``stop_index``) and the trajectory is cut at it: the same result with one
host sync instead of one per step.
"""

from __future__ import annotations

import math
import time
import typing as tp
from pathlib import Path

import torch

from ..goals.rewards import EquationReward
from ..train.loops import Rollout
from ..train.video import Renderer, VideoRecorder

Tensor = torch.Tensor

# the feature names an equation may use, by domain (JAX ``DemoEngine.__init__``)
FEATURE_NAMES = {"walker": ("x", "z", "up", "vx", "vz", "am"),
                 "cheetah": ("x", "z", "up", "vx", "vz", "am"),
                 "hopper": ("x", "z", "up", "vx", "vz", "am"),
                 "point_mass_maze": ("x", "y", "vx", "vy")}
# the early stop: after step t > MIN_STEP, physics within STOP_ATOL (and
# numpy's default rtol) of the physics STOP_LAG steps before
MIN_STEP, STOP_LAG, STOP_ATOL, STOP_RTOL = 10, 5, 1e-7, 1e-5


def stop_index(rows: Tensor) -> Tensor:
    """The number of steps the JAX demo's loop takes over the physics rows
    ``rows`` [T+1, P] (the reset's row first): the first step t > 10 (0-based)
    at which ``np.allclose(rows[t + 1], rows[t - 4], atol=1e-7)`` holds, plus
    one, else T. A 0-d tensor on ``rows``' device."""
    steps = rows.shape[0] - 1
    first = MIN_STEP + 1  # the first step that may stop
    if steps <= first:
        return torch.tensor(steps, device=rows.device)
    a, b = rows[first + 1:], rows[first + 1 - STOP_LAG:steps + 1 - STOP_LAG]
    # numpy's isclose: |a - b| <= atol + rtol |b| with b finite, or a == b
    close = (((a - b).abs() <= STOP_ATOL + STOP_RTOL * b.abs()) & torch.isfinite(b)) | (a == b)
    close = close.all(-1)
    return torch.where(close.any(), close.int().argmax() + first + 1,
                       torch.tensor(steps, device=rows.device))


class DemoEngine:
    def __init__(self, workspace: tp.Any, num_inference_steps: int = 5120) -> None:
        self.ws = workspace
        self.num_inference_steps = num_inference_steps
        self.feature_names = FEATURE_NAMES.get(workspace.domain, ())
        self._B: tp.Optional[Tensor] = None  # [N, z_dim]
        self._features: tp.Optional[Tensor] = None  # [N, features]
        self._rollouts: tp.Dict[int, Rollout] = {}
        # the last rollout's reset (state, first timestep), and the last
        # request's times in ms: precompute (on the first), z inference,
        # rollout, video
        self.last_reset: tp.Optional[tp.Tuple[tp.Any, tp.Any]] = None
        self.timings: tp.Dict[str, float] = {}

    def _sync(self) -> None:
        if self.ws.device.type == "cuda":
            torch.cuda.synchronize(self.ws.device)

    def _features_of(self, physics: Tensor) -> Tensor:
        return getattr(self.ws.env, "goal_features", lambda p: p)(physics)

    # -- precompute ------------------------------------------------------
    @torch.no_grad()
    def precompute(self) -> None:
        ws = self.ws
        batch = ws.buffer.sample(ws.generator, self.num_inference_steps, with_physics=True)
        goal = batch.next_goal if batch.next_goal is not None else batch.next_obs
        self._B = ws.agent.backward_net(goal).float()
        self._features = self._features_of(batch.physics)

    # -- query -----------------------------------------------------------
    @torch.no_grad()
    def infer_z(self, equation: str) -> Tensor:
        if self._B is None:
            self.precompute()
        assert self._B is not None and self._features is not None
        reward = EquationReward(equation, self.feature_names, lambda p: p)
        rewards = reward.from_features(self._features)
        z = self._B.T @ rewards
        norm = torch.linalg.vector_norm(z)
        norm = torch.where(norm == 0, torch.full_like(norm, 1e-9), norm)
        return z * math.sqrt(z.numel()) / norm

    def _rollout_of(self, num_steps: int) -> Rollout:
        if num_steps not in self._rollouts:
            self._rollouts[num_steps] = Rollout(self.ws.env, self.ws.agent, 1, horizon=num_steps)
        return self._rollouts[num_steps]

    @torch.no_grad()
    def rollout(self, z: Tensor, num_steps: int = 500,
                video_path: tp.Optional[str] = None) -> tp.Dict[str, tp.Any]:
        """Policy rollout from a fresh reset, cut at the early stop, with an
        optional video (an animated PNG beside ``video_path``'s name)."""
        ws = self.ws
        meta_key = getattr(ws.agent, "meta_key", "z")
        state, ts = ws.env.reset(ws.generator, 1)
        self.last_reset = (state, ts)
        started = time.perf_counter()
        rollout = self._rollout_of(num_steps)
        rollout({meta_key: z}, state, ts)
        rows = torch.cat([ts.physics, rollout.physics[0]])
        steps = int(stop_index(rows))
        out: tp.Dict[str, tp.Any] = {"reward": float(rollout.rewards[0, :steps].double().sum()),
                                     "steps": steps, "_physics": rows[:steps + 1]}
        self.timings["rollout_ms"] = 1e3 * (time.perf_counter() - started)
        if video_path is not None:
            started = time.perf_counter()
            recorder = VideoRecorder(Path(video_path).parent, Renderer(ws.domain, ws._base_env()))
            recorder.record_trajectory(out["_physics"].cpu().numpy())
            saved = recorder.save(Path(video_path).name)
            out["video"] = str(saved) if saved else None
            self.timings["video_ms"] = 1e3 * (time.perf_counter() - started)
        return out

    def run(self, equation: str, num_steps: int = 500,
            video_path: tp.Optional[str] = None) -> tp.Dict[str, tp.Any]:
        self.timings = {}
        started = time.perf_counter()
        if self._B is None:
            self.precompute()
            self._sync()
            self.timings["precompute_ms"] = 1e3 * (time.perf_counter() - started)
            started = time.perf_counter()
        z = self.infer_z(equation)
        self._sync()
        self.timings["infer_ms"] = 1e3 * (time.perf_counter() - started)
        out = self.rollout(z, num_steps, video_path)
        out["equation"] = equation
        # the trajectory scored under the USER's equation too (the task's own
        # reward often differs from the typed objective), over every row
        phys = out.pop("_physics")
        reward = EquationReward(equation, self.feature_names, lambda p: p)
        out["equation_reward"] = float(reward.from_features(self._features_of(phys)).sum())
        return out
