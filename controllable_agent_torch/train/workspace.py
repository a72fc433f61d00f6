"""Workspace — agent + replay + console rows, and the offline training loop
(sliced mirror of ``controllable_agent_tpu/train/workspace.py``).

The port has no environments yet, so the workspace takes the observation and
action sizes and the episode length from the data (``EnvSpec``). Parts of
the JAX workspace that are not ported raise ``NotImplementedError`` naming
the ROADMAP item that ports them, whenever a config would make them fire:
evaluation rollouts, checkpoints, ``finalize``, videos, goal spaces and
custom rewards. Logging is console rows only.
"""

from __future__ import annotations

import dataclasses
import json
import typing as tp
from pathlib import Path

import torch

from ..agents import AGENTS
from ..config import apply_overrides, to_flat_dict
from ..data import ReplayBuffer
from ..utils import Stopwatch, resolve_device
from .loops import make_offline_trainer


@dataclasses.dataclass(frozen=True)
class WorkspaceConfig:
    """The JAX ``WorkspaceConfig`` fields, plus ``device``."""

    agent_name: str = "fb_ddpg"
    num_rollout_episodes: int = 10
    num_agent_updates: int = 50
    update_replay_buffer: bool = True
    task: str = "point_mass_maze_reach_top_left"
    obs_type: str = "states"
    frame_stack: int = 3
    seed: int = 1
    discount: float = 0.98
    future: float = 0.99
    goal_space: tp.Optional[str] = None
    append_goal_to_observation: bool = False
    num_train_frames: int = 2_000_010
    num_grad_steps: int = 1_000_000
    num_seed_frames: int = 4000
    eval_every_steps: int = 10_000
    num_eval_episodes: int = 10
    replay_buffer_episodes: int = 5000
    checkpoint_every: int = 100_000
    num_envs: int = 4
    episode_length: tp.Optional[int] = None
    steps_per_call: int = 200
    log_every_steps: int = 1000
    custom_reward: tp.Optional[str] = None
    d4rl_dataset: tp.Optional[str] = None
    # spherical mean of this many independent z = rᵀB/N regressions
    z_inference_draws: int = 8
    rollout_task_z_ratio: float = 0.0
    rollout_task_z_tasks: tp.Optional[str] = None
    task_z_refresh_frames: int = 100_000
    final_tests: int = 10
    snapshot_at: tp.Tuple[int, ...] = ()
    load_model: tp.Optional[str] = None
    folder: str = "exp_local"
    use_console: bool = True
    use_tb: bool = False
    use_wandb: bool = False
    save_eval_video: bool = True
    profile_dir: tp.Optional[str] = None
    device: str = "cuda"  # "cpu" runs the whole slice on the CPU (tests)


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """What the agent and the replay need to know of the environment."""

    obs_dim: int
    action_dim: int
    episode_length: int


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to controllable_agent_torch yet "
        f"(ROADMAP Queue A item {item})")


class Workspace:
    def __init__(self, cfg: WorkspaceConfig, spec: EnvSpec,
                 agent_cfg_overrides: tp.Sequence[str] = ()) -> None:
        unported = [
            (cfg.agent_name != "fb_ddpg", f"agent {cfg.agent_name!r}", 13),
            (cfg.obs_type != "states", "obs_type=pixels", 12),
            (cfg.goal_space is not None, "goal_space", 7),
            (cfg.custom_reward is not None, "custom_reward", 7),
            (cfg.d4rl_dataset is not None, "d4rl_dataset", 12),
            (cfg.load_model is not None, "load_model (checkpoints)", 7),
            (bool(cfg.snapshot_at), "snapshot_at (checkpoints)", 7),
            (cfg.use_tb or cfg.use_wandb or cfg.profile_dir is not None,
             "use_tb/use_wandb/profile_dir", 15),
            ((Path(cfg.folder) / "models" / "latest").exists(),
             "resuming from a checkpoint", 7),
            (cfg.eval_every_steps > 0, "evaluation (eval_every_steps; set it to 0)", 9),
            (cfg.checkpoint_every > 0, "checkpointing (checkpoint_every; set it to 0)", 7),
            (cfg.final_tests > 0, "finalize (final_tests; set it to 0)", 8),
        ]
        for fires, what, item in unported:
            if fires:
                raise _not_ported(what, item)
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(cfg.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.work_dir = Path(cfg.folder)
        self.work_dir.mkdir(parents=True, exist_ok=True)

        agent_cfg_cls, agent_cls = AGENTS[cfg.agent_name]
        self.agent_cfg = apply_overrides(agent_cfg_cls(goal_space=cfg.goal_space),
                                         list(agent_cfg_overrides))
        self.agent = agent_cls(self.agent_cfg, spec.obs_dim, spec.action_dim,
                               device=self.device, seed=cfg.seed)
        self.buffer = ReplayBuffer(
            max_episodes=cfg.replay_buffer_episodes, discount=cfg.discount,
            future=cfg.future, max_episode_length=spec.episode_length,
            device=self.device)
        self.timer = Stopwatch()
        self.global_step = 0
        self.last_row: tp.Dict[str, float] = {}
        self.inferred_z: tp.Optional[torch.Tensor] = None
        flat = to_flat_dict(cfg)
        flat.update(to_flat_dict(self.agent_cfg, "agent."))
        (self.work_dir / "config.json").write_text(json.dumps(flat, indent=2, default=str))

    def _infer_meta_from_replay(self, draws: tp.Optional[int] = None) -> torch.Tensor:
        """z = rᵀB/N over num_inference_steps samples of the stored rewards.
        ``draws`` > 1 returns the norm-preserving spherical mean of that many
        independent regressions (cfg.z_inference_draws by default)."""
        n = self.agent.cfg.num_inference_steps
        draws = self.cfg.z_inference_draws if draws is None else draws

        def one_draw() -> torch.Tensor:
            batch = self.buffer.sample(self.generator, n)
            return self.agent.infer_meta_from_obs_and_rewards(batch.next_obs,
                                                              batch.reward)

        if draws <= 1:
            return one_draw()
        zs = torch.stack([one_draw() for _ in range(draws)])
        unit = zs / torch.linalg.vector_norm(zs, dim=-1, keepdim=True).clamp_min(1e-12)
        mean = unit.mean(0)
        mean = mean / torch.linalg.vector_norm(mean).clamp_min(1e-12)
        return mean * torch.linalg.vector_norm(zs[0])

    def _log_row(self, steps: int, metrics: tp.Dict[str, torch.Tensor]
                 ) -> tp.Dict[str, float]:
        """One train row; converting the metrics waits for the device, so
        the lap after it times the work of the window."""
        row = {k: float(v) for k, v in metrics.items()}
        elapsed, total = self.timer.lap()
        row = {"step": float(self.global_step),
               "fps": steps / max(elapsed, 1e-9), "total_time": total, **row}
        if self.cfg.use_console:
            print("| train          | " + " | ".join(
                f"{k}: {v:.4f}" for k, v in row.items()), flush=True)
        return row


class OfflineWorkspace(Workspace):
    """Pure gradient-step training over a loaded buffer."""

    def train(self) -> tp.Dict[str, float]:
        """Runs ``num_grad_steps`` updates; returns the last train row."""
        cfg = self.cfg
        assert len(self.buffer) > 0, "offline training requires a loaded buffer"
        trainer = make_offline_trainer(self.agent, self.buffer.cfg,
                                       self.agent.cfg.batch_size,
                                       steps_per_call=cfg.steps_per_call)
        log_every = max(cfg.log_every_steps, cfg.steps_per_call)
        steps_since_log = 0
        row: tp.Dict[str, float] = {}
        self.timer.lap()
        while self.global_step < cfg.num_grad_steps:
            metrics = trainer(self.buffer.state, self.generator)
            self.global_step += cfg.steps_per_call
            steps_since_log += cfg.steps_per_call
            if steps_since_log >= log_every:
                row = self._log_row(steps_since_log, metrics)
                steps_since_log = 0
        if steps_since_log:
            row = self._log_row(steps_since_log, metrics)
        return row
