"""Workspace: agent + replay + logger + checkpoints, zero-shot task
inference, and the offline training loop (sliced mirror of
``controllable_agent_tpu/train/workspace.py``).

The port has no environment dynamics yet, so the workspace takes the
observation and action sizes and the episode length from the data
(``EnvSpec``); for the planar locomotion domains ``make_env`` gives the
kinematic side (goal features, observations and rewards from stored
physics). Parts of the JAX workspace that are not ported raise
``NotImplementedError`` naming the ROADMAP item that ports them, whenever a
config would make them fire: evaluation rollouts and ``finalize`` (item 9),
videos, TensorBoard/wandb and profiles (item 15), the other agents,
pixels and d4rl.
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
from ..goals import get_goal_space_dim, get_reward_function, goal_spaces, goals
from ..utils import Stopwatch, crossed, resolve_device
from . import checkpoint as ckpt_lib
from .logger import Logger
from .loops import make_offline_trainer

Tensor = torch.Tensor


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


def make_env(task: str, episode_length: tp.Optional[int] = None) -> tp.Any:
    """The kinematic side of a task's environment, by name: a
    ``LocomotionEnv`` for walker, cheetah and hopper, None for the point
    mass (its goal features are its physics). Other domains are not ported."""
    if task.startswith("point_mass_maze_"):
        return None
    domain = task.split("_", 1)[0]
    if domain in ("walker", "cheetah", "hopper"):
        from ..envs import locomotion
        return locomotion.make(task, episode_length=episode_length or 1000)
    raise _not_ported(f"the environment of task {task!r}", 12)


class Workspace:
    def __init__(self, cfg: WorkspaceConfig, spec: EnvSpec,
                 agent_cfg_overrides: tp.Sequence[str] = (),
                 agent_cfg_base: tp.Optional[tp.Dict[str, tp.Any]] = None) -> None:
        unported = [
            (cfg.agent_name != "fb_ddpg", f"agent {cfg.agent_name!r}", 13),
            (cfg.obs_type != "states", "obs_type=pixels", 12),
            (cfg.d4rl_dataset is not None, "d4rl_dataset", 12),
            (cfg.append_goal_to_observation, "append_goal_to_observation", 9),
            (cfg.use_tb or cfg.use_wandb or cfg.profile_dir is not None,
             "use_tb/use_wandb/profile_dir", 15),
            (cfg.eval_every_steps > 0, "evaluation (eval_every_steps; set it to 0)", 9),
            (cfg.final_tests > 0, "finalize (final_tests; set it to 0)", 9),
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
        self.domain = cfg.task.split("_", 1)[0]
        if self.domain == "point":
            self.domain = "point_mass_maze"

        # goal space -> goal_fn over physics + goal dim
        self.goal_fn: tp.Optional[tp.Callable[[Tensor], Tensor]] = None
        goal_dim: tp.Optional[int] = None
        if cfg.goal_space is not None:
            space_fns = goal_spaces.funcs.get(self.domain, {})
            if cfg.goal_space not in space_fns:
                raise ValueError(
                    f"Unknown goal space {cfg.goal_space} for {self.domain}")
            space_fn = space_fns[cfg.goal_space]
            env = make_env(cfg.task, cfg.episode_length)
            feats_fn = getattr(env, "goal_features", lambda p: p)
            self.goal_fn = lambda phys: space_fn(feats_fn(torch.as_tensor(phys)))
            goal_dim = get_goal_space_dim(cfg.goal_space)

        agent_cfg_cls, agent_cls = AGENTS[cfg.agent_name]
        field_names = {f.name for f in dataclasses.fields(agent_cfg_cls)}
        base_agent_cfg = agent_cfg_cls(goal_space=cfg.goal_space)
        if agent_cfg_base:
            # resumed folder: the saved run's resolved agent config is the
            # base (a run trained with e.g. agent.z_dim=100 must rebuild the
            # same network shapes before the checkpoint loads); agent.*
            # overrides of the command line still win below
            fixed = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in agent_cfg_base.items() if k in field_names}
            base_agent_cfg = dataclasses.replace(base_agent_cfg, **fixed)
        self.agent_cfg = apply_overrides(base_agent_cfg, list(agent_cfg_overrides))
        self.agent = agent_cls(self.agent_cfg, spec.obs_dim, spec.action_dim,
                               goal_dim=goal_dim, device=self.device, seed=cfg.seed)
        self.buffer = ReplayBuffer(
            max_episodes=cfg.replay_buffer_episodes, discount=cfg.discount,
            future=cfg.future, max_episode_length=spec.episode_length,
            device=self.device)
        self.logger = Logger(self.work_dir, use_console=cfg.use_console)
        self.timer = Stopwatch()
        self.global_step = 0
        self.global_episode = 0
        self.last_row: tp.Dict[str, float] = {}
        self.inferred_z: tp.Optional[Tensor] = None

        # the RESOLVED agent config is saved beside the workspace fields
        # (flattened agent.* keys): a folder resume must rebuild the network
        # shapes the checkpoint was trained with, not the class defaults
        flat = to_flat_dict(cfg)
        flat.update(to_flat_dict(self.agent_cfg, "agent."))
        (self.work_dir / "config.json").write_text(json.dumps(flat, indent=2, default=str))
        if (self.work_dir / "models" / "latest").exists():
            self.load_checkpoint(self.work_dir / "models" / "latest")
        elif cfg.load_model is not None:
            self.load_checkpoint(Path(cfg.load_model), exclude=["replay"])

    # -- zero-shot task inference ---------------------------------------
    def _init_eval_meta(self) -> tp.Dict[str, Tensor]:
        """Eval-time meta selection: every path of the JAX
        ``_init_eval_meta`` that needs no live environment. Returns an
        (unbatched) meta dict {meta_key: z}."""
        agent = self.agent
        meta_key = agent.meta_key

        def goal_meta(goal: tp.Any) -> tp.Dict[str, Tensor]:
            g = torch.as_tensor(goal, dtype=torch.float32, device=self.device)
            return {meta_key: agent.get_goal_meta(g)}

        # custom reward with a registered goal
        if self.cfg.custom_reward is not None:
            reward = get_reward_function(self.cfg.custom_reward, self.cfg.seed)
            if self.cfg.goal_space is not None:
                try:
                    return goal_meta(reward.get_goal(self.cfg.goal_space))
                except (NotImplementedError, ValueError):
                    pass
            if len(self.buffer) > 0:
                return {meta_key: self._infer_meta_from_replay(reward)}
        # registered goal for (goal_space, task)
        if self.cfg.goal_space is not None:
            space_goals = goals.funcs.get(self.cfg.goal_space, {})
            if self.cfg.task in space_goals:
                return goal_meta(space_goals[self.cfg.task]())
        # fallback: reward regression over replay samples
        if len(self.buffer) > 0:
            return {meta_key: self._infer_meta_from_replay(None)}
        return dict(agent.init_meta(self.generator))

    def _infer_meta_from_replay(self, custom_reward: tp.Optional[tp.Any] = None,
                                draws: tp.Optional[int] = None) -> Tensor:
        """z = rᵀB/N over num_inference_steps samples, with the rewards of
        ``custom_reward`` computed from the sampled physics (the stored
        rewards when it is None). ``draws`` > 1 returns the norm-preserving
        spherical mean of that many independent regressions
        (cfg.z_inference_draws by default)."""
        n = self.agent.cfg.num_inference_steps
        draws = self.cfg.z_inference_draws if draws is None else draws

        def one_draw() -> Tensor:
            batch = self.buffer.sample(
                self.generator, n,
                custom_reward=custom_reward.from_physics if custom_reward else None)
            obs = (batch.next_obs if (self.cfg.goal_space is None
                                      or batch.next_goal is None) else batch.next_goal)
            return self.agent.infer_meta_from_obs_and_rewards(obs, batch.reward)

        if draws <= 1:
            return one_draw()
        zs = torch.stack([one_draw() for _ in range(draws)])
        unit = zs / torch.linalg.vector_norm(zs, dim=-1, keepdim=True).clamp_min(1e-12)
        mean = unit.mean(0)
        mean = mean / torch.linalg.vector_norm(mean).clamp_min(1e-12)
        return mean * torch.linalg.vector_norm(zs[0])

    # -- checkpointing ---------------------------------------------------
    def _maybe_snapshot(self, prev_step: int) -> None:
        """Save milestone snapshots for steps crossed since prev_step (the
        loops advance in chunks)."""
        for frame in self.cfg.snapshot_at:
            if prev_step < frame <= self.global_step:
                self.save_checkpoint(self.work_dir / "models" / f"snapshot_{frame}")

    def save_checkpoint(self, path: tp.Optional[Path] = None,
                        exclude: tp.Sequence[str] = ()) -> None:
        path = path or (self.work_dir / "models" / "latest")
        path.parent.mkdir(parents=True, exist_ok=True)
        agent_state = dict(self.agent.train_state())
        agent_state["generator"] = self.generator.get_state()
        ckpt_lib.save_checkpoint(path, {
            "agent": agent_state,
            "replay": self.buffer.state,
            "global_step": self.global_step,
            "global_episode": self.global_episode,
        }, exclude=exclude)

    def load_checkpoint(self, path: Path,
                        only: tp.Optional[tp.Sequence[str]] = None,
                        exclude: tp.Sequence[str] = ()) -> None:
        out = ckpt_lib.load_checkpoint(path, only=only, exclude=exclude,
                                       device=self.device)
        if "agent" in out:
            agent_state = dict(out["agent"])
            generator_state = agent_state.pop("generator")
            self.agent.load_train_state(agent_state)
            if generator_state.numel() != self.generator.get_state().numel():
                # a CPU generator's state and a CUDA generator's differ in
                # kind, so the run could not continue its random sequence
                raise ValueError(
                    f"checkpoint {path}: the generator's state was saved on "
                    f"another device type than {self.device.type}; load it with "
                    f"device= set to the type it was saved on")
            self.generator.set_state(generator_state)
        if "replay" in out:
            self.buffer.state = out["replay"]
        if only is None or "global_step" in (only or ()):
            self.global_step = out["global_step"]
            self.global_episode = out["global_episode"]


class OfflineWorkspace(Workspace):
    """Pure gradient-step training over a loaded buffer."""

    def _log_train(self, steps: int, metrics: tp.Dict[str, Tensor]) -> None:
        """One train row; converting the metrics waits for the device, so
        the lap before it is taken after them."""
        values = {k: float(v) for k, v in metrics.items()}
        elapsed, total = self.timer.lap()
        with self.logger.log_and_dump_ctx(self.global_step, "train") as log:
            log("fps", steps / max(elapsed, 1e-9))
            log("total_time", total)
            log("step", self.global_step)
            for k, v in values.items():
                log(k, v)
        self.last_row = log.row

    def train(self) -> tp.Dict[str, float]:
        """Runs updates up to ``num_grad_steps``, with train rows, snapshots
        and periodic checkpoints, and saves a final checkpoint; returns the
        last train row."""
        cfg = self.cfg
        assert len(self.buffer) > 0, "offline training requires a loaded buffer"
        trainer = make_offline_trainer(self.agent, self.buffer.cfg,
                                       self.agent.cfg.batch_size,
                                       steps_per_call=cfg.steps_per_call)
        log_every = max(cfg.log_every_steps, cfg.steps_per_call)
        steps_since_log = 0
        metrics: tp.Dict[str, Tensor] = {}
        self.timer.lap()
        while self.global_step < cfg.num_grad_steps:
            prev_step = self.global_step
            metrics = trainer(self.buffer.state, self.generator)
            self.global_step += cfg.steps_per_call
            steps_since_log += cfg.steps_per_call
            self._maybe_snapshot(prev_step)
            if steps_since_log >= log_every:
                # metrics stay on the device between logs so that launches
                # queue up; this is the only host sync
                self._log_train(steps_since_log, metrics)
                steps_since_log = 0
            if crossed(self.global_step, cfg.checkpoint_every, cfg.steps_per_call):
                self.save_checkpoint()
        if steps_since_log:
            self._log_train(steps_since_log, metrics)
        self.save_checkpoint()
        return self.last_row
