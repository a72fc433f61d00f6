"""Workspace: environment + agent + replay + logger + checkpoints, zero-shot
task inference, evaluation rollouts, the final test battery, and the
offline and online training loops (mirror of
``controllable_agent_tpu/train/workspace.py``).

Evaluation advances all its episodes at once (``loops.Rollout``): on a CUDA
device the per-step program (policy -> ``env.step`` -> reward sum ->
trajectory writes) is one captured CUDA graph replayed ``episode_length``
times; on the CPU the same function runs eagerly. z may differ per episode,
so ``finalize`` rolls every task's episodes out in one batch. The online
loops (``OnlineWorkspace``, ``TrainOnlineWorkspace``) collect their episodes
the same way (``loops.EpisodeCollector``) and commit them to the replay on
the device; the collector draws from a generator of its own
(``collect_generator``), saved in checkpoints beside the workspace's.

``obs_type=pixels`` wraps the task's environment in rendered frames
(``envs/pixels.py``) and sets ``obs_type="pixels"`` on any agent config
that has the field, as the JAX workspace does: DDPG encodes the frames,
FB takes them as flat columns, and an agent whose DDPG is built without the
frames' shape (the intrinsic agents) raises JAX's ``ValueError``.

A ``d4rl_*`` task with ``d4rl_dataset=<.npz>`` evaluates on the dataset's
own episodes (``envs/d4rl_replay.py``) and adds d4rl's ``normalized_score``
to each evaluation row. ``use_tb`` and ``use_wandb`` add the logger's
TensorBoard and wandb sinks; ``profile_dir`` traces one training cycle after
the seed frames with ``torch.profiler`` into a Chrome trace there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..agents import agent_classes
from ..config import apply_overrides, save_config, to_flat_dict
from ..data import ReplayBuffer
from ..envs.base import Environment, EnvSpec
from ..envs.gridworld import build_gridworld_task
from ..envs.pointmass import TASKS as _PMM_TASKS
from ..envs.pointmass import PointMassMaze
from ..goals import get_goal_space_dim, get_reward_function, goal_spaces, goals
from ..utils import Stopwatch, crossed, frames_remaining, resolve_device, trace
from . import checkpoint as ckpt_lib
from . import jax_checkpoint
from .logger import Logger
from .loops import OnlineTrainer, Rollout, make_offline_trainer
from .physics_stats import PhysicsAggregator

Tensor = torch.Tensor
MetaDict = tp.Dict[str, Tensor]
# the collector's generator is seeded this far from the workspace's, so that
# the two streams differ
COLLECT_SEED_OFFSET = 1_000_003


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


def make_env(task: str, episode_length: tp.Optional[int] = None) -> Environment:
    """Name-based environment dispatch: the gridworld, the point-mass maze,
    the quadruped (episodes of 1,000 steps by default), jaco (250), and
    walker, cheetah and hopper (1,000)."""
    if task.startswith("grid_"):
        kwargs = {} if episode_length is None else {"max_episode_length": episode_length}
        return build_gridworld_task(task[len("grid_"):], **kwargs)
    if task.startswith("point_mass_maze_"):
        sub = task[len("point_mass_maze_"):]
        if sub not in _PMM_TASKS and sub != "multi_goal":
            raise ValueError(f"Unknown point-mass task {sub}")
        return PointMassMaze(sub if sub in _PMM_TASKS else "reach_top_left",
                             episode_length=episode_length or 1000)
    domain = task.split("_", 1)[0]
    if domain == "quadruped":
        from ..envs import quadruped
        return quadruped.make(task, episode_length=episode_length or 1000)
    if domain == "jaco":
        from ..envs import jaco
        return jaco.make(task, episode_length=episode_length or 250)
    if domain in ("walker", "cheetah", "hopper"):
        from ..envs import locomotion
        return locomotion.make(task, episode_length=episode_length or 1000)
    raise ValueError(f"Unknown task {task!r}")


def _can_regress(agent: tp.Any) -> bool:
    """Whether ``agent`` infers z from rewards: on states (FB, SF) or on
    states and actions (SF-SVD)."""
    return (hasattr(agent, "infer_meta_from_obs_and_rewards")
            or hasattr(agent, "infer_meta_from_obs_action_and_rewards"))


# the tasks of the final test battery, by domain
_FINAL_TASKS = {
    "cheetah": ["walk", "walk_backward", "run", "run_backward"],
    "quadruped": ["stand", "walk", "run", "jump"],
    "walker": ["stand", "walk", "run", "flip"],
    "hopper": ["stand", "hop", "hop_backward", "flip"],
}


@contextlib.contextmanager
def _chrome_trace(path: Path, device: torch.device) -> tp.Iterator[None]:
    """Profile the block's host and (on a card) device activity into ``path``,
    with the program's tracing on (``utils/trace.py``: the spans of each
    update and control step, which the captured programs take anew for the
    block and again after it); the block's device work is waited for before
    the trace ends."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, trace.traced():
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


class Workspace:
    def __init__(self, cfg: WorkspaceConfig,
                 agent_cfg_overrides: tp.Sequence[str] = (),
                 agent_cfg_base: tp.Optional[tp.Dict[str, tp.Any]] = None) -> None:
        agent_cfg_cls, agent_cls = agent_classes(cfg.agent_name)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.collect_generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + COLLECT_SEED_OFFSET)
        self.work_dir = Path(cfg.folder)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.domain = cfg.task.split("_", 1)[0]
        if self.domain == "point":
            self.domain = "point_mass_maze"
        if cfg.obs_type == "pixels":
            from ..envs.pixels import make_pixel_env
            self.env: Environment = make_pixel_env(cfg.task, frame_stack=cfg.frame_stack,
                                                   episode_length=cfg.episode_length)
        elif cfg.task.startswith("d4rl_"):
            from ..envs.d4rl_replay import D4RLReplayEnv
            if cfg.d4rl_dataset is None:
                raise ValueError("d4rl_* tasks need d4rl_dataset=<path.npz>")
            self.env = D4RLReplayEnv.from_npz(cfg.task[len("d4rl_"):], cfg.d4rl_dataset,
                                              device=self.device)
        else:
            self.env = make_env(cfg.task, cfg.episode_length)

        # goal space -> goal_fn over physics + goal dim
        self.goal_fn: tp.Optional[tp.Callable[[Tensor], Tensor]] = None
        goal_dim: tp.Optional[int] = None
        if cfg.goal_space is not None:
            space_fns = goal_spaces.funcs.get(self.domain, {})
            if cfg.goal_space not in space_fns:
                raise ValueError(
                    f"Unknown goal space {cfg.goal_space} for {self.domain}")
            space_fn = space_fns[cfg.goal_space]
            feats_fn = getattr(self.env, "goal_features", lambda p: p)
            self.goal_fn = lambda phys: space_fn(feats_fn(torch.as_tensor(phys)))
            goal_dim = get_goal_space_dim(cfg.goal_space)
            if cfg.append_goal_to_observation:
                from ..envs.wrappers import GoalAppendWrapper
                self.env = GoalAppendWrapper(self.env, self.goal_fn,
                                             append_goal_to_observation=True)
        self.spec: EnvSpec = self.env.spec
        spec = self.spec

        field_names = {f.name for f in dataclasses.fields(agent_cfg_cls)}
        base_agent_cfg = agent_cfg_cls(**({"goal_space": cfg.goal_space}
                                          if "goal_space" in field_names else {}))
        if agent_cfg_base:
            # resumed folder: the saved run's resolved agent config is the
            # base (a run trained with e.g. agent.z_dim=100 must rebuild the
            # same network shapes before the checkpoint loads); agent.*
            # overrides of the command line still win below
            fixed = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in agent_cfg_base.items() if k in field_names}
            base_agent_cfg = dataclasses.replace(base_agent_cfg, **fixed)
        self.agent_cfg = apply_overrides(base_agent_cfg, list(agent_cfg_overrides))
        if cfg.obs_type == "pixels":
            if "obs_type" not in field_names:
                raise ValueError(f"Agent {cfg.agent_name!r} has no pixels path")
            self.agent_cfg = dataclasses.replace(self.agent_cfg, obs_type="pixels")
        # the discrete agents take the number of actions, the others the action's width
        discrete = getattr(agent_cls, "takes_n_actions", False)
        if discrete != spec.discrete_actions:
            raise ValueError(f"agent {cfg.agent_name!r} acts in a "
                             f"{'discrete' if discrete else 'continuous'} action space; "
                             f"task {cfg.task!r} has a "
                             f"{'discrete' if spec.discrete_actions else 'continuous'} one")
        # DDPG takes the frames' shape (the JAX registry hands it to DDPG alone)
        shape = ({"obs_shape": spec.obs_shape} if getattr(agent_cls, "takes_obs_shape", False)
                 else {})
        self.agent = agent_cls(self.agent_cfg, spec.obs_dim,
                               spec.n_actions if discrete else spec.action_dim,
                               goal_dim=goal_dim, device=self.device, seed=cfg.seed, **shape)
        # sized by the first episode loaded: stored episodes may be longer or
        # shorter than the evaluation's episode_length; a d4rl dataset's
        # episodes differ in length, and the environment's is the longest
        self.buffer = ReplayBuffer(
            max_episodes=cfg.replay_buffer_episodes, discount=cfg.discount,
            future=cfg.future, device=self.device,
            max_episode_length=(spec.episode_length if cfg.task.startswith("d4rl_")
                                else None))
        # the DDPG family's n-step returns reach the sampler
        nstep = int(getattr(self.agent.cfg, "nstep", 1) or 1)
        if nstep > 1:
            self.buffer.cfg = dataclasses.replace(self.buffer.cfg, nstep=nstep)
        self.logger = Logger(self.work_dir, use_console=cfg.use_console,
                             use_tb=cfg.use_tb, use_wandb=cfg.use_wandb,
                             wandb_config=dataclasses.asdict(cfg))
        self._profiled = False
        self.timer = Stopwatch()
        self.global_step = 0
        self.global_episode = 0
        self.last_row: tp.Dict[str, float] = {}
        self.inferred_z: tp.Optional[Tensor] = None
        self._rollouts: tp.Dict[int, Rollout] = {}
        self._video_recorder: tp.Optional[tp.Any] = None
        self.eval_rewards_history: tp.List[float] = []

        # the RESOLVED agent config is saved beside the workspace fields
        # (flattened agent.* keys): a folder resume must rebuild the network
        # shapes the checkpoint was trained with, not the class defaults
        save_config(cfg, self.work_dir / "config.json",
                    extra=to_flat_dict(self.agent_cfg, "agent."))
        if (self.work_dir / "models" / "latest").exists():
            self.load_checkpoint(self.work_dir / "models" / "latest")
        elif cfg.load_model is not None:
            self.load_checkpoint(Path(cfg.load_model), exclude=["replay"])

    # -- zero-shot task inference ---------------------------------------
    def _init_eval_meta(self) -> MetaDict:
        """Eval-time meta selection, the paths of the JAX ``_init_eval_meta``
        in its order. Returns an (unbatched) meta dict: {meta_key: z} for an
        agent with a task vector, ``init_meta``'s (empty for DDPG)
        otherwise."""
        agent = self.agent
        meta_key = getattr(agent, "meta_key", None)
        can_goal = meta_key is not None and hasattr(agent, "get_goal_meta")
        can_infer = meta_key is not None and _can_regress(agent)

        def goal_meta(goal: tp.Any) -> MetaDict:
            g = torch.as_tensor(goal, dtype=torch.float32, device=self.device)
            return {meta_key: agent.get_goal_meta(g)}

        # the gridworld: z = B(the goal's observation) of a reset of its own
        # (on grid_simple its goal is not the evaluation episodes' goals, as in JAX)
        if hasattr(self.env, "get_goal_obs") and can_goal:
            state, _ = self.env.reset(self.generator, 1)
            return goal_meta(self.env.get_goal_obs(state)[0])

        # custom reward with a registered goal
        if self.cfg.custom_reward is not None:
            reward = get_reward_function(self.cfg.custom_reward, self.cfg.seed)
            if self.cfg.goal_space is not None and can_goal:
                try:
                    return goal_meta(reward.get_goal(self.cfg.goal_space))
                except (NotImplementedError, ValueError):
                    pass
            if len(self.buffer) > 0 and can_infer:
                return {meta_key: self._infer_meta_from_replay(reward)}
        # registered goal for (goal_space, task)
        if self.cfg.goal_space is not None and can_goal:
            space_goals = goals.funcs.get(self.cfg.goal_space, {})
            if self.cfg.task in space_goals:
                return goal_meta(space_goals[self.cfg.task]())
        # fallback: reward regression over replay samples
        if len(self.buffer) > 0 and can_infer:
            return {meta_key: self._infer_meta_from_replay(None)}
        return dict(agent.init_meta(self.generator))

    def _infer_meta_from_replay(self, custom_reward: tp.Optional[tp.Any] = None,
                                draws: tp.Optional[int] = None) -> Tensor:
        """z regressed on num_inference_steps samples, with the rewards of
        ``custom_reward`` computed from the sampled physics (the stored
        rewards when it is None): z = rᵀB/N for FB, lstsq(φ(s), r) for SF,
        lstsq(φ(s, a), r) for SF-SVD, whose action-conditioned regression
        takes the next state with the action, as the JAX workspace does.
        ``draws`` > 1 returns the norm-preserving spherical mean of that
        many independent regressions (cfg.z_inference_draws by default)."""
        n = self.agent.cfg.num_inference_steps
        draws = self.cfg.z_inference_draws if draws is None else draws

        def one_draw() -> Tensor:
            batch = self.buffer.sample(
                self.generator, n,
                custom_reward=custom_reward.from_physics if custom_reward else None)
            obs = (batch.next_obs if (self.cfg.goal_space is None
                                      or batch.next_goal is None) else batch.next_goal)
            if hasattr(self.agent, "infer_meta_from_obs_action_and_rewards"):
                return self.agent.infer_meta_from_obs_action_and_rewards(
                    obs, batch.action, batch.reward)
            return self.agent.infer_meta_from_obs_and_rewards(obs, batch.reward)

        if draws <= 1:
            return one_draw()
        zs = torch.stack([one_draw() for _ in range(draws)])
        unit = zs / torch.linalg.vector_norm(zs, dim=-1, keepdim=True).clamp_min(1e-12)
        mean = unit.mean(0)
        mean = mean / torch.linalg.vector_norm(mean).clamp_min(1e-12)
        return mean * torch.linalg.vector_norm(zs[0])

    # -- evaluation -----------------------------------------------------
    def check_data(self, storage: tp.Mapping[str, tp.Any]) -> None:
        """Raise if loaded episodes do not have the environment's sizes."""
        want = {"observation": self.spec.obs_dim, "action": self.spec.action_dim,
                "physics": self.spec.physics_dim}
        for name, size in want.items():
            if name in storage and storage[name].shape[-1] != size:
                raise ValueError(
                    f"the loaded episodes have {storage[name].shape[-1]} {name} columns, "
                    f"the environment of task {self.cfg.task!r} has {size}")

    def _eval_rollout(self, z: tp.Union[None, Tensor, MetaDict], num_envs: int
                      ) -> tp.Tuple[Tensor, Tensor, tp.Optional[Tensor]]:
        """Fresh initial states from the workspace's generator, rolled out
        under ``z`` ([z_dim], or [E, z_dim] for a z per episode; None for an
        agent without a meta; the meta dict of an agent without a task
        vector, such as DIAYN). The result lives in the rollout's buffers
        until its next run; pixel observations are not kept (None)."""
        if num_envs not in self._rollouts:
            self._rollouts[num_envs] = Rollout(self.env, self.agent, num_envs)
        state, ts = self.env.reset(self.generator, num_envs)
        totals, physics, obs = self._rollouts[num_envs](z, state, ts)
        if not bool(torch.isfinite(totals).all() & torch.isfinite(physics).all()):
            raise FloatingPointError("an evaluation rollout reached a non-finite state")
        return totals, physics, obs

    def _base_env(self) -> Environment:
        env = self.env
        while hasattr(env, "env"):
            env = env.env
        return env

    def _record_eval_video(self, physics: Tensor) -> None:
        """Save the first evaluation episode as a video, strided to at most
        about 250 frames (``eval_video/<step>.png``)."""
        from .video import Renderer, VideoRecorder
        if self._video_recorder is None:
            self._video_recorder = VideoRecorder(
                self.work_dir, Renderer(self.domain, self._base_env()))
        stride = max(1, physics.shape[0] // 250)
        self._video_recorder.frames = []
        self._video_recorder.record_trajectory(physics[::stride].cpu().numpy())
        self._video_recorder.save(f"{self.global_step}.mp4")
        self.logger.log_video("eval/video", self._video_recorder.frames, self.global_step)

    def evaluate(self) -> tp.Dict[str, float]:
        meta = self._init_eval_meta()
        meta_key = getattr(self.agent, "meta_key", None)
        z = meta.get(meta_key) if meta_key is not None else None
        totals, phys, obs = self._eval_rollout(meta if meta_key is None else z,
                                               self.cfg.num_eval_episodes)
        if self.cfg.custom_reward is not None:
            reward = get_reward_function(self.cfg.custom_reward, self.cfg.seed)
            totals = reward.from_physics(phys).sum(1)
        metrics = {
            "episode_reward": float(totals.mean()),
            "episode_length": float(self.spec.episode_length),
            "episode": float(self.global_episode),
            "step": float(self.global_step),
        }
        if totals.numel() > 1:
            metrics["episode_reward#std"] = float(totals.std(unbiased=False))
        base_env = self._base_env()
        if hasattr(base_env, "get_normalized_score"):
            # one normalized score per evaluation episode, logged as the mean
            metrics["normalized_score"] = float(np.mean(
                [base_env.get_normalized_score(t) for t in totals.tolist()]))
        if z is not None:
            metrics["z_norm"] = float(torch.linalg.vector_norm(z))
        metrics.update(self._eval_diagnostics(meta, phys, obs))
        # physics stats in every eval dump
        agg = PhysicsAggregator(self.domain,
                                features_fn=getattr(self._base_env(), "goal_features", None))
        agg.add_batch(phys.flatten(0, 1))
        metrics.update(dict(agg.dump()))
        if self.cfg.save_eval_video:
            self._record_eval_video(phys[0])
        self.eval_rewards_history.append(metrics["episode_reward"])
        with self.logger.log_and_dump_ctx(self.global_step, ty="eval") as log:
            for k, v in metrics.items():
                log(k, v)
        return metrics

    def _eval_diagnostics(self, meta: tp.Dict[str, Tensor], phys: Tensor,
                          obs: tp.Optional[Tensor]) -> tp.Dict[str, float]:
        """FB health diagnostics over the whole eval rollout set (z_correl,
        actor_success; gated by agent.cfg.additional_metric). Without the
        observations (pixels), z_correl only with a goal space."""
        agent = self.agent
        if not (getattr(agent.cfg, "additional_metric", False)
                and hasattr(agent, "compute_z_correl") and "z" in meta):
            return {}
        horizon = phys.shape[1]
        obs_flat = obs.flatten(0, 1) if obs is not None else None
        goals = self.goal_fn(phys.flatten(0, 1)) if self.goal_fn is not None else obs_flat
        out: tp.Dict[str, float] = {}
        if goals is not None:
            # one dot per step summed and divided by episodes: T x the per-step mean
            out["z_correl"] = float(agent.compute_z_correl(goals, meta["z"])) * horizon
        if obs_flat is not None:
            out["actor_success"] = float(agent.compute_actor_success(
                obs_flat, meta["z"], self.generator))
        return out

    def eval_maze_goals(self) -> tp.Dict[str, float]:
        """20-goal maze sweep, two episodes per goal, all rolled out at once:
        mean reward and distance at the last step."""
        from ..goals.rewards import MazeMultiGoal
        mg = MazeMultiGoal()
        goals = torch.as_tensor(mg.goals, device=self.device).repeat_interleave(2, 0)
        z = torch.stack([self.agent.get_goal_meta(goal) for goal in goals])
        _, physics, _ = self._eval_rollout(z, goals.shape[0])
        reward, distance = mg.from_goal(physics[:, -1, :2], goals)
        metrics = {"reward": float(reward.mean()), "distance": float(distance.mean()),
                   "step": float(self.global_step)}
        with self.logger.log_and_dump_ctx(self.global_step, ty="eval") as log:
            for k, v in metrics.items():
                log(k, v)
        return metrics

    def finalize(self) -> tp.Dict[str, tp.List[float]]:
        """Final multi-task test battery: every task of the domain, z from
        rewards relabeled on the replay's physics, ``final_tests`` episodes
        each, all tasks in one batch of rollouts; writes test_rewards.json."""
        from ..envs import locomotion, quadruped
        repeat = self.cfg.final_tests
        if not repeat:
            return {}
        out_path = self.work_dir / "test_rewards.json"
        if self.cfg.custom_reward == "maze_multi_goal":
            rewards = {"rewards": [self.eval_maze_goals()["reward"]]}
            out_path.write_text(json.dumps(rewards))
            return rewards
        if self.domain not in _FINAL_TASKS:
            return {}
        if not (_can_regress(self.agent)
                and len(self.buffer) > 0 and "physics" in self.buffer.state.storage):
            return {}
        known = quadruped.TASKS if self.domain == "quadruped" else locomotion.TASKS[self.domain]
        names = [name for name in _FINAL_TASKS[self.domain] if name in known]
        reward_fns = {f"{self.domain}_{name}": get_reward_function(
            f"{self.domain}_{name}", self.cfg.seed) for name in names}
        z = torch.stack([self._infer_meta_from_replay(fn) for fn in reward_fns.values()])
        _, physics, _ = self._eval_rollout(z.repeat_interleave(repeat, 0),
                                           repeat * len(reward_fns))
        rewards = {task: fn.from_physics(part).sum(1).tolist()
                   for (task, fn), part in zip(reward_fns.items(), physics.split(repeat))}
        out_path.write_text(json.dumps(rewards))
        return rewards

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
        agent_state["collect_generator"] = self.collect_generator.get_state()
        ckpt_lib.save_checkpoint(path, {
            "agent": agent_state,
            "replay": self.buffer.state,
            "global_step": self.global_step,
            "global_episode": self.global_episode,
        }, exclude=exclude)

    def _profile_ctx(self) -> tp.ContextManager[tp.Any]:
        """A one-shot ``torch.profiler`` capture of the first training cycle
        after the seed frames, written as a Chrome trace
        (``<profile_dir>/trace_<step>.json``, the step the cycle starts at)."""
        if (self.cfg.profile_dir and not self._profiled
                and self.global_step >= self.cfg.num_seed_frames):
            self._profiled = True
            return _chrome_trace(Path(self.cfg.profile_dir) / f"trace_{self.global_step}.json",
                                 self.device)
        return contextlib.nullcontext()

    def load_checkpoint(self, path: Path,
                        only: tp.Optional[tp.Sequence[str]] = None,
                        exclude: tp.Sequence[str] = ()) -> None:
        if (Path(path) / "agent.msgpack").exists():
            # a checkpoint of the JAX package: the agent with the counters, and
            # its replay where it saved one (the generator starts from the seed)
            def wanted(key: str) -> bool:
                return (only is None or key in only) and key not in exclude

            if wanted("agent"):
                meta = jax_checkpoint.load_agent(path, self.agent)
                self.global_step = meta["global_step"]
                self.global_episode = meta["global_episode"]
            if wanted("replay") and (Path(path) / "replay.msgpack").exists():
                self.buffer.state = jax_checkpoint.load_replay(path, self.device)
            return
        out = ckpt_lib.load_checkpoint(path, only=only, exclude=exclude,
                                       device=self.device)
        if "agent" in out:
            agent_state = dict(out["agent"])
            generator_state = agent_state.pop("generator")
            # a checkpoint of an offline run written before the online loops has none
            collect_state = agent_state.pop("collect_generator", None)
            self.agent.load_train_state(agent_state)
            if generator_state.numel() != self.generator.get_state().numel():
                # a CPU generator's state and a CUDA generator's differ in
                # kind, so the run could not continue its random sequence
                raise ValueError(
                    f"checkpoint {path}: the generator's state was saved on "
                    f"another device type than {self.device.type}; load it with "
                    f"device= set to the type it was saved on")
            self.generator.set_state(generator_state)
            if collect_state is not None:
                self.collect_generator.set_state(collect_state)
        if "replay" in out:
            self.buffer.state = out["replay"]
        if only is None or "global_step" in (only or ()):
            self.global_step = out["global_step"]
            self.global_episode = out["global_episode"]


    def _log_train(self, steps: int, metrics: tp.Mapping[str, tp.Any],
                   **counters: float) -> None:
        """One train row: fps over ``steps``, the time, the step, then
        ``counters`` and ``metrics``. Converting device metrics waits for the
        device, so the lap is taken after them."""
        values = {k: float(v) for k, v in metrics.items()}
        elapsed, total = self.timer.lap()
        with self.logger.log_and_dump_ctx(self.global_step, "train") as log:
            log("fps", steps / max(elapsed, 1e-9))
            log("total_time", total)
            log("step", self.global_step)
            for k, v in {**counters, **values}.items():
                log(k, v)
        self.last_row = log.row

    def _evaluate_and_save(self, stride: int) -> None:
        """Evaluation and checkpoint when their period was crossed by a loop
        that advances ``stride`` steps at a time."""
        if crossed(self.global_step, self.cfg.eval_every_steps, stride):
            self.evaluate()
        if crossed(self.global_step, self.cfg.checkpoint_every, stride):
            self.save_checkpoint()


class OfflineWorkspace(Workspace):
    """Pure gradient-step training over a loaded buffer."""

    def _make_offline_trainer(self) -> tp.Callable[[], tp.Dict[str, Tensor]]:
        """``trainer()`` runs ``steps_per_call`` updates and returns their mean
        metrics; the multi-host workspace puts its data-parallel trainer here
        (``train_multihost.py``)."""
        trainer = make_offline_trainer(self.agent, self.buffer.cfg, self.agent.cfg.batch_size,
                                       steps_per_call=self.cfg.steps_per_call)
        return lambda: trainer(self.buffer.state, self.generator)

    def train(self) -> tp.Dict[str, float]:
        """Runs updates up to ``num_grad_steps``, with train rows, snapshots,
        periodic evaluations and checkpoints, saves a final checkpoint and
        runs the final test battery; returns the last train row."""
        cfg = self.cfg
        assert len(self.buffer) > 0, "offline training requires a loaded buffer"
        trainer = self._make_offline_trainer()
        log_every = max(cfg.log_every_steps, cfg.steps_per_call)
        steps_since_log = 0
        metrics: tp.Dict[str, Tensor] = {}
        self.timer.lap()
        while self.global_step < cfg.num_grad_steps:
            prev_step = self.global_step
            with self._profile_ctx():
                metrics = trainer()
            self.global_step += cfg.steps_per_call
            steps_since_log += cfg.steps_per_call
            self._maybe_snapshot(prev_step)
            if steps_since_log >= log_every:
                # metrics stay on the device between logs so that launches
                # queue up; this is the only host sync
                self._log_train(steps_since_log, metrics)
                steps_since_log = 0
            self._evaluate_and_save(cfg.steps_per_call)
        if steps_since_log:
            self._log_train(steps_since_log, metrics)
        self.save_checkpoint()
        self.finalize()
        return self.last_row


class OnlineWorkspace(Workspace):
    """Online pretraining in episode-granular cycles (anytrain), vectorised
    over ``num_envs`` environments: collect one episode per environment,
    commit them, then run updates matched to the environment steps
    (``1 / update_every_steps`` per step; none before ``num_seed_frames``).
    One train row per cycle; evaluation, checkpoints and snapshots on the
    steps each cycle crosses; a final checkpoint and ``finalize()``.
    ``online_trainer.timings`` and ``cycle_timings`` hold the cycles' times
    of collection and of commit and updates."""

    def train(self) -> tp.Dict[str, float]:
        cfg = self.cfg
        updates_per_step = 1.0 / max(1, getattr(self.agent.cfg, "update_every_steps", 2))
        trainer = OnlineTrainer(self.env, self.agent, self.buffer, num_envs=cfg.num_envs,
                                goal_fn=self.goal_fn, updates_per_step=updates_per_step)
        self.online_trainer = trainer
        self.cycle_timings: tp.List[tp.Dict[str, float]] = []
        trainer.global_step, trainer.global_episode = self.global_step, self.global_episode
        steps_per_cycle = self.spec.episode_length * cfg.num_envs
        self.timer.lap()
        while frames_remaining(self.global_step, cfg.num_train_frames) > 0:
            warmup = self.global_step < cfg.num_seed_frames
            trainer.updates_per_step = 0.0 if warmup else updates_per_step
            with self._profile_ctx():
                metrics = trainer.run_cycle(self.generator, self.collect_generator)
            self.cycle_timings.append(dict(trainer.timings))
            prev_step, self.global_step = self.global_step, trainer.global_step
            self.global_episode = trainer.global_episode
            self._maybe_snapshot(prev_step)
            self._log_train(steps_per_cycle, metrics, episode=self.global_episode,
                            buffer_size=len(self.buffer))
            self._evaluate_and_save(steps_per_cycle)
        self.save_checkpoint()
        self.finalize()
        return self.last_row


class TrainOnlineWorkspace(Workspace):
    """Online training in cycles of ``num_rollout_episodes`` episodes, then
    ``num_agent_updates`` updates. ``rollout_task_z_ratio`` of each cycle's
    episodes are directed: they hold a task z inferred from the replay
    (refreshed every ``task_z_refresh_frames``; held random z's before the
    seed frames) for the whole episode. ``update_replay_buffer=False``
    trains on a frozen loaded buffer. ``cycle_timings`` holds each cycle's
    seconds of collection and of commits and updates, and its updates;
    ``trainer`` is the run's update program."""

    def _collector(self, num_envs: int, hold_meta: bool) -> OnlineTrainer:
        return OnlineTrainer(self.env, self.agent, self.buffer, num_envs=num_envs,
                             goal_fn=self.goal_fn, updates_per_step=0.0, hold_meta=hold_meta)

    def train(self) -> tp.Dict[str, float]:
        cfg = self.cfg
        horizon = self.spec.episode_length
        n_task = int(round(cfg.rollout_task_z_ratio * cfg.num_rollout_episodes))
        n_task = min(max(n_task, 0), cfg.num_rollout_episodes)
        n_rand = cfg.num_rollout_episodes - n_task
        collector = self._collector(n_rand, False) if n_rand else None
        task_collector = self._collector(n_task, True) if n_task else None
        task_names = ([t.strip() for t in cfg.rollout_task_z_tasks.split(",") if t.strip()]
                      if cfg.rollout_task_z_tasks else [cfg.task])
        task_zs: tp.Optional[Tensor] = None  # [len(task_names), z_dim]
        last_refresh = -(10 ** 12)
        meta_key = getattr(self.agent, "meta_key", "z")
        trainer = make_offline_trainer(self.agent, self.buffer.cfg, self.agent.cfg.batch_size,
                                       steps_per_call=cfg.num_agent_updates)
        self.trainer = trainer
        steps_per_cycle = horizon * cfg.num_rollout_episodes
        self.cycle_timings: tp.List[tp.Dict[str, float]] = []
        self.timer.lap()
        while frames_remaining(self.global_step, cfg.num_train_frames) > 0:
            prev_step = self.global_step
            metrics: tp.Dict[str, tp.Any] = {}
            timing = {"collect": 0.0, "update": 0.0, "updates": 0}
            if cfg.update_replay_buffer:
                if collector is not None:
                    collector.global_step = self.global_step
                    metrics.update(collector.run_cycle(self.generator, self.collect_generator))
                    timing["collect"] += collector.timings["collect"]
                    timing["update"] += collector.timings["update"]
                    self.global_step += horizon * n_rand
                    self.global_episode += n_rand
                if task_collector is not None:
                    can_infer = len(self.buffer) > 0 and self.global_step >= cfg.num_seed_frames
                    task_meta = None
                    if can_infer:
                        if task_zs is None or \
                                self.global_step - last_refresh >= cfg.task_z_refresh_frames:
                            task_zs = torch.stack([
                                self._infer_meta_from_replay(get_reward_function(t, cfg.seed))
                                for t in task_names])
                            last_refresh = self.global_step
                        # as the JAX workspace: slot i always takes task i mod the
                        # number of tasks, so a slot keeps its task every cycle
                        task_meta = {meta_key: task_zs[[i % len(task_names)
                                                        for i in range(n_task)]]}
                    task_collector.global_step = self.global_step
                    directed = task_collector.run_cycle(self.generator, self.collect_generator,
                                                        meta=task_meta)
                    timing["collect"] += task_collector.timings["collect"]
                    timing["update"] += task_collector.timings["update"]
                    if can_infer:
                        metrics["task_episode_reward"] = directed["episode_reward"]
                    metrics.setdefault("episode_reward", directed["episode_reward"])
                    self.global_step += horizon * n_task
                    self.global_episode += n_task
            else:
                self.global_step += steps_per_cycle
            self._maybe_snapshot(prev_step)
            if len(self.buffer) > 0:
                started = time.perf_counter()
                metrics.update(trainer(self.buffer.state, self.generator))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timing["update"] += time.perf_counter() - started
                timing["updates"] = cfg.num_agent_updates
            self.cycle_timings.append(timing)
            self._log_train(steps_per_cycle, metrics, episode=self.global_episode)
            self._evaluate_and_save(steps_per_cycle)
        self.save_checkpoint()
        self.finalize()
        return self.last_row
