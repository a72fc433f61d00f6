"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases 26-28     # a selection: ranges and lists
    python3 chip_smoke.py --phases 4,11,21

Drives ``controllable_agent_torch`` (and nothing of the JAX package) in
thirty-five phases, numbered 1-33, 35 and 36, each printed on its own lines
with its seconds; any failure exits non-zero. Phase 34, the port's first
benchmark harness, was removed with its tools (``perfbench/`` times the
port): a selection that names it is refused. A selection always builds the
kernels (phase 1), and builds the least of what its phases read from earlier ones: phase 4's
workspace for phases 5-11 and its folder for phase 31 (by running phase 4), its episodes on disk for
phases 15, 30 and 32, phase 2's errors for phase 5, FB's captured updates/s (phase 4's,
else a short run at its geometry) for phases 14, 18 and 24-26, a fresh
full-width FB agent for phase 13, phase 15's workspaces for phase 16 (by
running phase 15), one collected quadruped cycle for phase 22. The phases:

  1. build the CUDA kernels of ``controllable_agent_torch/csrc`` with nvcc;
  2. hold each of the two fused-FB-loss kernels (the forward's four sums,
     the one backward pass) against its plain PyTorch version on the card,
     at n=1024 (the batch) and the ragged n=300, d=50, and check that both
     are bitwise repeatable;
  3. one full-width FBDDPG update with the fused loss against one without,
     from the same state with the same noise;
  4. the offline slice through its entry point, ``train_offline.main``:
     synthetic walker-shaped ExORL episodes (64 x 1000, obs 24, action 6,
     physics 18) written with ``save_exorl_episodes``, relabeled for
     ``walker_walk``, a few hundred updates at full width in bf16 with
     ``agent.use_pallas_loss=true``, run as replays of one captured CUDA
     graph, with ``evaluate()`` (10 episodes x 1,000 steps) twice between
     those replays and ``finalize()`` after them: the ``eval.csv`` rows and
     ``test_rewards.json`` of that run are required; every kernel's launch count must equal the number of updates
     plus the capture's eager warm-up runs, and so must the runs that the
     kernels count on the device themselves; the run's peak device memory;
     then the updates/s of the eager loop at the same size beside it;
  5. each kernel's device time against its plain version and its bound at
     n=1024, 2048 and 4096, d=50, timed over replays of a CUDA graph of
     back-to-back calls, so that the host's launch rate does not enter the
     time; the SM clock while such a graph runs;
  6. a ``torch.profiler`` trace of a few slice updates inside graph replays:
     each kernel's device time by name, the device's busy share, the kernel
     launches per update and the graph launches per call;
  7. captured against eager: a few full-width bf16 updates with the fused
     loss from one state, batch and noise through a captured program and
     through the eager ``_update`` on a copy (parameters, targets and Adam
     moments must agree); two replays must sample different batches and
     draw different noise;
  8. relabeling on the card at a real size: a walker-shaped buffer of 1,000
     episodes x 1,000 steps with 18 physics columns, relabeled for
     ``walker_walk``; its time and peak memory; a sample of rows against
     the same reward function on the CPU;
  9. z for a named task (``walker_run`` rewards from the stored physics, 8
     draws): finite and of norm sqrt(z_dim); then the checkpoint phase 4
     left, loaded by a fresh workspace on the same folder: identical state
     and an identical next update;
 10. the planar dynamics on the card: ``forward_dynamics`` and one control
     step (``step``) for walker, cheetah and hopper on 4,096 random states,
     a share of them penetrating the ground, against the same functions in
     float64 on the CPU (``tools/dynamics_check.py``, which states the
     tolerances);
 11. evaluation at full width on the workspace phase 4 trained:
     ``evaluate()`` with 10 episodes x 1,000 steps as replays of the captured
     step, twice more (other initial states), then ``finalize()`` with
     ``final_tests=10`` (four walker tasks in one batch of 40 episodes) into
     ``test_rewards.json``; captured against eager rollouts over 10 steps;
     a ``torch.profiler`` trace of 10 replayed steps at 10 and at 16,384
     environments; environment steps/s and peak memory at 10, 1,024 and
     16,384 environments, over episodes of 250 steps.

 12. online FB pretraining through its entry point, ``pretrain.main``, at
     full width in bf16 with ``agent.use_pallas_loss=true``: ``walker_walk``,
     4 environments, episodes of 500 steps, one seed cycle of 2,000 steps,
     then two cycles of 2,000 steps and 1,000 updates each; per cycle the collection's seconds
     and environment steps/s (the captured control step), the updates/s and
     the buffer's size; the update program captured once across the cycles'
     commits; each fused wrapper's launches, by its count and by the
     kernels' own, equal to the updates plus the capture's warm-up runs;
     an evaluation (``eval.csv``, its video) and ``test_rewards.json``; the
     run's peak device memory; then a fresh run on the folder resumes for
     one more cycle, continuing the step, the replay and the agent's step;
 13. the other online paths: ``train_online.main`` with half of each
     cycle's episodes directed by a task z (``task_episode_reward``);
     ``pretrain.main agent=rnd`` at full width, 1 environment, two cycles; a captured
     RND update, a captured collector step and two programs replayed in
     turns on one generator, each against its eager counterpart to the bit;
     the cheetah's reset with its settling steps captured against the same
     steps launched from the host, in time and to the bit;
 14. successor features at the JAX defaults (hidden 1024, feature 512,
     backward hidden 512, z 100, batch 1024, float32): SF with each of its
     thirteen feature learners, with ``q_loss=false``, ``boltzmann=true``
     and ``mix_ratio=0.5``, and SF-SVD, each 10 updates through the
     captured trainer and the same updates eagerly on a twin from the same
     generator state (held to the bit, else to phase 7's tolerance); per
     agent the updates/s both ways, the kernel launches and device time per
     update under the profiler, the peak device memory, and how the update
     is captured (``mix_ratio`` > 0: two graphs with the pseudo-inverse run
     eagerly between them);
 15. SF (``lap``) and SF-SVD through ``train_offline.main`` at full width on
     phase 4's episodes, relabeled, 300 updates with an evaluation,
     ``finalize()`` into ``test_rewards.json`` and a resumed run;
     ``pretrain.main agent=sf`` (1 environment) for a seed cycle and a
     training cycle, resumed for one more;
 16. the SF agents' inference on 5,120 replay samples, float32 on the card
     against float64 on the CPU: SF's least squares with full rank and with
     a rank-deficient φ, SF-SVD's on φ(s, a), and ``get_goal_meta`` after
     ``precompute_cov``. The fused FB kernels are not on this path: their
     launches over phases 14-16 must be 0;
 17. the gridworld on the card: every layout and observation type, 1,024
     environments x 200 steps of the same actions on the card and on the
     CPU, equal to the bit (observations, rewards, discounts, step types,
     actions, physics, the state and the goal observation); ``simple``'s
     goals over 16,384 resets (every free cell but the start, none else);
     one control step of discrete FB at full width captured and replayed
     over 10 steps against eager, to the bit (the greedy rollout and the
     epsilon-greedy collector); environment steps/s of ``env.step`` alone
     and of the evaluation rollout at 10, 1,024 and 16,384 environments;
 18. the discrete agents at the JAX defaults (discrete FB: hidden 1024, z 50,
     batch 1024, float32; its default, ``boltzmann=false`` and
     ``q_loss=true``, whose pseudo-inverse runs eagerly between two graphs;
     discrete SF with icm, identity and lap), 20 updates each through the
     captured trainer against the same updates eagerly on a twin, as phase
     14;
 19. the entry points on the grid: ``pretrain.main agent=discrete_fb
     task=grid_simple`` at full width (4 environments, a seed cycle, three
     training cycles, two evaluations with their videos; returns in [0,
     200], a finite goal-observation z of norm sqrt(z_dim), one capture of
     the update program), resumed for one more cycle; ``anytrain.main
     agent=discrete_fb task=grid_obstacle`` and ``pretrain.main
     agent=discrete_sf task=grid_simple`` for a seed cycle and a training
     cycle. No fused FB kernel is on this path: their launches over phases
     17-19 must be 0 by both counts;
 20. the 3-D engine on the card: ``forward_dynamics`` and one control step of
     the quadruped on flat ground, on an escape terrain and of jaco on 4,096
     random states against float64 on the CPU (``tools/dynamics_check.py``,
     each model's allowance); for stand, escape, fetch and jaco (the other
     quadruped tasks step stand's physics), a full-width FB policy's
     rollout of 10 episodes over 10 steps as replays of one captured control
     step against eager, to the bit, and the kernel launches and device ms
     per control step under the profiler; ``env.step`` alone at 10, 1,024
     and 16,384 environments for stand, at 10 for escape and fetch
     (``tools/env_step.py``), and one copy of 16,384 escape terrains;
 21. this slice's main path, the recipe of ``results/quad_one`` with only
     the cycles and the cycle's size short: ``train_online.main``
     ``agent=fb_ddpg task=quadruped_stand goal_space=quad_pos_speed`` at
     full width (hidden 1024, feature 512, backward hidden 526, z 50, batch
     1024) in bf16 with ``agent.use_pallas_loss=true``, two cycles of 4
     episodes x 500 steps and 250 updates; per cycle the collection's
     seconds and share and the updates/s; one capture of the update program;
     the fused kernels' launches by the wrappers' count and by the kernels'
     own, equal and > 0; then ``evaluate()`` (10 episodes, its video) and
     ``finalize()`` into ``test_rewards.json`` with exactly the four rows of
     the quadruped's battery, finite and in [0, 1000], each timed;
 22. the other entry points of the slice: ``pretrain agent=fb_ddpg
     task=jaco_reach_top_left`` (4 environments x 250 steps, a seed cycle and
     a cycle of 500 updates; ``finalize()`` returns ``{}``), ``train_offline``
     on phase 21's replay relabeled for ``quadruped_walk`` (400 captured
     updates, the relabeled rewards against the reward function), and
     ``anytrain`` on ``quadruped_fetch`` and ``quadruped_escape`` for one
     cycle of 2 environments x 500 steps and 500 updates each;
 23. pixels on the card: 84 x 84 frames with a stack of 3 of the walker,
     cheetah, hopper and point-mass maze, 1,024 environments x 20 steps,
     against the same physics rendered on the CPU (uint8 within 1, equal on
     at least 99.9%); ``random_shift_aug`` against ``np.pad(mode="edge")``
     and a crop, to the bit; the encoder on the card against the CPU; a
     full-width pixel DDPG collector captured against eager, to the bit;
     ``env.step`` on frames at 10, 1,024 and 4,096 environments;
 24. this slice's main path: ``pretrain agent=ddpg obs_type=pixels
     task=walker_walk`` at the JAX DDPG defaults (hidden 1024, batch 1024,
     n-step 3, float32, 84 x 84 x 9 uint8 frames, pad 4), cut to 1
     environment, episodes of 100 steps and a replay of 64 episodes: a seed
     cycle and a cycle of 50 updates, one capture of the update, a uint8 replay; a resumed
     workspace; the launches and device time of an update; ``evaluate()``
     (10 episodes, its video) and ``finalize()`` (``{}``); 10 full-width
     pixel updates captured against eager on a twin, to the bit; the
     captured update with cuDNN's TF32 off and on;
 25. the five explorers (DIAYN, ICM, ICM-APT, Disagreement, MaxEnt) at the
     JAX defaults, 25 updates each captured against eager on a twin, to
     the bit; ``pretrain agent=diayn`` (episodes of 500 steps) with the skill resampled in the
     captured collector. No fused FB kernel is on phases 23-25: their
     launches must be 0 by both counts;
 26. the last seven agents of the JAX registry at the JAX defaults (hidden
     1024, batch 1024, float32; Proto's 2,048-row queue): APS, NEWAPS (and
     with ``future_ratio=0.5``, two graphs around an eager pinv), SMM and
     Proto on phase 4's walker-shaped episodes with the meta column each
     reads (``task``, ``z``), UVF, GoalTD3 and GoalSM with
     ``goal_space=simplified_point_mass_maze`` on maze-shaped episodes with
     2-D goals and a ``g`` column; 25 updates each captured against eager
     on a twin, to the bit, with updates/s both ways, launches and device
     ms per update and the peak memory;
 27. ``pretrain agent={aps,new_aps,smm,proto} task=walker_walk`` at full
     width, 1 environment, episodes of 500 steps, a seed cycle and a
     training cycle each: APS's
     task changes in the replay only at multiples of 5 steps, SMM's one-hot
     z only at multiples of 50, NEWAPS's ``test_rewards.json`` has the four
     walker rows, and Proto, resumed from its folder, keeps its queue;
 28. ``pretrain agent={uvf,goal_td3,goal_sm}
     task=point_mass_maze_reach_top_left
     goal_space=simplified_point_mass_maze custom_reward=maze_multi_goal``,
     episodes of 500 steps, a seed cycle, a training cycle and ``finalize()`` (the 20-goal sweep,
     2 episodes each, one batch) into a finite ``test_rewards.json`` in [0,
     1]; then ``train_offline agent=goal_td3`` on that run's replay. No
     fused FB kernel is on phases 26-28: their launches must be 0 by both
     counts;
 29. d4rl, an earlier slice's main path: a synthetic dataset of
     halfcheetah-medium-v2's shape (1,000 episodes x 1,000 rows, timeouts,
     observations 17, actions 6) written as ``.npz``;
     ``train_offline.main task=d4rl_halfcheetah d4rl_dataset=...`` at the
     JAX FB defaults in bf16 with ``agent.use_pallas_loss=true``, 300
     captured updates, ``profile_dir`` set: the fused launches equal the
     updates + 6 by both counts (the profiled call turns the program's
     tracing on and the next call off again, each a capture with its two
     warm-up runs), the Chrome trace of the cycle after the seed frames
     names the fused kernels and the program's spans, the run's evaluation
     and one more
     have a ``normalized_score`` equal to d4rl's score, on the host, of the
     dataset's returns of the episodes the resets drew; the replay
     environment's captured control step against eager, to the bit;
     updates/s, the load's seconds (printed by ``train_offline``), the
     evaluation's seconds and the peak memory;
 30. data parallelism on the card at world size 1, through a one-process
     NCCL group (``tcp://127.0.0.1``): the captured data-parallel FB update
     (fused loss, bf16, the JAX defaults) against the plain captured
     update from the same state, batches and noise, to the bit; the fused
     launches of the data-parallel run by both counts; a profiler trace of
     replays of each (NCCL's kernels and copies per update); both updates/s
     in turns; ``train_multihost.main`` with one NCCL process on phase 4's
     episodes (300 updates, one evaluation and a checkpoint from process 0,
     one capture); one ``OnlineTrainer`` cycle with the group on the walker
     (4 x 1,000 steps collected, 500 data-parallel updates). A failed
     NCCL start or capture fails the phase; there is no gloo on the card;
 31. serving on the card from phase 4's folder: the demo's engine
     (``demo.serve._build_engine``, 5,120 inference rows) behind the real
     ``HTTPServer`` on 127.0.0.1 in a thread, answering three equations
     with 500-step rollouts and videos (each rollout equal to an eager one
     of the same z from the same reset, to the bit; z of norm sqrt(z_dim);
     the z inference, rollout, video and request times and the first
     request's capture), refusing an injection in red and serving
     ``/video?name=rollout.gif``; ``play_behaviors.main play_task=walker_run
     num_episodes=3`` (3 finite returns, 3 videos); ``export_replay.main`` of
     ``models/latest``, read back equal to the replay to the bit;
     ``orchestration.EntryPoint("offline")`` on a copy of the folder (300
     captured updates with the plain loss, one evaluation, whose return it
     returns negated); ``train.hiplogs`` over phase 4's and the EntryPoint's
     runs. No fused FB kernel runs on this phase: their launches must be 0
     by both counts;
 32. the data-parallel updates of the other agents at world size 1, through
     a one-process NCCL group: DDPG, RND, ICM-APT, Proto, NEWAPS with
     ``future_ratio=0.5``, SF with ``svd_sr`` and with ``mix_ratio=0.5`` (its
     pseudo-inverse between two graphs) and discrete FB with ``q_loss=true``
     on the grid, at the JAX defaults (float32): the captured data-parallel
     trainer against the plain captured one from the same state, batches
     and noise, to the bit, and both updates/s in turns;
     ``train_multihost.main agent=rnd`` with one NCCL process on phase 4's
     episodes (300 updates, one evaluation and a checkpoint, one capture).
     No fused FB kernel runs on this phase: their launches must be 0 by both
     counts;
 33. the dm_control tools' device halves at full width, this slice's main
     path (``tools/collect_mujoco_buffer.py``, ``tools/eval_mujoco.py``):
     (a) the collector's ``Collector`` with RND at its defaults (batch 1024)
     on eight synthetic episodes in dm_control walker's layout (obs 24,
     action 6, MuJoCo physics 18 near the standing pose): five bursts of 100
     captured updates (one capture), then 1,000 acts of its policy with one
     refresh of the acting copy; (b) ``train_offline
     physics_format=mujoco_walker`` on those episodes, written as ``.npz``,
     at the JAX FB defaults in bf16 with the fused loss, 300 updates: the
     fused launches equal the updates + 2 by both counts; (c) the
     evaluator's ``Evaluator`` on (b)'s folder: z for walker stand, walk and
     run as the spherical mean of 8 draws of 5,120 samples (each draw's
     coherence printed), then 1,000 acts per task from adapted MuJoCo states,
     each act deterministic; (d) where ``importlib.util.find_spec`` finds
     dm_control, the host loops too (3 collected episodes, 2 evaluation
     episodes per task); else a line naming the missing package;
 35. this slice's main path, the recipe mode of ``tools/online_curve.py``:
     ``recipe=results/quad_one entry=train_online`` with two cuts,
     ``num_train_frames`` at three cycles (10 episodes x 1,000 steps and
     5,000 updates each; the recipe has 201) and ``final_tests`` at 2 (10):
     the resolved ``config.json`` is the stored one but for the replaced
     keys and the two cuts, with the fused loss and bf16; the fused
     launches by the wrappers' counts equal the kernels' own and the
     updates plus the capture's warm-up runs; ``check.json`` is written
     with the quadruped's four battery rows, each with its verdict, and no
     checkpoint is left;
 36. the optimizer layer of one full-width FB update (bf16 mu): the three
     Adam steps and the two soft-updates through the multi-tensor kernels
     (``csrc/fused_optim.cu``) and through the ``_foreach`` versions, three
     updates each from one state, equal to the bit; the fused launches of a
     call (3 Adam, 2 lerp, by ``optim.launches``); device ms per call in one
     CUDA graph, in turns, and per step beside its bound (the bytes at 3.35
     TB/s). Then the agent's 56 bf16 copies made stale by a write to every
     parameter: ``Bf16Copy.refresh`` (``optim.cast_``, one launch of
     ``bf16_copy_refresh_kernel`` by ``bf16_copy.refreshes``) equal to
     ``cast_plain`` to the bit, and the cast timed the same way against
     ``cast_plain`` beside its bound (6 B an element). Phases 4 and 35 count
     the kernels' launches on their runs (3 Adam and 2 lerp an update, the
     capture's warm-up runs included; the refresh kernel's as they come), and
     the ``kernels`` line gains a row for each kernel.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script fails before printing a result.
"""

from __future__ import annotations

import csv
import dataclasses
import gc
import importlib.util
import json
import math
import re
import shutil
import socket
import sys
import tempfile
import threading
import time
import typing as tp
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import torch

import torch.distributed as dist

from controllable_agent_torch import (_build, anytrain, export_replay, optim, play_behaviors,
                                      pretrain, train_multihost, train_offline, train_online)
from controllable_agent_torch.agents import (FEATURE_LEARNERS, DDPGAgent, DDPGConfig, DDPGNoise,
                                             DiscreteFBAgent, DiscreteFBConfig, DiscreteSFAgent,
                                             DiscreteSFConfig, FBDDPGAgent, FBDDPGConfig, RNDAgent,
                                             RNDConfig,
                                             SFAgent, SFConfig, SFSVDAgent, SFSVDConfig,
                                             UpdateNoise, agent_classes)
from controllable_agent_torch.agents.sf import normalized_solution
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data import replay as replay_lib
from controllable_agent_torch.data.d4rl import normalized_score
from controllable_agent_torch.data.exorl import (load_exorl_episodes, save_exorl_episodes,
                                                 synthetic_episodes)
from controllable_agent_torch.demo import serve
from controllable_agent_torch.envs import build_gridworld_task, gridworld, locomotion
from controllable_agent_torch.envs.base import EnvSpec
from controllable_agent_torch.envs.pixels import make_pixel_env
from controllable_agent_torch.goals import get_reward_function
from controllable_agent_torch.goals.rewards import MazeMultiGoal
from controllable_agent_torch.models.networks import (Dense, PixelEncoder, conv_repr_dim,
                                                      l2_normalize)
from controllable_agent_torch.ops.augment import draw_shifts, random_shift_aug
from controllable_agent_torch.ops.linalg import lstsq, pinv
from controllable_agent_torch.ops import fused_fb as ff
from controllable_agent_torch.orchestration import EntryPoint
from controllable_agent_torch.parallel import make_dp_offline_trainer, make_group, multihost
from controllable_agent_torch.pretrain import build_workspace
from controllable_agent_torch.train.workspace import OfflineWorkspace, make_env
from controllable_agent_torch.tools import (collect_mujoco_buffer, dynamics_check, env_step,
                                            eval_mujoco, mujoco_bridge, online_curve)
from controllable_agent_torch.train import checkpoint as ckpt_lib
from controllable_agent_torch.train import hiplogs
from controllable_agent_torch.train.loops import (WARMUP_RUNS, CapturedProgram,
                                                  EpisodeCollector, OnlineTrainer, Rollout,
                                                  init_meta_batched, make_offline_trainer)
from controllable_agent_torch.utils.device import card_name_and_power_limit, query_card
from controllable_agent_torch.utils import trace
from controllable_agent_torch.utils.tree import soft_update

SEED = 0
N, N_RAGGED, D = 1024, 300, 50
SIZES = (1024, 2048, 4096)  # batches at which phase 5 times the kernels
OBS_DIM, ACTION_DIM, PHYSICS_DIM, EPISODES, EPISODE_LENGTH = 24, 6, 18, 64, 1000
SLICE_STEPS, STEPS_PER_CALL = 600, 100
EAGER_STEPS = 100  # the eager loop timed beside the captured trainer
PROFILE_STEPS = 20
CAPTURED_UPDATES = 3  # phase 7: updates through the captured program and eagerly
RELABEL_EPISODES, RELABEL_ROWS_CHECKED = 1000, 4096
Z_DRAWS = 8
DYNAMICS_STATES = 4096  # phase 10
EVAL_EVERY = 300  # phase 4 evaluates between replays of the training graph, twice
EVAL_EPISODES, FINAL_TESTS = 10, 10  # phases 4 and 11
WALKER_TASKS = tuple(f"walker_{t}" for t in ("stand", "walk", "run", "flip"))
COMPARED_STEPS = 10  # captured against eager, and the profiled window (cut from 20)
COLLECTOR_STEPS = 20  # phase 13: the collector captured against eager
RATE_STEPS = 250  # phase 11: the rollout's rate by environments over episodes of 250 steps (1,000)
ROLLOUT_SIZES = (10, 1024, 16384)  # environments advanced together
QUAD_STEP_SIZES = {"quadruped_stand": ROLLOUT_SIZES}  # phase 20; the other tasks at 10 (a cut)
# device kernels of each wrapper, as the profiler names them
KERNEL_NAMES = {"fwd": ("fb_fwd_tile_kernel", "fb_fwd_reduce_kernel"),
                "bwd": ("fb_bwd_tile_kernel", "fb_bwd_reduce_kernel")}
# Published H100 SXM peaks (dense). The ops bound of every row is taken at
# the rate of float32-accurate products on the tensor cores: 3xTF32 does
# three TF32 products per product, so a third of the 495 TFLOP/s TF32 peak.
F32_ACCURATE_TC_FLOP_PER_S = 495e12 / 3
# phase 12: a seed cycle, then two of 1,000 updates (cut from three, then from 2,000 updates)
ONLINE_ENVS, ONLINE_CYCLES = 4, 3
CYCLE_STEPS = ONLINE_ENVS * EPISODE_LENGTH  # environment steps of one cycle
# episodes of phases 12, 21, 22's anytrain, 25's DIAYN run, 27 and 28 (a cut from 1,000 steps)
SHORT_LENGTH = 500
SHORT_CYCLE = ONLINE_ENVS * SHORT_LENGTH  # phases 12, 21, 25 and 28: environment steps of a cycle
ONLINE_EVAL_EVERY = 2 * SHORT_CYCLE  # crossed at 4,000 steps (8,000 by the resumed run)
DIRECTED_CYCLES, DIRECTED_UPDATES = 2, 50  # phase 13's train_online run (cut from 3 cycles)
RND_CYCLES, RND_ENVS = 2, 1  # phase 13: a seed cycle, then one of 500 updates (cut from 2 envs)
RND_CYCLE_STEPS = RND_ENVS * EPISODE_LENGTH
CHEETAH_RESETS = 10  # environments of phase 13's cheetah reset, an evaluation's
# phases 14, 18: updates per agent, in calls of 5 then 5 (cut from 30, then 20)
SF_UPDATES, SF_FIRST = 10, 5
SF_PROFILED = 5  # phase 14: updates under the profiler per agent (the launch count)
# phase 14's variants beyond the thirteen learners at their defaults
SF_VARIANTS = (("lap", "q_loss", False), ("icm", "boltzmann", True), ("svd_sr", "mix_ratio", 0.5))
SF_RESUMED_STEPS = 100  # phase 15: updates of the resumed offline runs
SF_OFFLINE_STEPS = 300  # phase 15: updates of the offline runs, one evaluation
SF_ONLINE_ENVS = 1  # phase 15: pretrain agent=sf, cycles of 1 x 1,000 steps (cut from 2)
SF_CYCLE_STEPS = SF_ONLINE_ENVS * EPISODE_LENGTH
INFERENCE_SAMPLES = 5120  # phase 16: the agents' num_inference_steps
GRID_ENVS, GRID_LENGTH = 1024, 200  # phase 17: environments per pair; the JAX default episode
GRID_FIELDS = ("observation", "reward", "discount", "physics", "step_type", "action")
GRID_RESETS = 16384  # phase 17: resets of simple whose goals are counted
GRID_SIZES = (10, 1024, 16384)  # phase 17: environments advanced together
GRID_EPISODES = 64  # phase 18: random-policy episodes of grid_simple in the replay
GRID_CYCLE_STEPS = ONLINE_ENVS * GRID_LENGTH  # phase 19: environment steps of one cycle
GRID_CYCLES = 4  # phase 19: a seed cycle, then three of 400 updates
QUAD_BATTERY = tuple(f"quadruped_{t}" for t in ("stand", "walk", "run", "jump"))
QUAD_STEP_TASKS = ("quadruped_stand", "quadruped_escape", "quadruped_fetch")  # phase 20
QUAD_PROFILED = QUAD_STEP_TASKS + ("jaco_reach_top_left",)
QUAD_CYCLES, QUAD_UPDATES = 2, 250  # phase 21 (updates cut from 1,000; phase 35 runs 5,000)
QUAD_ANYTRAIN_ENVS = 2  # phase 22: anytrain on fetch and escape, one cycle of 2 x 1,000 steps
QUAD_REPLAY_EPISODES = 2000  # results/quad_one's replay_buffer_episodes
JACO_LENGTH = 250  # phase 22
QUAD_OFFLINE_UPDATES = 400  # phase 22: train_offline on phase 21's replay
PIXEL_TASKS = ("walker_walk", "cheetah_run", "hopper_hop", "point_mass_maze_reach_top_left")
PIXEL_ENVS, PIXEL_STEPS = 1024, 20  # phase 23: frames on the card
PIXEL_CPU_ENVS = 8  # phase 23: of them rendered again on the CPU at every step (cut from 16)
PIXEL_EQUAL_SHARE = 0.999  # uint8 frames: within 1 everywhere, equal on this share
AUG_PAD, ENCODER_BATCH = 4, 64  # phase 23: DrQ's pad (the JAX default); encoder's check
# the encoder's features, card against CPU: float32 sums of 81 x 32 products in another order
ENCODER_RTOL, ENCODER_ATOL = 1e-4, 1e-5
# phase 24's cuts (the recipe: 4 environments, 5,000 episodes of 1,000 steps)
PIXEL_RUN_ENVS, PIXEL_REPLAY_EPISODES, PIXEL_EPISODE_LENGTH = 1, 64, 100  # 100: cut from 250
PIXEL_CYCLE_STEPS = PIXEL_RUN_ENVS * PIXEL_EPISODE_LENGTH
PIXEL_COMPARED_UPDATES, PIXEL_FIRST = 10, 5  # phase 24: captured vs eager, timed after 5 (cut from 20)
EXPLORERS = ("diayn", "icm", "icm_apt", "disagreement", "max_ent")  # phase 25
EXPLORER_UPDATES = 25  # phase 25: updates per explorer, captured and eager (cut from 100, then 50)
TF32_TIMED = 5  # phase 24: pixel updates timed with cuDNN's TF32 off and on (cut from 10)
# phase 26: the last seven agents at the JAX defaults, and NEWAPS's hindsight z
ITEM13_AGENTS = ("aps", "new_aps", "new_aps future_ratio=0.5", "smm", "proto", "uvf",
                 "goal_td3", "goal_sm")
ITEM13_UPDATES = 25  # phase 26: updates per agent, captured and eager (cut from 100, then 50)
ITEM13_EXPLORERS = ("aps", "new_aps", "smm", "proto")  # phase 27, on walker_walk
ITEM13_ENVS = 1  # phase 27's environments (cut from 4, then 2)
MAZE_AGENTS = ("uvf", "goal_td3", "goal_sm")  # phase 28, on the point-mass maze
MAZE_GOAL_SPACE = "simplified_point_mass_maze"
MAZE_OFFLINE_UPDATES = 400  # phase 28: train_offline agent=goal_td3
# phase 29: a synthetic dataset of halfcheetah-medium-v2's shape, and its run
D4RL_DOMAIN, D4RL_EPISODES, D4RL_ROWS, D4RL_OBS, D4RL_ACTION = "halfcheetah", 1000, 1000, 17, 6
D4RL_STEPS, D4RL_SEED_FRAMES = 300, 100  # updates; the profiled call starts at step 100
# phase 30: data parallelism on one card
DP_UPDATES, DP_TIMED = 100, 100  # updates held to the plain ones to the bit; timed, in turns (200)
DP_GATHERS = 9  # all-gathers per DP update: goals, then F1, F2, B, TF1, TF2, TB, z, discount
MH_STEPS = 300  # train_multihost's updates
DP_ONLINE_UPDATES = 500  # the online cycle with a group: 4 x 1,000 steps, 500 updates (1,000)
# phase 31: serving on the card from phase 4's folder
SERVE_ROWS, SERVE_STEPS = 5120, 500  # the demo's inference rows and rollout steps
SERVE_COMPARED = 100  # steps of each served rollout held to an eager one (a cut from 500)
SERVE_EQUATIONS = ("vx", "exp(-(x-8)**2) * up", "-vx")
SERVE_INJECTION = "__import__('os')"
PLAY_EPISODES, PLAY_LENGTH = 3, 250  # play_behaviors' episodes, cut from 1,000 steps
ENTRY_UPDATES = 300  # EntryPoint("offline") on phase 4's checkpoint and replay
# phase 32: the other agents' data-parallel updates on one card, (agent, config overrides)
DP_AGENTS = (("ddpg", {}), ("rnd", {}), ("icm_apt", {}), ("proto", {}),
             ("new_aps", {"future_ratio": 0.5}), ("sf", {"feature_learner": "svd_sr"}),
             ("sf", {"mix_ratio": 0.5}), ("discrete_fb", {"q_loss": True}))
# updates held to the plain ones to the bit; timed a turn, in turns (plain, dp, dp, plain)
DP_AGENT_UPDATES, DP_AGENT_TIMED = 20, 25  # (timed cut from 50)
# phase 33: the dm_control tools' device halves at full width
MJ_EPISODES = 8  # synthetic episodes in dm_control walker's layout (obs 24, action 6, physics 18)
MJ_BURSTS = 5  # bursts of collect_mujoco_buffer.UPDATES_PER_CALL captured RND updates
MJ_ACTS = 1000  # acts of the collector's policy, and of the evaluator's for each task
MJ_OFFLINE_STEPS = 300  # train_offline physics_format=mujoco_walker, the fused loss
MJ_TASKS = ("walker_stand", "walker_walk", "walker_run")
MJ_HOST_EPISODES, MJ_HOST_EVAL_EPISODES = 3, 2  # (d), where dm_control is installed
# phase 35: results/quad_one's recipe through online_curve, cut to three cycles
RECIPE = Path(__file__).resolve().parent / "results" / "quad_one"
RECIPE_CYCLES, RECIPE_FINAL_TESTS = 3, 2
LAST_PHASE = 36
# phase numbers are names: a removed phase keeps its number, and naming it is refused
REMOVED_PHASES = {34: "phase 34 (the first benchmark harness) was removed with its tools; "
                      "perfbench/ and BENCHMARK.json time the port"}
F32_EPS = float(torch.finfo(torch.float32).eps)
HBM_BYTES_PER_S = 3.35e12
FWD_RTOL = 2e-4  # as tests/test_pallas_fb.py: order of f32 sums over n^2
GRAD_RTOL = 1e-4  # of the largest entry: f32 accumulation order only


def kernel_inputs(n: int, d: int, seed: int) -> tp.List[torch.Tensor]:
    rng = np.random.RandomState(seed)
    xs = [rng.randn(n, d).astype(np.float32) for _ in range(6)]
    xs.append(rng.uniform(0.9, 1.0, (n, 1)).astype(np.float32))
    return [torch.from_numpy(x).cuda() for x in xs]


def loss_cotangent(n: int) -> torch.Tensor:
    """d(loss)/d(sums) as the agent's normalisation gives them."""
    denom = n * (n - 1)
    return torch.tensor([0.5 / denom, -1.0 / n, 1.0 / denom, -2.0 / n],
                        device="cuda")


def check_kernels(n: int) -> tp.Dict[str, float]:
    """Each kernel against its plain version; returns max abs errors (the
    forward's for its FB sums and its orthonormality sums apart)."""
    args = kernel_inputs(n, D, SEED + n)
    g = loss_cotangent(n)
    pairs = {
        "fwd": (ff.fwd(*args), ff.fwd_plain(*args)),
        "bwd": (torch.stack(ff.bwd(*args, g)), torch.stack(ff.bwd_plain(*args, g))),
    }
    scale = ff.fwd_plain(*[x.abs() for x in args])
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        if name == "fwd":
            # rtol on each sum, plus float32 rounding of its terms' size
            # (the diagonal sum of random inputs may cancel towards 0)
            tols = FWD_RTOL * want.abs() + 1e-6 * scale
            worst = int(((got - want).abs() / tols).argmax())
            err, tol = float((got - want).abs()[worst]), float(tols[worst])
            what = f"rtol {FWD_RTOL} + 1e-6 x sum of |terms|, worst of the 4 sums"
        else:  # dF1, dF2 and dB, each to its own largest entry
            tols = GRAD_RTOL * want.abs().flatten(1).max(1).values
            worst = int(((got - want).abs().flatten(1).max(1).values / tols).argmax())
            err = float((got[worst] - want[worst]).abs().max())
            tol = float(tols[worst])
            what = (f"atol {GRAD_RTOL} x max|plain| of each of dF1, dF2, dB, "
                    f"worst is {('dF1', 'dF2', 'dB')[worst]}")
        ok = err <= tol
        print(f"phase 2 n={n} d={D} {name}: max_abs_err {err:.3e} "
              f"tolerance {tol:.3e} ({what}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel {name} disagrees with its plain version at n={n}")
    for name, again in (("fwd", ff.fwd(*args)), ("bwd", torch.stack(ff.bwd(*args, g)))):
        if not torch.equal(again, pairs[name][0]):
            raise AssertionError(f"{name} is not bitwise repeatable")
    print(f"phase 2 n={n}: fwd and bwd bitwise repeatable")
    fwd_err = (pairs["fwd"][0] - pairs["fwd"][1]).abs()
    return {"fwd_fb": float(fwd_err[:2].max()), "fwd_orth": float(fwd_err[2:].max()),
            "bwd": float((pairs["bwd"][0] - pairs["bwd"][1]).abs().max())}


def check_update(episodes: tp.List[tp.Dict[str, np.ndarray]]) -> None:
    """One full-width update with and without the fused loss, float32
    compute, same state and noise: the FB loss and its gradients agree to
    f32 summation order; Adam's first step is ~lr*sign(g), so parameters
    agree except where a near-zero gradient flips sign."""
    buf = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cuda")
    buf.load_episodes(episodes)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = buf.sample(gen, N)
    fused = FBDDPGAgent(FBDDPGConfig(use_pallas_loss=True), OBS_DIM, ACTION_DIM,
                        device="cuda", seed=SEED)
    plain = FBDDPGAgent(FBDDPGConfig(use_pallas_loss=False), OBS_DIM, ACTION_DIM,
                        device="cuda", seed=SEED)
    plain.load_state_dict(fused.state_dict())
    noise = UpdateNoise.draw(fused.cfg, N, ACTION_DIM, gen, torch.device("cuda"))

    def fb_grads(agent: tp.Any) -> tp.Tuple[float, tp.List[torch.Tensor]]:
        z = agent._build_train_z(batch, noise)
        loss, _ = agent._fb_loss(batch, z, batch.next_obs, noise.next_action_normal)
        params = list(agent.forward_net.parameters()) + list(agent.backward_net.parameters())
        return float(loss.detach()), list(torch.autograd.grad(loss, params))

    loss_f, grads_f = fb_grads(fused)
    loss_p, grads_p = fb_grads(plain)
    loss_err = abs(loss_f - loss_p)
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(grads_f, grads_p))
    m_f = fused._update(batch, noise)
    m_p = plain._update(batch, noise)
    lr = fused.cfg.lr
    diffs = torch.cat([(a - b).abs().flatten().detach() for a, b in
                       zip(fused.parameters(), plain.parameters())])
    flipped = float((diffs > 1e-3 * lr).float().mean())
    print(f"phase 3 update fused vs plain (n={N}, f32): fb_loss {loss_f:.6f} vs "
          f"{loss_p:.6f} (abs err {loss_err:.3e}, rtol 1e-4); worst grad "
          f"err/max {grad_err:.3e} (tol 1e-3); post-update max param diff "
          f"{float(diffs.max()):.3e} (tol 2*lr), share > 1e-3*lr {flipped:.2e} "
          f"(tol 1e-3); metrics fb_loss {float(m_f['fb_loss']):.6f} vs "
          f"{float(m_p['fb_loss']):.6f}")
    if not (loss_err <= 1e-4 * abs(loss_p) and grad_err <= 1e-3
            and float(diffs.max()) <= 2 * lr and flipped <= 1e-3):
        raise AssertionError("fused and plain updates disagree")


def walker_physics(shape: tp.Tuple[int, ...], generator: torch.Generator,
                   device: str) -> torch.Tensor:
    """Walker-shaped [q, qd] rows: the torso between lying and standing
    height, pitch and joints within a radian, velocities of a few units."""
    q = torch.rand(shape + (9,), generator=generator, device=device) * 2 - 1
    q[..., 0] *= 3.0
    q[..., 1] = 0.3 + 1.3 * (q[..., 1] + 1) / 2
    qd = torch.randn(shape + (9,), generator=generator, device=device) * 2
    return torch.cat([q, qd], -1)


def slice_args(folder: str, episodes_dir: str) -> tp.List[str]:
    return [f"replay_dir={episodes_dir}", "task=walker_walk", "relabel=true",
            "agent=fb_ddpg", "agent.use_pallas_loss=true",
            "agent.compute_dtype=bfloat16", f"num_grad_steps={SLICE_STEPS}",
            f"steps_per_call={STEPS_PER_CALL}", f"log_every_steps={STEPS_PER_CALL}",
            f"eval_every_steps={EVAL_EVERY}", f"num_eval_episodes={EVAL_EPISODES}",
            "checkpoint_every=0", f"final_tests={FINAL_TESTS}", "save_eval_video=false",
            f"replay_buffer_episodes={EPISODES}", f"folder={folder}", f"seed={SEED}"]


def read_csv(path: tp.Any) -> tp.List[tp.Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def check_test_rewards(ws: tp.Any, returned: tp.Any = None,
                       tasks: tp.Tuple[str, ...] = WALKER_TASKS) -> tp.Dict[str, tp.List[float]]:
    """``test_rewards.json`` of the workspace: the domain's battery (the
    four walker tasks by default) with FINAL_TESTS finite returns each inside
    [0, episode_length]."""
    horizon = ws.spec.episode_length
    written = json.loads((ws.work_dir / "test_rewards.json").read_text())
    if (returned is not None and written != returned) or tuple(written) != tasks \
            or not all(len(v) == FINAL_TESTS
                       and all(math.isfinite(r) and 0.0 <= r <= horizon for r in v)
                       for v in written.values()):
        raise AssertionError(f"bad test_rewards.json: {written}")
    return written


def write_slice_episodes(tmp: str) -> int:
    """Phase 4's episodes: synthetic walker-shaped ExORL episodes with walker
    physics, written to ``tmp/episodes`` (phase 15 reads them too)."""
    episodes = synthetic_episodes(EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED)
    gen = torch.Generator().manual_seed(SEED)
    for episode in episodes:
        episode["physics"] = walker_physics((EPISODE_LENGTH + 1,), gen, "cpu").numpy()
    store = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cpu")
    store.load_episodes(episodes)
    return save_exorl_episodes(store.state, f"{tmp}/episodes")


def check_stored_rewards(storage: tp.Dict[str, torch.Tensor], episodes_dir: str) -> None:
    """Phase 4's replay holds walker_walk's rewards. ``train_offline`` loaded
    the episode files and relabeled the stored physics on the card
    (``ReplayBuffer.relabel``, ``ROWS_PER_PASS`` rows at a time), so: the
    stored physics equal the files' to the bit; the stored rewards equal the
    same function over the same rows in the same passes on the card to the
    bit; and they are within 1e-5 of float64 on the CPU (float32 rounding,
    2.5e-7 measured). The CPU's float32 values, one episode at a time (the
    JAX package's way), are printed beside them."""
    reward = get_reward_function("walker_walk")
    files = torch.stack([torch.from_numpy(ep["physics"])
                         for ep in load_exorl_episodes(Path(episodes_dir))])
    physics = storage["physics"]
    rows = physics.reshape(-1, physics.shape[-1])
    again = torch.cat([reward.from_physics(part)
                       for part in rows.split(replay_lib.ROWS_PER_PASS)])
    stored = storage["reward"][..., 0]
    exact = reward.from_physics(files.double())
    cpu = torch.stack([reward.from_physics(episode.numpy()) for episode in files])
    off = (stored.cpu().double() - exact).abs()
    cpu_outliers = int((cpu - stored.cpu()).abs().gt(1e-6).sum())
    worst = divmod(int(off.argmax()), stored.shape[1])
    same_physics = torch.equal(physics.cpu(), files)
    same_passes = torch.equal(stored, again.reshape(stored.shape))
    print(f"phase 4 rewards: the stored physics equal to the episode files' {same_physics}; "
          f"the stored rewards equal to walker_walk's over the same rows in the relabel's "
          f"passes on the card {same_passes}; against float64 on the CPU max |diff| "
          f"{float(off.max()):.3e} at episode {worst[0]} step {worst[1]} (tolerance 1e-5); the "
          f"CPU's float32 one episode at a time against float64 "
          f"{float((cpu.double() - exact).abs().max()):.3e} ({cpu_outliers} rows beyond 1e-6 "
          f"of the card's; CPU {torch.backends.cpu.get_cpu_capability()}, "
          f"{torch.get_num_threads()} threads)")
    if not (same_physics and same_passes and float(off.max()) <= 1e-5):
        raise AssertionError("the buffer does not hold walker_walk's rewards")


def run_slice(tmp: str) -> tp.Tuple[tp.Dict[str, int], tp.Any]:
    written = write_slice_episodes(tmp)
    torch.cuda.reset_peak_memory_stats()
    ff.reset_launches()
    reset_optimizer_launches()
    t0 = time.perf_counter()
    ws = train_offline.main(slice_args(f"{tmp}/run", f"{tmp}/episodes"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ff.launches)
    ran = ff.device_runs()
    peak = torch.cuda.max_memory_allocated()
    row, z = ws.last_row, ws.inferred_z
    expected = SLICE_STEPS + WARMUP_RUNS
    print(f"phase 4 slice: {written} episodes relabeled for walker_walk, "
          f"{ws.global_step} updates as replays of one captured graph in {wall:.1f} s "
          f"(load, relabel, capture and checkpoint included); launches {counts} = "
          f"{SLICE_STEPS} replayed updates (replays x the launches the graph holds) + "
          f"{WARMUP_RUNS} eager warm-up runs of the capture; runs counted on the device by "
          f"the kernels themselves over the same run: {ran}")
    check_optimizer_launches(4, SLICE_STEPS, "train_offline (phase 4)")
    if ws.global_step != SLICE_STEPS or ws.agent.step != SLICE_STEPS \
            or any(c != expected for c in counts.values()) or ran != counts:
        raise AssertionError(f"expected {expected} launches of every kernel, as many runs "
                             f"on the device and {SLICE_STEPS} steps, got {counts}, {ran}, "
                             f"step {ws.agent.step}")
    check_stored_rewards(ws.buffer.state.storage, f"{tmp}/episodes")
    if not all(math.isfinite(v) for v in row.values()):
        raise AssertionError(f"non-finite train metrics: {row}")
    if z is None or z.shape != (ws.agent.cfg.z_dim,) or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"bad inferred z: {z}")
    captured_rate = row["fps"]
    print(f"phase 4 slice: {captured_rate:.1f} updates/s over the last "
          f"{STEPS_PER_CALL} updates (captured), fb_loss {row['fb_loss']:.4f}, actor_loss "
          f"{row['actor_loss']:.4f}, on {card_name_and_power_limit()}")
    print("phase 4 slice: inferred z " + " ".join(f"{v:.4f}" for v in z.tolist()))
    print(f"phase 4 slice: peak device memory {peak / 2**20:.1f} MiB "
          "(torch.cuda.max_memory_allocated over the run: replay, the training graph's "
          "pool and the two rollouts' buffers and graphs included)")

    # the evaluations ran between replays of the training graph, each drawing its
    # initial states eagerly from the generator that the graph is registered with
    windows = [float(r["fps"]) for r in read_csv(ws.work_dir / "train.csv")]
    evals = read_csv(ws.work_dir / "eval.csv")
    returns = [float(r["episode_reward"]) for r in evals]
    print(f"phase 4 slice: evaluated at steps {[int(float(r['step'])) for r in evals]} "
          f"({EVAL_EPISODES} episodes x {ws.spec.episode_length} steps each, the first with "
          f"the rollout's capture), episode_reward " + ", ".join(f"{r:.2f}" for r in returns)
          + "; updates/s by window of the train rows (a window after an evaluation holds "
          "its time): " + ", ".join(f"{w:.1f}" for w in windows))
    if [int(float(r["step"])) for r in evals] != list(range(EVAL_EVERY, SLICE_STEPS + 1, EVAL_EVERY)) \
            or not all(math.isfinite(r) and 0.0 <= r <= ws.spec.episode_length for r in returns) \
            or returns[0] == returns[-1]:
        raise AssertionError(f"bad eval rows from the training run: {evals}")
    written = check_test_rewards(ws)
    print("phase 4 slice: test_rewards.json from the run's finalize(): mean returns "
          + ", ".join(f"{t} {np.mean(written[t]):.2f}" for t in WALKER_TASKS))

    # the eager loop at the same size, once, beside the captured trainer
    eager = make_offline_trainer(ws.agent, ws.buffer.cfg, ws.agent.cfg.batch_size,
                                 EAGER_STEPS, capture=False)
    float(eager(ws.buffer.state, ws.generator)["fb_loss"])  # warm-up
    t0 = time.perf_counter()
    float(eager(ws.buffer.state, ws.generator)["fb_loss"])
    eager_rate = EAGER_STEPS / (time.perf_counter() - t0)
    print(f"phase 4 slice: eager loop {eager_rate:.1f} updates/s over {EAGER_STEPS} updates, "
          f"captured {captured_rate:.1f} ({captured_rate / eager_rate:.2f}x), same agent, "
          f"same buffer, on {card_name_and_power_limit()}")
    return counts, ws


def time_ms(fn: tp.Callable[[], tp.Any], calls: int = 50, replays: int = 20) -> float:
    """Device ms per call of ``fn``: ``calls`` back-to-back calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound(flops: float, nbytes: float) -> tp.Tuple[float, str]:
    """The least ms the card could take, and which of the two bounds it."""
    ops_ms = 1e3 * flops / F32_ACCURATE_TC_FLOP_PER_S
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def time_pair(kernel: tp.Callable[[], tp.Any], plain: tp.Callable[[], tp.Any],
              calls: int) -> tp.Tuple[float, float, str]:
    """Kernel and plain version in turns (plain, kernel, kernel, plain);
    returns the best of each and the four times as text."""
    plain_a = time_ms(plain, calls)
    ms_a = time_ms(kernel, calls)
    ms_b = time_ms(kernel, calls)
    plain_b = time_ms(plain, calls)
    turns = f"kernel {ms_a:.5f}/{ms_b:.5f} ms, plain {plain_a:.5f}/{plain_b:.5f} ms"
    return min(ms_a, ms_b), min(plain_a, plain_b), turns


def clock_under_load(fn: tp.Callable[[], tp.Any], calls: int = 50) -> str:
    """The SM clock as ``nvidia-smi`` reads it while a CUDA graph of ``calls``
    back-to-back calls of ``fn`` is replayed (about a second of queued work)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(1000):
        graph.replay()
    clock = query_card("clocks.sm")
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    return f"{clock} ({'the device still busy' if busy else 'the device already idle'} when read)"


def time_kernels(errors: tp.Dict[str, float], counts: tp.Dict[str, int]
                 ) -> tp.List[tp.Dict[str, tp.Any]]:
    source = "controllable_agent_torch/csrc/fused_fb.cu"
    rows = []

    def row(name: str, replaces: str, kernel: str, err: str, times: tp.Tuple[float, float],
            least: tp.Tuple[float, str], note: str) -> None:
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": f"controllable_agent_tpu/ops/pallas_fb.py:{replaces}",
                     "launches": counts[kernel], "max_abs_err": errors[err],
                     "ms": times[0], "plain_ms": times[1], "bound_ms": least[0],
                     "bound_by": least[1], "library_ms": None, "wrapper": kernel,
                     "launches_by_path": {"train_offline (phase 4)": counts[kernel]},
                     "note": note})

    for n in SIZES:
        xs = kernel_inputs(n, D, SEED)
        g = loss_cotangent(n)
        nd, n2d = n * D, n * n * D
        in_bytes = 4 * (6 * nd + n)
        calls = max(4, 50 * N * N // (n * n))
        # The least flops each function needs. The FB sums need the n x n
        # TM = min(TF1 TB^T, TF2 TB^T) (4 n^2 d) and one n x n by n x d product
        # with it (2 n^2 d); every term in M1 or M2 alone factors through d x d
        # Gram matrices (O(n d^2), not counted). The orthonormality sums need the
        # symmetric Gram matrix B^T B (n d (d+1)) and the row norms (2 n d). The
        # backward (dF1, dF2 and the FB part of dB together) needs TM once
        # (4 n^2 d), (g TM off) B for dF1 and dF2 (2 n^2 d) and TM^T (g (F1 + F2))
        # for dB (2 n^2 d): 8 n^2 d. It reads the inputs and g and writes three
        # n x d outputs.
        least = {"fwd": (6 * n2d + nd * (D + 1) + 2 * nd, in_bytes + 16),
                 "fwd_fb": (6 * n2d, in_bytes + 8),
                 "fwd_orth": (nd * (D + 1) + 2 * nd, 4 * nd + 8),
                 "bwd": (8 * n2d, in_bytes + 16 + 12 * nd)}
        timed = {}
        for name, kernel, plain in (
                ("fwd", lambda: ff.fwd(*xs), lambda: ff.fwd_plain(*xs)),
                ("bwd", lambda: ff.bwd(*xs, g), lambda: ff.bwd_plain(*xs, g))):
            ms, plain_ms, turns = time_pair(kernel, plain, calls)
            timed[name] = (ms, plain_ms)
            flops, nbytes = least[name]
            bound_ms, bound_by = bound(flops, nbytes)
            print(f"phase 5 {name} n={n} d={D}: {turns} (CUDA graph), bound {bound_ms:.5f} ms "
                  f"({bound_by}, {flops / 1e9:.4f} GFLOP at "
                  f"{F32_ACCURATE_TC_FLOP_PER_S / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.3f} MB); "
                  f"{ms / bound_ms:.1f}x the bound, {plain_ms / ms:.2f}x faster than plain")
        if n != N:
            continue
        print(f"phase 5 SM clock under load (fwd, n={n}): {clock_under_load(lambda: ff.fwd(*xs))}; "
              f"idle: {query_card('clocks.sm')}")
        # one launch computes two TPU kernels' outputs: each row carries the
        # joint times beside the bound of its own function
        note = "one fb_fwd launch computes both rows; ms and plain_ms are the joint launch's"
        row("fwd (FB sums)", "61", "fwd", "fwd_fb", timed["fwd"], bound(*least["fwd_fb"]), note)
        row("fwd (orthonormality sums)", "91", "fwd", "fwd_orth", timed["fwd"],
            bound(*least["fwd_orth"]), note)
        note = "one fb_bwd launch computes both rows; the numbers are the pair's"
        row("bwd (dF1, dF2)", "184", "bwd", "bwd", timed["bwd"], bound(*least["bwd"]), note)
        row("bwd (dB)", "219", "bwd", "bwd", timed["bwd"], bound(*least["bwd"]), note)
    return rows


def profile_slice(ws: tp.Any) -> None:
    """Device time by kernel over PROFILE_STEPS updates of the slice's agent
    on its replay, run as graph replays under ``torch.profiler``."""
    trainer = make_offline_trainer(ws.agent, ws.buffer.cfg, ws.agent.cfg.batch_size,
                                   PROFILE_STEPS)
    float(trainer(ws.buffer.state, ws.generator)["fb_loss"])  # captures, warms up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(trainer(ws.buffer.state, ws.generator)["fb_loss"])
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    graph_launches = sum(e.name == "cudaGraphLaunch" for e in prof.events())
    if not kernels:
        raise AssertionError("the profiler saw no device kernels")
    if graph_launches != PROFILE_STEPS:
        raise AssertionError(f"expected {PROFILE_STEPS} graph launches in the call, "
                             f"the profiler saw {graph_launches}")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"phase 6 profile: {PROFILE_STEPS} updates in {graph_launches} graph launches "
          f"(one call), {len(kernels) / PROFILE_STEPS:.1f} kernel launches and "
          f"{1e-3 * busy_us / PROFILE_STEPS:.4f} ms of device time per update, "
          f"{1e3 * wall / PROFILE_STEPS:.3f} ms of wall time per update under the "
          f"profiler (busy share {1e-6 * busy_us / wall:.4f})")
    for name, parts in KERNEL_NAMES.items():
        per = [sum(e.time_range.elapsed_us() for e in kernels if part in e.name)
               / PROFILE_STEPS for part in parts]
        count = [sum(part in e.name for e in kernels) for part in parts]
        if not all(per) or any(c != PROFILE_STEPS for c in count):
            raise AssertionError(f"expected {PROFILE_STEPS} launches of each of {parts} "
                                 f"inside the replays, the profiler saw {count}")
        print(f"phase 6 profile {name}: {1e-3 * sum(per):.5f} ms of device time per "
              "update, once per update inside the replays ("
              + ", ".join(f"{p} {1e-3 * t:.5f}" for p, t in zip(parts, per)) + ")")


def check_capture(ws: tp.Any) -> None:
    """Captured against eager at full width in bf16 with the fused loss, and
    that replays draw fresh batches and noise."""
    cfg = ws.agent.cfg
    captured = FBDDPGAgent(cfg, OBS_DIM, ACTION_DIM, device="cuda", seed=SEED + 1)
    eager = FBDDPGAgent(cfg, OBS_DIM, ACTION_DIM, device="cuda", seed=SEED + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batch = ws.buffer.sample(gen, N)
    noise = UpdateNoise.draw(cfg, N, ACTION_DIM, gen, torch.device("cuda"))
    program = CapturedProgram(lambda: captured._update(batch, noise), captured.device,
                              captured.train_state().values())
    program.replay(CAPTURED_UPDATES)
    for _ in range(CAPTURED_UPDATES):
        eager._update(batch, noise)
    torch.cuda.synchronize()
    got, want = captured.train_state(), eager.train_state()
    # the same kernels in the same order: expected equal to the bit. Allowed,
    # should cuBLAS choose another algorithm under capture: 2*lr per update
    # for parameters and targets (Adam moves an entry by about lr), 1e-3 of
    # the largest entry for a moment.
    worst = {"parameters and targets": 0.0, "Adam moments": 0.0}
    bitwise = True
    for name, a in got.items():
        b = want[name]
        bitwise = bitwise and torch.equal(a, b)
        diff = float((a.float() - b.float()).abs().max())
        if "_opt." in name and not name.endswith("count"):
            worst["Adam moments"] = max(worst["Adam moments"],
                                        diff / max(float(b.float().abs().max()), 1e-30))
        else:
            worst["parameters and targets"] = max(worst["parameters and targets"], diff)
    tol = 2 * cfg.lr * CAPTURED_UPDATES
    print(f"phase 7 captured vs eager: {CAPTURED_UPDATES} updates (n={N}, bf16, fused loss): "
          f"max abs diff of parameters, targets and counters "
          f"{worst['parameters and targets']:.3e} (tolerance {tol:.1e}), of Adam moments "
          f"{worst['Adam moments']:.3e} of their largest entry (tolerance 1e-3); "
          f"equal to the bit: {bitwise}; steps {captured.step} and {eager.step}")
    if worst["parameters and targets"] > tol or worst["Adam moments"] > 1e-3 \
            or captured.step != CAPTURED_UPDATES:
        raise AssertionError("captured and eager updates disagree")

    def draw() -> tp.Tuple[torch.Tensor, torch.Tensor]:
        sampled = replay_lib.sample(ws.buffer.state, gen, N, ws.buffer.cfg)
        return sampled.obs, UpdateNoise.draw(cfg, N, ACTION_DIM, gen,
                                             torch.device("cuda")).z_normal

    drawing = CapturedProgram(draw, captured.device, generators=[gen])
    seen = []
    for _ in range(2):
        drawing.replay()
        torch.cuda.synchronize()
        seen.append([x.clone() for x in drawing.out])
    fresh = [not torch.equal(a, b) for a, b in zip(*seen)]
    print(f"phase 7 two replays of sample + noise: batches differ {fresh[0]}, "
          f"noise differs {fresh[1]} (generator registered with the graph)")
    if not all(fresh):
        raise AssertionError("a replay repeated its batch or its noise")


def check_relabel() -> None:
    """Relabel a walker-shaped buffer of RELABEL_EPISODES x EPISODE_LENGTH
    steps for walker_walk on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    shape = (RELABEL_EPISODES, EPISODE_LENGTH + 1)
    physics = walker_physics(shape, gen, "cuda")
    env = locomotion.make("walker_walk")
    buf = ReplayBuffer(RELABEL_EPISODES, discount=0.98, future=0.99, device="cuda")
    buf.state = replay_lib.ReplayState(
        storage={"observation": env.obs_from_physics(physics),
                 "action": torch.rand(shape + (ACTION_DIM,), generator=gen, device="cuda") * 2 - 1,
                 "reward": torch.zeros(shape + (1,), device="cuda"),
                 "discount": torch.ones(shape + (1,), device="cuda"),
                 "physics": physics},
        ep_lengths=torch.full((RELABEL_EPISODES,), EPISODE_LENGTH, dtype=torch.int64,
                              device="cuda"),
        n_episodes=RELABEL_EPISODES, idx=0, max_episodes=RELABEL_EPISODES,
        max_episode_length=EPISODE_LENGTH)
    reward = get_reward_function("walker_walk")
    rows = shape[0] * shape[1]
    reward.from_physics(physics[:2])  # warm-up: loads the elementwise kernels
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    buf.relabel(reward.from_physics)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pick = torch.randint(rows, (RELABEL_ROWS_CHECKED,), generator=gen, device="cuda")
    got = buf.state.storage["reward"].reshape(rows)[pick].cpu()
    want = reward.from_physics(physics.reshape(rows, -1)[pick].cpu())
    err = float((got - want).abs().max())
    print(f"phase 8 relabel: {rows} walker rows ({PHYSICS_DIM} physics columns, "
          f"{physics.numel() * 4 / 1e6:.0f} MB) for walker_walk on the card in "
          f"{1e3 * wall:.2f} ms of wall time ({start.elapsed_time(end):.2f} ms between CUDA "
          f"events); peak device memory {peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} "
          f"MiB above the buffer's {held / 2**20:.1f}; rewards in [{float(got.min()):.4f}, "
          f"{float(got.max()):.4f}], mean {float(got.mean()):.4f}; max abs err of "
          f"{RELABEL_ROWS_CHECKED} rows against the CPU {err:.3e} (tolerance 1e-5), on "
          f"{card_name_and_power_limit()}")
    if not err <= 1e-5 or not float(got.max()) > float(got.min()):
        raise AssertionError("rewards relabeled on the card disagree with the CPU's")


def check_task_z_and_checkpoint(ws: tp.Any, tmp: str) -> None:
    """z for a named task from the stored physics, and the checkpoint that
    phase 4 left, resumed by a fresh workspace on the same folder."""
    reward = get_reward_function("walker_run", SEED)
    z = ws._infer_meta_from_replay(reward, draws=Z_DRAWS)
    norm, want_norm = float(z.norm()), math.sqrt(ws.agent.cfg.z_dim)
    print(f"phase 9 z for walker_run ({Z_DRAWS} draws of "
          f"{ws.agent.cfg.num_inference_steps} relabeled samples): norm {norm:.4f} "
          f"(sqrt(z_dim) = {want_norm:.4f}), first entries "
          + " ".join(f"{v:.4f}" for v in z[:6].tolist()))
    if z.shape != (ws.agent.cfg.z_dim,) or not bool(torch.isfinite(z).all()) \
            or abs(norm - want_norm) > 1e-3:
        raise AssertionError(f"bad z for walker_run: {z}")

    # phase 4 ended with a checkpoint; the eager loop beside it and phase 6
    # have trained on since, so save again and resume that
    ws.global_step = ws.agent.step
    ws.save_checkpoint()
    args = [a for a in slice_args(f"{tmp}/run", f"{tmp}/episodes")
            if not a.startswith(("replay_dir=", "relabel="))]
    fresh = build_workspace(args, OfflineWorkspace)
    same = all(torch.equal(v, fresh.agent.train_state()[k])
               for k, v in ws.agent.train_state().items())
    same_gen = torch.equal(ws.generator.get_state(), fresh.generator.get_state())
    same_replay = all(torch.equal(v, fresh.buffer.state.storage[k])
                      for k, v in ws.buffer.state.storage.items())
    batch = ws.buffer.sample(torch.Generator(device="cuda").manual_seed(SEED + 3), N)
    losses = [float(w.agent.update(batch, w.generator)["fb_loss"]) for w in (ws, fresh)]
    torch.cuda.synchronize()
    same_after = all(torch.equal(v, fresh.agent.train_state()[k])
                     for k, v in ws.agent.train_state().items())
    print(f"phase 9 checkpoint: saved at step {ws.global_step}, a fresh workspace on the "
          f"folder resumed at step {fresh.global_step}; state identical {same}, generator "
          f"identical {same_gen}, replay identical {same_replay}; next update fb_loss "
          f"{losses[0]:.6f} and {losses[1]:.6f}, state identical after it {same_after}")
    if not (same and same_gen and same_replay and same_after and losses[0] == losses[1]
            and fresh.global_step == ws.global_step == fresh.agent.step - 1):
        raise AssertionError("the resumed workspace differs from the saved one")


def check_dynamics() -> None:
    """The planar dynamics on the card against float64 on the CPU."""
    for domain in dynamics_check.DOMAINS:
        pressed, held = dynamics_check.check_domain(domain, DYNAMICS_STATES, "cuda", SEED)
        ok = all(h.ok for h in held)
        print(f"phase 10 dynamics {domain}: {DYNAMICS_STATES} states, {pressed:.2f} of them "
              f"with a contact pressed, card float32 against CPU float64 (tolerances "
              f"{dynamics_check.DYNAMICS_TOL} and {dynamics_check.STEP_TOL} of the largest "
              f"entry, by state; a state beyond it within {dynamics_check.OUTLIER_FACTOR:.0f}x): "
              + "; ".join(str(h) for h in held) + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"the {domain}'s dynamics on the card disagree with the CPU's")


def _timed(fn: tp.Callable[[], tp.Any]) -> tp.Tuple[tp.Any, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_rollout(rollout: Rollout, z: torch.Tensor, state: tp.Any, ts: tp.Any,
                    substeps: int, phase: str = "phase 11") -> None:
    """A ``torch.profiler`` trace of one captured rollout of COMPARED_STEPS
    steps: launches and device time per control step, the busy share, and
    the kernels that take most of the device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = _timed(lambda: rollout(z, state, ts))
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    graph_launches = sum(e.name == "cudaGraphLaunch" for e in prof.events())
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: tp.Dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    print(f"{phase} profile E={rollout.num_envs}: {COMPARED_STEPS} control steps in "
          f"{graph_launches} graph launches: {len(kernels) / COMPARED_STEPS:.1f} kernel launches "
          f"and {1e-3 * busy_us / COMPARED_STEPS:.4f} ms of device time per control step "
          f"({substeps} substeps), {1e3 * wall / COMPARED_STEPS:.3f} ms of wall time per step "
          f"under the profiler (busy share {1e-6 * busy_us / wall:.4f}); most device time: "
          + "; ".join(f"{name[:48]} {us / busy_us:.3f}" for name, us in top))
    if graph_launches != COMPARED_STEPS or not kernels:
        raise AssertionError(f"expected {COMPARED_STEPS} graph launches with device kernels, "
                             f"the profiler saw {graph_launches} and {len(kernels)} kernels")


def check_evaluation(ws: tp.Any) -> None:
    """``evaluate()`` and ``finalize()`` at full width, the captured rollout
    against the eager one, its trace, and its rate by number of environments."""
    card = card_name_and_power_limit()
    horizon = ws.spec.episode_length
    torch.cuda.reset_peak_memory_stats()
    first, first_s = _timed(ws.evaluate)
    starts = ws._rollouts[EVAL_EPISODES].physics[:, 0].clone()
    second, second_s = _timed(ws.evaluate)
    peak = torch.cuda.max_memory_allocated()
    fresh = not torch.equal(starts, ws._rollouts[EVAL_EPISODES].physics[:, 0])
    rows = read_csv(ws.work_dir / "eval.csv")
    print(f"phase 11 evaluate: {EVAL_EPISODES} episodes x {horizon} steps as replays of the "
          f"step that phase 4's first evaluation captured: {first_s:.3f} s and {second_s:.3f} s "
          f"({EVAL_EPISODES * horizon / second_s:.0f} environment steps/s, z inference, "
          f"diagnostics and the csv row included); episode_reward {first['episode_reward']:.2f} "
          f"and {second['episode_reward']:.2f}, z_norm {second['z_norm']:.4f}; the two "
          f"evaluations started from different states: {fresh}; {len(rows)} rows in "
          f"eval.csv; peak device memory {peak / 2**20:.1f} MiB, on {card}")
    if not (fresh and len(rows) == SLICE_STEPS // EVAL_EVERY + 2
            and all(math.isfinite(v) for m in (first, second) for v in m.values())
            and 0.0 <= second["episode_reward"] <= horizon):
        raise AssertionError(f"bad evaluation: {first}, {second}")

    rewards, final_s = _timed(ws.finalize)
    written = check_test_rewards(ws, rewards)
    print(f"phase 11 finalize: {len(WALKER_TASKS)} tasks x {FINAL_TESTS} episodes x {horizon} "
          f"steps in one batch of {len(WALKER_TASKS) * FINAL_TESTS}, as replays of the step "
          f"that phase 4's finalize() captured: {final_s:.3f} s; mean returns "
          + ", ".join(f"{t} {np.mean(written[t]):.2f}" for t in WALKER_TASKS) + f", on {card}")

    # captured against eager over COMPARED_STEPS steps from the same states
    env = locomotion.make(ws.cfg.task, COMPARED_STEPS)
    z = ws._init_eval_meta()[ws.agent.meta_key]
    state, ts = env.reset(ws.generator, EVAL_EPISODES)
    captured = Rollout(env, ws.agent, EVAL_EPISODES)
    eager = Rollout(env, ws.agent, EVAL_EPISODES, capture=False)
    got = [x.clone() for x in captured(z, state, ts)]
    eager(z, state, ts)  # warm-up
    want, eager_s = _timed(lambda: eager(z, state, ts))
    _, captured_s = _timed(lambda: captured(z, state, ts))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"phase 11 captured vs eager: {COMPARED_STEPS} steps x {EVAL_EPISODES} episodes from the "
          f"same states: equal to the bit: {bitwise} (max abs diff {err:.3e}; the same kernels "
          f"in the same order, so no tolerance is allowed); eager {1e3 * eager_s / COMPARED_STEPS:.3f} "
          f"ms per control step, captured {1e3 * captured_s / COMPARED_STEPS:.3f}, on {card}")
    if not bitwise:
        raise AssertionError("captured and eager rollouts disagree")

    del eager, got, want
    profile_rollout(captured, z, state, ts, env.n_substeps)
    wide = Rollout(env, ws.agent, ROLLOUT_SIZES[-1])
    state, ts = env.reset(ws.generator, ROLLOUT_SIZES[-1])
    wide(z, state, ts)  # captures
    profile_rollout(wide, z, state, ts, env.n_substeps)
    del captured, wide, state, ts

    rate_env = locomotion.make(ws.cfg.task, RATE_STEPS)
    for envs in ROLLOUT_SIZES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        rollout = Rollout(rate_env, ws.agent, envs)
        state, ts = rate_env.reset(ws.generator, envs)
        _, capture_s = _timed(lambda: rollout(z, state, ts))
        (totals, physics, _), run_s = _timed(lambda: rollout(z, state, ts))
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(totals).all() & torch.isfinite(physics).all())
        print(f"phase 11 rollout E={envs}: {RATE_STEPS} steps in {run_s:.3f} s "
              f"({1e3 * run_s / RATE_STEPS:.3f} ms per control step, {envs * RATE_STEPS / run_s:.0f} "
              f"environment steps/s; {capture_s:.3f} s with the capture); peak device memory "
              f"{peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} MiB above what was held "
              f"before, the [E, T, .] buffers included; mean return {float(totals.mean()):.2f}; "
              f"finite: {finite}, on {card}")
        if not finite:
            raise AssertionError(f"non-finite rollout at E={envs}")
        del rollout, state, ts, totals, physics


def replay_bytes(ws: tp.Any) -> int:
    return sum(v.numel() * v.element_size() for v in ws.buffer.state.storage.values())


def online_args(folder: str, frames: int, *extra: str) -> tp.List[str]:
    """Phase 12's command line: FB at full width, bf16, the fused loss."""
    return ["task=walker_walk", "agent=fb_ddpg", "agent.use_pallas_loss=true",
            "agent.compute_dtype=bfloat16", f"num_envs={ONLINE_ENVS}",
            f"episode_length={SHORT_LENGTH}", f"num_seed_frames={SHORT_CYCLE}",
            f"num_train_frames={frames}", f"eval_every_steps={ONLINE_EVAL_EVERY}", f"num_eval_episodes={EVAL_EPISODES}",
            f"final_tests={FINAL_TESTS}", f"folder={folder}", f"seed={SEED}", *extra]


def report_cycles(ws: tp.Any, phase: str) -> tp.List[tp.Dict[str, float]]:
    """One line per cycle of an ``OnlineWorkspace`` run: the collection's
    seconds and environment steps/s, the updates/s, the collection's share
    of the cycle, the buffer's size (from ``train.csv``)."""
    rows = read_csv(ws.work_dir / "train.csv")[-len(ws.cycle_timings):]
    envs, horizon = ws.cfg.num_envs, ws.spec.episode_length
    out = []
    for i, (timing, row) in enumerate(zip(ws.cycle_timings, rows)):
        collect, update, updates = timing["collect"], timing["update"], int(timing["updates"])
        share = collect / (collect + update)
        out.append({"collect_s": collect, "steps_per_s": envs * horizon / collect,
                    "updates_per_s": updates / update if updates else float("nan"),
                    "share": share})
        print(f"{phase} cycle {i + 1}: step {int(float(row['step']))}; collection of "
              f"{envs} x {horizon} steps {collect:.3f} s "
              f"({envs * horizon / collect:.0f} environment steps/s, the reset included"
              f"{', and the capture of the control step' if i == 0 else ''}); {updates} updates "
              f"in {update:.3f} s ({out[-1]['updates_per_s']:.1f} updates/s, the commit "
              f"included{', and the capture of the update' if updates and i == 1 else ''}); "
              f"collection {share:.4f} of the cycle; buffer {int(float(row['buffer_size']))} episodes; "
              f"episode_reward {float(row['episode_reward']):.2f}")
    return out


def run_online(tmp: str) -> tp.Tuple[tp.Dict[str, int], tp.Any]:
    """Phase 12: online FB pretraining through ``pretrain.main``, then a
    resumed run on its folder."""
    card = card_name_and_power_limit()
    folder = f"{tmp}/online"
    frames = ONLINE_CYCLES * SHORT_CYCLE
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ff.reset_launches()
    ws, wall = _timed(lambda: pretrain.main(online_args(folder, frames)))
    counts, ran = dict(ff.launches), ff.device_runs()
    peak = torch.cuda.max_memory_allocated()
    cycles = report_cycles(ws, "phase 12")
    updates = sum(int(t["updates"]) for t in ws.cycle_timings)
    captures = ws.online_trainer.trainer.captures
    expected = updates + WARMUP_RUNS
    print(f"phase 12 pretrain: {ONLINE_CYCLES} cycles, {ws.global_step} environment steps, "
          f"{updates} updates in {wall:.1f} s (the evaluations with their videos, finalize() "
          f"and the checkpoint included); the update program captured {captures} time(s) "
          f"across {len(ws.buffer)} committed episodes; launches {counts} = {updates} replayed "
          f"updates + {WARMUP_RUNS} eager warm-up runs; runs counted on the device by the "
          f"kernels themselves {ran}; peak device memory {peak / 2**20:.1f} MiB, "
          f"{(peak - held) / 2**20:.1f} MiB above the {held / 2**20:.1f} held before (the replay "
          f"of {ws.cfg.replay_buffer_episodes} episodes, {replay_bytes(ws) / 2**20:.1f} MiB, "
          f"allocated at the first commit), on {card}")
    if captures != 1 or ws.agent.step != updates \
            or updates != (ONLINE_CYCLES - 1) * SHORT_CYCLE // 2 \
            or any(c != expected for c in counts.values()) or ran != counts \
            or ws.global_step != frames or len(ws.buffer) != ONLINE_CYCLES * ONLINE_ENVS:
        raise AssertionError(f"online run: captures {captures}, agent step {ws.agent.step}, "
                             f"updates {updates}, launches {counts}, device runs {ran}, "
                             f"step {ws.global_step}, buffer {len(ws.buffer)}")
    row = ws.last_row
    if not all(math.isfinite(v) for v in row.values()):
        raise AssertionError(f"non-finite train metrics: {row}")
    steady = cycles[2:]
    print(f"phase 12 collection (the captured control step at E={ONLINE_ENVS}) after the first "
          f"cycle: " + ", ".join(f"{c['steps_per_s']:.0f}" for c in steady) + " environment "
          f"steps/s; updates/s " + ", ".join(f"{c['updates_per_s']:.1f}" for c in steady)
          + "; collection's share of a training cycle "
          + ", ".join(f"{c['share']:.4f}" for c in steady) + f", on {card}")
    evals = read_csv(ws.work_dir / "eval.csv")
    returns = [float(r["episode_reward"]) for r in evals]
    steps = [int(float(r["step"])) for r in evals]
    videos = [(ws.work_dir / "eval_video" / f"{s}.png").stat().st_size for s in steps]
    physics = ws._rollouts[EVAL_EPISODES].physics[0]
    _, video_s = _timed(lambda: ws._record_eval_video(physics))
    print(f"phase 12 evaluations at steps {steps}: episode_reward "
          + ", ".join(f"{r:.2f}" for r in returns) + f"; videos of {videos} bytes, "
          f"{video_s:.3f} s of host time to draw and write one ({physics.shape[0]} steps, "
          f"every {max(1, physics.shape[0] // 250)}th drawn)")
    if steps != list(range(ONLINE_EVAL_EVERY, frames + 1, ONLINE_EVAL_EVERY)) \
            or not all(math.isfinite(r) and 0.0 <= r <= EPISODE_LENGTH for r in returns) \
            or not all(videos):
        raise AssertionError(f"bad eval rows from the online run: {evals}")
    written = check_test_rewards(ws)
    print("phase 12 test_rewards.json from the run's finalize(): mean returns "
          + ", ".join(f"{t} {np.mean(written[t]):.2f}" for t in WALKER_TASKS))

    ff.reset_launches()
    resumed, wall = _timed(lambda: pretrain.main(online_args(folder, frames + SHORT_CYCLE,
                                                             "final_tests=0")))
    rows = read_csv(resumed.work_dir / "train.csv")
    more = SHORT_CYCLE // 2
    report_cycles(resumed, "phase 12 resumed")
    print(f"phase 12 resumed: a fresh run on the folder continued from step {frames} to "
          f"{resumed.global_step} (train rows at steps {[int(float(r['step'])) for r in rows]}), "
          f"agent step {updates} -> {resumed.agent.step}, buffer {len(ws.buffer)} -> "
          f"{len(resumed.buffer)} episodes, launches {dict(ff.launches)} in {wall:.1f} s")
    if resumed.global_step != frames + SHORT_CYCLE or resumed.agent.step != updates + more \
            or len(resumed.buffer) != len(ws.buffer) + ONLINE_ENVS \
            or int(float(rows[-1]["step"])) != frames + SHORT_CYCLE \
            or any(c != more + WARMUP_RUNS for c in ff.launches.values()):
        raise AssertionError("the resumed online run did not continue the saved one")
    return counts, resumed


def check_online_paths(tmp: str, fb_agent: tp.Any) -> None:
    """Phase 13: ``train_online.main`` with directed episodes, the RND
    explorer through ``pretrain.main``, captured programs against eager ones
    at full width, and the cheetah's reset."""
    card = card_name_and_power_limit()
    frames = DIRECTED_CYCLES * CYCLE_STEPS
    ff.reset_launches()
    directed, wall = _timed(lambda: train_online.main([
        "task=walker_walk", "agent=fb_ddpg", "agent.use_pallas_loss=true",
        "agent.compute_dtype=bfloat16", "rollout_task_z_ratio=0.5",
        f"num_rollout_episodes={ONLINE_ENVS}", f"num_agent_updates={DIRECTED_UPDATES}",
        f"num_seed_frames={CYCLE_STEPS}", f"num_train_frames={frames}", "eval_every_steps=0",
        "final_tests=0", f"folder={tmp}/directed", f"seed={SEED}"]))
    rows = read_csv(directed.work_dir / "train.csv")
    # the first cycle directs no episode (the seed frames are not in yet)
    task = [float(r.get("task_episode_reward") or "nan") for r in rows[1:]]
    print(f"phase 13 train_online: {DIRECTED_CYCLES} cycles of {ONLINE_ENVS} episodes, half of "
          f"them holding the walker_walk z inferred from the replay once the seed frames are "
          f"in, {DIRECTED_UPDATES} updates each, in {wall:.1f} s; episode_reward "
          + ", ".join(f"{float(r['episode_reward']):.2f}" for r in rows)
          + "; task_episode_reward from the second cycle on " + ", ".join(f"{t:.2f}" for t in task)
          + f"; launches {dict(ff.launches)}, on {card}")
    if directed.global_step != frames or len(directed.buffer) != DIRECTED_CYCLES * ONLINE_ENVS \
            or not all(math.isfinite(t) for t in task) \
            or any(c != DIRECTED_CYCLES * DIRECTED_UPDATES + WARMUP_RUNS
                   for c in ff.launches.values()):
        raise AssertionError(f"bad directed run: {rows}")
    del directed

    rnd, wall = _timed(lambda: pretrain.main([
        "agent=rnd", "task=walker_walk", f"num_envs={RND_ENVS}",
        f"num_seed_frames={RND_CYCLE_STEPS}", f"num_train_frames={RND_CYCLES * RND_CYCLE_STEPS}",
        f"eval_every_steps={RND_CYCLES * RND_CYCLE_STEPS}", f"num_eval_episodes={EVAL_EPISODES}",
        "final_tests=0", "save_eval_video=false", f"folder={tmp}/rnd", f"seed={SEED}"]))
    report_cycles(rnd, "phase 13 rnd")
    row, evals = rnd.last_row, read_csv(rnd.work_dir / "eval.csv")
    print(f"phase 13 rnd: pretrain.main agent=rnd (hidden {rnd.agent.cfg.hidden_dim}, batch "
          f"{rnd.agent.cfg.batch_size}, nstep {rnd.buffer.cfg.nstep}) {RND_CYCLES} cycles in "
          f"{wall:.1f} s, agent step {rnd.agent.step}, update captured "
          f"{rnd.online_trainer.trainer.captures} time(s); intr_reward {row['intr_reward']:.4f}, "
          f"rnd_loss {row['rnd_loss']:.4f}, critic_loss {row['critic_loss']:.4f}; evaluation "
          f"episode_reward {float(evals[-1]['episode_reward']):.2f}")
    if rnd.agent.step != (RND_CYCLES - 1) * RND_CYCLE_STEPS // 2 \
            or rnd.online_trainer.trainer.captures != 1 or rnd.buffer.cfg.nstep != 3 \
            or not all(math.isfinite(v) for v in row.values()) or len(evals) != 1:
        raise AssertionError(f"bad RND run: {row}, {evals}")

    # a full-width RND update (n-step batch, running statistics) captured and eager
    agents = [RNDAgent(rnd.agent.cfg, OBS_DIM, ACTION_DIM, device="cuda", seed=SEED)
              for _ in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    batch = rnd.buffer.sample(gen, rnd.agent.cfg.batch_size)
    noise = DDPGNoise.draw(rnd.agent.cfg.batch_size, ACTION_DIM, gen, torch.device("cuda"))
    program = CapturedProgram(lambda: agents[0]._update(batch, noise), agents[0].device,
                              agents[0].train_state().values())
    program.replay(CAPTURED_UPDATES)
    for _ in range(CAPTURED_UPDATES):
        agents[1]._update(batch, noise)
    torch.cuda.synchronize()
    unequal = [k for k, v in agents[1].train_state().items()
               if not torch.equal(agents[0].train_state()[k], v)]
    print(f"phase 13 rnd captured vs eager: {CAPTURED_UPDATES} full-width updates from one state, "
          f"batch and noise; tensors of the train state that differ: {unequal or 'none'}")
    if unequal or agents[0].step != CAPTURED_UPDATES:
        raise AssertionError("captured and eager RND updates disagree")
    del rnd, agents, program

    # the collector at full width: captured against eager over COLLECTOR_STEPS steps,
    # across the exploration schedule's end and an in-episode z resample
    env = locomotion.make("walker_walk", COLLECTOR_STEPS)
    gens = [torch.Generator(device="cuda").manual_seed(SEED + 5) for _ in range(2)]
    collectors = [EpisodeCollector(env, fb_agent, ONLINE_ENVS, gens[0]),
                  EpisodeCollector(env, fb_agent, ONLINE_ENVS, gens[1], capture=False)]
    runs = []
    for collector, gen in zip(collectors, gens):
        meta = init_meta_batched(fb_agent, gen, ONLINE_ENVS)
        state, ts = env.reset(gen, ONLINE_ENVS)
        runs.append({k: v.clone() for k, v in collector(meta, state, ts, 0).items()})
    unequal = [k for k, v in runs[1].items() if not torch.equal(runs[0][k], v)]
    print(f"phase 13 collector captured vs eager: {ONLINE_ENVS} walker episodes x "
          f"{COLLECTOR_STEPS} steps, full-width bf16 policy with its noise; columns that "
          f"differ: {unequal or 'none'}; generators in the same state after: "
          f"{torch.equal(gens[0].get_state(), gens[1].get_state())}")
    if unequal or not torch.equal(gens[0].get_state(), gens[1].get_state()):
        raise AssertionError("captured and eager collectors disagree")

    # the cheetah's reset: 200 settling steps replayed from one captured step
    cheetah = locomotion.make("cheetah_run")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    _, capture_s = _timed(lambda: cheetah.reset(gen, CHEETAH_RESETS))
    (state, _), reset_s = _timed(lambda: cheetah.reset(gen, CHEETAH_RESETS))
    c = cheetah.model.tensors(state.q.device, state.q.dtype)
    u = torch.rand((CHEETAH_RESETS, cheetah.spec.action_dim), generator=gen, device="cuda")
    q = torch.cat([torch.tensor([0.0, cheetah.init_z, 0.0], device="cuda").expand(
        CHEETAH_RESETS, 3), c.limit_lo + u * (c.limit_hi - c.limit_lo)], -1)
    qd = torch.zeros_like(q)
    eager, eager_s = _timed(lambda: cheetah.settle(q, qd, capture=False))
    captured, settle_s = _timed(lambda: cheetah.settle(q, qd))
    bitwise = all(torch.equal(a, b) for a, b in zip(captured, eager))
    print(f"phase 13 cheetah reset of {CHEETAH_RESETS} environments: {reset_s:.3f} s with its "
          f"200 settling steps replayed ({capture_s:.3f} s with the capture); the settling steps "
          f"alone {settle_s:.3f} s replayed, {eager_s:.3f} s launched from the host; equal to "
          f"the bit: {bitwise}, on {card}")
    if not bitwise:
        raise AssertionError("captured and eager settling steps disagree")


def _sf_configs() -> tp.List[tp.Tuple[str, type, tp.Any]]:
    """Phase 14's agents: SF with each learner at the JAX defaults, the
    variants, and SF-SVD."""
    configs = [(f"sf {name}", SFAgent, SFConfig(feature_learner=name))
               for name in sorted(FEATURE_LEARNERS)]
    configs += [(f"sf {name} {key}={value}", SFAgent,
                 SFConfig(feature_learner=name, **{key: value}))
                for name, key, value in SF_VARIANTS]
    return configs + [("sf_svd", SFSVDAgent, SFSVDConfig())]


def check_captured_agent(phase: str, label: str, make_agent: tp.Callable[[], tp.Any],
                         cfg: tp.Any, buf: tp.Any, fb_rate: float, card: str,
                         updates: int = SF_UPDATES, first: int = SF_FIRST,
                         bitwise_only: bool = False) -> tp.Dict[str, tp.Any]:
    """One agent of phases 14, 18, 24 and 25: ``updates`` updates through the
    captured trainer and the same updates eagerly on a twin (``make_agent``
    builds both) from the same generator state, timed after the first
    ``first``; then the profiler over SF_PROFILED more replays.
    ``bitwise_only``: the two must agree to the bit, no tolerance."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    results = []
    for capture in (True, False):
        agent = make_agent()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        trainer = make_offline_trainer(agent, buf.cfg, cfg.batch_size, updates,
                                       capture=capture)
        trainer(buf.state, gen, steps=first)  # captures, or warms the eager loop up
        torch.cuda.synchronize()
        metrics, seconds = _timed(lambda: trainer(buf.state, gen, steps=updates - first))
        if capture:
            peak = torch.cuda.max_memory_allocated() - held
        results.append((agent, gen, trainer, {k: v.clone() for k, v in metrics.items()},
                        (updates - first) / seconds))
    (agent, gen, trainer, metrics, rate), (twin, twin_gen, _, twin_metrics, eager_rate) = results
    got, want = agent.train_state(), twin.train_state()
    bitwise = all(torch.equal(got[k], v) for k, v in want.items()) \
        and all(torch.equal(metrics[k], v) for k, v in twin_metrics.items()) \
        and torch.equal(gen.get_state(), twin_gen.get_state())
    worst = {"parameters and targets": 0.0, "Adam moments": 0.0}
    for name, b in want.items():
        diff = float((got[name].float() - b.float()).abs().max())
        if "_opt." in name and not name.endswith("count"):
            worst["Adam moments"] = max(worst["Adam moments"],
                                        diff / max(float(b.float().abs().max()), 1e-30))
        else:
            worst["parameters and targets"] = max(worst["parameters and targets"], diff)
    tol = 2 * cfg.lr * updates
    program = trainer._program
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer(buf.state, gen, steps=SF_PROFILED)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = len(kernels) / SF_PROFILED
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in kernels) / SF_PROFILED
    # the matrix products by their cuBLAS/CUTLASS names, against the rest
    products = [e for e in kernels if "gemm" in e.name.lower() or "cutlass" in e.name.lower()]
    products_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in products) / SF_PROFILED
    row = {k: float(v) for k, v in metrics.items()}  # means over the timed call
    how = (f"{len(program.graphs)} captured graphs with the pseudo-inverse (torch.linalg.pinv, "
           f"an SVD checked on the host) run eagerly between them" if len(program.graphs) > 1
           else "one captured graph")
    losses = ", ".join(f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_loss"))
    print(f"{phase} {label}: captured {rate:.1f} updates/s, eager {eager_rate:.1f} "
          f"({rate / eager_rate:.2f}x), FB's captured trainer in phase 4 {fb_rate:.1f}; update as "
          f"{how}; {launches:.1f} kernel launches and {busy_ms:.4f} ms of device time per update, "
          f"{len(products) / SF_PROFILED:.1f} of them matrix products taking {products_ms:.4f} ms "
          f"(profiler, {SF_PROFILED} updates); peak device memory {peak / 2**20:.1f} MiB above "
          f"the {held / 2**20:.1f} held; captured vs eager after {updates} updates: equal to "
          f"the bit {bitwise}, max abs diff of parameters and targets "
          f"{worst['parameters and targets']:.3e} (tolerance {tol:.1e}), of Adam moments "
          f"{worst['Adam moments']:.3e} of their largest entry (tolerance 1e-3); {losses}; "
          f"on {card}")
    if not all(math.isfinite(v) for v in row.values()) or agent.step != updates + SF_PROFILED \
            or twin.step != updates or (not bitwise and (
                bitwise_only or worst["parameters and targets"] > tol
                or worst["Adam moments"] > 1e-3)):
        raise AssertionError(f"{label}: captured and eager updates disagree or are not finite")
    return {"label": label, "captured": rate, "eager": eager_rate, "launches": launches,
            "products_ms": products_ms, "busy_ms": busy_ms,
            "graphs": len(program.graphs), "peak_mib": peak / 2**20, "bitwise": bitwise}


def check_sf_learners(episodes: tp.List[tp.Dict[str, np.ndarray]],
                      fb_rate: float) -> tp.List[tp.Dict[str, tp.Any]]:
    """Phase 14: every SF learner, three variants and SF-SVD at the JAX
    defaults (hidden 1024, feature 512, backward hidden 512, z 100, batch
    1024, float32) on walker-shaped episodes."""
    card = card_name_and_power_limit()
    buf = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cuda")
    buf.load_episodes(episodes)
    out = []
    for label, agent_cls, cfg in _sf_configs():
        out.append(check_captured_agent(
            "phase 14", label, lambda: agent_cls(cfg, OBS_DIM, ACTION_DIM, device="cuda",
                                                 seed=SEED), cfg, buf, fb_rate, card))
        gc.collect()
        torch.cuda.empty_cache()
    rates = [r["captured"] for r in out]
    print(f"phase 14 summary: {len(out)} agents at full width in float32, captured "
          f"{min(rates):.1f}-{max(rates):.1f} updates/s (FB in bf16 with the fused loss: "
          f"{fb_rate:.1f}); equal to the bit: "
          + ", ".join(f"{r['label']} {r['bitwise']}" for r in out) + f"; on {card}")
    return out


def sf_offline_args(folder: str, episodes_dir: str, steps: int, *agent: str) -> tp.List[str]:
    """Phase 15's offline command line: phase 4's, for an SF agent."""
    return [f"replay_dir={episodes_dir}", "task=walker_walk", "relabel=true", *agent,
            f"num_grad_steps={steps}", f"steps_per_call={STEPS_PER_CALL}",
            f"log_every_steps={STEPS_PER_CALL}", f"eval_every_steps={EVAL_EVERY}",
            f"num_eval_episodes={EVAL_EPISODES}", "checkpoint_every=0",
            f"final_tests={FINAL_TESTS}", "save_eval_video=false",
            f"replay_buffer_episodes={EPISODES}", f"folder={folder}", f"seed={SEED}"]


def run_sf_entry_points(tmp: str) -> tp.Dict[str, tp.Any]:
    """Phase 15: ``train_offline.main`` for SF (lap) and SF-SVD at full
    width, each resumed, and ``pretrain.main agent=sf``, resumed."""
    card = card_name_and_power_limit()
    out = {}
    for name, agent in (("sf", ("agent=sf", "agent.feature_learner=lap")),
                        ("sf_svd", ("agent=sf_svd",))):
        folder = f"{tmp}/{name}"
        torch.cuda.reset_peak_memory_stats()
        ws, wall = _timed(lambda: train_offline.main(sf_offline_args(
            folder, f"{tmp}/episodes", SF_OFFLINE_STEPS, *agent)))
        peak = torch.cuda.max_memory_allocated()
        row, z = ws.last_row, ws.inferred_z
        evals = read_csv(ws.work_dir / "eval.csv")
        returns = [float(r["episode_reward"]) for r in evals]
        written = check_test_rewards(ws)
        print(f"phase 15 train_offline {' '.join(agent)}: {ws.global_step} updates in {wall:.1f} s "
              f"(load, relabel, capture, the evaluations, finalize() and the checkpoint included), "
              f"{row['fps']:.1f} updates/s over the last {STEPS_PER_CALL} (captured); sf_loss "
              f"{row['sf_loss']:.4f}, phi_loss {row['phi_loss']:.4f}, actor_loss "
              f"{row['actor_loss']:.4f}; evaluations at steps "
              f"{[int(float(r['step'])) for r in evals]} episode_reward "
              + ", ".join(f"{r:.2f}" for r in returns) + "; test_rewards.json mean returns "
              + ", ".join(f"{t} {np.mean(written[t]):.2f}" for t in WALKER_TASKS)
              + f"; inferred z norm {float(z.norm()):.4f}; peak device memory "
              f"{peak / 2**20:.1f} MiB; on {card}")
        if ws.global_step != SF_OFFLINE_STEPS or ws.agent.step != SF_OFFLINE_STEPS \
                or not all(math.isfinite(v) for v in row.values()) \
                or [int(float(r["step"])) for r in evals] != list(
                    range(EVAL_EVERY, SF_OFFLINE_STEPS + 1, EVAL_EVERY)) \
                or not all(math.isfinite(r) and 0.0 <= r <= ws.spec.episode_length
                           for r in returns) \
                or abs(float(z.norm()) - math.sqrt(ws.agent.cfg.z_dim)) > 1e-3:
            raise AssertionError(f"bad {name} offline run: {row}, {evals}, {z}")
        more = SF_OFFLINE_STEPS + SF_RESUMED_STEPS
        resumed, wall = _timed(lambda: train_offline.main(
            [a for a in sf_offline_args(folder, f"{tmp}/episodes", more, *agent)
             if not a.startswith(("final_tests=", "eval_every_steps="))]
            + ["final_tests=0", "eval_every_steps=0"]))
        print(f"phase 15 train_offline {' '.join(agent)} resumed: a fresh run on the folder "
              f"continued from step {SF_OFFLINE_STEPS} to {resumed.global_step} (agent step "
              f"{resumed.agent.step}) in {wall:.1f} s")
        if resumed.global_step != more or resumed.agent.step != more:
            raise AssertionError(f"the resumed {name} run did not continue the saved one")
        out[name] = resumed
        del ws
        gc.collect()
        torch.cuda.empty_cache()

    folder = f"{tmp}/sf_online"
    args = ["task=walker_walk", "agent=sf", "agent.feature_learner=lap",
            f"num_envs={SF_ONLINE_ENVS}", f"num_seed_frames={SF_CYCLE_STEPS}",
            f"eval_every_steps={2 * SF_CYCLE_STEPS}", f"num_eval_episodes={EVAL_EPISODES}",
            "save_eval_video=false", f"folder={folder}", f"seed={SEED}"]
    ws, wall = _timed(lambda: pretrain.main(args + [f"num_train_frames={2 * SF_CYCLE_STEPS}",
                                                    f"final_tests={FINAL_TESTS}"]))
    report_cycles(ws, "phase 15 sf pretrain")
    written = check_test_rewards(ws)
    evals = read_csv(ws.work_dir / "eval.csv")
    print(f"phase 15 pretrain agent=sf: a seed cycle and a training cycle in {wall:.1f} s, agent "
          f"step {ws.agent.step}, update captured {ws.online_trainer.trainer.captures} time(s); "
          f"evaluation episode_reward {float(evals[-1]['episode_reward']):.2f}; "
          f"test_rewards.json mean returns "
          + ", ".join(f"{t} {np.mean(written[t]):.2f}" for t in WALKER_TASKS) + f"; on {card}")
    if ws.agent.step != SF_CYCLE_STEPS // 2 or ws.online_trainer.trainer.captures != 1 \
            or len(evals) != 1 or not all(math.isfinite(v) for v in ws.last_row.values()):
        raise AssertionError(f"bad sf pretrain run: {ws.last_row}, {evals}")
    del ws
    resumed, wall = _timed(lambda: pretrain.main(args + [f"num_train_frames={3 * SF_CYCLE_STEPS}",
                                                         "final_tests=0"]))
    report_cycles(resumed, "phase 15 sf pretrain resumed")
    print(f"phase 15 pretrain agent=sf resumed: step {2 * SF_CYCLE_STEPS} -> "
          f"{resumed.global_step}, agent step {resumed.agent.step}, buffer "
          f"{len(resumed.buffer)} episodes, in {wall:.1f} s")
    if resumed.global_step != 3 * SF_CYCLE_STEPS or resumed.agent.step != SF_CYCLE_STEPS \
            or len(resumed.buffer) != 3 * SF_ONLINE_ENVS:
        raise AssertionError("the resumed sf pretrain run did not continue the saved one")
    return out


def _held_to_float64(what: str, got: torch.Tensor, want: torch.Tensor,
                     tol: float, detail: str) -> None:
    err = float((got.double().cpu() - want).norm() / want.norm())
    ok = err <= tol
    print(f"phase 16 {what}: relative error {err:.3e} against float64 on the CPU, tolerance "
          f"{tol:.3e} ({detail}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} on the card disagrees with float64 on the CPU")


def check_lstsq(what: str, phi: torch.Tensor, reward: torch.Tensor) -> None:
    """z = lstsq(φ, r) normalized, float32 on the card against float64 on
    the CPU with the float32 cutoff. Tolerance 50 eps (κ + κ² tan θ), the
    perturbation bound of least squares: κ the condition number over the
    kept singular values, θ the angle between r and the range of φ."""
    z_dim = phi.shape[1]
    a, b = phi.double().cpu(), reward.reshape(-1, 1).double().cpu()
    rcond = F32_EPS * max(a.shape)
    x = lstsq(a, b, rcond=rcond)
    s = torch.linalg.svdvals(a)
    kept = s[s >= rcond * s[0]]
    kappa = float(kept[0] / kept[-1])
    fit = a @ x
    tan = float((b - fit).norm() / fit.norm())
    want = math.sqrt(z_dim) * x[:, 0] / x.norm()
    got = normalized_solution(phi, reward, z_dim)
    _held_to_float64(what, got, want, 50 * F32_EPS * (kappa + kappa ** 2 * tan),
                     f"{a.shape[0]} samples x {z_dim} features, rank {len(kept)}, "
                     f"condition number {kappa:.1f}, tan theta {tan:.3f}")


def check_sf_inference(sf_ws: tp.Any, svd_ws: tp.Any) -> None:
    """Phase 16: the inference of phase 15's agents on INFERENCE_SAMPLES of
    their replay, float32 on the card against float64 on the CPU."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    batch = sf_ws.buffer.sample(gen, INFERENCE_SAMPLES)
    phi = sf_ws.agent.features(batch.next_obs)
    check_lstsq("sf lstsq, full rank", phi, batch.reward)
    deficient = phi.clone()
    deficient[:, 1] = 0.0
    deficient[:, 2] = deficient[:, 3]
    check_lstsq("sf lstsq, rank-deficient (a dead and a duplicated feature)", deficient,
                batch.reward)
    check_lstsq("sf_svd lstsq of phi(s, a)", svd_ws.agent.features(batch.next_obs, batch.action),
                batch.reward)

    agent = sf_ws.agent
    agent.precompute_cov(batch.next_obs)
    phi64 = phi.double().cpu()
    cov = phi64.T @ phi64 / phi64.shape[0]
    rtol = 10 * cov.shape[0] * F32_EPS
    want_inv = pinv(cov, rtol=rtol)
    s = torch.linalg.svdvals(cov)
    kappa = float(s[0] / s[s > rtol * s[0]][-1])
    tol = 50 * F32_EPS * kappa
    detail = f"covariance of {phi64.shape[0]} x {phi64.shape[1]} features, condition number {kappa:.1f}"
    _held_to_float64("precompute_cov: the pinv of the phi covariance", agent.inv_cov, want_inv,
                     tol, detail)
    goal = batch.next_obs[7]
    want = l2_normalize(phi64[7:8] @ want_inv)[0]
    _held_to_float64("get_goal_meta after precompute_cov", agent.get_goal_meta(goal), want, tol,
                     detail)


def _grid_trajectory(env: tp.Any, goals: torch.Tensor, actions: torch.Tensor
                     ) -> tp.Dict[str, torch.Tensor]:
    """Every field of a reset to ``goals`` and of one step per row of
    ``actions`` [T, E], on the device of ``goals``, brought to the CPU."""
    state, ts = env.reset_with_goals(goals)
    steps = [ts]
    for a in actions.to(goals.device):
        state, ts = env.step(state, a)
        steps.append(ts)
    out = {f: torch.stack([getattr(t, f) for t in steps]).cpu() for f in GRID_FIELDS}
    out.update(goal_obs=env.get_goal_obs(state).cpu(), pos=state.pos.cpu(),
               goal=state.goal.cpu(), t=state.t.cpu())
    return out


def check_gridworld() -> None:
    """Phase 17: the gridworld on the card against the CPU to the bit,
    ``simple``'s goals, a captured control step of discrete FB against
    eager, and the environment's rate."""
    card = card_name_and_power_limit()
    actions = torch.from_numpy(
        np.random.RandomState(SEED).randint(0, 5, (GRID_LENGTH, GRID_ENVS))).float()
    compared, mismatched = 0, []
    walls = goals_reached = last = 0
    for layout in gridworld.TASKS:
        for obs_type in gridworld.OBSERVATION_TYPES:
            env = build_gridworld_task(layout, observation_type=obs_type, penalty_for_walls=-0.5)
            goals, _ = env.reset(torch.Generator().manual_seed(SEED), GRID_ENVS)
            got = _grid_trajectory(env, goals.goal.cuda(), actions)
            want = _grid_trajectory(env, goals.goal, actions)
            compared += 1
            mismatched += [f"{layout}/{obs_type}/{k}" for k in want
                           if not torch.equal(got[k], want[k])]
            walls += int((want["reward"] == -0.5).sum())
            goals_reached += int((want["reward"] == 1.0).sum())
            last += int((got["step_type"][-1] == 2).sum())
    print(f"phase 17 gridworld: {compared} layout x observation type pairs, {GRID_ENVS} "
          f"environments x {GRID_LENGTH} steps of the same actions on the card and on the CPU "
          f"(observations, rewards, discounts, step types, actions, physics, the state and the "
          f"goal observation): equal to the bit {not mismatched}; {walls} wall hits and "
          f"{goals_reached} goal rewards along the way, LAST at step {GRID_LENGTH} in {last} of "
          f"{compared * GRID_ENVS} episodes")
    if mismatched:
        raise AssertionError(f"the gridworld on the card differs from the CPU: {mismatched}")

    env = build_gridworld_task("simple")
    state, _ = env.reset(torch.Generator(device="cuda").manual_seed(SEED), GRID_RESETS)
    drawn = state.goal.cpu().numpy()
    cells, counts = np.unique(drawn, axis=0, return_counts=True)
    free = {tuple(c) for c in env.free_cells.tolist()}
    expected = GRID_RESETS / len(free)
    ok = ({tuple(c) for c in cells.tolist()} == free and tuple(env.start) not in free
          and counts.min() > 0.75 * expected and counts.max() < 1.25 * expected)
    print(f"phase 17 simple's goals over {GRID_RESETS} resets on the card: {len(cells)} cells "
          f"drawn of the {len(free)} free cells other than the start, each {counts.min()}-"
          f"{counts.max()} times (expected {expected:.1f}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("simple's goals are not drawn uniformly over its free cells")

    # one control step of discrete FB at full width, captured against eager
    agent = DiscreteFBAgent(DiscreteFBConfig(), env.spec.obs_dim, env.spec.n_actions,
                            device="cuda", seed=SEED)
    short = build_gridworld_task("simple", max_episode_length=COMPARED_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    z = agent.sample_z(EVAL_EPISODES, gen)
    state, ts = short.reset(gen, EVAL_EPISODES)
    got = [x.clone() for x in Rollout(short, agent, EVAL_EPISODES)(z, state, ts)]
    want = Rollout(short, agent, EVAL_EPISODES, capture=False)(z, state, ts)
    rollout_ok = all(torch.equal(a, b) for a, b in zip(got, want))
    gens = [torch.Generator(device="cuda").manual_seed(SEED + 1) for _ in range(2)]
    runs = []
    for capture, g in zip((True, False), gens):
        collector = EpisodeCollector(short, agent, EVAL_EPISODES, g, capture=capture)
        meta = init_meta_batched(agent, g, EVAL_EPISODES)
        state, ts = short.reset(g, EVAL_EPISODES)
        runs.append({k: v.clone() for k, v in collector(meta, state, ts, 0).items()})
    collector_ok = all(torch.equal(runs[0][k], v) for k, v in runs[1].items()) \
        and torch.equal(gens[0].get_state(), gens[1].get_state())
    print(f"phase 17 discrete FB (hidden {agent.cfg.hidden_dim}, z {agent.cfg.z_dim}) on "
          f"grid_simple, {COMPARED_STEPS} control steps x {EVAL_EPISODES} environments as "
          f"replays of one captured step against eager: greedy rollout equal to the bit "
          f"{rollout_ok}, epsilon-greedy collector equal to the bit {collector_ok}")
    if not (rollout_ok and collector_ok):
        raise AssertionError("the captured grid control step disagrees with the eager one")

    for envs in GRID_SIZES:
        state, ts = env.reset(gen, envs)
        held = dataclasses.replace(state, pos=state.pos.clone(), t=state.t.clone())
        action = torch.arange(envs, device="cuda").remainder(5).float()

        def step() -> torch.Tensor:
            new, out = env.step(held, action)
            held.pos.copy_(new.pos)
            held.t.copy_(new.t)
            return out.reward

        program = CapturedProgram(step, torch.device("cuda"), [held.pos, held.t])
        _, env_s = _timed(lambda: program.replay(GRID_LENGTH))
        z = agent.sample_z(envs, gen)
        rollout = Rollout(env, agent, envs)
        rollout(z, state, ts)  # captures
        (totals, _, _), run_s = _timed(lambda: rollout(z, state, ts))
        print(f"phase 17 grid E={envs}: env.step alone {envs * GRID_LENGTH / env_s:.0f} "
              f"environment steps/s ({1e3 * env_s / GRID_LENGTH:.4f} ms per step, one graph "
              f"replay each); the evaluation rollout with discrete FB's greedy policy at full "
              f"width {envs * GRID_LENGTH / run_s:.0f} environment steps/s "
              f"({1e3 * run_s / GRID_LENGTH:.4f} ms per control step), mean return "
              f"{float(totals.mean()):.2f}, on {card}")
        del program, rollout


def grid_buffer() -> tp.Any:
    """GRID_EPISODES random-policy episodes of ``grid_simple`` (200 steps,
    agent_pos observations), collected on the card."""
    env = build_gridworld_task("simple")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state, ts = env.reset(gen, GRID_EPISODES)
    steps = [ts.to_buffer_dict()]
    for _ in range(GRID_LENGTH):
        a = torch.randint(0, 5, (GRID_EPISODES,), generator=gen, device="cuda").float()
        state, ts = env.step(state, a)
        steps.append(ts.to_buffer_dict())
    buf = ReplayBuffer(GRID_EPISODES, discount=0.98, future=0.99, device="cuda")
    buf.add_trajectory({k: torch.stack([t[k] for t in steps]) for k in steps[0]}, GRID_LENGTH)
    return buf


def check_discrete_agents(fb_rate: float) -> None:
    """Phase 18: the discrete agents' update at the JAX defaults, captured
    against eager on a twin."""
    card = card_name_and_power_limit()
    buf = grid_buffer()
    configs = [("discrete_fb", DiscreteFBAgent, DiscreteFBConfig()),
               ("discrete_fb boltzmann=false", DiscreteFBAgent,
                DiscreteFBConfig(boltzmann=False)),
               ("discrete_fb q_loss=true", DiscreteFBAgent, DiscreteFBConfig(q_loss=True))]
    configs += [(f"discrete_sf {name}", DiscreteSFAgent, DiscreteSFConfig(feature_learner=name))
                for name in ("icm", "identity", "lap")]
    out = []
    for label, agent_cls, cfg in configs:
        out.append(check_captured_agent(
            "phase 18", label, lambda: agent_cls(cfg, 2, 5, device="cuda", seed=SEED), cfg, buf,
            fb_rate, card))
        gc.collect()
        torch.cuda.empty_cache()
    graphs = {r["label"]: r["graphs"] for r in out}
    if graphs["discrete_fb q_loss=true"] != 2 or any(
            n != 1 for label, n in graphs.items() if label != "discrete_fb q_loss=true"):
        raise AssertionError(f"unexpected graphs per update: {graphs}")


def grid_args(folder: str, agent: str, task: str, frames: int, *extra: str) -> tp.List[str]:
    """Phase 19's command line: a discrete agent at the JAX defaults on a
    grid task, 4 environments, one seed cycle."""
    return [f"agent={agent}", f"task={task}", f"num_envs={ONLINE_ENVS}",
            f"num_seed_frames={GRID_CYCLE_STEPS}", f"num_train_frames={frames}",
            f"eval_every_steps={2 * GRID_CYCLE_STEPS}", f"num_eval_episodes={EVAL_EPISODES}",
            f"folder={folder}", f"seed={SEED}", *extra]


def run_grid_entry_points(tmp: str) -> None:
    """Phase 19: discrete FB through ``pretrain.main`` on ``grid_simple``
    with a resume, ``anytrain`` on ``grid_obstacle``, discrete SF through
    ``pretrain.main``."""
    card = card_name_and_power_limit()
    folder = f"{tmp}/grid"
    frames = GRID_CYCLES * GRID_CYCLE_STEPS
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ws, wall = _timed(lambda: pretrain.main(grid_args(folder, "discrete_fb", "grid_simple",
                                                      frames)))
    peak = torch.cuda.max_memory_allocated()
    report_cycles(ws, "phase 19 discrete_fb")
    updates = sum(int(t["updates"]) for t in ws.cycle_timings)
    captures = ws.online_trainer.trainer.captures
    evals = read_csv(ws.work_dir / "eval.csv")
    returns = [float(r["episode_reward"]) for r in evals]
    steps = [int(float(r["step"])) for r in evals]
    videos = [(ws.work_dir / "eval_video" / f"{s}.png").exists() for s in steps]
    z = ws._init_eval_meta()["z"]
    z_norm = float(z.norm())
    print(f"phase 19 pretrain agent=discrete_fb task=grid_simple: {GRID_CYCLES} cycles, "
          f"{ws.global_step} environment steps, {updates} updates in {wall:.1f} s; the update "
          f"program captured {captures} time(s); evaluations at steps {steps}: episode_reward "
          + ", ".join(f"{r:.2f}" for r in returns) + f", videos {videos}; the goal-observation "
          f"z finite {bool(torch.isfinite(z).all())}, norm {z_norm:.4f} (sqrt(z_dim) "
          f"{math.sqrt(ws.agent.cfg.z_dim):.4f}); finalize() on the grid {ws.finalize()}; peak "
          f"device memory {peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} above the "
          f"{held / 2**20:.1f} held, on {card}")
    if captures != 1 or updates != (GRID_CYCLES - 1) * GRID_CYCLE_STEPS // 2 \
            or ws.agent.step != updates or steps != [2 * GRID_CYCLE_STEPS, frames] \
            or not all(videos) or not all(0.0 <= r <= GRID_LENGTH for r in returns) \
            or not bool(torch.isfinite(z).all()) \
            or abs(z_norm - math.sqrt(ws.agent.cfg.z_dim)) > 1e-3 \
            or (ws.work_dir / "test_rewards.json").exists() \
            or not all(math.isfinite(v) for v in ws.last_row.values()):
        raise AssertionError(f"the grid pretrain run: captures {captures}, updates {updates}, "
                             f"evaluations {evals}, z norm {z_norm}")
    resumed, wall = _timed(lambda: pretrain.main(grid_args(
        folder, "discrete_fb", "grid_simple", frames + GRID_CYCLE_STEPS)))
    print(f"phase 19 resumed: step {frames} -> {resumed.global_step}, agent step {updates} -> "
          f"{resumed.agent.step}, buffer {len(ws.buffer)} -> {len(resumed.buffer)} episodes "
          f"in {wall:.1f} s")
    if resumed.global_step != frames + GRID_CYCLE_STEPS \
            or resumed.agent.step != updates + GRID_CYCLE_STEPS // 2 \
            or len(resumed.buffer) != len(ws.buffer) + ONLINE_ENVS:
        raise AssertionError("the resumed grid run did not continue the saved one")
    del ws, resumed

    for entry, agent, task in ((anytrain.main, "discrete_fb", "grid_obstacle"),
                               (pretrain.main, "discrete_sf", "grid_simple")):
        name = f"{entry.__module__.rsplit('.', 1)[1]} agent={agent} task={task}"
        run, wall = _timed(lambda: entry(grid_args(
            f"{tmp}/{agent}_{task}", agent, task, 2 * GRID_CYCLE_STEPS)))
        report_cycles(run, f"phase 19 {name}")
        row = run.last_row
        print(f"phase 19 {name}: a seed cycle and a training cycle in {wall:.1f} s, agent step "
              f"{run.agent.step}, " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                                                 if k.endswith("_loss")) + f", on {card}")
        if run.agent.step != GRID_CYCLE_STEPS // 2 \
                or not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"{name}: agent step {run.agent.step}, row {row}")



def check_3d_engine() -> None:
    """Phase 20: the 3-D engine's dynamics on the card against float64, the
    captured control step of every quadruped task and of jaco against eager,
    launches and device time per control step, and ``env.step``'s rate."""
    card = card_name_and_power_limit()
    for domain in dynamics_check.DOMAINS_3D:
        pressed, held = dynamics_check.check_domain(domain, DYNAMICS_STATES, "cuda", SEED)
        allowed, factor = dynamics_check.ALLOWANCES.get(
            domain, (dynamics_check.STEP_OUTLIERS, dynamics_check.OUTLIER_FACTOR))
        ok = all(h.ok for h in held)
        print(f"phase 20 dynamics {domain}: {DYNAMICS_STATES} states, {pressed:.2f} of them "
              f"with a contact pressed, card float32 against CPU float64 (tolerances "
              f"{dynamics_check.DYNAMICS_TOL} and {dynamics_check.STEP_TOL} of the largest "
              f"entry, by state; after a step {allowed} of the states may miss, within "
              f"{factor:.0f}x): " + "; ".join(str(h) for h in held) + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"the {domain}'s dynamics on the card disagree with the CPU's")

    for task in QUAD_PROFILED:
        env = make_env(task, COMPARED_STEPS)
        agent = FBDDPGAgent(FBDDPGConfig(compute_dtype="bfloat16"), env.spec.obs_dim,
                            env.spec.action_dim, device="cuda", seed=SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        z = agent.sample_z(EVAL_EPISODES, gen)
        state, ts = env.reset(gen, EVAL_EPISODES)
        captured = Rollout(env, agent, EVAL_EPISODES)
        eager = Rollout(env, agent, EVAL_EPISODES, capture=False)
        # the capture's eager warm-up steps have warmed the eager path
        got = [x.clone() for x in captured(z, state, ts)]
        want, eager_s = _timed(lambda: eager(z, state, ts))
        _, captured_s = _timed(lambda: captured(z, state, ts))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
        finite = bool(torch.isfinite(got[1]).all())
        print(f"phase 20 captured vs eager {task}: FB at full width (bf16), {COMPARED_STEPS} "
              f"control steps x {EVAL_EPISODES} episodes from the same states: equal to the "
              f"bit {bitwise}, finite {finite}; eager {1e3 * eager_s / COMPARED_STEPS:.3f} ms "
              f"per control step, captured {1e3 * captured_s / COMPARED_STEPS:.3f}, on {card}")
        if not (bitwise and finite):
            raise AssertionError(f"{task}: the captured control step disagrees with the eager one")
        profile_rollout(captured, z, state, ts, env.n_substeps, f"phase 20 {task}")
        del agent, captured, eager, got, want

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for task in QUAD_STEP_TASKS:
        env = make_env(task)
        for envs in QUAD_STEP_SIZES.get(task, ROLLOUT_SIZES[:1]):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = env_step.step_timing(env, envs, gen)
            print(f"phase 20 env.step {task} E={envs}: {t.steps_per_s:.0f} environment steps/s "
                  f"({t.replay_ms:.4f} ms per replay of the captured step); eager "
                  f"{t.launches} launches and {t.device_ms:.4f} ms of device time per step "
                  f"({env.n_substeps} substeps) under the profiler; captured equal to eager "
                  f"{t.bitwise}; peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
                  f" MiB, on {card}")
            if not t.bitwise:
                raise AssertionError(f"{task} E={envs}: the captured env.step differs")
    copy_ms = env_step.terrain_copy_ms(ROLLOUT_SIZES[-1], gen)
    print(f"phase 20 escape terrain at E={ROLLOUT_SIZES[-1]}: one copy of the "
          f"{ROLLOUT_SIZES[-1] * 101 * 101 * 4 / 1e6:.0f} MB of terrains {copy_ms:.4f} ms (the "
          f"step hands the same tensor on, so the loops' copies of the state skip it), on {card}")


def quad_args(folder: str, *extra: str) -> tp.List[str]:
    """The quadruped runs' common arguments: FB at full width, bf16, the
    fused loss, 10 evaluation episodes and a battery of 10 per task."""
    return ["agent=fb_ddpg", "agent.use_pallas_loss=true", "agent.compute_dtype=bfloat16",
            f"num_eval_episodes={EVAL_EPISODES}", f"final_tests={FINAL_TESTS}",
            f"folder={folder}", f"seed={SEED}", *extra]


def run_quadruped(tmp: str) -> tp.Tuple[tp.Dict[str, int], tp.Any]:
    """Phase 21: ``train_online`` on the quadruped with ``quad_pos_speed``
    at full width, then ``evaluate()`` and ``finalize()``."""
    card = card_name_and_power_limit()
    frames = QUAD_CYCLES * SHORT_CYCLE
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ff.reset_launches()
    ws, wall = _timed(lambda: train_online.main(quad_args(
        f"{tmp}/quad", "task=quadruped_stand", "goal_space=quad_pos_speed",
        f"episode_length={SHORT_LENGTH}",
        f"num_rollout_episodes={ONLINE_ENVS}", f"num_agent_updates={QUAD_UPDATES}",
        f"num_train_frames={frames}", "eval_every_steps=0",
        f"replay_buffer_episodes={QUAD_REPLAY_EPISODES}")))
    counts, ran = dict(ff.launches), ff.device_runs()
    peak = torch.cuda.max_memory_allocated()
    rows = read_csv(ws.work_dir / "train.csv")
    updates = sum(int(t["updates"]) for t in ws.cycle_timings)
    for i, (timing, row) in enumerate(zip(ws.cycle_timings, rows)):
        collect, update = timing["collect"], timing["update"]
        print(f"phase 21 cycle {i + 1}: {collect + update:.3f} s: collection of {ONLINE_ENVS} x "
              f"{SHORT_LENGTH} steps {collect:.3f} s ({SHORT_CYCLE / collect:.0f}"
              f" environment steps/s{', the capture of the control step included' if i == 0 else ''}"
              f"), {int(timing['updates'])} updates and the commit {update:.3f} s "
              f"({timing['updates'] / update:.1f} updates/s"
              f"{', the capture of the update included' if i == 0 else ''}); collection "
              f"{collect / (collect + update):.4f} of the cycle; episode_reward "
              f"{float(row['episode_reward']):.2f}, fb_loss {float(row['fb_loss']):.4f}")
    captures = ws.trainer.captures
    expected = updates + WARMUP_RUNS
    print(f"phase 21 train_online agent=fb_ddpg task=quadruped_stand goal_space=quad_pos_speed: "
          f"{QUAD_CYCLES} cycles, {ws.global_step} environment steps, {updates} updates in "
          f"{wall:.1f} s (finalize() and the checkpoint included); the update program captured "
          f"{captures} time(s) across {len(ws.buffer)} committed episodes; fused launches "
          f"{counts} by the wrappers' counts = {updates} replayed updates + {WARMUP_RUNS} eager "
          f"warm-up runs; {ran} by the kernels' own count in device memory; peak device memory "
          f"{peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} above the {held / 2**20:.1f} "
          f"held before, on {card}")
    if captures != 1 or ws.agent.step != updates or updates != QUAD_CYCLES * QUAD_UPDATES \
            or any(c != expected for c in counts.values()) or ran != counts \
            or not all(c > 0 for c in counts.values()) or ws.global_step != frames \
            or len(ws.buffer) != QUAD_CYCLES * ONLINE_ENVS \
            or not all(math.isfinite(v) for v in ws.last_row.values()):
        raise AssertionError(f"quadruped run: captures {captures}, agent step {ws.agent.step}, "
                             f"launches {counts}, device runs {ran}, row {ws.last_row}")
    metrics, eval_s = _timed(ws.evaluate)
    video = ws.work_dir / "eval_video" / f"{ws.global_step}.png"
    print(f"phase 21 evaluate: {EVAL_EPISODES} episodes x {SHORT_LENGTH} steps in {eval_s:.3f} s "
          f"(the capture of the control step, z inferred from the replay ({ws.cfg.z_inference_draws}"
          f" draws), the csv row and the video included): episode_reward "
          f"{metrics['episode_reward']:.2f}, z_norm {metrics['z_norm']:.4f}, phys_up_mean "
          f"{metrics['phys_up_mean']:.4f}; video {video.stat().st_size} bytes, on {card}")
    if not (all(math.isfinite(v) for v in metrics.values())
            and 0.0 <= metrics["episode_reward"] <= EPISODE_LENGTH and video.stat().st_size > 0):
        raise AssertionError(f"bad quadruped evaluation: {metrics}")
    rewards, final_s = _timed(ws.finalize)
    written = check_test_rewards(ws, rewards, QUAD_BATTERY)
    print(f"phase 21 finalize: {len(QUAD_BATTERY)} tasks x {FINAL_TESTS} episodes x "
          f"{SHORT_LENGTH} steps in one batch of {len(QUAD_BATTERY) * FINAL_TESTS} in "
          f"{final_s:.3f} s; test_rewards.json mean returns "
          + ", ".join(f"{t} {np.mean(written[t]):.2f}" for t in QUAD_BATTERY) + f", on {card}")
    return counts, ws


def run_quadruped_paths(tmp: str) -> None:
    """Phase 22: jaco through ``pretrain``, ``train_offline`` on phase 21's
    replay relabeled for ``quadruped_walk``, ``anytrain`` on fetch and escape."""
    card = card_name_and_power_limit()
    jaco_cycle = ONLINE_ENVS * JACO_LENGTH
    jaco_ws, wall = _timed(lambda: pretrain.main(quad_args(
        f"{tmp}/jaco", "task=jaco_reach_top_left", f"num_envs={ONLINE_ENVS}",
        f"num_seed_frames={jaco_cycle}", f"num_train_frames={2 * jaco_cycle}",
        "eval_every_steps=0")))
    battery = jaco_ws.finalize()
    jaco_rows = read_csv(jaco_ws.work_dir / "train.csv")
    print(f"phase 22 pretrain agent=fb_ddpg task=jaco_reach_top_left: {ONLINE_ENVS} x "
          f"{JACO_LENGTH} steps per cycle, a seed cycle and a cycle of {jaco_ws.agent.step} "
          f"updates in {wall:.1f} s; collection {jaco_ws.cycle_timings[-1]['collect']:.3f} s of "
          f"the last cycle; episode_reward "
          + ", ".join(f"{float(r['episode_reward']):.3f}" for r in jaco_rows)
          + f"; finalize() {battery}, test_rewards.json written "
          f"{(jaco_ws.work_dir / 'test_rewards.json').exists()}, on {card}")
    if jaco_ws.agent.step != jaco_cycle // 2 or battery != {} \
            or (jaco_ws.work_dir / "test_rewards.json").exists() \
            or not all(math.isfinite(v) for v in jaco_ws.last_row.values()):
        raise AssertionError(f"the jaco run: agent step {jaco_ws.agent.step}, {battery}")
    del jaco_ws

    offline, wall = _timed(lambda: train_offline.main(quad_args(
        f"{tmp}/quad_offline", "task=quadruped_walk", "goal_space=quad_pos_speed",
        f"load_replay={tmp}/quad/models/latest", "relabel=true",
        f"num_grad_steps={QUAD_OFFLINE_UPDATES}", f"steps_per_call={STEPS_PER_CALL}",
        f"log_every_steps={STEPS_PER_CALL}", "eval_every_steps=0", "final_tests=0",
        f"replay_buffer_episodes={QUAD_REPLAY_EPISODES}")))
    storage, lengths = offline.buffer.state.storage, offline.buffer.state.ep_lengths
    n = int(lengths[0])
    want = get_reward_function("quadruped_walk").from_physics(storage["physics"][0, 1:n + 1])
    relabeled = torch.equal(storage["reward"][0, 1:n + 1, 0], want)
    print(f"phase 22 train_offline task=quadruped_walk on phase 21's replay ({len(offline.buffer)}"
          f" episodes) relabeled from the stored physics (equal to the reward function to the "
          f"bit {relabeled}): {offline.global_step} captured updates in {wall:.1f} s, "
          f"{offline.last_row['fps']:.1f} updates/s in the last window, fb_loss "
          f"{offline.last_row['fb_loss']:.4f}, inferred z finite "
          f"{bool(torch.isfinite(offline.inferred_z).all())}, on {card}")
    if offline.global_step != QUAD_OFFLINE_UPDATES or not relabeled \
            or not bool(torch.isfinite(offline.inferred_z).all()):
        raise AssertionError("the offline quadruped run")
    del offline

    for task in ("quadruped_fetch", "quadruped_escape"):
        run, wall = _timed(lambda: anytrain.main(quad_args(
            f"{tmp}/{task}", f"task={task}", f"num_envs={QUAD_ANYTRAIN_ENVS}",
            f"episode_length={SHORT_LENGTH}", "num_seed_frames=0",
            f"num_train_frames={QUAD_ANYTRAIN_ENVS * SHORT_LENGTH}",
            "eval_every_steps=0", "final_tests=0")))
        timing = run.cycle_timings[0]
        row = run.last_row
        print(f"phase 22 anytrain task={task}: one cycle of {QUAD_ANYTRAIN_ENVS} x "
              f"{SHORT_LENGTH} "
              f"steps (collection {timing['collect']:.3f} s, the capture included) and "
              f"{run.agent.step} updates ({timing['update']:.3f} s) in {wall:.1f} s; "
              f"episode_reward {row['episode_reward']:.2f}, fb_loss {row['fb_loss']:.4f}, "
              f"on {card}")
        if run.agent.step != QUAD_ANYTRAIN_ENVS * SHORT_LENGTH // 2 \
                or not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"{task}: agent step {run.agent.step}, row {row}")
        del run


def _stacked(frames: tp.List[torch.Tensor], stack: int) -> tp.List[torch.Tensor]:
    """The wrapper's observations of a run of frames [E, H, W, C] (uint8):
    the first tiled, then the last ``stack`` frames, flat."""
    held = [frames[0]] * stack
    out = [torch.stack(held, 3).reshape(frames[0].shape[0], -1)]
    for frame in frames[1:]:
        held = held[1:] + [frame]
        out.append(torch.stack(held, 3).reshape(frame.shape[0], -1))
    return out


def _uint8_agreement(got: torch.Tensor, want: torch.Tensor) -> tp.Tuple[int, float]:
    """Largest difference and the share of equal entries of two uint8 tensors."""
    diff = (got.int() - want.int()).abs()
    return int(diff.max()), float((diff == 0).float().mean())


def check_pixels() -> None:
    """Phase 23: the rendered frames on the card against the same render on
    the CPU, the random shifts against an explicit crop of edge-padded
    images, the encoder on the card against the CPU, the captured pixel
    control step against eager, and ``env.step``'s rate on frames."""
    card = card_name_and_power_limit()
    for task in PIXEL_TASKS:
        env = make_pixel_env(task)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
        (state, ts), reset_s = _timed(lambda: env.reset(gen, PIXEL_ENVS))
        obs, phys = [ts.observation[:PIXEL_CPU_ENVS].cpu()], [ts.physics[:PIXEL_CPU_ENVS].cpu()]
        started = time.perf_counter()
        for _ in range(PIXEL_STEPS):
            action = torch.rand((PIXEL_ENVS, env.spec.action_dim), generator=gen,
                                device="cuda") * 2 - 1
            state, ts = env.step(state, action)
            obs.append(ts.observation[:PIXEL_CPU_ENVS].cpu())
            phys.append(ts.physics[:PIXEL_CPU_ENVS].cpu())
        run_s = time.perf_counter() - started
        # the same physics rows rendered and stacked on the CPU
        want = _stacked([env.frame_fn(p).to(torch.uint8) for p in phys], env.frame_stack)
        agreement = [_uint8_agreement(g, w) for g, w in zip(obs, want)]
        worst, share = max(a[0] for a in agreement), min(a[1] for a in agreement)
        newest = ts.observation.reshape((PIXEL_ENVS,) + env.spec.obs_shape[:2]
                                        + (env.frame_stack, 3))[..., -1, :].cpu()
        last_worst, last_share = _uint8_agreement(
            newest, env.frame_fn(ts.physics.cpu()).to(torch.uint8))
        print(f"phase 23 frames {task}: {PIXEL_ENVS} environments x {PIXEL_STEPS} steps of "
              f"84 x 84 x {env.frame_stack} uint8 frames on the card ({reset_s:.3f} s reset, "
              f"{run_s:.3f} s for the eager steps and the copies out); the observations of "
              f"{PIXEL_CPU_ENVS} of them at every step against the CPU's render of the same "
              f"physics: largest difference {worst}, equal on {share:.6f} (at the worst step); "
              f"the newest frame of all {PIXEL_ENVS} at the last step: largest difference "
              f"{last_worst}, equal on {last_share:.6f}, on {card}")
        if max(worst, last_worst) > 1 or min(share, last_share) < PIXEL_EQUAL_SHARE:
            raise AssertionError(f"{task}: card frames differ from the CPU's")

    # the shifts: one gather against a crop of np.pad(mode="edge")
    imgs = ts.observation.reshape((PIXEL_ENVS,) + env.spec.obs_shape)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    shifts = draw_shifts(PIXEL_ENVS, AUG_PAD, gen, torch.device("cuda"))
    shifted = random_shift_aug(imgs, shifts, AUG_PAD)
    aug_ms = time_ms(lambda: random_shift_aug(imgs, shifts, AUG_PAD))
    padded = np.pad(imgs[:PIXEL_CPU_ENVS].cpu().numpy(),
                    ((0, 0), (AUG_PAD, AUG_PAD), (AUG_PAD, AUG_PAD), (0, 0)), mode="edge")
    size = env.spec.obs_shape[0]
    crops = np.stack([padded[b, r:r + size, c:c + size]
                      for b, (r, c) in enumerate(shifts[:PIXEL_CPU_ENVS].tolist())])
    exact = np.array_equal(shifted[:PIXEL_CPU_ENVS].cpu().numpy(), crops)
    print(f"phase 23 random_shift_aug: {PIXEL_ENVS} uint8 images of {env.spec.obs_shape}, pad "
          f"{AUG_PAD}: {aug_ms:.4f} ms per call ({2 * imgs.numel() / aug_ms / 1e6:.1f} GB/s read "
          f"and written); {PIXEL_CPU_ENVS} of them against np.pad(mode='edge') and a crop at the "
          f"same offsets: equal to the bit {exact}; dtype {shifted.dtype}, on {card}")
    if not exact or shifted.dtype != torch.uint8:
        raise AssertionError("the random shifts differ from an explicit crop")

    # the encoder: the card against the CPU on the same weights and frames
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        encoder = PixelEncoder(env.spec.obs_shape[2])
    frames = imgs[:ENCODER_BATCH]
    with torch.no_grad():
        want = encoder(frames.cpu())
        got = encoder.cuda()(frames)
    # torch.testing.assert_close's measure: |diff| against atol + rtol |cpu|
    err = float(((got.cpu() - want).abs() / (ENCODER_ATOL + ENCODER_RTOL * want.abs())).max())
    encoder_ms = time_ms(lambda: encoder(imgs), calls=5, replays=5)
    print(f"phase 23 PixelEncoder: {ENCODER_BATCH} frames of {env.spec.obs_shape} -> "
          f"{got.shape[1]} features; the card (cuDNN, TF32 off) against the CPU, largest "
          f"|diff| / ({ENCODER_ATOL} + {ENCODER_RTOL} |cpu|) {err:.3f} (must be <= 1); largest "
          f"|diff| {float((got.cpu() - want).abs().max()):.3e}; a forward pass over "
          f"{PIXEL_ENVS} frames {encoder_ms:.4f} ms, on {card}")
    if err > 1.0 or got.shape[1] != conv_repr_dim(*env.spec.obs_shape[:2]):
        raise AssertionError("the encoder on the card differs from the CPU")
    del imgs, shifted, encoder, state, ts

    # the captured pixel control step (render, encoder, policy) against eager
    env = make_pixel_env("walker_walk", episode_length=COMPARED_STEPS)
    agent = DDPGAgent(DDPGConfig(obs_type="pixels"), env.spec.obs_dim, ACTION_DIM,
                      device="cuda", seed=SEED, obs_shape=env.spec.obs_shape)
    gens = [torch.Generator(device="cuda").manual_seed(SEED + 22) for _ in range(2)]
    runs = []
    for capture, g in ((True, gens[0]), (False, gens[1])):
        collector = EpisodeCollector(env, agent, PIXEL_RUN_ENVS, g, capture=capture)
        state, ts = env.reset(g, PIXEL_RUN_ENVS)
        runs.append({k: v.clone() for k, v in collector({}, state, ts, 0).items()})
    unequal = [k for k, v in runs[1].items() if not torch.equal(runs[0][k], v)]
    print(f"phase 23 pixel collector captured vs eager: {PIXEL_RUN_ENVS} walker episodes x "
          f"{COMPARED_STEPS} steps, the full-width pixel DDPG policy with its noise; columns "
          f"that differ: {unequal or 'none'}; observations {runs[0]['observation'].dtype}; "
          f"generators in the same state after: "
          f"{torch.equal(gens[0].get_state(), gens[1].get_state())}, on {card}")
    if unequal or runs[0]["observation"].dtype != torch.uint8 \
            or not torch.equal(gens[0].get_state(), gens[1].get_state()):
        raise AssertionError("captured and eager pixel collectors disagree")
    del agent, runs

    env = make_pixel_env("walker_walk")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    for envs in env_step.PIXEL_SIZES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t = env_step.step_timing(env, envs, gen)
        peak = torch.cuda.max_memory_allocated() - held
        print(f"phase 23 env.step walker pixels E={envs}: {t.launches} launches and "
              f"{t.device_ms:.4f} ms of device time per eager step, {t.replay_ms:.4f} ms per "
              f"replay of its graph ({t.steps_per_s:.0f} environment steps/s); captured equal "
              f"to eager {t.bitwise}; peak {peak / 2**20:.1f} MiB above the held, on {card}")
        if not t.bitwise:
            raise AssertionError(f"the captured pixel step differs at E={envs}")


def pixel_args(folder: str, frames: int) -> tp.List[str]:
    """Phase 24's command line: pixel DDPG at the JAX defaults on the walker,
    cut to PIXEL_RUN_ENVS environments and PIXEL_REPLAY_EPISODES episodes of
    PIXEL_EPISODE_LENGTH steps."""
    return ["agent=ddpg", "obs_type=pixels", "task=walker_walk", f"num_envs={PIXEL_RUN_ENVS}",
            f"replay_buffer_episodes={PIXEL_REPLAY_EPISODES}",
            f"episode_length={PIXEL_EPISODE_LENGTH}",
            f"num_seed_frames={PIXEL_CYCLE_STEPS}", f"num_train_frames={frames}",
            "eval_every_steps=0", f"num_eval_episodes={EVAL_EPISODES}",
            f"final_tests={FINAL_TESTS}", f"folder={folder}", f"seed={SEED}"]


def run_pixels(tmp: str, fb_rate: float) -> None:
    """Phase 24: ``pretrain agent=ddpg obs_type=pixels`` at full width, its
    evaluation, ``finalize()``, a resume of the folder, and the captured
    pixel update against eager on a twin."""
    card = card_name_and_power_limit()
    folder, frames = f"{tmp}/pixels", 2 * PIXEL_CYCLE_STEPS
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ws, wall = _timed(lambda: pretrain.main(pixel_args(folder, frames)))
    peak = torch.cuda.max_memory_allocated()
    cycles = report_cycles(ws, "phase 24")
    cfg, storage = ws.agent.cfg, ws.buffer.state.storage
    captures = ws.online_trainer.trainer.captures
    print(f"phase 24 pretrain agent=ddpg obs_type=pixels task=walker_walk (hidden "
          f"{cfg.hidden_dim}, batch {cfg.batch_size}, nstep {ws.buffer.cfg.nstep}, "
          f"{cfg.compute_dtype}, frames {ws.spec.obs_shape}, aug_pad {cfg.aug_pad}; cut: "
          f"{PIXEL_RUN_ENVS} environments, episodes of {PIXEL_EPISODE_LENGTH} steps, a replay of "
          f"{PIXEL_REPLAY_EPISODES} episodes): a seed "
          f"cycle and a cycle of {ws.agent.step} updates in {wall:.1f} s; the update captured "
          f"{captures} time(s); the replay's observations {storage['observation'].dtype} "
          f"{tuple(storage['observation'].shape)} ({replay_bytes(ws) / 2**30:.2f} GiB); peak "
          f"device memory {peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} above the "
          f"{held / 2**20:.1f} held, on {card}")
    if captures != 1 or ws.agent.step != PIXEL_CYCLE_STEPS // 2 \
            or storage["observation"].dtype != torch.uint8 or ws.global_step != frames \
            or not all(math.isfinite(v) for v in ws.last_row.values()):
        raise AssertionError(f"pixel run: captures {captures}, agent step {ws.agent.step}, "
                             f"row {ws.last_row}")
    print(f"phase 24 training cycle: collection {cycles[1]['collect_s']:.3f} s "
          f"({cycles[1]['steps_per_s']:.0f} environment steps/s), {cycles[1]['updates_per_s']:.2f}"
          f" updates/s with the capture, collection {cycles[1]['share']:.4f} of the cycle")

    # a fresh workspace on the folder: the checkpoint of the run's end
    resumed = build_workspace(pixel_args(folder, frames))
    same = all(torch.equal(v.cpu(), ws.agent.train_state()[k].cpu())
               for k, v in resumed.agent.train_state().items())
    same_replay = torch.equal(resumed.buffer.state.storage["observation"][:len(ws.buffer)],
                              storage["observation"][:len(ws.buffer)])
    print(f"phase 24 resumed: a fresh workspace on the folder at step {resumed.global_step}, "
          f"agent step {resumed.agent.step}, {len(resumed.buffer)} episodes; train state equal "
          f"{same}, replay frames equal {same_replay}")
    if not (same and same_replay and resumed.global_step == frames):
        raise AssertionError("the resumed pixel workspace differs from the saved run")
    del resumed
    gc.collect()

    # launches and device time per update under the profiler
    trainer = ws.online_trainer.trainer
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, profiled_s = _timed(lambda: trainer(ws.buffer.state, ws.generator, steps=SF_PROFILED))
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in kernels) / SF_PROFILED
    convs = [e for e in kernels if "conv" in e.name.lower() or "cudnn" in e.name.lower()
             or "sm90_xmma" in e.name.lower() or "implicit" in e.name.lower()]
    conv_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in convs) / SF_PROFILED
    print(f"phase 24 profile: {len(kernels) / SF_PROFILED:.1f} kernel launches and "
          f"{busy_ms:.3f} ms of device time per update ({SF_PROFILED} replays, "
          f"{1e3 * profiled_s / SF_PROFILED:.3f} ms of wall time each under the profiler; busy "
          f"share {busy_ms * SF_PROFILED / (1e3 * profiled_s):.4f}); the convolutions' kernels "
          f"by name {len(convs) / SF_PROFILED:.1f} per update, {conv_ms:.3f} ms, on {card}")

    metrics, eval_s = _timed(ws.evaluate)
    video = ws.work_dir / "eval_video" / f"{ws.global_step}.png"
    battery, final_s = _timed(ws.finalize)
    print(f"phase 24 evaluate: {EVAL_EPISODES} episodes x {PIXEL_EPISODE_LENGTH} steps of frames in "
          f"{eval_s:.3f} s (the capture of the control step and the video included; "
          f"{EVAL_EPISODES * PIXEL_EPISODE_LENGTH / eval_s:.0f} environment steps/s): episode_reward "
          f"{metrics['episode_reward']:.2f}; video {video.stat().st_size} bytes; finalize() "
          f"{battery} in {final_s:.3f} s (DDPG infers no z), on {card}")
    if not (math.isfinite(metrics["episode_reward"])
            and 0.0 <= metrics["episode_reward"] <= PIXEL_EPISODE_LENGTH
            and video.stat().st_size > 0 and battery == {}
            and not (ws.work_dir / "test_rewards.json").exists()):
        raise AssertionError(f"pixel evaluation: {metrics}, {battery}")

    # full-width pixel updates captured against eager on a twin, to the bit
    buf, spec = ws.buffer, ws.spec
    del ws
    gc.collect()
    torch.cuda.empty_cache()
    make_agent = lambda: DDPGAgent(cfg, spec.obs_dim, ACTION_DIM, device="cuda",  # noqa: E731
                                   seed=SEED, obs_shape=spec.obs_shape)
    check_captured_agent("phase 24", "ddpg pixels", make_agent, cfg, buf, fb_rate, card,
                         updates=PIXEL_COMPARED_UPDATES, first=PIXEL_FIRST, bitwise_only=True)
    gc.collect()
    torch.cuda.empty_cache()
    # cuDNN's TF32 default (True in PyTorch; the entry points leave it): the
    # same captured updates with it off, as this script pins it, and on
    rates, losses = {}, {}
    for allow in (False, True):
        torch.backends.cudnn.allow_tf32 = allow
        agent = make_agent()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
        trainer = make_offline_trainer(agent, buf.cfg, cfg.batch_size, TF32_TIMED)
        trainer(buf.state, gen, steps=PIXEL_FIRST)  # captures
        metrics, seconds = _timed(lambda: trainer(buf.state, gen))
        rates[allow], losses[allow] = TF32_TIMED / seconds, float(metrics["critic_loss"])
        del agent, trainer
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 24 cuDNN TF32 (matmul TF32 off both times): the captured pixel update "
          f"{rates[False]:.2f} updates/s with it off, {rates[True]:.2f} with it on "
          f"({rates[True] / rates[False]:.3f}x); critic_loss over {TF32_TIMED} updates "
          f"{losses[False]:.6f} and {losses[True]:.6f}, on {card}")


def skill_episodes(episodes: tp.List[tp.Dict[str, np.ndarray]], skills: int
                   ) -> tp.List[tp.Dict[str, np.ndarray]]:
    """The episodes with a one-hot ``skill`` column, one skill per episode."""
    rng = np.random.RandomState(SEED)
    eye = np.eye(skills, dtype=np.float32)
    return [{**ep, "skill": np.repeat(eye[rng.randint(skills)][None], len(ep["reward"]), 0)}
            for ep in episodes]


def check_explorers(tmp: str, episodes: tp.List[tp.Dict[str, np.ndarray]],
                    fb_rate: float) -> None:
    """Phase 25: the five explorers at the JAX defaults, captured against
    eager on a twin, and ``pretrain agent=diayn`` with the skill resampled
    in the captured collector."""
    card = card_name_and_power_limit()
    out = []
    for name in EXPLORERS:
        cfg_cls, agent_cls = agent_classes(name)
        cfg = cfg_cls()
        data = skill_episodes(episodes, cfg.skill_dim) if name == "diayn" else episodes
        buf = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cuda")
        buf.load_episodes(data)
        buf.cfg = dataclasses.replace(buf.cfg, nstep=cfg.nstep)
        out.append(check_captured_agent(
            "phase 25", name, lambda: agent_cls(cfg, OBS_DIM, ACTION_DIM, device="cuda",
                                                seed=SEED), cfg, buf, fb_rate, card,
            updates=EXPLORER_UPDATES, bitwise_only=True))
        del buf
        gc.collect()
        torch.cuda.empty_cache()
    print("phase 25 summary: captured updates/s " + ", ".join(
        f"{r['label']} {r['captured']:.1f} ({r['launches']:.0f} launches, {r['busy_ms']:.3f} ms)"
        for r in out) + f"; all equal to eager to the bit; on {card}")

    frames = 2 * SHORT_CYCLE
    ws, wall = _timed(lambda: pretrain.main([
        "agent=diayn", "task=walker_walk", f"num_envs={ONLINE_ENVS}",
        f"episode_length={SHORT_LENGTH}", f"num_seed_frames={SHORT_CYCLE}",
        f"num_train_frames={frames}", "eval_every_steps=0",
        "final_tests=0", f"folder={tmp}/diayn", f"seed={SEED}"]))
    report_cycles(ws, "phase 25 diayn")
    skill = ws.buffer.state.storage["skill"][:len(ws.buffer)]
    every = ws.agent.cfg.update_skill_every_step
    # index i of an episode holds the skill of step i - 1, resampled where (i - 1) % every == 0
    changed = (skill[:, 1:] != skill[:, :-1]).any(-1)  # [episodes, T]: between i and i + 1
    where = changed.nonzero()[:, 1]
    collector = ws.online_trainer.collector
    row = ws.last_row
    print(f"phase 25 pretrain agent=diayn: a seed cycle and a cycle of {ws.agent.step} updates "
          f"in {wall:.1f} s; the collector captured {collector._program is not None}; the skill "
          f"column {tuple(skill.shape)}, one-hot {bool((skill.sum(-1) == 1).all())}, changed at "
          f"{int(changed.sum())} of {changed.numel()} step boundaries, all at multiples of "
          f"{every} {bool((where % every == 0).all())}; diayn_acc {row['diayn_acc']:.4f}, "
          f"diayn_loss {row['diayn_loss']:.4f}, intr_reward {row['intr_reward']:.4f}, on {card}")
    if collector._program is None or not bool((skill.sum(-1) == 1).all()) \
            or int(changed.sum()) == 0 or not bool((where % every == 0).all()) \
            or not all(math.isfinite(v) for v in row.values()):
        raise AssertionError(f"the DIAYN run: {row}")


def item13_episodes(name: str, cfg: tp.Any, maze: bool) -> tp.List[tp.Dict[str, np.ndarray]]:
    """Phase 26's episodes for agent ``name``: phase 4's walker-shaped ones,
    or point-mass-maze-shaped ones (obs 4, action 2, a 2-D ``goal``
    column of positions in the maze) for the goal agents; with the
    meta column that the agent's update reads, one value per episode:
    APS's unit ``task``, NEWAPS's unit ``z``, SMM's one-hot ``z``, the goal
    agents' ``g`` (one of the 20 maze goals)."""
    rng = np.random.RandomState(SEED)
    rows = EPISODE_LENGTH + 1
    if maze:
        episodes = synthetic_episodes(EPISODES, EPISODE_LENGTH, 4, 2, SEED)
        goals = MazeMultiGoal().goals
        for ep in episodes:
            ep["goal"] = rng.uniform(-0.3, 0.3, (rows, 2)).astype(np.float32)
            ep["g"] = np.repeat(goals[rng.randint(len(goals))][None], rows, 0)
        return episodes
    episodes = synthetic_episodes(EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED)
    for ep in episodes:
        if name == "aps":
            task = rng.randn(cfg.sf_dim).astype(np.float32)
            ep["task"] = np.repeat((task / np.linalg.norm(task))[None], rows, 0)
        elif name == "new_aps":
            z = rng.randn(cfg.z_dim).astype(np.float32)
            ep["z"] = np.repeat((z / np.linalg.norm(z))[None], rows, 0)
        elif name == "smm":
            ep["z"] = np.repeat(np.eye(cfg.z_dim, dtype=np.float32)[rng.randint(cfg.z_dim)][None],
                                rows, 0)
    return episodes


def check_item13_agents(fb_rate: float) -> None:
    """Phase 26: the last seven agents at the JAX defaults (hidden 1024,
    batch 1024, float32; Proto's 2,048-row queue) and NEWAPS with
    ``future_ratio=0.5``, ITEM13_UPDATES each captured against eager on a
    twin, to the bit."""
    card = card_name_and_power_limit()
    out = []
    for label in ITEM13_AGENTS:
        name = label.split(" ")[0]
        cfg_cls, agent_cls = agent_classes(name)
        maze = name in MAZE_AGENTS
        cfg = cfg_cls(**({"goal_space": MAZE_GOAL_SPACE} if maze else {}),
                      **({"future_ratio": 0.5} if "future_ratio" in label else {}))
        buf = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cuda")
        buf.load_episodes(item13_episodes(name, cfg, maze))
        buf.cfg = dataclasses.replace(buf.cfg, nstep=int(getattr(cfg, "nstep", 1)))
        obs_dim, action_dim = (4, 2) if maze else (OBS_DIM, ACTION_DIM)
        goal_dim = 2 if maze else None
        result = check_captured_agent(
            "phase 26", label, lambda: agent_cls(cfg, obs_dim, action_dim, goal_dim=goal_dim,
                                                 device="cuda", seed=SEED),
            cfg, buf, fb_rate, card, updates=ITEM13_UPDATES, bitwise_only=True)
        if ("future_ratio" in label) != (result["graphs"] == 2):
            raise AssertionError(f"{label}: {result['graphs']} captured graphs")
        out.append(result)
        del buf
        gc.collect()
        torch.cuda.empty_cache()
    print("phase 26 summary: captured updates/s " + ", ".join(
        f"{r['label']} {r['captured']:.1f} (eager {r['eager']:.1f}; {r['launches']:.0f} "
        f"launches, {r['busy_ms']:.3f} ms, peak {r['peak_mib']:.0f} MiB)" for r in out)
        + f"; all equal to eager to the bit; FB in phase 4 {fb_rate:.1f}; on {card}")


def item13_args(agent: str, folder: str, frames: int, *extra: str,
                envs: int = ONLINE_ENVS) -> tp.List[str]:
    """Phases 27 and 28: ``pretrain`` at the JAX defaults, ``envs``
    environments, episodes of ``SHORT_LENGTH`` steps, a seed cycle, no
    evaluation."""
    return [f"agent={agent}", f"num_envs={envs}", f"episode_length={SHORT_LENGTH}",
            f"num_seed_frames={envs * SHORT_LENGTH}", f"num_train_frames={frames}",
            "eval_every_steps=0", f"folder={folder}", f"seed={SEED}", *extra]


def meta_changes(ws: tp.Any, key: str) -> tp.Tuple[int, int, torch.Tensor]:
    """Where the replay's ``key`` column changes between steps: (changes,
    step boundaries, the steps at which it changed). Index i of an episode
    holds the meta of step i - 1."""
    column = ws.buffer.state.storage[key][:len(ws.buffer)]
    changed = (column[:, 1:] != column[:, :-1]).any(-1)
    return int(changed.sum()), changed.numel(), changed.nonzero()[:, 1]


def run_item13_explorers(tmp: str) -> None:
    """Phase 27: ``pretrain`` with APS, NEWAPS, SMM and Proto on
    ``walker_walk`` at full width, a seed cycle and a training cycle each;
    the meta resampled in the captured collector; NEWAPS's final battery;
    Proto resumed from its folder, its queue with it."""
    card = card_name_and_power_limit()
    cycle = ITEM13_ENVS * SHORT_LENGTH
    frames = 2 * cycle
    updates = cycle // 2
    for agent in ITEM13_EXPLORERS:
        folder = f"{tmp}/{agent}"
        tests = [f"final_tests={FINAL_TESTS}"] if agent == "new_aps" else ["final_tests=0"]
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ws, wall = _timed(lambda: pretrain.main(item13_args(agent, folder, frames,
                                                            "task=walker_walk", *tests,
                                                            envs=ITEM13_ENVS)))
        peak = torch.cuda.max_memory_allocated() - held
        cycles = report_cycles(ws, f"phase 27 {agent}")
        row = ws.last_row
        captures = ws.online_trainer.trainer.captures
        collector = ws.online_trainer.collector
        meta = ""
        ok = captures == 1 and ws.agent.step == updates and collector._program is not None \
            and all(math.isfinite(v) for v in row.values())
        every = {"aps": getattr(ws.agent.cfg, "update_task_every_step", 0),
                 "smm": getattr(ws.agent.cfg, "update_skill_every_step", 0)}.get(agent)
        if every:
            key = "task" if agent == "aps" else "z"
            n, boundaries, where = meta_changes(ws, key)
            at_multiples = bool((where % every == 0).all())
            meta = (f"; the {key} column changed at {n} of {boundaries} step boundaries, all "
                    f"at multiples of {every} {at_multiples}")
            ok = ok and n > 0 and at_multiples
        if agent == "new_aps":
            written = check_test_rewards(ws)
            meta = "; test_rewards.json mean returns " + ", ".join(
                f"{t} {np.mean(written[t]):.2f}" for t in WALKER_TASKS)
        if agent == "proto":
            queue = ws.agent.queue
            meta = (f"; the queue {tuple(queue.shape)} finite "
                    f"{bool(torch.isfinite(queue).all())}, rows written "
                    f"{int((queue != 0).any(1).sum())}, pointer {int(ws.agent.queue_ptr)}")
            ok = ok and bool(torch.isfinite(queue).all()) and bool((queue != 0).any(1).all())
        losses = ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                           if k.endswith("loss") or "reward" in k)
        print(f"phase 27 pretrain agent={agent}: a seed cycle and a cycle of {ws.agent.step} "
              f"updates in {wall:.1f} s; the update captured {captures} time(s), the collector "
              f"captured {collector._program is not None}; training cycle "
              f"{cycles[-1]['updates_per_s']:.1f} updates/s, collection "
              f"{cycles[-1]['share']:.4f} of it; peak device memory {peak / 2**20:.1f} MiB "
              f"above the {held / 2**20:.1f} held; {losses}{meta}, on {card}")
        if not ok:
            raise AssertionError(f"the {agent} run: captures {captures}, step {ws.agent.step}, "
                                 f"{row}{meta}")
        if agent == "proto":
            args = item13_args(agent, folder, frames + cycle, "task=walker_walk",
                               "final_tests=0", envs=ITEM13_ENVS)
            resumed = pretrain.build_workspace(args)
            same = torch.equal(resumed.agent.queue, ws.agent.queue) \
                and int(resumed.agent.queue_ptr) == int(ws.agent.queue_ptr) \
                and resumed.agent.step == ws.agent.step
            _, wall = _timed(resumed.train)
            print(f"phase 27 proto resumed: the queue, its pointer and the agent's step as "
                  f"saved {same}; continued from step {frames} to {resumed.global_step}, agent "
                  f"step {ws.agent.step} -> {resumed.agent.step} in {wall:.1f} s")
            if not same or resumed.global_step != frames + cycle \
                    or resumed.agent.step != 2 * updates:
                raise AssertionError("the resumed Proto run did not continue the saved one")
            del resumed
        del ws
        gc.collect()
        torch.cuda.empty_cache()


def run_item13_goal_agents(tmp: str) -> None:
    """Phase 28: ``pretrain`` with UVF, GoalTD3 and GoalSM on the point-mass
    maze with the 20-goal ``maze_multi_goal`` battery, a seed cycle, a
    training cycle and ``finalize()``; ``train_offline agent=goal_td3`` on
    the GoalTD3 run's replay."""
    card = card_name_and_power_limit()
    frames = 2 * SHORT_CYCLE
    maze = ["task=point_mass_maze_reach_top_left", f"goal_space={MAZE_GOAL_SPACE}",
            "custom_reward=maze_multi_goal", "final_tests=2"]

    def sweep(ws: tp.Any, what: str) -> None:
        rewards = json.loads((ws.work_dir / "test_rewards.json").read_text())["rewards"]
        evals = read_csv(ws.work_dir / "eval.csv")
        _, final_s = _timed(ws.finalize)
        print(f"{what}: the 20-goal sweep (finalize(), 20 goals x 2 episodes x "
              f"{ws.spec.episode_length} steps in one batch, {final_s:.3f} s when run again): "
              f"reward {rewards[0]:.4f}, distance {float(evals[-1]['distance']):.4f}, on {card}")
        if len(rewards) != 1 or not (math.isfinite(rewards[0]) and 0.0 <= rewards[0] <= 1.0):
            raise AssertionError(f"{what}: bad test_rewards.json {rewards}")

    for agent in MAZE_AGENTS:
        ws, wall = _timed(lambda: pretrain.main(item13_args(agent, f"{tmp}/{agent}", frames,
                                                            *maze)))
        cycles = report_cycles(ws, f"phase 28 {agent}")
        row = ws.last_row
        captures = ws.online_trainer.trainer.captures
        key = ws.agent.meta_key  # UVF's z, the goal agents' g
        meta = ws.buffer.state.storage[key][:len(ws.buffer)]
        zeros = bool((meta == 0).all())
        print(f"phase 28 pretrain agent={agent}: a seed cycle and a cycle of {ws.agent.step} "
              f"updates in {wall:.1f} s, finalize() included; the update captured {captures} "
              f"time(s); training cycle {cycles[-1]['updates_per_s']:.1f} updates/s, "
              f"collection {cycles[-1]['share']:.4f} of it; the {key} column "
              f"{tuple(meta.shape)}, all zeros {zeros} (GoalSM's init_meta is zeros); "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items() if "loss" in k))
        if captures != 1 or ws.agent.step != SHORT_CYCLE // 2 or zeros != (agent == "goal_sm") \
                or not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"the {agent} run: captures {captures}, step {ws.agent.step}, "
                                 f"g zeros {zeros}, {row}")
        sweep(ws, f"phase 28 {agent}")
        del ws
        gc.collect()
        torch.cuda.empty_cache()

    offline, wall = _timed(lambda: train_offline.main([
        "agent=goal_td3", *maze, f"load_replay={tmp}/goal_td3/models/latest",
        f"num_grad_steps={MAZE_OFFLINE_UPDATES}", f"steps_per_call={STEPS_PER_CALL}",
        f"log_every_steps={STEPS_PER_CALL}", "eval_every_steps=0", "checkpoint_every=0",
        f"folder={tmp}/goal_td3_offline", f"seed={SEED}"]))
    windows = [float(r["fps"]) for r in read_csv(offline.work_dir / "train.csv")]
    print(f"phase 28 train_offline agent=goal_td3 on that replay ({len(offline.buffer)} "
          f"episodes, relabeled for point_mass_maze_reach_top_left): {offline.global_step} "
          f"updates in {wall:.1f} s; updates/s by window " + ", ".join(f"{w:.1f}" for w in windows)
          + f"; batch_reward {offline.last_row['batch_reward']:.4f}")
    if offline.global_step != MAZE_OFFLINE_UPDATES or offline.agent.step != MAZE_OFFLINE_UPDATES \
            or not all(math.isfinite(v) for v in offline.last_row.values()):
        raise AssertionError(f"the offline GoalTD3 run: {offline.last_row}")
    sweep(offline, "phase 28 train_offline agent=goal_td3")


def write_d4rl_dataset(path: str) -> tp.Dict[str, np.ndarray]:
    """Phase 29's dataset: halfcheetah-medium-v2's shape (1,000 episodes of
    1,000 rows, a timeout on every 1,000th row, observations of 17, actions
    of 6), drawn from the seed."""
    rng = np.random.RandomState(SEED)
    n = D4RL_EPISODES * D4RL_ROWS
    timeouts = np.zeros(n, bool)
    timeouts[D4RL_ROWS - 1::D4RL_ROWS] = True
    dataset = {"observations": rng.randn(n, D4RL_OBS).astype(np.float32),
               "actions": rng.uniform(-1, 1, (n, D4RL_ACTION)).astype(np.float32),
               "rewards": (4.0 + rng.randn(n)).astype(np.float32),
               "terminals": np.zeros(n, bool), "timeouts": timeouts}
    np.savez(path, **dataset)
    return dataset


def check_d4rl_score(ws: tp.Any, dataset: tp.Dict[str, np.ndarray], row: tp.Dict[str, str],
                     what: str) -> float:
    """The ``normalized_score`` of an ``eval.csv`` row against d4rl's score,
    on the host, of the stored returns of the episodes its resets drew."""
    episodes = ws._rollouts[EVAL_EPISODES]._state.episode.cpu().numpy()
    rewards = dataset["rewards"].astype(np.float64).reshape(D4RL_EPISODES, D4RL_ROWS)
    returns = rewards[episodes, :D4RL_ROWS - 1].sum(1)  # an episode's last row has no reward
    want = float(np.mean([normalized_score(D4RL_DOMAIN, r) for r in returns]))
    got = float(row["normalized_score"])
    print(f"phase 29 {what}: normalized_score {got:.6f} in eval.csv, {want:.6f} from the "
          f"dataset's returns of the episodes the resets drew ({sorted(episodes.tolist())})")
    if not (math.isfinite(got) and abs(got - want) <= 1e-5 * max(1.0, abs(want))):
        raise AssertionError(f"{what}: normalized_score {got} against {want} on the host")
    return got


def run_d4rl(tmp: str) -> tp.Tuple[tp.Dict[str, int], tp.Any]:
    """Phase 29: ``train_offline task=d4rl_halfcheetah`` at full width."""
    card = card_name_and_power_limit()
    path = f"{tmp}/d4rl_halfcheetah.npz"
    dataset, write_s = _timed(lambda: write_d4rl_dataset(path))
    print(f"phase 29 dataset: {D4RL_EPISODES} x {D4RL_ROWS} rows of halfcheetah-medium-v2's "
          f"shape (observations {D4RL_OBS}, actions {D4RL_ACTION}) written in {write_s:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    ff.reset_launches()
    profiles = f"{tmp}/d4rl_profile"
    ws, wall = _timed(lambda: train_offline.main([
        f"task=d4rl_{D4RL_DOMAIN}", f"d4rl_dataset={path}", "agent=fb_ddpg",
        "agent.use_pallas_loss=true", "agent.compute_dtype=bfloat16",
        f"num_grad_steps={D4RL_STEPS}", f"steps_per_call={STEPS_PER_CALL}",
        f"log_every_steps={STEPS_PER_CALL}", f"eval_every_steps={D4RL_STEPS}",
        f"num_eval_episodes={EVAL_EPISODES}", "checkpoint_every=0", "final_tests=0",
        "save_eval_video=false", f"replay_buffer_episodes={D4RL_EPISODES}",
        f"num_seed_frames={D4RL_SEED_FRAMES}", f"profile_dir={profiles}",
        f"folder={tmp}/d4rl", f"seed={SEED}"]))
    counts, ran = dict(ff.launches), ff.device_runs()
    peak = torch.cuda.max_memory_allocated()
    # three captures: the first call's, the profiled (traced) call's, the next call's
    expected = D4RL_STEPS + 3 * WARMUP_RUNS
    print(f"phase 29 train_offline task=d4rl_{D4RL_DOMAIN}: {len(ws.buffer)} episodes of "
          f"{ws.buffer.state.max_episode_length} transitions in the replay, {ws.global_step} "
          f"updates as replays of one captured graph in {wall:.1f} s (the load, the capture, "
          f"an evaluation and z's inference included); fused launches {counts} by the "
          f"wrappers' counts, {ran} by the kernels' own (expected {expected} each); "
          f"{ws.last_row['fps']:.1f} updates/s over the last {STEPS_PER_CALL}; peak device "
          f"memory {peak / 2**20:.1f} MiB; on {card}")
    if len(ws.buffer) != D4RL_EPISODES or ws.buffer.state.max_episode_length != D4RL_ROWS - 1 \
            or ws.spec.obs_dim != D4RL_OBS or ws.global_step != D4RL_STEPS \
            or any(c != expected for c in counts.values()) or ran != counts \
            or not all(math.isfinite(v) for v in ws.last_row.values()):
        raise AssertionError(f"the d4rl run: {len(ws.buffer)} episodes, {counts}, {ran}, "
                             f"{ws.last_row}")
    evals = read_csv(ws.work_dir / "eval.csv")
    if [int(float(r["step"])) for r in evals] != [D4RL_STEPS]:
        raise AssertionError(f"expected one evaluation at step {D4RL_STEPS}: {evals}")
    check_d4rl_score(ws, dataset, evals[-1], "the run's evaluation")
    metrics, eval_s = _timed(ws.evaluate)
    print(f"phase 29 evaluate(): {EVAL_EPISODES} episodes x {ws.spec.episode_length} replayed "
          f"steps in {eval_s:.3f} s ({EVAL_EPISODES * ws.spec.episode_length / eval_s:.0f} "
          f"environment steps/s), episode_reward {metrics['episode_reward']:.2f}, on {card}")
    check_d4rl_score(ws, dataset, read_csv(ws.work_dir / "eval.csv")[-1], "a second evaluation")

    traces = sorted(Path(profiles).iterdir())
    text = traces[0].read_text() if len(traces) == 1 else ""
    found = {part: text.count(part) for parts in KERNEL_NAMES.values() for part in parts}
    spans = {name: text.count(f'"{name}"') for name in ("sample", "update", "optimizer",
                                                         "graph_replay")}
    marks = text.count('"trace_begin_')
    print(f"phase 29 profile_dir: {[t.name for t in traces]}, {len(text) / 1e6:.1f} MB; "
          f"mentions of the fused kernels: {found}; of the program's spans: {spans}; "
          f"begin marks on the device: {marks}")
    if len(traces) != 1 or traces[0].name != f"trace_{D4RL_SEED_FRAMES}.json" \
            or not all(found.values()) or not all(spans.values()) or not marks:
        raise AssertionError("expected one Chrome trace of the cycle after the seed frames, "
                             "with the fused kernels, the program's spans and its marks in it")

    env, agent, gen = ws.env, ws.agent, torch.Generator(device="cuda").manual_seed(SEED)
    state, ts = env.reset(gen, EVAL_EPISODES)
    captured = Rollout(env, agent, EVAL_EPISODES)
    eager = Rollout(env, agent, EVAL_EPISODES, capture=False)
    got = [x.clone() for x in captured(ws.inferred_z, state, ts)]
    want = eager(ws.inferred_z, state, ts)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"phase 29 replay environment: {EVAL_EPISODES} episodes x {env.spec.episode_length} "
          f"steps, the captured control step against eager: equal to the bit {bitwise}")
    if not bitwise:
        raise AssertionError("the d4rl replay's captured control step differs from eager")
    return counts, ws


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _profile_updates(trainer: tp.Any, buf: tp.Any, gen: torch.Generator
                     ) -> tp.Tuple[int, int, int]:
    """Kernels per update, NCCL kernels and device-to-device copies in
    PROFILE_STEPS replayed updates."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer(buf.state, gen, steps=PROFILE_STEPS)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = sum("nccl" in e.name.lower() for e in kernels)
    copies = sum("memcpy dtod" in e.name.lower() for e in kernels)
    return len(kernels), nccl, copies


def check_data_parallel(tmp: str, episodes_dir: str) -> tp.Dict[str, tp.Dict[str, int]]:
    """Phase 30: a one-process NCCL group on the card; the fused kernels'
    launches of each path, by path."""
    card = card_name_and_power_limit()
    by_path: tp.Dict[str, tp.Dict[str, int]] = {}
    cfg = FBDDPGConfig(use_pallas_loss=True, compute_dtype="bfloat16")
    buf = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cuda")
    buf.load_episodes(synthetic_episodes(EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED))
    if not multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda"):
        raise AssertionError("no process group was started")
    try:
        group = make_group()
        print(f"phase 30 group: backend {dist.get_backend(group)}, world size "
              f"{dist.get_world_size(group)}")
        plain_agent, dp_agent = (FBDDPGAgent(cfg, OBS_DIM, ACTION_DIM, device="cuda", seed=SEED)
                                 for _ in range(2))
        plain = make_offline_trainer(plain_agent, buf.cfg, cfg.batch_size, DP_UPDATES)
        dp = make_dp_offline_trainer(dp_agent, buf.cfg, cfg.batch_size, DP_UPDATES, group)
        plain_gen, dp_gen = (torch.Generator(device="cuda").manual_seed(SEED) for _ in range(2))
        want = {k: v.clone() for k, v in plain(buf.state, plain_gen).items()}
        ff.reset_launches()
        got = dp(buf.state, dp_gen)
        torch.cuda.synchronize()
        counts, ran = dict(ff.launches), ff.device_runs()
        by_path["data-parallel update, 1 process (phase 30)"] = counts
        states = plain_agent.train_state(), dp_agent.train_state()
        bitwise = all(torch.equal(states[1][k], v) for k, v in states[0].items()) \
            and all(torch.equal(got[k], v) for k, v in want.items()) \
            and torch.equal(plain_gen.get_state(), dp_gen.get_state())
        print(f"phase 30 data-parallel update: {DP_UPDATES} captured updates through a one-process "
              f"NCCL group against the plain captured trainer from the same state, batches and "
              f"noise: equal to the bit {bitwise}; captures {dp.captures}; fused launches "
              f"{counts} by the wrappers' counts, {ran} by the kernels' own")
        if not bitwise or dp.captures != 1 or ran != counts \
                or any(c != DP_UPDATES + WARMUP_RUNS for c in counts.values()):
            raise AssertionError("the data-parallel update at world size 1 differs from the plain")

        seen = {name: _profile_updates(t, buf, g)
                for name, t, g in (("plain", plain, plain_gen), ("dp", dp, dp_gen))}
        for name, (kernels, nccl, copies) in seen.items():
            print(f"phase 30 profile {name}: {PROFILE_STEPS} replayed updates, "
                  f"{kernels / PROFILE_STEPS:.1f} kernels per update, {nccl} NCCL kernels, "
                  f"{copies / PROFILE_STEPS:.1f} device-to-device copies per update")
        extra_copies = (seen["dp"][2] - seen["plain"][2]) / PROFILE_STEPS
        if seen["dp"][1] == 0 and extra_copies < DP_GATHERS:
            raise AssertionError("the replays of the data-parallel update show no collective")

        rates: tp.Dict[str, tp.List[float]] = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain"):
            trainer, gen = (plain, plain_gen) if name == "plain" else (dp, dp_gen)
            _, seconds = _timed(lambda: trainer(buf.state, gen, steps=DP_TIMED))
            rates[name].append(DP_TIMED / seconds)
        print(f"phase 30 updates/s, {DP_TIMED} captured updates a turn (plain, dp, dp, plain): "
              f"plain {', '.join(f'{r:.1f}' for r in rates['plain'])}, data-parallel "
              f"{', '.join(f'{r:.1f}' for r in rates['dp'])}, on {card}")
        del plain, dp, plain_agent, dp_agent
        gc.collect()  # the graphs that hold the group's collectives go before the group
        torch.cuda.synchronize()
    finally:
        multihost.shutdown()

    torch.cuda.reset_peak_memory_stats()
    ff.reset_launches()
    folder = f"{tmp}/multihost"
    ws, wall = _timed(lambda: train_multihost.main([
        f"coordinator=127.0.0.1:{_free_port()}", "num_processes=1", "process_id=0",
        *slice_args(folder, episodes_dir), f"num_grad_steps={MH_STEPS}",
        f"eval_every_steps={MH_STEPS}", f"checkpoint_every={MH_STEPS}", "final_tests=0"]))
    counts, ran = dict(ff.launches), ff.device_runs()
    by_path["train_multihost, 1 process (phase 30)"] = counts
    evals = read_csv(ws.work_dir / "eval.csv")
    meta = json.loads((ws.work_dir / "models" / "latest" / "meta.json").read_text())
    trainer = ws.mh_trainer
    print(f"phase 30 train_multihost: one NCCL process, {len(ws.buffer)} episodes (its shard), "
          f"{ws.global_step} updates in {wall:.1f} s (the load, relabeling, the capture, an "
          f"evaluation and the checkpoint included), {ws.last_row['fps']:.1f} updates/s over the "
          f"last {STEPS_PER_CALL}; group world size {trainer.shard.world}, captures "
          f"{trainer.captures}; evaluations at {[int(float(r['step'])) for r in evals]}, "
          f"episode_reward {float(evals[-1]['episode_reward']):.2f}; checkpoint at step "
          f"{meta['global_step']}; fused launches {counts}, {ran} by the kernels' own; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, on {card}")
    if trainer.group is None or trainer.captures != 1 or meta["global_step"] != MH_STEPS \
            or [int(float(r["step"])) for r in evals] != [MH_STEPS] or ran != counts \
            or any(c != MH_STEPS + WARMUP_RUNS for c in counts.values()) \
            or dist.is_initialized():
        raise AssertionError(f"train_multihost: {counts}, {ran}, {meta}, {evals}")
    del ws, trainer

    if not multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda"):
        raise AssertionError("no process group was started")
    try:
        env = make_env("walker_walk")
        agent = FBDDPGAgent(cfg, OBS_DIM, ACTION_DIM, device="cuda", seed=SEED)
        buffer = ReplayBuffer(4 * ONLINE_ENVS, discount=0.98, future=0.99, device="cuda")
        online = OnlineTrainer(env, agent, buffer, num_envs=ONLINE_ENVS,
                               updates_per_step=DP_ONLINE_UPDATES / CYCLE_STEPS,
                               group=make_group())
        ff.reset_launches()
        metrics, seconds = _timed(lambda: online.run_cycle(
            torch.Generator(device="cuda").manual_seed(SEED),
            torch.Generator(device="cuda").manual_seed(SEED + 1)))
        counts, ran = dict(ff.launches), ff.device_runs()
        by_path["online cycle with a group, 1 process (phase 30)"] = counts
        timing = online.timings
        print(f"phase 30 online cycle with the group: walker_walk, {ONLINE_ENVS} x "
              f"{EPISODE_LENGTH} steps collected in {timing['collect']:.3f} s, "
              f"{len(buffer)} episodes committed, {timing['updates']} data-parallel updates in "
              f"{timing['update']:.3f} s (the captures included), {seconds:.1f} s in all; "
              f"fb_loss {metrics.get('fb_loss', float('nan')):.4f}, episode_reward "
              f"{metrics['episode_reward']:.2f}; fused launches {counts}, {ran} by the "
              f"kernels' own, on {card}")
        if len(buffer) != ONLINE_ENVS or ran != counts \
                or any(c != DP_ONLINE_UPDATES + WARMUP_RUNS for c in counts.values()) \
                or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"the online cycle with a group: {metrics}, {counts}, {ran}")
        del online
        gc.collect()
        torch.cuda.synchronize()
    finally:
        multihost.shutdown()
    return by_path


def check_dp_agents(tmp: str, episodes_dir: str) -> None:
    """Phase 32: the data-parallel update of each agent of DP_AGENTS at world
    size 1 against its plain update, captured, and ``train_multihost.main
    agent=rnd`` with one NCCL process."""
    card = card_name_and_power_limit()
    walker = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cuda")
    walker.load_episodes(synthetic_episodes(EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED))
    grid = grid_buffer()
    if not multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda"):
        raise AssertionError("no process group was started")
    summary = []
    try:
        group = make_group()
        print(f"phase 32 group: backend {dist.get_backend(group)}, world size "
              f"{dist.get_world_size(group)}")
        for name, overrides in DP_AGENTS:
            label = " ".join([name] + [f"{k}={v}" for k, v in overrides.items()])
            cfg_cls, agent_cls = agent_classes(name)
            cfg = cfg_cls(**overrides)
            discrete = name.startswith("discrete_")
            buf = grid if discrete else walker
            sample_cfg = dataclasses.replace(buf.cfg, nstep=int(getattr(cfg, "nstep", 1)))
            dims = (2, 5) if discrete else (OBS_DIM, ACTION_DIM)
            plain_agent, dp_agent = (agent_cls(cfg, *dims, device="cuda", seed=SEED)
                                     for _ in range(2))
            plain = make_offline_trainer(plain_agent, sample_cfg, cfg.batch_size,
                                         DP_AGENT_UPDATES)
            dp = make_dp_offline_trainer(dp_agent, sample_cfg, cfg.batch_size, DP_AGENT_UPDATES,
                                         group)
            plain_gen, dp_gen = (torch.Generator(device="cuda").manual_seed(SEED)
                                 for _ in range(2))
            want = {k: v.clone() for k, v in plain(buf.state, plain_gen).items()}
            got = dp(buf.state, dp_gen)
            torch.cuda.synchronize()
            states = plain_agent.train_state(), dp_agent.train_state()
            bitwise = set(got) == set(want) \
                and all(torch.equal(states[1][k], v) for k, v in states[0].items()) \
                and all(torch.equal(got[k], v) for k, v in want.items()) \
                and torch.equal(plain_gen.get_state(), dp_gen.get_state())
            graphs = len(dp._program.graphs) if dp._program is not None else 0
            rates: tp.Dict[str, tp.List[float]] = {"plain": [], "dp": []}
            for turn in ("plain", "dp", "dp", "plain"):
                trainer, gen = (plain, plain_gen) if turn == "plain" else (dp, dp_gen)
                _, seconds = _timed(lambda: trainer(buf.state, gen, steps=DP_AGENT_TIMED))
                rates[turn].append(DP_AGENT_TIMED / seconds)
            overhead = 1.0 - np.mean(rates["dp"]) / np.mean(rates["plain"])
            print(f"phase 32 {label}: {DP_AGENT_UPDATES} captured data-parallel updates through "
                  f"a one-process NCCL group against the plain captured trainer from the same "
                  f"state, batches and noise: equal to the bit {bitwise}; captures "
                  f"{dp.captures} ({graphs} graph(s) per update); updates/s, "
                  f"{DP_AGENT_TIMED} a turn (plain, dp, dp, plain): plain "
                  f"{', '.join(f'{r:.1f}' for r in rates['plain'])}, data-parallel "
                  f"{', '.join(f'{r:.1f}' for r in rates['dp'])} (overhead {overhead:.3f}), "
                  f"on {card}")
            expect_graphs = 2 if overrides.get("future_ratio") or overrides.get("mix_ratio") \
                or overrides.get("q_loss") else 1
            if not bitwise or dp.captures != 1 or graphs != expect_graphs \
                    or not all(math.isfinite(float(v)) for v in got.values()):
                raise AssertionError(f"{label}: the data-parallel update at world size 1 "
                                     f"differs from the plain one")
            summary.append(f"{label} {np.mean(rates['dp']):.1f} (plain "
                           f"{np.mean(rates['plain']):.1f})")
            del plain, dp, plain_agent, dp_agent, states
            gc.collect()  # the graphs that hold the group's collectives go before the group
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
    finally:
        multihost.shutdown()
    print(f"phase 32 summary: data-parallel updates/s at world size 1 "
          f"{'; '.join(summary)}; all equal to the plain update to the bit; on {card}")
    del walker, grid

    folder = f"{tmp}/multihost_rnd"
    ws, wall = _timed(lambda: train_multihost.main([
        f"coordinator=127.0.0.1:{_free_port()}", "num_processes=1", "process_id=0",
        f"replay_dir={episodes_dir}", "task=walker_walk", "relabel=true", "agent=rnd",
        f"num_grad_steps={MH_STEPS}", f"steps_per_call={STEPS_PER_CALL}",
        f"log_every_steps={STEPS_PER_CALL}", f"eval_every_steps={MH_STEPS}",
        f"num_eval_episodes={EVAL_EPISODES}", f"checkpoint_every={MH_STEPS}",
        "final_tests=0", "save_eval_video=false", f"replay_buffer_episodes={EPISODES}",
        f"folder={folder}", f"seed={SEED}"]))
    evals = read_csv(ws.work_dir / "eval.csv")
    meta = json.loads((ws.work_dir / "models" / "latest" / "meta.json").read_text())
    trainer = ws.mh_trainer
    row = ws.last_row
    print(f"phase 32 train_multihost agent=rnd: one NCCL process, {len(ws.buffer)} episodes, "
          f"{ws.agent.step} updates in {wall:.1f} s (the load, relabeling, the capture, an "
          f"evaluation and the checkpoint included), {row['fps']:.1f} updates/s over the last "
          f"{STEPS_PER_CALL}; group world size {trainer.shard.world}, captures "
          f"{trainer.captures}; evaluations at {[int(float(r['step'])) for r in evals]}, "
          f"episode_reward {float(evals[-1]['episode_reward']):.2f}; checkpoint at step "
          f"{meta['global_step']}; rnd_loss {row['rnd_loss']:.4f}, intr_reward "
          f"{row['intr_reward']:.4f}, on {card}")
    if trainer.group is None or trainer.captures != 1 or ws.agent.step != MH_STEPS \
            or meta["global_step"] != MH_STEPS \
            or [int(float(r["step"])) for r in evals] != [MH_STEPS] \
            or not all(math.isfinite(v) for v in row.values()) or dist.is_initialized():
        raise AssertionError(f"train_multihost agent=rnd: {row}, {meta}, {evals}")
    del ws, trainer


def _get(url: str) -> tp.Tuple[int, str, bytes, float]:
    """(status, content type, body, ms) of a GET answered in full."""
    started = time.perf_counter()
    with urllib.request.urlopen(url, timeout=300) as response:
        body = response.read()
        return (response.status, response.headers.get("Content-Type"), body,
                1e3 * (time.perf_counter() - started))


def serve_requests(tmp: str) -> None:
    """The demo over a real socket: the engine built from phase 4's folder,
    SERVE_EQUATIONS answered with rollouts and videos, an injection refused,
    the video served; each rollout held to an eager one to the bit."""
    started = time.perf_counter()
    engine = serve._build_engine(f"{tmp}/run", "cuda", SERVE_ROWS)
    print(f"phase 31 demo: the engine restored phase 4's folder in "
          f"{time.perf_counter() - started:.2f} s; feature names {engine.feature_names}")
    httpd = serve.make_server(engine, 0, "127.0.0.1", f"{tmp}/demo_videos")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    card = card_name_and_power_limit()
    try:
        for equation in SERVE_EQUATIONS:
            status, _, body, request_ms = _get(f"{base}/run?equation="
                                               + urllib.parse.quote(equation))
            page = body.decode()
            found = re.search(r"reward: (\S+) over (\d+) steps", page)
            if status != 200 or found is None or "/video?name=rollout.gif" not in page:
                raise AssertionError(f"bad answer to {equation!r}: {status} {page[-400:]}")
            steps = int(found.group(2))
            timings, rollout = dict(engine.timings), engine._rollouts[SERVE_STEPS]
            reward = float(rollout.rewards[0, :steps].double().sum())
            # the served rollout's first steps against an eager rollout of the same z
            # from the same reset
            z = engine.infer_z(equation)
            eager = Rollout(engine.ws.env, engine.ws.agent, 1, capture=False,
                            horizon=SERVE_COMPARED)
            eager({"z": z}, *engine.last_reset)
            bitwise = (torch.equal(eager.physics, rollout.physics[:, :SERVE_COMPARED])
                       and torch.equal(eager.rewards, rollout.rewards[:, :SERVE_COMPARED]))
            norm = float(torch.linalg.vector_norm(z))
            capture = (None if rollout.capture_seconds is None
                       else f"{1e3 * rollout.capture_seconds:.1f} ms")
            first = ("; precompute of B and the features on "
                     f"{SERVE_ROWS} rows {timings['precompute_ms']:.1f} ms, the rollout's "
                     f"capture {capture} (in the rollout's)" if "precompute_ms" in timings else "")
            print(f"phase 31 demo: {equation!r} answered in {request_ms:.1f} ms over the socket "
                  f"(z inference {timings['infer_ms']:.2f} ms, rollout of {SERVE_STEPS} steps "
                  f"{timings['rollout_ms']:.1f} ms, video encoding {timings['video_ms']:.1f} ms"
                  f"{first}); {steps} steps, reward {reward:.4f}, |z| {norm:.5f}; captured "
                  f"equal to eager to the bit over the first {SERVE_COMPARED} steps {bitwise}; "
                  f"on {card}")
            if not (bitwise and steps <= SERVE_STEPS and math.isfinite(reward)
                    and abs(norm - math.sqrt(engine.ws.agent.cfg.z_dim)) < 1e-3):
                raise AssertionError(f"bad demo rollout for {equation!r}")
        status, _, body, request_ms = _get(f"{base}/run?equation="
                                           + urllib.parse.quote(SERVE_INJECTION))
        page = body.decode()
        print(f"phase 31 demo: {SERVE_INJECTION!r} answered {status} in {request_ms:.1f} ms, "
              f"refused in red: {'color:red' in page and 'not allowed' in page}")
        if status != 200 or "<p style='color:red'>" not in page or "not allowed" not in page:
            raise AssertionError(f"the injection was not refused: {page[-400:]}")
        status, kind, body, request_ms = _get(f"{base}/video?name=rollout.gif")
        print(f"phase 31 demo: /video?name=rollout.gif {status} {kind}, {len(body)} bytes in "
              f"{request_ms:.1f} ms")
        if status != 200 or kind != "image/png" or body[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("the rollout's video was not served")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the demo server did not stop")


def check_serving(tmp: str) -> None:
    """Phase 31: the demo, play_behaviors, export_replay, the offline
    EntryPoint and hiplogs on phase 4's folder."""
    folder = f"{tmp}/run"
    serve_requests(tmp)

    started = time.perf_counter()
    export_replay.main([f"checkpoint={folder}/models/latest", f"out_dir={tmp}/exported"])
    seconds = time.perf_counter() - started
    replay = ckpt_lib.load_checkpoint(Path(folder, "models", "latest"), only=["replay"],
                                      device="cuda")["replay"]
    episodes = list(load_exorl_episodes(Path(tmp, "exported")))
    lengths = replay.ep_lengths.tolist()
    same = len(episodes) == replay.n_episodes and all(
        set(ep) == set(replay.storage) and all(
            np.array_equal(ep[k], v[i, :lengths[i] + 1].cpu().numpy())
            for k, v in replay.storage.items()) for i, ep in enumerate(episodes))
    print(f"phase 31 export_replay: {len(episodes)} episodes in {seconds:.2f} s, read back "
          f"equal to the replay to the bit for {sorted(replay.storage)}: {same}")
    if not same:
        raise AssertionError("the exported episodes differ from the replay")

    # the offline EntryPoint on a copy of phase 4's config, checkpoint and replay,
    # with the plain loss (no fused kernel runs on this phase)
    entry = f"{tmp}/entry"
    shutil.copytree(Path(folder, "models", "latest"), Path(entry, "models", "latest"))
    shutil.copy(Path(folder, "config.json"), Path(entry, "config.json"))
    start = json.loads(Path(entry, "models", "latest", "meta.json").read_text())["global_step"]
    started = time.perf_counter()
    result = EntryPoint("offline")(
        folder=entry, num_grad_steps=start + ENTRY_UPDATES, eval_every_steps=ENTRY_UPDATES,
        final_tests=0, **{"agent.use_pallas_loss": "false"})
    seconds = time.perf_counter() - started
    evals = read_csv(Path(entry, "eval.csv"))
    print(f"phase 31 EntryPoint('offline'): {ENTRY_UPDATES} captured updates from step "
          f"{start} and {len(evals)} evaluation in {seconds:.2f} s; returned {result}, the "
          f"evaluation's return {evals[-1]['episode_reward'] if evals else None}")
    if len(evals) != 1 or result != -float(evals[0]["episode_reward"]):
        raise AssertionError(f"EntryPoint returned {result} for evaluations {evals}")

    records = {r["xp"]: r for r in hiplogs.aggregate_tree(tmp)}
    points = {name: len(hiplogs.HipLog(Path(d, "hip.log")).to_experiment(step=1).datapoints)
              for name, d in (("phase 4", folder), ("EntryPoint", entry))}
    print(f"phase 31 hiplogs: {len(records)} runs under the phase's folder, datapoints "
          f"{points}; eval_episode_reward_last of phase 4's "
          f"{records.get(folder, {}).get('eval_episode_reward_last')} and the EntryPoint's "
          f"{records.get(entry, {}).get('eval_episode_reward_last')}")
    if not (all(points.values()) and "eval_episode_reward_last" in records.get(folder, {})
            and "eval_episode_reward_last" in records.get(entry, {})):
        raise AssertionError("hiplogs did not read both runs")

    started = time.perf_counter()
    # last: a workspace with an override saves it into the folder's config.json
    summary = play_behaviors.main([f"folder={folder}", "play_task=walker_run",
                                   f"num_episodes={PLAY_EPISODES}",
                                   f"episode_length={PLAY_LENGTH}"])
    seconds = time.perf_counter() - started
    written = json.loads(Path(folder, "play_rewards.json").read_text())
    videos = sorted(p.name for p in Path(folder, "eval_video").glob("play_*.png"))
    print(f"phase 31 play_behaviors: {PLAY_EPISODES} episodes x {PLAY_LENGTH} steps of "
          f"walker_run's z in {seconds:.2f} s (videos included), returns "
          + ", ".join(f"{r:.2f}" for r in written["rewards"]) + f", videos {videos}")
    if written != summary or len(written["rewards"]) != PLAY_EPISODES \
            or not all(math.isfinite(r) for r in written["rewards"]) \
            or videos != [f"play_{i}.png" for i in range(PLAY_EPISODES)]:
        raise AssertionError(f"bad play_behaviors output: {written}, {videos}")


def mujoco_walker_episodes(n: int, seed: int) -> tp.List[tp.Dict[str, np.ndarray]]:
    """Episodes in dm_control walker's layout: normal observations (24),
    uniform actions (6), MuJoCo physics [qpos, qvel] (18) near the standing
    pose (qpos = [rootz, rootx, rooty, six joints], the 1.3 m torso offset in
    the model), uniform rewards, discount 1; float32, as the collector saves."""
    rng = np.random.RandomState(seed)
    t = EPISODE_LENGTH + 1
    episodes = []
    for _ in range(n):
        qpos = np.concatenate([rng.uniform(-0.1, 0.05, (t, 1)), rng.uniform(-1, 1, (t, 1)),
                               rng.uniform(-0.3, 0.3, (t, 1)), rng.uniform(-0.5, 0.5, (t, 6))],
                              -1)
        episodes.append({
            "observation": rng.randn(t, OBS_DIM).astype(np.float32),
            "action": rng.uniform(-1, 1, (t, ACTION_DIM)).astype(np.float32),
            "reward": rng.rand(t, 1).astype(np.float32),
            "discount": np.ones((t, 1), np.float32),
            "physics": np.concatenate([qpos, rng.randn(t, 9)], -1).astype(np.float32)})
    return episodes


def _timed_acts(act: tp.Callable[[int], np.ndarray]) -> tp.Tuple[np.ndarray, float]:
    """MJ_ACTS calls of ``act(i)`` (each returns on the host, so the last
    waited for the card); what they returned and the ms per call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    actions = np.stack([act(i) for i in range(MJ_ACTS)])
    return actions, 1e3 * (time.perf_counter() - t0) / MJ_ACTS


def _check_actions(what: str, actions: np.ndarray) -> None:
    if actions.shape != (MJ_ACTS, ACTION_DIM) or not np.isfinite(actions).all() \
            or np.abs(actions).max() > 1.0:
        raise AssertionError(f"{what}: bad actions {actions.shape}, "
                             f"max |a| {np.abs(actions).max()}")


def check_mujoco_collector(tmp: str, card: str) -> Path:
    """Phase 33 (a): the collector's device half at RND's defaults; returns
    the directory its episodes were written to."""
    spec = EnvSpec(obs_dim=OBS_DIM, action_dim=ACTION_DIM, physics_dim=PHYSICS_DIM,
                   episode_length=EPISODE_LENGTH)
    collector = collect_mujoco_buffer.Collector(
        "rnd", spec, MJ_EPISODES, batch_size=RNDConfig().batch_size,
        random_episodes=MJ_EPISODES, seed=SEED, device="cuda")
    episodes = mujoco_walker_episodes(MJ_EPISODES, SEED)
    out = Path(tmp) / "mujoco_episodes"
    out.mkdir()
    for i, episode in enumerate(episodes):
        np.savez(out / f"episode_{i:06d}_{EPISODE_LENGTH}.npz", **episode)
        collector.add_episode(episode)
    rates, metrics = [], {}
    for _ in range(MJ_BURSTS):
        metrics, seconds = _timed(lambda: collector.train(1))
        rates.append(collect_mujoco_buffer.UPDATES_PER_CALL / seconds)
    cfg = collector.agent.cfg
    print(f"phase 33 (a) collector: RND (hidden {cfg.hidden_dim}, rep {cfg.rnd_rep_dim}, batch "
          f"{cfg.batch_size}, n-step {collector.buffer.cfg.nstep}) on {MJ_EPISODES} episodes "
          f"of dm_control walker's layout: {MJ_BURSTS} bursts of "
          f"{collect_mujoco_buffer.UPDATES_PER_CALL} updates, {collector.trainer.captures} "
          f"capture(s); updates/s by burst (the first with its capture) "
          + ", ".join(f"{r:.1f}" for r in rates) + f"; on {card}")
    if collector.trainer.captures != 1 or collector.agent.step != MJ_BURSTS * 100 \
            or collector.buffer.cfg.nstep != cfg.nstep \
            or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"the collector's bursts: {collector.trainer.captures} captures, "
                             f"step {collector.agent.step}, {metrics}")
    obs = episodes[0]["observation"]
    step = MJ_EPISODES * EPISODE_LENGTH  # past num_expl_steps: the policy's own actions
    collector.refresh_policy()

    def act(i: int) -> np.ndarray:
        if i == MJ_ACTS // 2:
            collector.refresh_policy()
        return collector.act(obs[i], step + i)

    actions, ms = _timed_acts(act)
    _check_actions("the collector's policy", actions)
    print(f"phase 33 (a) collector: {MJ_ACTS} acts of the exploration policy at obs width "
          f"{OBS_DIM} (one observation up, one action down; one refresh of the acting copy "
          f"among them) {ms:.4f} ms per act; on {card}")
    return out


def run_mujoco_offline(tmp: str, episodes_dir: Path, card: str) -> tp.Dict[str, int]:
    """Phase 33 (b): ``train_offline physics_format=mujoco_walker`` on (a)'s
    episodes at the JAX FB defaults, bf16, the fused loss."""
    ff.reset_launches()
    ws, wall = _timed(lambda: train_offline.main([
        f"replay_dir={episodes_dir}", "physics_format=mujoco_walker", "task=walker_walk",
        "relabel=true", "agent=fb_ddpg", "agent.use_pallas_loss=true",
        "agent.compute_dtype=bfloat16", f"num_grad_steps={MJ_OFFLINE_STEPS}",
        f"steps_per_call={STEPS_PER_CALL}", f"log_every_steps={STEPS_PER_CALL}",
        "eval_every_steps=0", "checkpoint_every=0", "final_tests=0", "save_eval_video=false",
        f"replay_buffer_episodes={MJ_EPISODES}", f"folder={tmp}/mujoco_run", f"seed={SEED}"]))
    counts, ran = dict(ff.launches), ff.device_runs()
    expected = MJ_OFFLINE_STEPS + WARMUP_RUNS
    print(f"phase 33 (b) train_offline physics_format=mujoco_walker: {len(ws.buffer)} "
          f"episodes, observations recomputed from the adapted physics, relabeled for "
          f"walker_walk; {ws.global_step} updates as replays of one captured graph in "
          f"{wall:.1f} s (the load and the capture included), {ws.last_row['fps']:.1f} "
          f"updates/s over the last {STEPS_PER_CALL}; fused launches {counts} by the "
          f"wrappers' counts, {ran} by the kernels' own (expected {expected} each); on {card}")
    if len(ws.buffer) != MJ_EPISODES or ws.global_step != MJ_OFFLINE_STEPS \
            or any(c != expected for c in counts.values()) or ran != counts \
            or not all(math.isfinite(v) for v in ws.last_row.values()):
        raise AssertionError(f"the mujoco_walker run: {counts}, {ran}, {ws.last_row}")
    return counts


def check_mujoco_evaluator(tmp: str, episodes_dir: Path, card: str) -> None:
    """Phase 33 (c) and (d): the evaluator's device half on (b)'s folder, and
    the host loops where dm_control is installed."""
    evaluator = eval_mujoco.Evaluator.build([f"folder={tmp}/mujoco_run"], "cuda")
    loaded = evaluator.load_episodes(episodes_dir, MJ_EPISODES)
    ws = evaluator.ws
    if ws.global_step != MJ_OFFLINE_STEPS or loaded != MJ_EPISODES:
        raise AssertionError(f"the evaluator's workspace: step {ws.global_step}, {loaded} "
                             f"episodes")
    states = np.load(episodes_dir / f"episode_000000_{EPISODE_LENGTH}.npz")["physics"]
    z_dim = ws.agent.cfg.z_dim
    zs = {}
    for task in MJ_TASKS:
        (z, coherence), z_s = _timed(lambda: evaluator.infer_z(
            get_reward_function(task, ws.cfg.seed)))
        act = evaluator.make_act(z)
        _, obs_ms = _timed_acts(lambda i: evaluator.obs_from_state(states[i]))
        actions, ms = _timed_acts(lambda i: act(evaluator.obs_from_state(states[i])))
        _check_actions(f"the evaluator's policy on {task}", actions)
        again = act(evaluator.obs_from_state(states[0]))
        print(f"phase 33 (c) evaluator {task}: z from {evaluator.z_draws} draws of "
              f"{ws.agent.cfg.num_inference_steps} samples in {1e3 * z_s:.1f} ms, coherence "
              f"{coherence:.4f}, |z| {float(z.norm()):.4f}; {MJ_ACTS} acts from adapted MuJoCo "
              f"states (the observation on the host, the policy on the card) {ms:.4f} ms per "
              f"act, of which the observation alone {obs_ms:.4f} ms; the same action again for the same state {np.array_equal(again, actions[0])}"
              f"; on {card}")
        if not (bool(torch.isfinite(z).all()) and math.isclose(float(z.norm()), math.sqrt(z_dim),
                                                               rel_tol=1e-4)
                and 0.0 < coherence <= 1.0 + 1e-6 and np.array_equal(again, actions[0])):
            raise AssertionError(f"{task}: z {z}, coherence {coherence}")
        zs[task] = z
    if importlib.util.find_spec("dm_control") is None:
        print("phase 33 (d): dm_control is not installed on this machine "
              "(importlib.util.find_spec): the host loops are held on the CPU by "
              "tests/test_torch_collect_mujoco.py and tests/test_torch_eval_mujoco.py")
        return
    mujoco_host_loops(tmp, evaluator, zs, card)


def mujoco_host_loops(tmp: str, evaluator: tp.Any, zs: tp.Dict[str, torch.Tensor],
                      card: str) -> None:
    """Phase 33 (d): the collector's host loop over real dm_control episodes
    (one random, then the policy's), and the evaluator's rollouts."""
    env = mujoco_bridge.make_env("walker_stand", seed=SEED)
    ts = env.reset()
    spec = EnvSpec(obs_dim=collect_mujoco_buffer.flat_obs(ts).shape[0],
                   action_dim=int(np.prod(env.action_spec().shape)),
                   physics_dim=mujoco_bridge.mj_state(env).shape[0],
                   episode_length=EPISODE_LENGTH)
    collector = collect_mujoco_buffer.Collector("rnd", spec, MJ_HOST_EPISODES,
                                                batch_size=RNDConfig().batch_size,
                                                random_episodes=1, seed=SEED,
                                                device=evaluator.ws.device)
    seconds, wall = _timed(lambda: collect_mujoco_buffer.collect(
        env, collector, Path(tmp) / "host_episodes", MJ_HOST_EPISODES, random_episodes=1,
        updates_per_episode=500, policy_refresh_every=1, seed=SEED))
    written = sorted((Path(tmp) / "host_episodes").glob("*.npz"))
    print(f"phase 33 (d) collector on dm_control walker_stand: {len(written)} episodes of "
          f"{EPISODE_LENGTH} steps in {wall:.1f} s (" + ", ".join(
              f"{part} {t:.1f} s" for part, t in seconds.items())
          + f"); {collector.updates} updates; on {card}")
    if len(written) != MJ_HOST_EPISODES or len(collector.buffer) != MJ_HOST_EPISODES:
        raise AssertionError(f"the host collector wrote {len(written)} episodes")
    for task, z in zs.items():
        returns, wall = _timed(lambda: evaluator.returns(
            mujoco_bridge.make_env(task, seed=SEED), z, MJ_HOST_EVAL_EPISODES, EPISODE_LENGTH))
        print(f"phase 33 (d) evaluator on dm_control {task}: returns "
              f"{[round(r, 2) for r in returns]} in {wall:.1f} s; on {card}")
        if len(returns) != MJ_HOST_EVAL_EPISODES or not all(
                math.isfinite(r) and 0.0 <= r <= EPISODE_LENGTH for r in returns):
            raise AssertionError(f"{task}: returns {returns}")


def check_mujoco_tools(tmp: str) -> tp.Dict[str, int]:
    """Phase 33: the dm_control tools' device halves; the fused launches of (b)."""
    card = card_name_and_power_limit()
    episodes_dir = check_mujoco_collector(tmp, card)
    gc.collect()
    torch.cuda.empty_cache()
    counts = run_mujoco_offline(tmp, episodes_dir, card)
    gc.collect()
    torch.cuda.empty_cache()
    check_mujoco_evaluator(tmp, episodes_dir, card)
    return counts


def run_recipe(tmp: str) -> tp.Dict[str, int]:
    """Phase 35: ``tools/online_curve.py``'s recipe mode on ``results/quad_one``,
    cut to ``RECIPE_CYCLES`` cycles and a battery of ``RECIPE_FINAL_TESTS``
    episodes per task; returns the run's fused launches."""
    card = card_name_and_power_limit()
    stored = json.loads((RECIPE / "config.json").read_text())
    cycle = stored["num_rollout_episodes"] * EPISODE_LENGTH
    frames = RECIPE_CYCLES * cycle
    folder = Path(tmp) / "recipe"
    cuts = [f"num_train_frames={frames}", f"final_tests={RECIPE_FINAL_TESTS}"]
    reset_optimizer_launches()
    rc, wall = _timed(lambda: online_curve.main([
        f"recipe={RECIPE}", "entry=train_online", f"folder={folder}", *cuts]))
    if rc != 0:
        raise AssertionError(f"online_curve recipe={RECIPE} returned {rc}")
    saved = json.loads((folder / "config.json").read_text())
    cut = {c.split("=")[0] for c in cuts}
    differ = {k: (v, saved.get(k)) for k, v in stored.items() if saved.get(k) != v
              and k not in set(online_curve.RECIPE_REPLACED) | cut}
    if differ or not saved["agent.use_pallas_loss"] or saved["agent.compute_dtype"] != \
            "bfloat16" or saved["checkpoint_every"] <= stored["num_train_frames"] \
            or saved["num_train_frames"] != frames or saved["final_tests"] != RECIPE_FINAL_TESTS:
        raise AssertionError(f"the recipe resolved to {saved}; stored keys that differ: {differ}")
    check = json.loads((folder / "check.json").read_text())
    counts, runs = check["launches"], check["device_runs"]
    updates = RECIPE_CYCLES * stored["num_agent_updates"]
    print(f"phase 35 online_curve recipe=results/quad_one entry=train_online, {RECIPE_CYCLES} "
          f"cycles of {cycle} frames: {check['frames']} frames, {check['updates']} updates in "
          f"{check['seconds']:.1f} s of run ({wall:.1f} s with the records), collection "
          f"{check['collection_share']:.4f} of a cycle; fused launches {counts} by the "
          f"wrappers' counts, {runs} by the kernels' own; battery "
          + ", ".join(f"{t} {r['port_mean']:.1f} ({r['verdict']})"
                      for t, r in check["battery"].items()) + f"; on {card}")
    if check["frames"] != frames or check["updates"] != updates or runs != counts \
            or not check["launches_equal"] \
            or any(c != updates + WARMUP_RUNS for c in counts.values()) \
            or list(check["battery"]) != list(QUAD_BATTERY) \
            or not all(r["verdict"] in ("inside", "outside") for r in check["battery"].values()) \
            or (folder / "models").exists():
        raise AssertionError(f"phase 35: {check}")
    check_optimizer_launches(35, updates, "online_curve recipe=results/quad_one (phase 35)")
    return counts


# the optimizer kernels' launches by main path (phases 4 and 35), for the kernels line
OPTIMIZER_LAUNCHES: tp.Dict[str, tp.Dict[str, int]] = {}


def reset_optimizer_launches() -> None:
    """Zero ``optim.launches`` and the refresh kernel's count
    (``bf16_copy.refreshes``)."""
    optim.reset_launches()
    trace.counters["bf16_copy.refreshes"] = 0


def check_optimizer_launches(phase: int, updates: int, path: str) -> None:
    """The optimizer kernels' launches of a FB run of ``updates`` captured
    updates since ``reset_optimizer_launches()``: 3 Adam steps and 2
    soft-updates each, the capture's warm-up runs included; kept by path,
    with the refresh kernel's launches (set-up only: none is expected in a
    replay, and their number is the run's own)."""
    runs = updates + WARMUP_RUNS
    expected = {"adam": 3 * runs, "lerp": 2 * runs}
    cast = trace.counters["bf16_copy.refreshes"]
    print(f"phase {phase} optimizer launches {dict(optim.launches)} by optim.launches "
          f"(expected {expected}: {updates} updates + {WARMUP_RUNS} warm-up runs); "
          f"bf16_copy_refresh_kernel {cast} by bf16_copy.refreshes")
    if optim.launches != expected:
        raise AssertionError(f"phase {phase}: optimizer launches {optim.launches}, "
                             f"expected {expected}")
    OPTIMIZER_LAUNCHES[path] = {**expected, "cast": cast}


def time_optimizer() -> tp.Dict[str, tp.Dict[str, float]]:
    """Phase 36: the optimizer layer of one full-width FB update (bf16 mu,
    bf16 networks: the Linear gradients bf16, the copies written with the
    parameters): the forward, backward and actor Adam steps and the two
    soft-updates, fused (``Adam.step``, ``soft_update``) and by _foreach
    (``adam_plain`` on the widened gradients, ``lerp_plain``, each then
    casting the copies): three updates of each from one state equal to the
    bit, copies included; the fused launches of a call by
    ``optim.launches``; device ms per call in one CUDA graph each, in turns,
    and per step, beside the bound of the bytes at 3.35 TB/s. Returns, for
    each kernel, the summed ms of its calls in one update by kernel and by
    _foreach and their bound; for the refresh kernel, one refresh of the
    agent's copies."""
    agent = FBDDPGAgent(FBDDPGConfig(use_pallas_loss=True, compute_dtype="bfloat16"),
                        OBS_DIM, ACTION_DIM, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    opts = {"fw_opt": agent.fw_opt, "bw_opt": agent.bw_opt, "actor_opt": agent.actor_opt}
    # the gradients as an update hands them over: bf16 for a parameter with a copy
    grads = {name: [(1e-3 * torch.randn(leaf.shape, device="cuda", generator=gen)).to(leaf.dtype)
                    for leaf in opt.leaves] for name, opt in opts.items()}
    pairs = {"forward": (agent.forward_net, agent.target_forward_net),
             "backward": (agent.backward_net, agent.target_backward_net)}
    tau = agent.cfg.fb_target_tau

    def copies(opt: tp.Any) -> tp.List[tp.Tuple[torch.Tensor, torch.Tensor]]:
        """(parameter, its copy) of each parameter of ``opt`` that has one."""
        return [(p, leaf) for p, leaf in zip(opt.params.values(), opt.leaves) if leaf is not p]

    def target_copies(target: tp.Any) -> tp.List[tp.Tuple[torch.Tensor, torch.Tensor]]:
        params = list(target.parameters())
        return [(c.param, c.copy) for c in optim.copies_of(target, params) if c is not None]

    def adam_plain(opt: tp.Any, g: tp.Sequence[torch.Tensor]) -> None:
        optim.adam_plain(list(opt.params.values()), [x.float() for x in g],
                         list(opt.mu.values()), list(opt.nu.values()), opt.count_t, opt.lr,
                         opt.b1, opt.b2, opt.eps)
        params, held = zip(*copies(opt))
        optim.cast_plain(held, params)

    def lerp_plain(net: tp.Any, target: tp.Any, w: float) -> None:
        optim.lerp_plain(list(target.parameters()), list(net.parameters()), w)
        params, held = zip(*target_copies(target))
        optim.cast_plain(held, params)

    steps = {"fused": (lambda opt, g: opt.step(g), soft_update),
             "plain": (adam_plain, lerp_plain)}

    def update(way: str) -> tp.Callable[[], None]:
        adam_step, lerp_step = steps[way]

        def run() -> None:
            with torch.no_grad():
                for name, opt in opts.items():
                    adam_step(opt, grads[name])
                for net, target in pairs.values():
                    lerp_step(net, target, tau)
        return run

    held_copies = [c for opt in opts.values() for _, c in copies(opt)] + [
        c for _, target in pairs.values() for _, c in target_copies(target)]
    state = [*agent.train_state().values()]
    saved = [t.clone() for t in state]
    results = {}
    for way in steps:
        with torch.no_grad():
            for t, before in zip(state, saved):
                t.copy_(before)
        for _ in range(3):
            update(way)()
        torch.cuda.synchronize()
        results[way] = [t.clone() for t in state + held_copies]
    names = list(agent.train_state()) + [f"copy {i}" for i in range(len(held_copies))]
    differ = [n for n, a, b in zip(names, results["fused"], results["plain"])
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"phase 36: fused and plain differ after 3 updates in {differ}")
    print("phase 36: fused and plain equal to the bit after 3 updates "
          f"({len(state)} tensors of the train state, {len(held_copies)} bf16 copies)")

    # the wrappers' counts, not a profiler: a profiler session over these
    # graphs saw none of the fused kernels (PERF.md, kernel table)
    before = dict(optim.launches)
    update("fused")()
    launched = {k: optim.launches[k] - before[k] for k in before}
    print(f"phase 36 launches per call: fused {launched} by optim.launches")
    if launched != {"adam": 3, "lerp": 2}:
        raise AssertionError(f"phase 36: expected 3 Adam and 2 lerp launches, counted {launched}")

    # bytes each needs: Adam reads p, g, mu, nu and writes p, mu, nu and the
    # copy once; a soft-update reads both nets and writes the target and its copy
    def adam_bytes(opt: tp.Any) -> int:
        mu_bytes = next(iter(opt.mu.values())).element_size()
        return sum(p.numel() * (4 + g.element_size() + 2 * mu_bytes + 4 + 4 + 4)
                   for p, g in zip(opt.params.values(), opt.leaves)) + sum(
                       2 * c.numel() for _, c in copies(opt))

    least = {name: adam_bytes(opt) for name, opt in opts.items()}
    least.update({name: 12 * sum(p.numel() for p in target.parameters())
                  + 2 * sum(c.numel() for _, c in target_copies(target))
                  for name, (_, target) in pairs.items()})
    total = sum(least.values())
    order = ["plain", "fused", "fused", "plain"]
    times: tp.Dict[str, tp.List[float]] = {way: [] for way in steps}
    for way in order:
        times[way].append(time_ms(update(way), calls=10))
    bound_ms = 1e3 * total / HBM_BYTES_PER_S
    best = {way: min(ts) for way, ts in times.items()}
    print(f"phase 36 one update's optimizer layer (3 Adam steps, 2 soft-updates; "
          f"{total / 1e6:.1f} MB): " + ", ".join(
              f"{way} {'/'.join(f'{t:.5f}' for t in ts)} ms" for way, ts in times.items())
          + f" (CUDA graph, in turns {order}); bound {bound_ms:.5f} ms (bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); fused {best['fused'] / bound_ms:.2f}x the "
          f"bound, {best['plain'] / best['fused']:.2f}x faster than plain")
    rows = {kernel: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0} for kernel in ("adam", "lerp")}
    for name, nbytes in least.items():
        if name in opts:
            opt, g = opts[name], grads[name]
            one = {"fused": lambda: opt.step(g), "plain": lambda: adam_plain(opt, g)}
        else:
            net, target = pairs[name]
            one = {"fused": lambda: soft_update(net, target, tau),
                   "plain": lambda: lerp_plain(net, target, tau)}
        with torch.no_grad():
            ms, plain_ms = time_ms(one["fused"], calls=20), time_ms(one["plain"], calls=20)
        least_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        turns = f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms"
        print(f"phase 36 {name}: {turns} (CUDA graph); {nbytes / 1e6:.2f} MB, bound "
              f"{least_ms:.5f} ms; {ms / least_ms:.2f}x the bound, "
              f"{1e-6 * nbytes / ms:.0f} GB/s")
        row = rows["adam" if name in opts else "lerp"]
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += least_ms
    rows["cast"] = time_refresh(agent)
    print(f"phase 36 card: {card_name_and_power_limit()}")
    return rows


def time_refresh(agent: tp.Any) -> tp.Dict[str, float]:
    """Phase 36's refresh: every parameter of the full-width FB agent
    written, so all its bf16 copies are stale; ``Bf16Copy.refresh`` over
    them (``optim.cast_``: one launch of ``bf16_copy_refresh_kernel`` by
    ``bf16_copy.refreshes``) equal to ``cast_plain`` on the same parameters
    to the bit; then ``cast_`` and ``cast_plain`` timed in CUDA graphs, in
    turns, beside the bound of 6 B an element (read 4, write 2) at 3.35
    TB/s."""
    held = [c for m in agent.modules() if isinstance(m, Dense) for c in m.bf16 or ()]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 36)
    with torch.no_grad():
        for c in held:
            c.param.add_(1e-3 * torch.randn(c.param.shape, device="cuda", generator=gen))
    if not held or not all(c.stale() for c in held):
        raise AssertionError(f"phase 36: {len(held)} copies, not all stale after the write")
    copies, params = [c.copy for c in held], [c.param for c in held]
    want = [torch.empty_like(x) for x in copies]
    optim.cast_plain(want, params)
    before = trace.counters["bf16_copy.refreshes"]
    optim.Bf16Copy.refresh(held)
    launched = trace.counters["bf16_copy.refreshes"] - before
    torch.cuda.synchronize()
    differ = [i for i, (a, b) in enumerate(zip(copies, want)) if not torch.equal(a, b)]
    parts = len(optim.plan(len(held), optim._max_tensors("cast")))
    print(f"phase 36 refresh: {len(held)} stale copies, {launched} launch(es) of "
          f"bf16_copy_refresh_kernel by bf16_copy.refreshes (plan: {parts}); "
          f"{len(held) - len(differ)} of {len(held)} equal to cast_plain to the bit")
    if differ or launched != parts or any(c.stale() for c in held):
        raise AssertionError(f"phase 36: refresh differs in copies {differ}, launched "
                             f"{launched} for {parts}, stale after it "
                             f"{sum(c.stale() for c in held)}")
    elements = sum(p.numel() for p in params)
    least_ms = 1e3 * 6 * elements / HBM_BYTES_PER_S
    order = ["plain", "kernel", "kernel", "plain"]
    ways = {"kernel": lambda: optim.cast_(copies, params),
            "plain": lambda: optim.cast_plain(copies, params)}
    times: tp.Dict[str, tp.List[float]] = {way: [] for way in ways}
    for way in order:
        times[way].append(time_ms(ways[way], calls=20))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    print(f"phase 36 refresh of {len(held)} copies ({elements} elements, "
          f"{6 * elements / 1e6:.2f} MB): " + ", ".join(
              f"{way} {'/'.join(f'{t:.5f}' for t in ts)} ms" for way, ts in times.items())
          + f" (CUDA graph, in turns {order}); bound {least_ms:.5f} ms; "
          f"{ms / least_ms:.2f}x the bound, {plain_ms / ms:.2f}x faster than plain")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": least_ms}


def optimizer_rows(times: tp.Dict[str, tp.Dict[str, float]],
                   launches: tp.Dict[str, tp.Dict[str, int]]) -> tp.List[tp.Dict[str, tp.Any]]:
    """The ``kernels`` line's rows of the optimizer kernels: phase 36's
    times (one FB update's calls; one refresh of the agent's copies), the
    launches of phases 4 and 35 (the main path: the last of them that
    ran)."""
    source = "controllable_agent_torch/csrc/fused_optim.cu"
    note = ("one FB update's calls (3 Adam steps; 2 soft-updates; the refresh: one of the "
            "agent's 56 copies), 20 calls a CUDA graph on the same tensors: a set under the "
            "50 MB L2 partly stays there")
    rows = []
    for key, name, kernel, wrapper, library in (
            ("adam", "adam (bf16 mu)", "adam_multi_tensor_apply_kernel", "optim.adam", None),
            ("lerp", "lerp (soft-update)", "lerp_multi_tensor_apply_kernel", "optim.lerp_",
             "torch._foreach_lerp_"),
            ("cast", "bf16 copy refresh", "bf16_copy_refresh_kernel", "optim.cast_",
             "Tensor.copy_")):
        t = times[key]
        by_path = {path: counts[key] for path, counts in launches.items() if key in counts}
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": ("none (XLA's casts of the weights at each use)" if key == "cast"
                                  else "none (optax's Adam and the target updates, left to XLA)"),
                     "launches": list(by_path.values())[-1] if by_path else None,
                     "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": "bytes",
                     "library_ms": t["plain_ms"] if library else None, "wrapper": wrapper,
                     "kernel": kernel, "launches_by_path": by_path, "note": note})
    return rows


def measure_fb_rate() -> float:
    """FB's captured updates/s at phase 4's geometry (bf16, the fused loss,
    batch 1024) on its episodes, for a selection of phases without phase 4:
    the rate that phases 14, 18, 24-26 print beside their own."""
    cfg = FBDDPGConfig(use_pallas_loss=True, compute_dtype="bfloat16")
    buf = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cuda")
    buf.load_episodes(synthetic_episodes(EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED))
    agent = FBDDPGAgent(cfg, OBS_DIM, ACTION_DIM, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    trainer = make_offline_trainer(agent, buf.cfg, cfg.batch_size, STEPS_PER_CALL)
    trainer(buf.state, gen)  # the capture
    torch.cuda.synchronize()
    _, seconds = _timed(lambda: trainer(buf.state, gen))
    rate = STEPS_PER_CALL / seconds
    print(f"fb_rate: FB's captured trainer at phase 4's geometry {rate:.1f} updates/s over "
          f"{STEPS_PER_CALL} updates (phase 4 not selected), on {card_name_and_power_limit()}")
    return rate


def quad_replay(tmp: str) -> None:
    """Phase 21's replay for a selection of phases without phase 21: one
    cycle of ``train_online`` on the quadruped, collected without updates."""
    train_online.main(quad_args(
        f"{tmp}/quad", "task=quadruped_stand", "goal_space=quad_pos_speed",
        f"episode_length={SHORT_LENGTH}", f"num_rollout_episodes={ONLINE_ENVS}",
        "num_agent_updates=0", f"num_train_frames={SHORT_CYCLE}", "eval_every_steps=0",
        "final_tests=0",
        f"replay_buffer_episodes={QUAD_REPLAY_EPISODES}"))


def parse_phases(argv: tp.Sequence[str]) -> tp.List[int]:
    """``--phases 26-28`` or ``--phases 4,11,21`` (ranges and lists mixed);
    every phase without the option. A range steps over a removed phase; a
    selection that names one (alone or as a range's end) is refused."""
    if not argv:
        return [p for p in range(1, LAST_PHASE + 1) if p not in REMOVED_PHASES]
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit(f"usage: python3 chip_smoke.py [--phases 1-{LAST_PHASE} | 4,11,21]")
    phases = set()
    for part in argv[1].split(","):
        lo, _, hi = part.partition("-")
        named = {int(lo), int(hi or lo)} & REMOVED_PHASES.keys()
        if named:
            raise SystemExit(REMOVED_PHASES[min(named)])
        phases.update(range(int(lo), int(hi or lo) + 1))
    if not phases or min(phases) < 1 or max(phases) > LAST_PHASE:
        raise SystemExit(f"phases are numbered 1 to {LAST_PHASE}, got {argv[1]}")
    return sorted((phases - REMOVED_PHASES.keys()) | {1})  # the kernels build for every selection


class SmokeRun:
    """The selected phases in order. What a phase reads from an earlier one
    is built on first use, by that phase when it is selected and by the
    least that gives it otherwise: phase 4's workspace (phases 5-11) and
    folder (31), its episodes on disk (15, 30, 32), FB's updates/s (14, 18, 24-26), phase 2's errors
    (5), phase 12's FB agent (13), phase 15's workspaces (16) and phase
    21's replay (22). Each phase prints its seconds."""

    def __init__(self, tmp: str, phases: tp.Sequence[int]) -> None:
        self.tmp, self.phases = tmp, set(phases)
        self.rows: tp.Optional[tp.List[tp.Dict[str, tp.Any]]] = None  # the kernels line
        self._errors: tp.Optional[tp.Dict[str, float]] = None
        self._slice: tp.Optional[tp.Tuple[tp.Dict[str, int], tp.Any]] = None
        self._fb_rate: tp.Optional[float] = None
        self._episodes = False
        self._sf_runs: tp.Optional[tp.Dict[str, tp.Any]] = None

    def timed(self, phase: int, fn: tp.Callable[[], tp.Any]) -> tp.Any:
        out, seconds = _timed(fn)
        print(f"phase {phase} seconds: {seconds:.1f}")
        return out

    def errors(self) -> tp.Dict[str, float]:
        if self._errors is None:
            def phase2() -> tp.Dict[str, float]:
                errors = check_kernels(N)
                check_kernels(N_RAGGED)
                return errors
            self._errors = self.timed(2, phase2)
        return self._errors

    def slice(self) -> tp.Tuple[tp.Dict[str, int], tp.Any]:
        if self._slice is None:
            self._slice = self.timed(4, lambda: run_slice(self.tmp))
            self._episodes = True
            self._fb_rate = self._slice[1].last_row["fps"]
        return self._slice

    def fb_rate(self) -> float:
        if self._fb_rate is None:
            self._fb_rate = measure_fb_rate()
        return self._fb_rate

    def episodes_dir(self) -> str:
        if not self._episodes:
            write_slice_episodes(self.tmp)
            self._episodes = True
        return f"{self.tmp}/episodes"

    def sf_runs(self) -> tp.Dict[str, tp.Any]:
        if self._sf_runs is None:
            self._sf_runs = run_sf_entry_points(self.tmp)
        return self._sf_runs

    def by_path(self, path: str, counts: tp.Dict[str, int]) -> None:
        for row in self.rows or []:
            row["launches_by_path"][path] = counts[row["wrapper"]]

    def zero_launches(self, phases: tp.Sequence[int], path: str,
                      group: tp.Sequence[tp.Tuple[int, tp.Callable[[], tp.Any]]]) -> None:
        """The selected phases of a group that no fused FB kernel is on: the
        wrappers' counts and the kernels' own must stay 0 over them."""
        if not any(n in self.phases for n, _ in group):
            return
        ff.reset_launches()
        for n, fn in group:
            if n in self.phases:
                self.timed(n, fn)
        counts, runs = dict(ff.launches), ff.device_runs()
        print(f"phases {phases}: fused FB launches {counts} by the wrappers' counts, {runs} by "
              f"the kernels' own")
        if any(counts.values()) or any(runs.values()):
            raise AssertionError(f"phases {phases} launched fused FB kernels: {counts}, {runs}")
        self.by_path(path, counts)

    def run(self) -> None:
        tmp, selected = self.tmp, self.phases
        if 2 in selected:
            self.errors()
        if 3 in selected:
            self.timed(3, lambda: check_update(synthetic_episodes(
                EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED)))
        if selected & {4, 5, 6, 7, 9, 11, 31}:
            self.slice()  # phase 31 serves phase 4's folder
        if 5 in selected:
            errors, counts = self.errors(), self.slice()[0]
            self.rows = self.timed(5, lambda: time_kernels(errors, counts))
        for n, fn in ((6, lambda: profile_slice(self.slice()[1])),
                      (7, lambda: check_capture(self.slice()[1])),
                      (8, check_relabel),
                      (9, lambda: check_task_z_and_checkpoint(self.slice()[1], tmp)),
                      (10, check_dynamics),
                      (11, lambda: check_evaluation(self.slice()[1]))):
            if n in selected:
                self.timed(n, fn)
        if self._slice is not None:
            # free the offline workspace (its rollouts of up to 16,384 environments
            # included) so that the later phases' peak memory is their own
            self._slice = (self._slice[0], None)
            gc.collect()
            torch.cuda.empty_cache()
        if selected & {14, 18, 24, 25, 26}:
            self.fb_rate()  # before the groups whose fused launches must stay 0

        fb_agent = None
        if 12 in selected:
            # the online path: the kernels' launches of the online run
            online_counts, online_ws = self.timed(12, lambda: run_online(tmp))
            for row in self.rows or []:
                row["launches"] = online_counts[row["wrapper"]]
            self.by_path("pretrain (phase 12)", online_counts)
            fb_agent = online_ws.agent
            del online_ws
        if 13 in selected:
            if fb_agent is None:
                fb_agent = FBDDPGAgent(FBDDPGConfig(use_pallas_loss=True,
                                                    compute_dtype="bfloat16"),
                                       OBS_DIM, ACTION_DIM, device="cuda", seed=SEED)
            self.timed(13, lambda: check_online_paths(tmp, fb_agent))
        del fb_agent
        gc.collect()
        torch.cuda.empty_cache()

        if 16 in selected:
            selected.add(15)  # phase 16 reads phase 15's workspaces
        if 15 in selected:
            self.episodes_dir()
        self.zero_launches((14, 15, 16), "sf, sf_svd (phases 14-16)", (
            (14, lambda: check_sf_learners(synthetic_episodes(
                EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED), self.fb_rate())),
            (15, self.sf_runs),
            (16, lambda: check_sf_inference(self.sf_runs()["sf"], self.sf_runs()["sf_svd"]))))
        self._sf_runs = None
        self.zero_launches((17, 18, 19), "grid (phases 17-19)", (
            (17, check_gridworld), (18, lambda: check_discrete_agents(self.fb_rate())),
            (19, lambda: run_grid_entry_points(tmp))))

        if 20 in selected:
            self.timed(20, check_3d_engine)
            gc.collect()
            torch.cuda.empty_cache()
        if 21 in selected:
            quad_counts, quad_ws = self.timed(21, lambda: run_quadruped(tmp))
            for row in self.rows or []:
                row["launches"] = quad_counts[row["wrapper"]]
            self.by_path("quadruped train_online (phase 21)", quad_counts)
            del quad_ws
            gc.collect()
            torch.cuda.empty_cache()
        elif 22 in selected:
            quad_replay(tmp)
        if 22 in selected:
            ff.reset_launches()
            self.timed(22, lambda: run_quadruped_paths(tmp))
            other_counts, other_runs = dict(ff.launches), ff.device_runs()
            print(f"phase 22: fused FB launches {other_counts} by the wrappers' counts, "
                  f"{other_runs} by the kernels' own")
            if other_runs != other_counts or not all(other_counts.values()):
                raise AssertionError(f"phase 22's fused launches: {other_counts}, {other_runs}")
            self.by_path("jaco, quadruped train_offline, fetch, escape (phase 22)", other_counts)

        gc.collect()
        torch.cuda.empty_cache()
        self.zero_launches((23, 24, 25), "pixels, explorers (phases 23-25)", (
            (23, check_pixels), (24, lambda: run_pixels(tmp, self.fb_rate())),
            (25, lambda: check_explorers(tmp, synthetic_episodes(
                EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED), self.fb_rate()))))
        gc.collect()
        torch.cuda.empty_cache()
        self.zero_launches((26, 27, 28), "item-13 agents (phases 26-28)", (
            (26, lambda: check_item13_agents(self.fb_rate())),
            (27, lambda: run_item13_explorers(tmp)),
            (28, lambda: run_item13_goal_agents(tmp))))
        gc.collect()
        torch.cuda.empty_cache()
        if 29 in selected:
            # this slice's main path: the kernels' launches of the d4rl run
            d4rl_counts, d4rl_ws = self.timed(29, lambda: run_d4rl(tmp))
            for row in self.rows or []:
                row["launches"] = d4rl_counts[row["wrapper"]]
            self.by_path("train_offline task=d4rl_halfcheetah (phase 29)", d4rl_counts)
            del d4rl_ws
            gc.collect()
            torch.cuda.empty_cache()
        if 30 in selected:
            paths = self.timed(30, lambda: check_data_parallel(tmp, self.episodes_dir()))
            for path, counts in paths.items():
                self.by_path(path, counts)
        gc.collect()
        torch.cuda.empty_cache()
        self.zero_launches((31,), "serving (phase 31)", ((31, lambda: check_serving(tmp)),))
        gc.collect()
        torch.cuda.empty_cache()
        self.zero_launches((32,), "data-parallel agents (phase 32)", (
            (32, lambda: check_dp_agents(tmp, self.episodes_dir())),))
        gc.collect()
        torch.cuda.empty_cache()
        if 33 in selected:
            # this slice's main path: the kernels' launches of its train_offline leg
            mujoco_counts = self.timed(33, lambda: check_mujoco_tools(tmp))
            for row in self.rows or []:
                row["launches"] = mujoco_counts[row["wrapper"]]
            self.by_path("train_offline physics_format=mujoco_walker (phase 33)",
                         mujoco_counts)
        gc.collect()
        torch.cuda.empty_cache()
        if 35 in selected:
            # this slice's main path: the kernels' launches of the recipe's run
            recipe_counts = self.timed(35, lambda: run_recipe(tmp))
            for row in self.rows or []:
                row["launches"] = recipe_counts[row["wrapper"]]
            self.by_path("online_curve recipe=results/quad_one (phase 35)", recipe_counts)
            gc.collect()
            torch.cuda.empty_cache()
        if 36 in selected:
            times = self.timed(36, time_optimizer)
            self.rows = (self.rows or []) + optimizer_rows(times, OPTIMIZER_LAUNCHES)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # every float32 product under test runs in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    started = time.perf_counter()

    def build() -> None:
        seconds, logs = _build.build()
        for log in logs.values():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print("phase 1 ptxas:", line.strip())
        print(f"phase 1 build: {len(logs)} source(s) compiled in {seconds:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        run = SmokeRun(tmp, phases)
        run.timed(1, build)
        run.run()

    print(f"total: {time.perf_counter() - started:.1f} s for phases {phases}, the build included")
    if run.rows is not None:
        print(json.dumps({"kernels": run.rows}))
    print(f"card: {card_name_and_power_limit()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
