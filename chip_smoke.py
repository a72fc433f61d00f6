"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``controllable_agent_torch`` (and nothing of the JAX package) in six
phases, each printed on its own line; any failure exits non-zero:

  1. build the CUDA kernels of ``controllable_agent_torch/csrc`` with nvcc;
  2. hold each of the three fused-FB-loss kernels (forward sums, cov sums,
     the one backward pass) against its plain PyTorch version on the card,
     at n=1024 (the batch) and the ragged n=300, d=50, and check that the
     forward sums and the backward are bitwise repeatable;
  3. one full-width FBDDPG update with the fused loss against one without,
     from the same state with the same noise;
  4. the offline slice through its entry point, ``train_offline.main``:
     synthetic ExORL episodes (64 x 1000, obs 24, action 6) written with
     ``save_exorl_episodes``, a few hundred updates at full width in bf16
     with ``agent.use_pallas_loss=true``; every kernel's launch count must
     equal the number of updates;
  5. each kernel's device time against its plain version and its bound at
     n=1024, d=50 (the backward also at n=2048 and 4096), timed over
     replays of a CUDA graph of back-to-back calls, so that the host's
     launch rate does not enter the time;
  6. a ``torch.profiler`` trace of a few slice updates: each kernel's device
     time by name, the device's busy share and the launches per update.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script fails before printing a result.
"""

from __future__ import annotations

import json
import math
import sys
import tempfile
import time
import typing as tp

import numpy as np
import torch

from controllable_agent_torch import _build, train_offline
from controllable_agent_torch.agents import FBDDPGAgent, FBDDPGConfig, UpdateNoise
from controllable_agent_torch.data import ReplayBuffer
from controllable_agent_torch.data.exorl import save_exorl_episodes, synthetic_episodes
from controllable_agent_torch.ops import fused_fb as ff
from controllable_agent_torch.train.loops import make_offline_trainer
from controllable_agent_torch.utils.device import card_name_and_power_limit

SEED = 0
N, N_RAGGED, D = 1024, 300, 50
BWD_SIZES = (1024, 2048, 4096)  # batches at which phase 5 times the backward
OBS_DIM, ACTION_DIM, EPISODES, EPISODE_LENGTH = 24, 6, 64, 1000
SLICE_STEPS, STEPS_PER_CALL = 300, 100
PROFILE_STEPS = 20
# device kernels of each wrapper, as the profiler names them
KERNEL_NAMES = {"fwd_sums": ("fb_fwd_tile_kernel", "reduce_pairs_kernel"),
                "cov_sums": ("fb_gram_kernel", "fb_gram_reduce_kernel"),
                "bwd": ("fb_bwd_tile_kernel", "fb_bwd_reduce_kernel")}
# Published H100 SXM peaks (dense). The ops bound of every row is taken at
# the rate of float32-accurate products on the tensor cores: 3xTF32 does
# three TF32 products per product, so a third of the 495 TFLOP/s TF32 peak.
F32_ACCURATE_TC_FLOP_PER_S = 495e12 / 3
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
    """Each kernel against its plain version; returns max abs errors."""
    args = kernel_inputs(n, D, SEED + n)
    g = loss_cotangent(n)
    pairs = {
        "fwd_sums": (ff.fwd_sums(*args), ff.fwd_sums_plain(*args)),
        "cov_sums": (ff.cov_sums(args[2]), ff.cov_sums_plain(args[2])),
        "bwd": (torch.stack(ff.bwd(*args, g)), torch.stack(ff.bwd_plain(*args, g))),
    }
    absargs = [x.abs() for x in args]
    scales = {"fwd_sums": ff.fwd_sums_plain(*absargs),
              "cov_sums": ff.cov_sums_plain(absargs[2])}
    torch.cuda.synchronize()
    errors = {}
    for name, (got, want) in pairs.items():
        err = float((got - want).abs().max())
        if name.endswith("sums"):
            # rtol on each sum, plus float32 rounding of its terms' size
            # (the diagonal sum of random inputs may cancel towards 0)
            tols = FWD_RTOL * want.abs() + 1e-6 * scales[name]
            worst = int(((got - want).abs() / tols).argmax())
            err, tol = float((got - want).abs()[worst]), float(tols[worst])
            ok = err <= tol
            what = f"rtol {FWD_RTOL} + 1e-6 x sum of |terms|, worst of the 2 sums"
        else:  # dF1, dF2 and dB, each to its own largest entry
            tols = GRAD_RTOL * want.abs().flatten(1).max(1).values
            worst = int(((got - want).abs().flatten(1).max(1).values / tols).argmax())
            err = float((got[worst] - want[worst]).abs().max())
            tol = float(tols[worst])
            ok = err <= tol
            what = (f"atol {GRAD_RTOL} x max|plain| of each of dF1, dF2, dB, "
                    f"worst is {('dF1', 'dF2', 'dB')[worst]}")
        print(f"phase 2 n={n} d={D} {name}: max_abs_err {err:.3e} "
              f"tolerance {tol:.3e} ({what}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel {name} disagrees with its plain version at n={n}")
        errors[name] = float((got - want).abs().max())
    if not torch.equal(ff.fwd_sums(*args), pairs["fwd_sums"][0]):
        raise AssertionError("fwd_sums is not bitwise repeatable")
    if not torch.equal(torch.stack(ff.bwd(*args, g)), pairs["bwd"][0]):
        raise AssertionError("bwd is not bitwise repeatable")
    print(f"phase 2 n={n}: fwd_sums and bwd bitwise repeatable")
    return errors


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


def run_slice(episodes: tp.List[tp.Dict[str, np.ndarray]]
              ) -> tp.Tuple[tp.Dict[str, int], tp.Any]:
    with tempfile.TemporaryDirectory() as tmp:
        store = ReplayBuffer(EPISODES, discount=0.98, future=0.99, device="cpu")
        store.load_episodes(episodes)
        written = save_exorl_episodes(store.state, f"{tmp}/episodes")
        argv = [f"replay_dir={tmp}/episodes", "relabel=false", "agent=fb_ddpg",
                "agent.use_pallas_loss=true", "agent.compute_dtype=bfloat16",
                f"num_grad_steps={SLICE_STEPS}", f"steps_per_call={STEPS_PER_CALL}",
                f"log_every_steps={STEPS_PER_CALL}", "eval_every_steps=0",
                "checkpoint_every=0", "final_tests=0",
                f"replay_buffer_episodes={EPISODES}", f"folder={tmp}/run",
                f"seed={SEED}"]
        ff.reset_launches()
        t0 = time.perf_counter()
        ws = train_offline.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ff.launches)
    row, z = ws.last_row, ws.inferred_z
    print(f"phase 4 slice: {written} episodes, {ws.global_step} updates in "
          f"{wall:.1f} s (load included); launches {counts}")
    if ws.global_step != SLICE_STEPS or any(c != SLICE_STEPS for c in counts.values()):
        raise AssertionError(f"expected {SLICE_STEPS} launches of every kernel, "
                             f"got {counts}")
    if not all(math.isfinite(v) for v in row.values()):
        raise AssertionError(f"non-finite train metrics: {row}")
    if z is None or z.shape != (ws.agent.cfg.z_dim,) or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"bad inferred z: {z}")
    print(f"phase 4 slice: {row['fps']:.1f} updates/s over the last "
          f"{STEPS_PER_CALL} updates, fb_loss {row['fb_loss']:.4f}, actor_loss "
          f"{row['actor_loss']:.4f}, on {card_name_and_power_limit()}")
    print("phase 4 slice: inferred z " + " ".join(f"{v:.4f}" for v in z.tolist()))
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


def time_kernels(errors: tp.Dict[str, float], counts: tp.Dict[str, int]
                 ) -> tp.List[tp.Dict[str, tp.Any]]:
    args = kernel_inputs(N, D, SEED)
    nd, n2d = N * D, N * N * D
    in_bytes = 4 * (6 * nd + N)
    # The least flops each function needs. The forward needs the n x n
    # TM = min(TF1 TB^T, TF2 TB^T) (4 n^2 d) and one n x n by n x d product
    # with it (2 n^2 d); every term in M1 or M2 alone factors through d x d
    # Gram matrices (O(n d^2), not counted). Kernel 2 needs the symmetric
    # Gram matrix B^T B (n d (d+1)) and the row norms (2 n d).
    source = "controllable_agent_torch/csrc/fused_fb.cu"
    table = [
        # name, kernel, plain, flops, bytes, replaced TPU kernel
        ("fwd_sums", lambda: ff.fwd_sums(*args), lambda: ff.fwd_sums_plain(*args),
         6 * n2d, in_bytes + 8, "controllable_agent_tpu/ops/pallas_fb.py:61"),
        ("cov_sums", lambda: ff.cov_sums(args[2]), lambda: ff.cov_sums_plain(args[2]),
         nd * (D + 1) + 2 * nd, 4 * nd + 8, "controllable_agent_tpu/ops/pallas_fb.py:91"),
    ]
    rows = []
    for name, kernel, plain, flops, nbytes, replaces in table:
        ms, plain_ms, turns = time_pair(kernel, plain, 50)
        bound_ms, bound_by = bound(flops, nbytes)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        print(f"phase 5 {name} n={N} d={D}: {turns} (CUDA graph), bound "
              f"{bound_ms:.5f} ms ({bound_by}, {flops / 1e9:.4f} GFLOP at "
              f"{F32_ACCURATE_TC_FLOP_PER_S / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.3f} MB)")
    # The backward (dF1, dF2 and the FB part of dB together) needs TM once
    # (4 n^2 d), (g TM off) B for dF1 and dF2 (2 n^2 d) and TM^T (g (F1 + F2))
    # for dB (2 n^2 d): 8 n^2 d. It reads the inputs and g and writes three
    # n x d outputs.
    for n in BWD_SIZES:
        xs = args if n == N else kernel_inputs(n, D, SEED)
        g = loss_cotangent(n)
        flops, nbytes = 8 * n * n * D, 4 * (6 * n * D + n) + 16 + 12 * n * D
        ms, plain_ms, turns = time_pair(lambda: ff.bwd(*xs, g), lambda: ff.bwd_plain(*xs, g),
                                        max(4, 50 * N * N // (n * n)))
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"phase 5 bwd n={n} d={D}: {turns} (CUDA graph), bound {bound_ms:.5f} ms "
              f"({bound_by}, {flops / 1e9:.4f} GFLOP at "
              f"{F32_ACCURATE_TC_FLOP_PER_S / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.3f} MB); "
              f"{ms / bound_ms:.1f}x the bound, {plain_ms / ms:.2f}x faster than plain")
        if n != N:
            continue
        # one launch computes both TPU kernels' outputs: each row carries the pair's numbers
        for part, replaces in (("dF1, dF2", "controllable_agent_tpu/ops/pallas_fb.py:184"),
                               ("dB", "controllable_agent_tpu/ops/pallas_fb.py:219")):
            rows.append({"name": f"bwd ({part})", "route": "cuda", "source": source,
                         "replaces": replaces, "launches": counts["bwd"],
                         "max_abs_err": errors["bwd"], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                         "note": "one fb_bwd launch computes both rows; the numbers are "
                                 "the pair's"})
    return rows


def profile_slice(ws: tp.Any) -> None:
    """Device time by kernel over PROFILE_STEPS updates of the slice's agent
    on its replay, under ``torch.profiler``."""
    trainer = make_offline_trainer(ws.agent, ws.buffer.cfg, ws.agent.cfg.batch_size,
                                   PROFILE_STEPS)
    float(trainer(ws.buffer.state, ws.generator)["fb_loss"])  # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(trainer(ws.buffer.state, ws.generator)["fb_loss"])
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no device kernels")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"phase 6 profile: {PROFILE_STEPS} updates, {len(kernels) / PROFILE_STEPS:.1f} "
          f"kernel launches and {1e-3 * busy_us / PROFILE_STEPS:.4f} ms of device "
          f"time per update, {1e3 * wall / PROFILE_STEPS:.3f} ms of wall time per "
          f"update under the profiler (busy share {1e-6 * busy_us / wall:.4f})")
    for name, parts in KERNEL_NAMES.items():
        per = [sum(e.time_range.elapsed_us() for e in kernels if part in e.name)
               / PROFILE_STEPS for part in parts]
        if not all(per):
            raise AssertionError(f"the profiler saw no {parts} kernel")
        print(f"phase 6 profile {name}: {1e-3 * sum(per):.5f} ms of device time per "
              "update (" + ", ".join(f"{p} {1e-3 * t:.5f}" for p, t in zip(parts, per))
              + ")")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # every float32 product under test runs in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    seconds, logs = _build.build()
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("phase 1 ptxas:", line.strip())
    print(f"phase 1 build: {len(logs)} source(s) compiled in {seconds:.1f} s")

    errors = check_kernels(N)
    check_kernels(N_RAGGED)

    episodes = synthetic_episodes(EPISODES, EPISODE_LENGTH, OBS_DIM, ACTION_DIM, SEED)
    check_update(episodes)
    counts, ws = run_slice(episodes)
    rows = time_kernels(errors, counts)
    profile_slice(ws)

    print(json.dumps({"kernels": rows}))
    print(f"card: {card_name_and_power_limit()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
