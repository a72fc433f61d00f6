// Fused Forward-Backward loss for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by controllable_agent_torch/ops/fused_fb.py).
//
// Replaces the four Pallas TPU kernels of controllable_agent_tpu/ops/pallas_fb.py:
//   fb_fwd_tile_kernel  <- _fwd_kernel     (pallas_fb.py:61)
//                      and _cov_kernel     (pallas_fb.py:91)
//   fb_bwd_tile_kernel  <- _bwd_kernel     (pallas_fb.py:184)
//                      and _bwd_db_kernel  (pallas_fb.py:219)
// each followed by a one-pass fixed-order reduction of its per-block partials
// (fb_fwd_reduce_kernel, fb_bwd_reduce_kernel).
//
// Inputs are row-major float32 [n, d] (F1, F2, B and the targets TF1, TF2,
// TB), the discount [n, 1] and, for the backward, the cotangent g[4] of the
// four sums (off_sum, diag_sum, cov_off_sum, cov_diag_sum), read from device
// memory so that the backward needs no host sync.
//
// What bounds them on the H100: at the slice's shapes (n = 1024, d = 50) the
// inputs are ~1.4 MB while the forward and the backward need 6 n^2 d and
// 8 n^2 d flops, so they are bound by arithmetic, not by bytes. The n x n
// measure matrices never reach device memory: each block computes its tiles
// of M1 = F1 B^T, M2 = F2 B^T and TM = min(TF1 TB^T, TF2 TB^T) on chip.
// The orthonormality sums need no n x n matrix at all: with G = B^T B (d x d),
// sum_{i != j} cov_ij^2 = |G|_F^2 - sum_i |b_i|^4 and sum_i cov_ii = trace G
// = sum_i |b_i|^2, ~2 n d^2 flops on 4 n d bytes: alone they would be bound
// by a launch, so they ride in the forward's. (The subtraction cancels
// little: for rank-d B with equal row norms, sum_i |b_i|^4 <= (d / n) |G|_F^2.)
//
// What the design does about the TPU's sequential grid: Hopper's blocks run
// in parallel and in no order, so every kernel writes per-block partials to
// scratch and a second kernel sums them in a fixed order: no float atomics,
// so two runs give bitwise-equal results.
//
// Both tile kernels run on the tensor cores, mma.sync m16n8k8 in 3xTF32. One
// block of 8 warps owns one 64 x 64 tile (rows i, columns j) of the n x n
// plane, 256 blocks at n = 1024 for 132 SMs, two resident per SM (104 KB of
// shared memory each). The backward:
//   1. it stages its row tiles of TF1, TF2, F1, F2 and its column tiles of
//      TB, B into shared memory once, with cp.async (8-byte pieces: rows of
//      [n, 50] float32 are 200 bytes apart, so neither TMA nor 16-byte
//      cp.async can address them; branch-free, zero-filling outside n x d:
//      stage_tile), in two commit groups so that TM is formed while F1, F2,
//      B are still arriving;
//   2. each warp forms TM, M1, M2 for a 16 x 32 part of the tile
//      (tile_products, which the forward shares), then
//      W1, W2 = 2 g_off (M - g_i TM) off the diagonal, g_diag on it, 0
//      outside n x n, in the accumulator registers;
//   3. dF1, dF2 partials W B_tile straight from those registers: an
//      accumulator fragment is an A fragment once the depth is permuted the
//      same way in both operands (frag_b_perm); the two warps that share
//      rows add their halves through shared memory, in a fixed order;
//   4. W1^T, W2^T go to shared memory in A-fragment order (one 16-byte read
//      per lane), over the dead TF1, TF2, for the dB partial
//      W1^T F1_tile + W2^T F2_tile;
//   5. it writes dF into the slot of its column tile and dB into the slot of
//      its row tile (rows padded to a multiple of 8 floats, so each warp's
//      8-byte stores fill whole 32-byte sectors); fb_bwd_reduce_kernel sums
//      the slots in order.
// TM is formed once per update, not once per output. Staged rows have a
// pitch of 68 floats (4 mod 32), so each fragment read, of (row g, column t)
// in the products and of (row 2 t, column g) in the permuted B operands,
// hits 32 distinct banks with no address arithmetic beyond an immediate.
// What bounds it: the mma issue rate and the instructions around it (the
// TF32 splits, shared-memory reads, staging), in about equal parts; the
// least work, 8 n^2 d flops at 165 TFLOP/s, is ~10x below its time. The
// depth loops of the products (steps 2 and 4) stay rolled: fully unrolled,
// the kernel is faster alone but its code no longer fits the SMs'
// instruction caches once other kernels run between calls, as they do in
// the update, and it is then slower.
//
// The forward is steps 1 and 2 of the backward with another end: each
// thread squares its residuals M - g_i TM off the diagonal and adds M1 + M2
// on it; the block sums both in a fixed order (shuffles within a warp,
// then the 8 warps' sums by the shuffles of warp 0) and writes one pair.
// Its product loops are unrolled: it is short enough to keep its code in
// the instruction caches inside an update, where the backward is not. It
// needs no W^T and no dF exchange, so three buffers would do (the targets,
// then the online tiles into their place: 52 KB, three blocks per SM); it
// keeps six side by side as the backward does, which measured ~10% faster
// at n = 1024: 256 blocks are one wave either way, and three buffers lose
// the overlap of TM with the second load.
// The orthonormality sums ride in the same launch: each of the n / 64
// diagonal blocks already holds 64 rows of B in shared memory and adds
// their part of G = B^T B on the tensor cores, a product over a depth of 64
// rows in which both operands read B "down the rows" with the depth
// permuted as in frag_b_perm (row 2 t, column g: 32 distinct banks; the
// permutation is free because both operands take it), plus sum |b_i|^4 and
// sum |b_i|^2 of its rows. That is ~84 mma per warp more on 16 of 256
// blocks, all of one wave. The tensor cores were taken over float32 FMA
// because the fragments and the splits are the code the block has just
// run, so the diagonal blocks add little to the kernel's instruction
// footprint. fb_fwd_reduce_kernel (one block of 1024 threads) then sums the
// pairs, the partial Gram matrices entry by entry (four neighbouring
// entries per thread, all partials of them in flight together) and the
// row-norm sums, and writes the four sums. What bounds the forward: the
// rate of mma.sync (the cross terms of 3xTF32 are ~5.6 of the tile
// kernel's ~14 us at n = 1024), then the latency of a launch that is one
// wave of blocks, and the second launch (~3 us).
// A finish by the last block in the tile kernel (an integer ticket) would
// save the second launch, but one ticket per device is wrong when two
// streams run the forward at once, and a ticket per call costs the launch
// that zeroes it; so the forward stays two launches.
//
// Why 3xTF32 and not TF32: the weights are residuals M - g TM of products of
// O(1) entries that cancel, and the squared loss amplifies their noise.
// TF32 keeps an 11-bit significand, ~5e-4 relative error per product, which
// the tests' 1e-4 gradient tolerance does not hold. Splitting each operand
// a = hi + lo (both TF32) and summing lo*hi + hi*lo + hi*hi in float32 keeps
// ~21 bits, float32-level, at a third of the tensor cores' TF32 rate
// (495 / 3 = 165 TFLOP/s), still 2.5x the CUDA cores' float32 rate.
//
// The ragged edge (n not a multiple of the tile) is masked inside the
// kernels: rows/columns >= n load as zero and contribute nothing; inputs are
// never copied to pad n. d <= 64: tiles are staged in shared memory padded
// with zeros to a multiple of 8, mma's depth (each tile kernel is compiled
// for each of the 8 paddings).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDP = 64;  // d padded

// Square kBT x kBT tiles; staged matrices of kBT rows of pitch kBP, in
// dynamic shared memory, six in either tile kernel
constexpr int kBT = 64;
constexpr int kBP = kDP + 4;  // = 4 (mod 32)
constexpr int kBMat = kBT * kBP;
constexpr int kTileSmemBytes = 6 * kBMat * static_cast<int>(sizeof(float));
constexpr int kRedThreads = 1024;  // the forward's second pass, one block

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// How often the forward's and the backward's launches have run on this
// device: each reduction kernel, the last of its launch, adds one as it runs.
// Replays of a CUDA graph count like any other run, which a count kept by
// the host cannot see. Read and zeroed by fb_runs and fb_runs_reset.
__device__ unsigned long long fb_run_counts[2];

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums over the block of kCount values per thread, in a fixed order: within
// a warp by shuffles, then the kNumWarps <= 32 warps' sums through `red` by
// the shuffles of warp 0. Thread 0 gets the sums in v.
template <int kCount, int kNumWarps>
__device__ __forceinline__ void block_sums(float (&v)[kCount], float (*red)[kNumWarps]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < kCount; ++c) {
    v[c] = warp_sum(v[c]);
    if (lane == 0) red[c][warp] = v[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < kCount; ++c) v[c] = warp_sum(lane < kNumWarps ? red[c][lane] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core helpers of both tile kernels.

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// cp.async with a source size of 0 reads nothing and fills its piece with
// zeros, so a piece outside the matrix costs the same one instruction as a
// copy, with no branch.
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(unsigned dst, const float* src, bool copy) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(kBytes), "r"(copy ? kBytes : 0)
               : "memory");
}

// Stage rows [row0, row0 + kBT) x columns [0, kPad) of x into s (row pitch
// kBP), zero outside n x d: 8-byte pieces when `pairs` (d even, x 8-byte
// aligned), else 4-byte ones. Each thread keeps one column (or pair) and
// steps over rows: one 64-bit product per tile and an addition per row for
// the source address, no division. The caller commits the group.
template <int kPad>
__device__ __forceinline__ void stage_tile(float* s, const float* __restrict__ x, int row0,
                                           int n, int d, bool pairs) {
  const int rows = n - row0;  // rows of the tile inside x
  if (pairs) {
    constexpr int kStep = kThreads / 32;
    const int c = 2 * (threadIdx.x % 32), r0 = threadIdx.x / 32;
    if (c >= kPad) return;
    const float* src = x + static_cast<size_t>(row0 + r0) * d + c;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s + r0 * kBP + c));
#pragma unroll
    for (int k = 0; k < kBT / kStep; ++k, src += kStep * d)
      cp_async_zfill<8>(dst + k * kStep * kBP * 4, src, c < d && r0 + k * kStep < rows);
  } else {
    constexpr int kStep = kThreads / 64;
    const int c = threadIdx.x % 64, r0 = threadIdx.x / 64;
    if (c >= kPad) return;
    const float* src = x + static_cast<size_t>(row0 + r0) * d + c;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s + r0 * kBP + c));
#pragma unroll
    for (int k = 0; k < kBT / kStep; ++k, src += kStep * d)
      cp_async_zfill<4>(dst + k * kStep * kBP * 4, src, c < d && r0 + k * kStep < rows);
  }
}

// An mma operand split into two TF32 parts, x = hi + lo.
struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

// hi = x rounded to TF32's 10-bit mantissa (to nearest, ties away from
// zero); lo = x - hi, exact in float32. The tensor cores read only the top
// 19 bits of a TF32 operand, so lo needs no rounding of its own (|lo| <=
// 2^-11 |x|, so dropping its low bits costs ~2^-21 |x|). Integer arithmetic:
// cvt.rna.tf32.f32 compiles to a longer sequence.
__device__ __forceinline__ void split_tf32(float x, unsigned* hi, unsigned* lo) {
  const unsigned h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  *hi = h;
  *lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, &f.hi[0], &f.lo[0]);
  split_tf32(a1, &f.hi[1], &f.lo[1]);
  split_tf32(a2, &f.hi[2], &f.lo[2]);
  split_tf32(a3, &f.hi[3], &f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, &f.hi[0], &f.lo[0]);
  split_tf32(b1, &f.hi[1], &f.lo[1]);
  return f;
}

// m16n8k8 fragments, g = lane / 4, t = lane % 4. A (16 x 8): a0 = (g, t),
// a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4). B (8 x 8):
// b0 = (k = t, n = g), b1 = (t + 4, g). C (16 x 8): c[q] = (g + 8 (q / 2),
// 2 t + q % 2).
//
// frag_a: p points at (row g, column t) of a row-major 16-row block.
__device__ __forceinline__ FragA frag_a(const float* p) {
  return split_a(p[0], p[8 * kBP], p[4], p[8 * kBP + 4]);
}

// frag_b of B[k][n] = X[n][k]: p points at (row g, column t) of X.
__device__ __forceinline__ FragB frag_b(const float* p) { return split_b(p[0], p[4]); }

// frag_b of B[k][n] = X[k][n] with the depth permuted, k = t <-> row 2 t,
// k = t + 4 <-> row 2 t + 1: p points at (row 2 t, column g) of X. The A
// operand must use the same permutation.
__device__ __forceinline__ FragB frag_b_perm(const float* p) {
  return split_b(p[0], p[kBP]);
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float* c, const FragA& a,
                                           const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// c1 += A1 X^T and c2 += A2 X^T for one warp's 16 x 32 part of the tile,
// over a staged depth of 8 kSteps: a1, a2 point at (row g, column t) of the
// warp's 16 rows of A1, A2 and x at (row g, column t) of its 32 rows of X.
// Four m16n8 fragments per product. The depth loop is unrolled kUnroll
// times: 1 (rolled) in the backward, whose code is long enough to lose the
// SMs' instruction caches between two updates; kSteps (all) in the forward,
// which is short enough to gain from it there too.
template <int kSteps, int kUnroll>
__device__ __forceinline__ void tile_products(const float* a1, const float* a2,
                                              const float* x, float (&c1)[4][4],
                                              float (&c2)[4][4]) {
#pragma unroll kUnroll
  for (int ks = 0; ks < kSteps; ++ks) {
    FragB fb[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) fb[nt] = frag_b(x + 8 * nt * kBP + 8 * ks);
    const FragA fa1 = frag_a(a1 + 8 * ks);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_3xtf32(c1[nt], fa1, fb[nt]);
    const FragA fa2 = frag_a(a2 + 8 * ks);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_3xtf32(c2[nt], fa2, fb[nt]);
  }
}

// Scratch of the forward, in floats, for t = cdiv(n, 64) tiles a side: the
// (off, diag) pair of each of the t^2 blocks, then the (sum |b_i|^4,
// sum |b_i|^2) pair of each diagonal block, then its kPad x kPad partial
// Gram matrix.
__host__ __device__ inline int fwd_gram_offset(int tiles) { return 2 * tiles * tiles + 2 * tiles; }

// The forward, first pass, for d padded to 8 kSteps. Block (x, y) owns rows
// [64 y, 64 y + 64) and columns [64 x, 64 x + 64) of the n x n plane and
// writes
//   off  = sum_{i != j} (M1 - g_i TM)^2 + (M2 - g_i TM)^2
//   diag = sum_{i == j} M1 + M2
// of its tile. A diagonal block (x == y) also writes, for its 64 rows of B,
// sum_i |b_i|^4, sum_i |b_i|^2 and the partial Gram matrix sum_i b_i b_i^T
// (kPad x kPad, row-major; columns >= d are zero).
template <int kSteps>
__global__ void __launch_bounds__(kThreads, 2)
fb_fwd_tile_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   const float* __restrict__ b, const float* __restrict__ tf1,
                   const float* __restrict__ tf2, const float* __restrict__ tb,
                   const float* __restrict__ disc, float* __restrict__ partials,
                   int n, int d, int pairs) {
  constexpr int kPad = 8 * kSteps;
  extern __shared__ float4 smem4[];
  __shared__ float red[4][kWarps];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sTF1 = smem;
  float* sTF2 = smem + kBMat;
  float* sTB = smem + 2 * kBMat;
  float* sF1 = smem + 3 * kBMat;
  float* sF2 = smem + 4 * kBMat;
  float* sB = smem + 5 * kBMat;

  const int row0 = blockIdx.y * kBT, col0 = blockIdx.x * kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // Warp (wm, wn) owns rows 16 wm + [0, 16) and columns 32 wn + [0, 32).
  const int wm = warp / 2, wn = warp % 2;
  const int a_off = (16 * wm + g) * kBP + t, b_off = (32 * wn + g) * kBP + t;

  stage_tile<kPad>(sTF1, tf1, row0, n, d, pairs);
  stage_tile<kPad>(sTF2, tf2, row0, n, d, pairs);
  stage_tile<kPad>(sTB, tb, col0, n, d, pairs);
  cp_async_commit();
  stage_tile<kPad>(sF1, f1, row0, n, d, pairs);
  stage_tile<kPad>(sF2, f2, row0, n, d, pairs);
  stage_tile<kPad>(sB, b, col0, n, d, pairs);
  cp_async_commit();
  // the discounts of this thread's two rows, while the tiles arrive
  float gi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + 16 * wm + g + 8 * h;
    gi[h] = gr < n ? disc[gr] : 0.f;
  }

  float tm[4][4];
  cp_async_wait<1>();
  __syncthreads();
  {
    float t1[4][4] = {}, t2[4][4] = {};
    tile_products<kSteps, kSteps>(sTF1 + a_off, sTF2 + a_off, sTB + b_off, t1, t2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) tm[nt][q] = fminf(t1[nt][q], t2[nt][q]);
  }
  cp_async_wait<0>();
  __syncthreads();
  float m1[4][4] = {}, m2[4][4] = {};
  tile_products<kSteps, kSteps>(sF1 + a_off, sF2 + a_off, sB + b_off, m1, m2);

  // sums[0..1]: off and diag of the tile; rows/columns >= n contribute nothing.
  float sums[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + 16 * wm + g + 8 * h;
    if (gr >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * h + e, gc = col0 + 32 * wn + 8 * nt + 2 * t + e;
        if (gc >= n) continue;
        if (gr == gc) {
          sums[1] += m1[nt][q] + m2[nt][q];
        } else {
          const float r1 = m1[nt][q] - gi[h] * tm[nt][q];
          const float r2 = m2[nt][q] - gi[h] * tm[nt][q];
          sums[0] += r1 * r1 + r2 * r2;
        }
      }
    }
  }

  const bool diagonal = blockIdx.x == blockIdx.y;  // sB holds rows [row0, row0 + 64) of B
  if (diagonal) {
    // sums[2..3]: sum |b_i|^4 and sum |b_i|^2; four threads per row (rows
    // >= n are zero), then the row's total on each of them.
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float sq = 0.f;
#pragma unroll
    for (int c = part; c < kPad; c += 4) {
      const float v = sB[r * kBP + c];
      sq = fmaf(v, v, sq);
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    if (part == 0) {
      sums[2] = sq * sq;
      sums[3] = sq;
    }

    // The partial Gram matrix B_tile^T B_tile over a depth of 64 rows, the
    // depth permuted as in frag_b_perm in both operands. Warp w owns rows
    // 16 (w % 4) + [0, 16) of G and its n-tiles w / 4, w / 4 + 2, ...
    const int mt = warp % 4, nt0 = warp / 4;
    if (2 * mt < kSteps) {
      const bool second = 2 * mt + 1 < kSteps;  // rows 16 mt + 8 + [0, 8) are inside kPad
      float acc[4][4] = {};
      const float* p = sB + 2 * t * kBP + g;
#pragma unroll 1
      for (int ks = 0; ks < kBT / 8; ++ks) {
        const float* pa = p + 8 * ks * kBP + 16 * mt;
        const FragA fa = split_a(pa[0], second ? pa[8] : 0.f, pa[kBP],
                                 second ? pa[kBP + 8] : 0.f);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (nt0 + 2 * u < kSteps)
            mma_3xtf32(acc[u], fa, frag_b_perm(p + 8 * ks * kBP + 8 * (nt0 + 2 * u)));
        }
      }
      float* gp = partials + fwd_gram_offset(gridDim.x) +
                  static_cast<size_t>(blockIdx.x) * kPad * kPad;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (nt0 + 2 * u >= kSteps) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * mt + g + 8 * h;
          if (i < kPad)
            *reinterpret_cast<float2*>(gp + i * kPad + 8 * (nt0 + 2 * u) + 2 * t) =
                make_float2(acc[u][2 * h], acc[u][2 * h + 1]);
        }
      }
    }
  }

  block_sums<4, kWarps>(sums, red);
  if (threadIdx.x == 0) {
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    *reinterpret_cast<float2*>(partials + 2 * blk) = make_float2(sums[0], sums[1]);
    if (diagonal)
      *reinterpret_cast<float2*>(partials + 2 * gridDim.x * gridDim.x + 2 * blockIdx.x) =
          make_float2(sums[2], sums[3]);
  }
}

// The forward, second pass (one block of kRedThreads): everything in a
// fixed order.
//   out[0], out[1] = the sums of the tiles' (off, diag) pairs;
//   out[2] = sum_{i != j} cov_ij^2 = |G|_F^2 - sum_i |b_i|^4, with G the sum
//            of the partial Gram matrices, entry by entry;
//   out[3] = sum_i cov_ii = sum_i |b_i|^2.
__global__ void __launch_bounds__(kRedThreads)
fb_fwd_reduce_kernel(const float* __restrict__ partials, int tiles, int kpad,
                     float* __restrict__ out) {
  __shared__ float red[5][kRedThreads / 32];
  const int blocks = tiles * tiles, entries = kpad * kpad;
  const float2* pair = reinterpret_cast<const float2*>(partials);
  const float2* norm = pair + blocks;
  // 16-byte aligned: fwd_gram_offset = 2 t (t + 1) is a multiple of 4
  const float4* gram = reinterpret_cast<const float4*>(partials + fwd_gram_offset(tiles));
  float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // off, diag, |G|_F^2, sum |b|^4, trace
  for (int i = threadIdx.x; i < blocks; i += kRedThreads) {
    const float2 p = pair[i];
    v[0] += p.x;
    v[1] += p.y;
  }
  for (int i = threadIdx.x; i < tiles; i += kRedThreads) {
    const float2 p = norm[i];
    v[3] += p.x;
    v[4] += p.y;
  }
  // four neighbouring entries per thread (kpad^2 / 4 <= kRedThreads of them)
  const int e4 = threadIdx.x, entries4 = entries / 4;
  if (e4 < entries4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int p = 0; p < tiles; ++p) {
      const float4 x = gram[static_cast<size_t>(p) * entries4 + e4];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    v[2] = fmaf(s.x, s.x, fmaf(s.y, s.y, fmaf(s.z, s.z, s.w * s.w)));
  }
  block_sums<5, kRedThreads / 32>(v, red);
  if (threadIdx.x == 0) {
    out[0] = v[0];
    out[1] = v[1];
    out[2] = v[2] - v[3];
    out[3] = v[4];
    atomicAdd(&fb_run_counts[0], 1ULL);
  }
}

// The backward, first pass, for d padded to 8 kSteps. Block (x, y) owns rows
// [64 y, 64 y + 64) and columns [64 x, 64 x + 64) of the n x n plane;
// partials holds three [tiles][n][8 kSteps] arrays: the dF1 and dF2
// partials by column tile, then the dB partials by row tile.
//
// Shared memory: six staged [64][kBP] tiles (kBP = 4 mod 32, so a fragment
// read of (row g, column t) or of (row 2 t, column g) hits 32 banks). After
// the products, W1^T and W2^T (in mma A-fragment order, one 16-byte read per
// lane) take the place of TF1, TF2, and the dF exchange that of TB, B.
template <int kSteps>
__global__ void __launch_bounds__(kThreads, 2)
fb_bwd_tile_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   const float* __restrict__ b, const float* __restrict__ tf1,
                   const float* __restrict__ tf2, const float* __restrict__ tb,
                   const float* __restrict__ disc, const float* __restrict__ gvec,
                   float* __restrict__ partials, int n, int d, int pairs) {
  constexpr int kPad = 8 * kSteps;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sTF1 = smem;
  float* sTF2 = smem + kBMat;
  float* sTB = smem + 2 * kBMat;
  float* sB = smem + 3 * kBMat;
  float* sF1 = smem + 4 * kBMat;
  float* sF2 = smem + 5 * kBMat;
  float* sWT = smem;             // W1^T, W2^T: 2 x 4096 floats over TF1, TF2
  float* sX = smem + 2 * kBMat;  // dF exchange: 2 x 4 x kSteps x 128 over TB, B

  const int row0 = blockIdx.y * kBT, col0 = blockIdx.x * kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  stage_tile<kPad>(sTF1, tf1, row0, n, d, pairs);
  stage_tile<kPad>(sTF2, tf2, row0, n, d, pairs);
  stage_tile<kPad>(sTB, tb, col0, n, d, pairs);
  cp_async_commit();
  stage_tile<kPad>(sF1, f1, row0, n, d, pairs);
  stage_tile<kPad>(sF2, f2, row0, n, d, pairs);
  stage_tile<kPad>(sB, b, col0, n, d, pairs);
  cp_async_commit();

  // 1. TM, M1, M2 of the tile. Warp (wm, wn) owns rows 16 wm + [0, 16) and
  // columns 32 wn + [0, 32): four m16n8 fragments per product.
  const int wm = warp / 2, wn = warp % 2;
  const int a_off = (16 * wm + g) * kBP + t, b_off = (32 * wn + g) * kBP + t;
  float tm[4][4];
  cp_async_wait<1>();
  __syncthreads();
  {
    float t1[4][4] = {}, t2[4][4] = {};
    tile_products<kSteps, 1>(sTF1 + a_off, sTF2 + a_off, sTB + b_off, t1, t2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) tm[nt][q] = fminf(t1[nt][q], t2[nt][q]);
  }
  cp_async_wait<0>();
  __syncthreads();  // also: every warp is done reading TF1, TF2, TB
  float w1[4][4] = {}, w2[4][4] = {};  // M1, M2, then the weights
  tile_products<kSteps, 1>(sF1 + a_off, sF2 + a_off, sB + b_off, w1, w2);

  // 2. The weights w = 2 g_off (M - g_i TM) off the diagonal, g_diag on it,
  // 0 outside n x n, in registers; W1^T and W2^T to shared memory in the
  // A-fragment order of step 4: element (i, j) of W goes to lane
  // 4 (j % 8) + (i % 8) / 2, register (j % 16) / 8 + 2 (i % 2) of fragment
  // (j / 16, i / 8).
  const float g_off2 = 2.f * gvec[0], g_diag = gvec[1];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 16 * wm + g + 8 * h, gr = row0 + i;
    const float gi = gr < n ? disc[gr] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * h + e, j = 32 * wn + 8 * nt + 2 * t + e, gc = col0 + j;
        if (gr >= n || gc >= n) {
          w1[nt][q] = w2[nt][q] = 0.f;
        } else if (gr == gc) {
          w1[nt][q] = w2[nt][q] = g_diag;
        } else {
          w1[nt][q] = g_off2 * (w1[nt][q] - gi * tm[nt][q]);
          w2[nt][q] = g_off2 * (w2[nt][q] - gi * tm[nt][q]);
        }
        const int at = ((j / 16) * 8 + i / 8) * 128 + (4 * (j % 8) + (i % 8) / 2) * 4 +
                       (j % 16) / 8 + 2 * (i % 2);
        sWT[at] = w1[nt][q];
        sWT[4096 + at] = w2[nt][q];
      }
    }
  }

  // 3. dF1, dF2 partials of the warp's rows over its 32 columns: W B_tile,
  // with W straight from the accumulators. A C fragment holds columns 2 t,
  // 2 t + 1, so depth is permuted as in frag_b_perm.
  float df1[kSteps][4] = {}, df2[kSteps][4] = {};
  const int bt_off = (32 * wn + 2 * t) * kBP + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const FragA a1 = split_a(w1[kk][0], w1[kk][2], w1[kk][1], w1[kk][3]);
    const FragA a2 = split_a(w2[kk][0], w2[kk][2], w2[kk][1], w2[kk][3]);
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt) {
      const FragB bb = frag_b_perm(sB + bt_off + 8 * kk * kBP + 8 * nt);
      mma_3xtf32(df1[nt], a1, bb);
      mma_3xtf32(df2[nt], a2, bb);
    }
  }
  __syncthreads();  // W^T complete; every warp is done reading B
  if (wn == 1) {
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt) {
      float* x = sX + ((wm * kSteps + nt) * 32 + lane) * 4;
      *reinterpret_cast<float4*>(x) = make_float4(df1[nt][0], df1[nt][1], df1[nt][2], df1[nt][3]);
      *reinterpret_cast<float4*>(x + 4 * kSteps * 128) =
          make_float4(df2[nt][0], df2[nt][1], df2[nt][2], df2[nt][3]);
    }
  }

  // 4. dB partial of columns 16 (warp % 4) + [0, 16), n-tiles
  // 4 (warp / 4) + [0, 4): W1^T F1 + W2^T F2, depth permuted as in frag_b_perm.
  const size_t slot = static_cast<size_t>(n) * kPad;
  const int jt = warp % 4, nt0 = 4 * (warp / 4);
  {
    float db[4][4] = {};
    const int ft_off = 2 * t * kBP + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* wt = sWT + 4096 * h + jt * 8 * 128 + lane * 4;
      const float* sF = h == 0 ? sF1 : sF2;
#pragma unroll 1
      for (int ks = 0; ks < kBT / 8; ++ks) {
        const float4 v = *reinterpret_cast<const float4*>(wt + ks * 128);
        const FragA a = split_a(v.x, v.y, v.z, v.w);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (nt0 + u < kSteps)
            mma_3xtf32(db[u], a, frag_b_perm(sF + ft_off + 8 * ks * kBP + 8 * (nt0 + u)));
        }
      }
    }
    float* p = partials + (2 * static_cast<size_t>(gridDim.x) + blockIdx.y) * slot;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (nt0 + u >= kSteps) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = col0 + 16 * jt + g + 8 * h;
        if (j < n)
          *reinterpret_cast<float2*>(p + static_cast<size_t>(j) * kPad + 8 * (nt0 + u) + 2 * t) =
              make_float2(db[u][2 * h], db[u][2 * h + 1]);
      }
    }
  }

  // 5. The dF partials: columns 0-31 plus columns 32-63, in that order.
  __syncthreads();
  if (wn == 0) {
    float* p1 = partials + static_cast<size_t>(blockIdx.x) * slot;
    float* p2 = p1 + static_cast<size_t>(gridDim.x) * slot;
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt) {
      const float* x = sX + ((wm * kSteps + nt) * 32 + lane) * 4;
      const float4 o1 = *reinterpret_cast<const float4*>(x);
      const float4 o2 = *reinterpret_cast<const float4*>(x + 4 * kSteps * 128);
      const float s1[4] = {df1[nt][0] + o1.x, df1[nt][1] + o1.y, df1[nt][2] + o1.z,
                           df1[nt][3] + o1.w};
      const float s2[4] = {df2[nt][0] + o2.x, df2[nt][1] + o2.y, df2[nt][2] + o2.z,
                           df2[nt][3] + o2.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * wm + g + 8 * h;
        if (r < n) {
          const size_t at = static_cast<size_t>(r) * kPad + 8 * nt + 2 * t;
          *reinterpret_cast<float2*>(p1 + at) = make_float2(s1[2 * h], s1[2 * h + 1]);
          *reinterpret_cast<float2*>(p2 + at) = make_float2(s2[2 * h], s2[2 * h + 1]);
        }
      }
    }
  }
}

// The backward, second pass: each of dF1, dF2, dB is the sum of its
// `tiles` partials (rows padded to kpad floats), in slot order.
__global__ void __launch_bounds__(kThreads)
fb_bwd_reduce_kernel(const float* __restrict__ partials, int tiles, int n, int d,
                     int kpad, float* __restrict__ df1, float* __restrict__ df2,
                     float* __restrict__ db) {
  const int nd = n * d, e = blockIdx.x * kThreads + threadIdx.x;
  if (e == 0) atomicAdd(&fb_run_counts[1], 1ULL);
  if (e >= 3 * nd) return;
  const int which = e / nd, idx = e - which * nd, i = idx / d, c = idx - i * d;
  const size_t stride = static_cast<size_t>(n) * kpad;
  const float* p = partials + which * tiles * stride + static_cast<size_t>(i) * kpad + c;
  float s = 0.f;
  for (int k = 0; k < tiles; ++k) s += p[k * stride];
  float* out = which == 0 ? df1 : (which == 1 ? df2 : db);
  out[idx] = s;
}

bool aligned8(const float* p) { return reinterpret_cast<std::uintptr_t>(p) % 8 == 0; }

// Whether stage_tile may copy 8-byte pieces: rows start 8-byte aligned.
int can_stage_pairs(int d, const float* f1, const float* f2, const float* b,
                    const float* tf1, const float* tf2, const float* tb) {
  return d % 2 == 0 && aligned8(f1) && aligned8(f2) && aligned8(b) && aligned8(tf1) &&
         aligned8(tf2) && aligned8(tb);
}

// The dynamic shared memory above 48 KB is opted into once per kernel and
// device; `configured` is the kernel's own record.
template <typename Kernel>
cudaError_t allow_shared_memory(Kernel kernel, int bytes, bool (&configured)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  return cudaSuccess;
}

// Launch both passes of the forward for d padded to 8 kSteps.
template <int kSteps>
int launch_fwd(const float* f1, const float* f2, const float* b, const float* tf1,
               const float* tf2, const float* tb, const float* disc, float* partials,
               float* out, int n, int d, cudaStream_t s) {
  static bool configured[64] = {};
  cudaError_t err = allow_shared_memory(fb_fwd_tile_kernel<kSteps>, kTileSmemBytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = cdiv(n, kBT);
  fb_fwd_tile_kernel<kSteps><<<dim3(tiles, tiles), kThreads, kTileSmemBytes, s>>>(
      f1, f2, b, tf1, tf2, tb, disc, partials, n, d,
      can_stage_pairs(d, f1, f2, b, tf1, tf2, tb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_fwd_reduce_kernel<<<1, kRedThreads, 0, s>>>(partials, tiles, 8 * kSteps, out);
  return static_cast<int>(cudaGetLastError());
}

// Launch both passes of the backward for d padded to 8 kSteps.
template <int kSteps>
int launch_bwd(const float* f1, const float* f2, const float* b, const float* tf1,
               const float* tf2, const float* tb, const float* disc, const float* g,
               float* partials, float* df1, float* df2, float* db, int n, int d,
               cudaStream_t s) {
  static bool configured[64] = {};
  cudaError_t err = allow_shared_memory(fb_bwd_tile_kernel<kSteps>, kTileSmemBytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = cdiv(n, kBT);
  fb_bwd_tile_kernel<kSteps><<<dim3(tiles, tiles), kThreads, kTileSmemBytes, s>>>(
      f1, f2, b, tf1, tf2, tb, disc, g, partials, n, d,
      can_stage_pairs(d, f1, f2, b, tf1, tf2, tb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_bwd_reduce_kernel<<<cdiv(3 * n * d, kThreads), kThreads, 0, s>>>(
      partials, tiles, n, d, 8 * kSteps, df1, df2, db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each returns a CUDA error code (0 on success); the
// launchers launch on the given stream, do not synchronise and allocate
// nothing.

// `return launch<cdiv(d, 8)>(...)` for d <= 64.
#define FB_DISPATCH(launch, ...)                      \
  switch (cdiv(d, 8)) {                               \
    case 1: return launch<1>(__VA_ARGS__);            \
    case 2: return launch<2>(__VA_ARGS__);            \
    case 3: return launch<3>(__VA_ARGS__);            \
    case 4: return launch<4>(__VA_ARGS__);            \
    case 5: return launch<5>(__VA_ARGS__);            \
    case 6: return launch<6>(__VA_ARGS__);            \
    case 7: return launch<7>(__VA_ARGS__);            \
    case 8: return launch<8>(__VA_ARGS__);            \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

extern "C" {

int fb_max_d() { return kDP; }

// Number of floats of scratch that fb_fwd needs.
int fb_fwd_partials(int n, int d) {
  const int tiles = cdiv(n, kBT), kpad = 8 * cdiv(d, 8);
  return fwd_gram_offset(tiles) + tiles * kpad * kpad;
}

// Number of floats of scratch that fb_bwd needs.
int fb_bwd_partials(int n, int d) { return 3 * cdiv(n, kBT) * n * 8 * cdiv(d, 8); }

// out[4] = (off_sum, diag_sum, cov_off_sum, cov_diag_sum); partials holds
// fb_fwd_partials(n, d) floats.
int fb_fwd(const float* f1, const float* f2, const float* b, const float* tf1,
           const float* tf2, const float* tb, const float* disc, float* partials,
           float* out, int n, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FB_DISPATCH(launch_fwd, f1, f2, b, tf1, tf2, tb, disc, partials, out, n, d, s)
}

// dF1, dF2 and the FB part of dB for the cotangent g[4]; partials holds
// fb_bwd_partials(n, d) floats.
int fb_bwd(const float* f1, const float* f2, const float* b, const float* tf1,
           const float* tf2, const float* tb, const float* disc, const float* g,
           float* partials, float* df1, float* df2, float* db, int n, int d,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FB_DISPATCH(launch_bwd, f1, f2, b, tf1, tf2, tb, disc, g, partials, df1, df2, db, n, d, s)
}

// counts[2] (host memory) = the runs of fb_fwd and of fb_bwd on the current
// device since the last fb_runs_reset. Unlike the launchers these two wait
// for the device, and must not be called while a stream is capturing.
int fb_runs(unsigned long long* counts) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyFromSymbol(counts, fb_run_counts, sizeof(fb_run_counts)));
}

int fb_runs_reset() {
  const unsigned long long zero[2] = {0ULL, 0ULL};
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyToSymbol(fb_run_counts, zero, sizeof(zero)));
}

}  // extern "C"
