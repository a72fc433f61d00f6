// Fused Forward-Backward loss for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by controllable_agent_torch/ops/fused_fb.py).
//
// Replaces the four Pallas TPU kernels of controllable_agent_tpu/ops/pallas_fb.py:
//   fb_fwd_tile_kernel  <- _fwd_kernel     (pallas_fb.py:61)
//   fb_gram_kernel      <- _cov_kernel     (pallas_fb.py:91)
//   fb_bwd_tile_kernel  <- _bwd_kernel     (pallas_fb.py:184)
//                      and _bwd_db_kernel  (pallas_fb.py:219)
// each followed by a one-pass fixed-order reduction of its per-block partials
// (reduce_pairs_kernel, fb_gram_reduce_kernel, fb_bwd_reduce_kernel).
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
// Kernel 2 needs no n x n matrix at all: with G = B^T B (d x d),
// sum_{i != j} cov_ij^2 = |G|_F^2 - sum_i |b_i|^4 and sum_i cov_ii = trace G,
// ~2 n d^2 flops on 4 n d bytes, so it is bound by its launches. (The
// subtraction cancels little: for rank-d B with equal row norms,
// sum_i |b_i|^4 <= (d / n) |G|_F^2.)
//
// What the design does about the TPU's sequential grid: Hopper's blocks run
// in parallel and in no order, so every kernel writes per-block partials to
// scratch and a second kernel sums them in a fixed order: no float atomics,
// so two runs give bitwise-equal results.
//
// The forward (kernel 1) runs float32 FMA on the CUDA cores with 4 x 4
// register tiles. The backward (fb_bwd_tile_kernel) runs on the tensor
// cores, mma.sync m16n8k8 in 3xTF32. One block of 8 warps owns one 64 x 64
// tile (rows i, columns j) of the n x n plane, 256 blocks at n = 1024 for
// 132 SMs, two resident per SM (104 KB of shared memory each):
//   1. it stages its row tiles of TF1, TF2, F1, F2 and its column tiles of
//      TB, B into shared memory once, with cp.async (8-byte pieces: rows of
//      [n, 50] float32 are 200 bytes apart, so neither TMA nor 16-byte
//      cp.async can address them), in two commit groups so that TM is
//      formed while F1, F2, B are still arriving;
//   2. each warp forms TM, M1, M2 for a 16 x 32 part of the tile, then
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
// with zeros to 64 columns (kernels 1, 2) or to a multiple of 8, mma's depth
// (the backward, compiled for each of the 8 paddings).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kDP = 64;  // d padded

// kernel 1: square kT x kT tiles, d staged in chunks of kKC
constexpr int kT = 64;
constexpr int kKC = 16;

// kernel 2: kGramRows rows of B per block
constexpr int kGramRows = 64;

// backward: square kBT x kBT tiles; six staged matrices of kBT rows of
// pitch kBP, in dynamic shared memory
constexpr int kBT = 64;
constexpr int kBP = kDP + 4;  // = 4 (mod 32)
constexpr int kBMat = kBT * kBP;
constexpr int kBwdSmemBytes = 6 * kBMat * static_cast<int>(sizeof(float));

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Sum of one value per thread over the block, in a fixed tree order.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// Stage rows [row0, row0 + kT) x columns [k0, k0 + kKC) of x into s,
// zero outside n x d.
__device__ void load_chunk(float (*s)[kKC + 1], const float* x, int row0,
                           int k0, int n, int d) {
  for (int e = threadIdx.x; e < kT * kKC; e += kThreads) {
    const int r = e / kKC, kk = e % kKC;
    const int gr = row0 + r, k = k0 + kk;
    s[r][kk] = (gr < n && k < d) ? x[gr * d + k] : 0.f;
  }
}

// Stage rows [row0, row0 + rows) x all d columns of x into s (row pitch
// `pitch`), zero outside n x d.
__device__ void load_rows(float* s, int pitch, const float* x, int row0,
                          int rows, int n, int d) {
  for (int e = threadIdx.x; e < rows * kDP; e += kThreads) {
    const int r = e / kDP, k = e % kDP;
    const int gr = row0 + r;
    s[r * pitch + k] = (gr < n && k < d) ? x[gr * d + k] : 0.f;
  }
}

// Kernel 1: per 64x64 tile of (rows i, columns j), the partial sums
//   off  = sum_{i != j} (M1 - g_i TM)^2 + (M2 - g_i TM)^2
//   diag = sum_{i == j} M1 + M2
// Thread (tx, ty) owns rows ty + 16a and columns tx + 16b, a, b < 4.
__global__ void __launch_bounds__(kThreads)
fb_fwd_tile_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   const float* __restrict__ b, const float* __restrict__ tf1,
                   const float* __restrict__ tf2, const float* __restrict__ tb,
                   const float* __restrict__ disc, float* __restrict__ partials,
                   int n, int d) {
  __shared__ float sF1[kT][kKC + 1], sF2[kT][kKC + 1];
  __shared__ float sTF1[kT][kKC + 1], sTF2[kT][kKC + 1];
  __shared__ float sB[kT][kKC + 1], sTB[kT][kKC + 1];
  __shared__ float red[kThreads];
  const int row0 = blockIdx.y * kT, col0 = blockIdx.x * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float m1[4][4], m2[4][4], t1[4][4], t2[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) m1[a][c] = m2[a][c] = t1[a][c] = t2[a][c] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kKC) {
    load_chunk(sF1, f1, row0, k0, n, d);
    load_chunk(sF2, f2, row0, k0, n, d);
    load_chunk(sTF1, tf1, row0, k0, n, d);
    load_chunk(sTF2, tf2, row0, k0, n, d);
    load_chunk(sB, b, col0, k0, n, d);
    load_chunk(sTB, tb, col0, k0, n, d);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      float a1[4], a2[4], at1[4], at2[4], bb[4], tbb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        a1[a] = sF1[r][kk];
        a2[a] = sF2[r][kk];
        at1[a] = sTF1[r][kk];
        at2[a] = sTF2[r][kk];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        bb[c] = sB[col][kk];
        tbb[c] = sTB[col][kk];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          m1[a][c] = fmaf(a1[a], bb[c], m1[a][c]);
          m2[a][c] = fmaf(a2[a], bb[c], m2[a][c]);
          t1[a][c] = fmaf(at1[a], tbb[c], t1[a][c]);
          t2[a][c] = fmaf(at2[a], tbb[c], t2[a][c]);
        }
    }
    __syncthreads();
  }

  float off = 0.f, dg = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gr = row0 + ty + 16 * a;
    if (gr >= n) continue;
    const float g = disc[gr];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gc = col0 + tx + 16 * c;
      if (gc >= n) continue;
      if (gr == gc) {
        dg += m1[a][c] + m2[a][c];
      } else {
        const float tm = fminf(t1[a][c], t2[a][c]);
        const float r1 = m1[a][c] - g * tm, r2 = m2[a][c] - g * tm;
        off += r1 * r1 + r2 * r2;
      }
    }
  }
  off = block_sum(off, red);
  dg = block_sum(dg, red);
  if (threadIdx.x == 0) {
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * blk] = off;
    partials[2 * blk + 1] = dg;
  }
}

// Kernel 2, first pass: per block of kGramRows rows of B, the partial Gram
// matrix sum_i b_i b_i^T (d x d, row-major) and sum_i |b_i|^4, written as
// d * d + 1 floats at partials + block * (d * d + 1).
__global__ void __launch_bounds__(kThreads)
fb_gram_kernel(const float* __restrict__ b, float* __restrict__ partials,
               int n, int d) {
  __shared__ float sB[kGramRows][kDP + 1];
  __shared__ float red[kThreads];
  load_rows(&sB[0][0], kDP + 1, b, blockIdx.x * kGramRows, kGramRows, n, d);
  __syncthreads();
  const int dd = d * d;
  float* out = partials + blockIdx.x * (dd + 1);
  for (int e = threadIdx.x; e < dd; e += kThreads) {
    const int k = e / d, l = e % d;
    float s = 0.f;
    for (int r = 0; r < kGramRows; ++r) s = fmaf(sB[r][k], sB[r][l], s);
    out[e] = s;
  }
  float q = 0.f;
  if (threadIdx.x < kGramRows) {
    float sq = 0.f;
    for (int k = 0; k < d; ++k) sq = fmaf(sB[threadIdx.x][k], sB[threadIdx.x][k], sq);
    q = sq * sq;  // rows >= n are zero
  }
  q = block_sum(q, red);
  if (threadIdx.x == 0) out[dd] = q;
}

// Kernel 2, second pass (one block): G = sum of the partial Gram matrices
// in a fixed order, then
//   out[0] = sum_{i != j} cov_ij^2 = |G|_F^2 - sum_i |b_i|^4,
//   out[1] = sum_i cov_ii = trace G.
__global__ void __launch_bounds__(kThreads)
fb_gram_reduce_kernel(const float* __restrict__ partials, int num_blocks,
                      int d, float* __restrict__ out) {
  __shared__ float red[kThreads];
  const int dd = d * d, stride = dd + 1;
  float fro = 0.f, tr = 0.f, q = 0.f;
  for (int e = threadIdx.x; e < dd; e += kThreads) {
    float s = 0.f;
    for (int p = 0; p < num_blocks; ++p) s += partials[p * stride + e];
    fro = fmaf(s, s, fro);
    if (e / d == e % d) tr += s;
  }
  for (int p = threadIdx.x; p < num_blocks; p += kThreads) q += partials[p * stride + dd];
  fro = block_sum(fro, red);
  tr = block_sum(tr, red);
  q = block_sum(q, red);
  if (threadIdx.x == 0) {
    out[0] = fro - q;
    out[1] = tr;
  }
}

// Second pass of kernel 1: out[0..1] = sum over blocks of the partial
// pairs, in a fixed order (one block).
__global__ void __launch_bounds__(kThreads)
reduce_pairs_kernel(const float* __restrict__ partials, int num_blocks,
                    float* __restrict__ out) {
  __shared__ float red[kThreads];
  float a = 0.f, c = 0.f;
  for (int i = threadIdx.x; i < num_blocks; i += kThreads) {
    a += partials[2 * i];
    c += partials[2 * i + 1];
  }
  a = block_sum(a, red);
  c = block_sum(c, red);
  if (threadIdx.x == 0) {
    out[0] = a;
    out[1] = c;
  }
}

// ---------------------------------------------------------------------------
// The backward: tensor-core helpers.

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage rows [row0, row0 + kBT) x columns [0, kPad) of x into s (row pitch
// kBP), zero outside n x d: cp.async of 8-byte pieces when `pairs` (d even,
// x 8-byte aligned), else of 4-byte ones. Each thread keeps one column (or
// pair) and steps over rows, so the addresses need no division. The caller
// commits the group.
template <int kPad>
__device__ void stage_tile(float* s, const float* __restrict__ x, int row0,
                           int n, int d, bool pairs) {
  if (pairs) {
    const int c = 2 * (threadIdx.x % 32), r0 = threadIdx.x / 32;
    if (c >= kPad) return;
#pragma unroll
    for (int r = r0; r < kBT; r += kThreads / 32) {
      float* dst = s + r * kBP + c;
      if (row0 + r < n && c < d) {
        cp_async8(dst, x + static_cast<size_t>(row0 + r) * d + c);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(0.f, 0.f);
      }
    }
  } else {
    const int c = threadIdx.x % 64, r0 = threadIdx.x / 64;
    if (c >= kPad) return;
#pragma unroll
    for (int r = r0; r < kBT; r += kThreads / 64) {
      float* dst = s + r * kBP + c;
      if (row0 + r < n && c < d) {
        cp_async4(dst, x + static_cast<size_t>(row0 + r) * d + c);
      } else {
        *dst = 0.f;
      }
    }
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
#pragma unroll 1
    for (int ks = 0; ks < kSteps; ++ks) {
      FragB fb[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) fb[nt] = frag_b(sTB + b_off + 8 * nt * kBP + 8 * ks);
      const FragA fa1 = frag_a(sTF1 + a_off + 8 * ks);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_3xtf32(t1[nt], fa1, fb[nt]);
      const FragA fa2 = frag_a(sTF2 + a_off + 8 * ks);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_3xtf32(t2[nt], fa2, fb[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) tm[nt][q] = fminf(t1[nt][q], t2[nt][q]);
  }
  cp_async_wait<0>();
  __syncthreads();  // also: every warp is done reading TF1, TF2, TB
  float w1[4][4] = {}, w2[4][4] = {};  // M1, M2, then the weights
#pragma unroll 1
  for (int ks = 0; ks < kSteps; ++ks) {
    FragB fb[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) fb[nt] = frag_b(sB + b_off + 8 * nt * kBP + 8 * ks);
    const FragA fa1 = frag_a(sF1 + a_off + 8 * ks);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_3xtf32(w1[nt], fa1, fb[nt]);
    const FragA fa2 = frag_a(sF2 + a_off + 8 * ks);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_3xtf32(w2[nt], fa2, fb[nt]);
  }

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

// Launch both passes for d padded to 8 kSteps.
template <int kSteps>
int launch_bwd(const float* f1, const float* f2, const float* b, const float* tf1,
               const float* tf2, const float* tb, const float* disc, const float* g,
               float* partials, float* df1, float* df2, float* db, int n, int d,
               cudaStream_t s) {
  // The dynamic shared memory above 48 KB is opted into once per device.
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(fb_bwd_tile_kernel<kSteps>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBwdSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) configured[dev] = true;
  }
  const int pairs = d % 2 == 0 && aligned8(f1) && aligned8(f2) && aligned8(b) &&
                    aligned8(tf1) && aligned8(tf2) && aligned8(tb);
  const int tiles = cdiv(n, kBT);
  fb_bwd_tile_kernel<kSteps><<<dim3(tiles, tiles), kThreads, kBwdSmemBytes, s>>>(
      f1, f2, b, tf1, tf2, tb, disc, g, partials, n, d, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_bwd_reduce_kernel<<<cdiv(3 * n * d, kThreads), kThreads, 0, s>>>(
      partials, tiles, n, d, 8 * kSteps, df1, df2, db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the given stream, does not synchronise,
// allocates nothing, and returns a CUDA error code (0 on success).

extern "C" {

int fb_max_d() { return kDP; }

// Number of floats of scratch that fb_fwd_sums needs.
int fb_fwd_partials(int n) {
  const int t = cdiv(n, kT);
  return 2 * t * t;
}

// Number of floats of scratch that fb_cov_sums needs.
int fb_cov_partials(int n, int d) { return cdiv(n, kGramRows) * (d * d + 1); }

// Number of floats of scratch that fb_bwd needs.
int fb_bwd_partials(int n, int d) { return 3 * cdiv(n, kBT) * n * 8 * cdiv(d, 8); }

int fb_fwd_sums(const float* f1, const float* f2, const float* b,
                const float* tf1, const float* tf2, const float* tb,
                const float* disc, float* partials, float* out, int n, int d,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(cdiv(n, kT), cdiv(n, kT));
  fb_fwd_tile_kernel<<<grid, kThreads, 0, s>>>(f1, f2, b, tf1, tf2, tb, disc,
                                               partials, n, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_pairs_kernel<<<1, kThreads, 0, s>>>(partials, grid.x * grid.y, out);
  return static_cast<int>(cudaGetLastError());
}

int fb_cov_sums(const float* b, float* partials, float* out, int n, int d,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = cdiv(n, kGramRows);
  fb_gram_kernel<<<blocks, kThreads, 0, s>>>(b, partials, n, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_gram_reduce_kernel<<<1, kThreads, 0, s>>>(partials, blocks, d, out);
  return static_cast<int>(cudaGetLastError());
}

// dF1, dF2 and the FB part of dB for the cotangent g[4]; partials holds
// fb_bwd_partials(n, d) floats.
int fb_bwd(const float* f1, const float* f2, const float* b, const float* tf1,
           const float* tf2, const float* tb, const float* disc, const float* g,
           float* partials, float* df1, float* df2, float* db, int n, int d,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cdiv(d, 8)) {
#define FB_BWD_CASE(k) \
  case k:              \
    return launch_bwd<k>(f1, f2, b, tf1, tf2, tb, disc, g, partials, df1, df2, db, n, d, s);
    FB_BWD_CASE(1) FB_BWD_CASE(2) FB_BWD_CASE(3) FB_BWD_CASE(4)
    FB_BWD_CASE(5) FB_BWD_CASE(6) FB_BWD_CASE(7) FB_BWD_CASE(8)
#undef FB_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
