// Fused Forward-Backward loss for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by controllable_agent_torch/ops/fused_fb.py).
//
// Replaces the four Pallas TPU kernels of controllable_agent_tpu/ops/pallas_fb.py:
//   fb_fwd_tile_kernel  <- _fwd_kernel     (pallas_fb.py:61)
//   fb_gram_kernel      <- _cov_kernel     (pallas_fb.py:91)
//   fb_bwd_df_kernel    <- _bwd_kernel     (pallas_fb.py:184)
//   fb_bwd_db_kernel    <- _bwd_db_kernel  (pallas_fb.py:219)
//
// Inputs are row-major float32 [n, d] (F1, F2, B and the targets TF1, TF2,
// TB), the discount [n, 1] and, for the backward, the cotangent g[4] of the
// four sums (off_sum, diag_sum, cov_off_sum, cov_diag_sum), read from device
// memory so that the backward needs no host sync.
//
// What bounds them on the H100: at the slice's shapes (n = 1024, d = 50) the
// inputs are ~1.4 MB while kernels 1, 3 and 4 do 8-12 n^2 d flops, so they
// are bound by arithmetic, not by bytes. The squared residuals amplify
// matmul noise, so the products run in float32 FMA on the CUDA cores
// (67 TFLOP/s peak), not on TF32 tensor cores. The n x n measure matrices
// never reach device memory: each block recomputes its tiles of
// M1 = F1 B^T, M2 = F2 B^T and TM = min(TF1 TB^T, TF2 TB^T) in registers and
// shared memory. Kernel 2 needs no n x n matrix at all: with G = B^T B
// (d x d), sum_{i != j} cov_ij^2 = |G|_F^2 - sum_i |b_i|^4 and
// sum_i cov_ii = trace G, ~2 n d^2 flops on 4 n d bytes, so it is bound by
// its launches. (The subtraction cancels little: for rank-d B with equal
// row norms, sum_i |b_i|^4 <= (d / n) |G|_F^2.)
//
// What the design does about the TPU's sequential grid: Hopper's blocks run
// in parallel and in no order, so
//   * kernels 1 and 2 write per-block partials to scratch and a second
//     one-block kernel (reduce_pairs_kernel, fb_gram_reduce_kernel) sums
//     them in a fixed order: no float atomics, so two runs give
//     bitwise-equal sums;
//   * kernel 3 gives each block a tile of 8 rows of dF and loops over all
//     column tiles inside the block; kernel 4 gives each block 8 columns
//     of dB and loops over the row tiles. 8-wide output tiles give
//     n / 8 = 128 blocks at n = 1024 for 132 SMs.
// The ragged edge (n not a multiple of the tile) is masked inside the
// kernels: rows/columns >= n load as zero and contribute nothing; inputs are
// never copied to pad n. d <= 64: tiles are staged in shared memory padded
// to 64 columns with zeros (d = 50 is not a multiple of 8 or 16).
//
// This is the simple, correct first version; wgmma/TMA come later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDP = 64;  // d padded

// kernel 1: square kT x kT tiles, d staged in chunks of kKC
constexpr int kT = 64;
constexpr int kKC = 16;

// kernel 2: kGramRows rows of B per block
constexpr int kGramRows = 64;

// kernel 3: kRowsDF rows of dF per block, column tiles of kColsDF
constexpr int kRowsDF = 8;
constexpr int kColsDF = 64;

// kernel 4: kColsDB columns of dB per block, row tiles of kRowsDB
constexpr int kColsDB = 8;
constexpr int kRowsDB = 32;

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

// The weight of entry (i, j) in the gradients of the FB sums:
//   w = 2 g_off (M - g_i TM) off(i, j) + g_diag diag(i, j), 0 outside n x n.
__device__ __forceinline__ void fb_weights(float m1, float m2, float t1,
                                           float t2, float gi, bool valid,
                                           bool diag, float g_off, float g_diag,
                                           float* w1, float* w2) {
  if (!valid) {
    *w1 = *w2 = 0.f;
  } else if (diag) {
    *w1 = *w2 = g_diag;
  } else {
    const float tm = fminf(t1, t2);
    *w1 = 2.f * g_off * (m1 - gi * tm);
    *w2 = 2.f * g_off * (m2 - gi * tm);
  }
}

// Kernel 3: dF1[i] = sum_j w1(i, j) B[j], dF2[i] = sum_j w2(i, j) B[j].
// A block owns kRowsDF rows of dF and loops over all column tiles.
__global__ void __launch_bounds__(kThreads)
fb_bwd_df_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                 const float* __restrict__ b, const float* __restrict__ tf1,
                 const float* __restrict__ tf2, const float* __restrict__ tb,
                 const float* __restrict__ disc, const float* __restrict__ g,
                 float* __restrict__ df1, float* __restrict__ df2, int n,
                 int d) {
  __shared__ float sF1[kRowsDF][kDP], sF2[kRowsDF][kDP];
  __shared__ float sTF1[kRowsDF][kDP], sTF2[kRowsDF][kDP];
  __shared__ float sB[kColsDF][kDP + 1], sTB[kColsDF][kDP + 1];
  __shared__ float sW1[kRowsDF][kColsDF], sW2[kRowsDF][kColsDF];
  const float g_off = g[0], g_diag = g[1];
  const int row0 = blockIdx.x * kRowsDF;
  // M entries: column c, rows rg and rg + 4; dF entries: column k = c,
  // rows rg and rg + 4.
  const int c = threadIdx.x % 64, rg = threadIdx.x / 64;

  load_rows(&sF1[0][0], kDP, f1, row0, kRowsDF, n, d);
  load_rows(&sF2[0][0], kDP, f2, row0, kRowsDF, n, d);
  load_rows(&sTF1[0][0], kDP, tf1, row0, kRowsDF, n, d);
  load_rows(&sTF2[0][0], kDP, tf2, row0, kRowsDF, n, d);

  float acc1[2] = {0.f, 0.f}, acc2[2] = {0.f, 0.f};
  for (int col0 = 0; col0 < n; col0 += kColsDF) {
    load_rows(&sB[0][0], kDP + 1, b, col0, kColsDF, n, d);
    load_rows(&sTB[0][0], kDP + 1, tb, col0, kColsDF, n, d);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = rg + 4 * a;
      float m1 = 0.f, m2 = 0.f, t1 = 0.f, t2 = 0.f;
      for (int k = 0; k < d; ++k) {
        const float bv = sB[c][k], tbv = sTB[c][k];
        m1 = fmaf(sF1[r][k], bv, m1);
        m2 = fmaf(sF2[r][k], bv, m2);
        t1 = fmaf(sTF1[r][k], tbv, t1);
        t2 = fmaf(sTF2[r][k], tbv, t2);
      }
      const int gr = row0 + r, gc = col0 + c;
      const bool valid = gr < n && gc < n;
      fb_weights(m1, m2, t1, t2, valid ? disc[gr] : 0.f, valid, gr == gc,
                 g_off, g_diag, &sW1[r][c], &sW2[r][c]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = rg + 4 * a;
      for (int j = 0; j < kColsDF; ++j) {
        const float bv = sB[j][c];
        acc1[a] = fmaf(sW1[r][j], bv, acc1[a]);
        acc2[a] = fmaf(sW2[r][j], bv, acc2[a]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int gr = row0 + rg + 4 * a;
    if (gr < n && c < d) {
      df1[gr * d + c] = acc1[a];
      df2[gr * d + c] = acc2[a];
    }
  }
}

// Kernel 4: dB[j] = sum_i w1(i, j) F1[i] + w2(i, j) F2[i].
// A block owns kColsDB columns of dB and loops over all row tiles.
__global__ void __launch_bounds__(kThreads)
fb_bwd_db_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                 const float* __restrict__ b, const float* __restrict__ tf1,
                 const float* __restrict__ tf2, const float* __restrict__ tb,
                 const float* __restrict__ disc, const float* __restrict__ g,
                 float* __restrict__ db, int n, int d) {
  __shared__ float sB[kColsDB][kDP], sTB[kColsDB][kDP];
  __shared__ float sF1[kRowsDB][kDP + 1], sF2[kRowsDB][kDP + 1];
  __shared__ float sTF1[kRowsDB][kDP + 1], sTF2[kRowsDB][kDP + 1];
  __shared__ float sW1[kRowsDB][kColsDB], sW2[kRowsDB][kColsDB];
  const float g_off = g[0], g_diag = g[1];
  const int col0 = blockIdx.x * kColsDB;
  // M entries: row r (lane), column cc (warp); dB entries: k, columns
  // cg and cg + 4.
  const int r = threadIdx.x % 32, cc = threadIdx.x / 32;
  const int k = threadIdx.x % 64, cg = threadIdx.x / 64;

  load_rows(&sB[0][0], kDP, b, col0, kColsDB, n, d);
  load_rows(&sTB[0][0], kDP, tb, col0, kColsDB, n, d);

  float acc[2] = {0.f, 0.f};
  for (int row0 = 0; row0 < n; row0 += kRowsDB) {
    load_rows(&sF1[0][0], kDP + 1, f1, row0, kRowsDB, n, d);
    load_rows(&sF2[0][0], kDP + 1, f2, row0, kRowsDB, n, d);
    load_rows(&sTF1[0][0], kDP + 1, tf1, row0, kRowsDB, n, d);
    load_rows(&sTF2[0][0], kDP + 1, tf2, row0, kRowsDB, n, d);
    __syncthreads();
    {
      float m1 = 0.f, m2 = 0.f, t1 = 0.f, t2 = 0.f;
      for (int kk = 0; kk < d; ++kk) {
        const float bv = sB[cc][kk], tbv = sTB[cc][kk];
        m1 = fmaf(sF1[r][kk], bv, m1);
        m2 = fmaf(sF2[r][kk], bv, m2);
        t1 = fmaf(sTF1[r][kk], tbv, t1);
        t2 = fmaf(sTF2[r][kk], tbv, t2);
      }
      const int gr = row0 + r, gc = col0 + cc;
      const bool valid = gr < n && gc < n;
      fb_weights(m1, m2, t1, t2, valid ? disc[gr] : 0.f, valid, gr == gc,
                 g_off, g_diag, &sW1[r][cc], &sW2[r][cc]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int col = cg + 4 * a;
      for (int i = 0; i < kRowsDB; ++i) {
        acc[a] = fmaf(sW1[i][col], sF1[i][k], acc[a]);
        acc[a] = fmaf(sW2[i][col], sF2[i][k], acc[a]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int gc = col0 + cg + 4 * a;
    if (gc < n && k < d) db[gc * d + k] = acc[a];
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 on success).

extern "C" {

int fb_max_d() { return kDP; }

// Number of floats of scratch that fb_fwd_sums needs.
int fb_fwd_partials(int n) {
  const int t = cdiv(n, kT);
  return 2 * t * t;
}

// Number of floats of scratch that fb_cov_sums needs.
int fb_cov_partials(int n, int d) { return cdiv(n, kGramRows) * (d * d + 1); }

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

int fb_bwd_df(const float* f1, const float* f2, const float* b,
              const float* tf1, const float* tf2, const float* tb,
              const float* disc, const float* g, float* df1, float* df2, int n,
              int d, void* stream) {
  fb_bwd_df_kernel<<<cdiv(n, kRowsDF), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      f1, f2, b, tf1, tf2, tb, disc, g, df1, df2, n, d);
  return static_cast<int>(cudaGetLastError());
}

int fb_bwd_db(const float* f1, const float* f2, const float* b,
              const float* tf1, const float* tf2, const float* tb,
              const float* disc, const float* g, float* db, int n, int d,
              void* stream) {
  fb_bwd_db_kernel<<<cdiv(n, kColsDB), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      f1, f2, b, tf1, tf2, tb, disc, g, db, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
