// The optimizer layer for Hopper (sm_90a): one multi-tensor Adam step and one
// multi-tensor soft-update (lerp) kernel, CUDA C++ with a plain C interface
// (loaded with ctypes by controllable_agent_torch/optim.py).
//
//   adam_multi_tensor_apply_kernel<MuT>  <- optim.py:adam_plain, ~16 torch._foreach_*
//                                           calls and the bias corrections' and
//                                           count's small kernels (~23 launches)
//   lerp_multi_tensor_apply_kernel       <- torch._foreach_lerp_ (utils/tree.py)
//
// Replaces no TPU kernel: the JAX package leaves optax's Adam and its
// target-network updates to XLA, which fuses each into a few loops. They are
// named as PyTorch's own multi-tensor kernels are, "multi_tensor_apply_kernel",
// because that is what they are, and what a trace finds the layer by.
//
// What bounds them on the H100: bytes. A step reads p, g, mu, nu once and
// writes p, mu, nu once, 24 B a parameter with a bfloat16 mu and 28 B with a
// float32 one, for ~15 flops: at 3.35 TB/s, 5.9M parameters take ~42 us. A
// soft-update reads the target and the online parameters and writes the
// target, 12 B a parameter. The _foreach sequence moved ~134 B a parameter.
//
// What the design does about it:
//  - One pass: each element of each tensor is loaded once, updated in
//    registers and stored once, 16-byte loads and stores (4 elements; 8 bytes
//    for a bfloat16 mu) where all of an element group's tensors are aligned,
//    a scalar loop for a misaligned tensor and a tensor's last n % 4 elements.
//  - Multi-tensor apply: the tensors' addresses and sizes travel by value in
//    the launch's argument block (under 4 KB), as PyTorch's multi_tensor_apply
//    does, with a prefix table of each tensor's chunks of kChunk elements that
//    the launcher builds from the sizes. A block takes chunks c = blockIdx.x,
//    + gridDim.x, ... and finds a chunk's tensor by binary search in that
//    table (the first i with chunk_end[i] > c). A CUDA graph freezes the
//    argument block: the addresses are those of the parameters, the moments
//    and the graph pool's gradients, the tensors every replay reads and
//    writes. A list longer than a block holds is split into several launches
//    by the caller (optim.py:plan).
//  - The grid fills every SM (resident blocks per SM x SMs), at most one block
//    a chunk.
//  - The step count lives in device memory: every block reads it at its start
//    and takes t = count + 1 for the bias corrections 1 - b^t (powf, as
//    torch.pow computes them); the last block of the step's last launch to
//    finish (a fence and an atomic ticket) stores t and resets the ticket.
//    Nothing reads the count after it is written, and a replay advances it.
//  - The arithmetic is optax's, in the order and with the roundings of
//    optim.py:adam_plain's _foreach calls, each of which rounds to float32 (or
//    mu's dtype) when it stores: __fmul_rn, __fadd_rn, __fdiv_rn and
//    __fsqrt_rn, which nvcc never contracts, and one fmaf where PyTorch's
//    kernel computes a + alpha * b in one expression, which nvcc contracts
//    (the parameter's update, _foreach_add_(params, update, alpha=-lr), and
//    the lerp). The card tests hold both kernels to the _foreach versions to
//    the bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                      // elements per 16-byte access
constexpr int kChunk = 2048;                 // elements a block takes at a time
constexpr int kSweeps = kChunk / (kThreads * kVec);
constexpr int kAdamMaxTensors = 64;          // Table<4, 64>: 2,820 bytes
constexpr int kLerpMaxTensors = 128;         // Table<2, 128>: 3,588 bytes
static_assert(kChunk % (kThreads * kVec) == 0, "a chunk is whole sweeps");

// A launch's tensors: kLists lists (Adam: p, g, mu, nu; lerp: target, src)
// of `tensors` tensors each, their sizes and the prefix table of their chunks
template <int kLists, int kMax>
struct Table {
  void* x[kLists][kMax];
  int64_t n[kMax];
  int chunk_end[kMax];  // chunks of tensors 0..i
  int tensors;

  // the chunk c's tensor k and its elements [start, end) of that tensor
  __device__ __forceinline__ int find(int c, int64_t& start, int64_t& end) const {
    int lo = 0, hi = tensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk_end[mid] > c) hi = mid; else lo = mid + 1;
    }
    start = static_cast<int64_t>(c - (lo > 0 ? chunk_end[lo - 1] : 0)) * kChunk;
    end = start + kChunk < n[lo] ? start + kChunk : n[lo];
    return lo;
  }

  __device__ __forceinline__ int chunks() const {
    return tensors > 0 ? chunk_end[tensors - 1] : 0;
  }
};

using AdamTable = Table<4, kAdamMaxTensors>;
using LerpTable = Table<2, kLerpMaxTensors>;

struct AdamArgs {
  int* count;      // the step count (int32, device memory)
  unsigned* ticket;  // 0 between launches
  float neg_lr, b1, b2, c1, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2 (rounded from double)
  int advance;     // whether this launch is its step's last, which advances the count
};

__device__ __forceinline__ bool aligned(const void* x, int bytes) {
  return (reinterpret_cast<uintptr_t>(x) & (bytes - 1)) == 0;
}

// mu's dtype: its load, store and the decayed moment b1 * mu rounded in it
template <typename MuT> struct Mu;

template <> struct Mu<float> {
  static constexpr int kVecBytes = 16;
  __device__ static float decay(float mu, float b1) { return __fmul_rn(mu, b1); }
  __device__ static float load(const void* base, int64_t i) {
    return static_cast<const float*>(base)[i];
  }
  __device__ static void store(void* base, int64_t i, float v) {
    static_cast<float*>(base)[i] = v;
  }
  __device__ static float4 load4(const void* base, int64_t i) {
    return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
  }
  __device__ static void store4(void* base, int64_t i, float4 v) {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) = v;
  }
};

template <> struct Mu<__nv_bfloat16> {
  static constexpr int kVecBytes = 8;
  __device__ static float decay(float mu, float b1) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(mu, b1)));
  }
  __device__ static float load(const void* base, int64_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  }
  __device__ static void store(void* base, int64_t i, float v) {
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  }
  __device__ static float4 load4(const void* base, int64_t i) {
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(base) + i);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
  }
  __device__ static void store4(void* base, int64_t i, float4 v) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v.x, v.y);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + i) = raw;
  }
};

struct AdamStep {
  float neg_lr, b1, b2, c1, c2, eps, bc1, bc2;

  // One element, as optim.py:adam_plain's _foreach calls compute it; mu is
  // read and returned in float32 (the caller rounds it into mu's dtype).
  template <typename MuT>
  __device__ __forceinline__ void apply(float& p, float g, float& mu, float& nu) const {
    const float decayed = Mu<MuT>::decay(mu, b1);             // _foreach_mul(mus, b1)
    const float m = __fadd_rn(__fmul_rn(g, c1), decayed);     // g * (1 - b1) + decayed
    const float sq = __fmul_rn(__fmul_rn(g, g), c2);          // (g * g) * (1 - b2)
    nu = __fadd_rn(__fmul_rn(nu, b2), sq);                    // nu * b2 + sq
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), eps);
    const float update = __fdiv_rn(__fdiv_rn(m, bc1), denom);
    p = fmaf(neg_lr, update, p);                              // p + (-lr) * update, one fma
    mu = m;
  }
};

template <typename MuT>
__global__ void __launch_bounds__(kThreads)
adam_multi_tensor_apply_kernel(const __grid_constant__ AdamTable table, const AdamArgs args) {
  __shared__ float bias[2];
  __shared__ int step;
  if (threadIdx.x == 0) {
    const int t = __ldcg(args.count) + 1;
    const float tf = __int2float_rn(t);
    bias[0] = __fsub_rn(1.0f, powf(args.b1, tf));
    bias[1] = __fsub_rn(1.0f, powf(args.b2, tf));
    step = t;
  }
  __syncthreads();
  const AdamStep op{args.neg_lr, args.b1, args.b2, args.c1, args.c2, args.eps, bias[0], bias[1]};
  for (int c = blockIdx.x; c < table.chunks(); c += gridDim.x) {
    int64_t start, end;
    const int k = table.find(c, start, end);
    float* p = static_cast<float*>(table.x[0][k]);
    const float* g = static_cast<const float*>(table.x[1][k]);
    void* mu = table.x[2][k];
    float* nu = static_cast<float*>(table.x[3][k]);
    int64_t scalar_from = start;
    if (aligned(p, 16) && aligned(g, 16) && aligned(nu, 16) && aligned(mu, Mu<MuT>::kVecBytes)) {
      const int64_t vec_end = start + (end - start) / kVec * kVec;
      float4 pv[kSweeps], gv[kSweeps], mv[kSweeps], nv[kSweeps];
#pragma unroll
      for (int s = 0; s < kSweeps; ++s) {
        const int64_t i = start + (s * kThreads + threadIdx.x) * kVec;
        if (i < vec_end) {
          pv[s] = *reinterpret_cast<const float4*>(p + i);
          gv[s] = *reinterpret_cast<const float4*>(g + i);
          mv[s] = Mu<MuT>::load4(mu, i);
          nv[s] = *reinterpret_cast<const float4*>(nu + i);
        }
      }
#pragma unroll
      for (int s = 0; s < kSweeps; ++s) {
        const int64_t i = start + (s * kThreads + threadIdx.x) * kVec;
        if (i < vec_end) {
          op.apply<MuT>(pv[s].x, gv[s].x, mv[s].x, nv[s].x);
          op.apply<MuT>(pv[s].y, gv[s].y, mv[s].y, nv[s].y);
          op.apply<MuT>(pv[s].z, gv[s].z, mv[s].z, nv[s].z);
          op.apply<MuT>(pv[s].w, gv[s].w, mv[s].w, nv[s].w);
          *reinterpret_cast<float4*>(p + i) = pv[s];
          Mu<MuT>::store4(mu, i, mv[s]);
          *reinterpret_cast<float4*>(nu + i) = nv[s];
        }
      }
      scalar_from = vec_end;
    }
    for (int64_t i = scalar_from + threadIdx.x; i < end; i += kThreads) {
      float pi = p[i], mi = Mu<MuT>::load(mu, i), ni = nu[i];
      op.apply<MuT>(pi, g[i], mi, ni);
      p[i] = pi;
      Mu<MuT>::store(mu, i, mi);
      nu[i] = ni;
    }
  }
  if (args.advance && threadIdx.x == 0) {
    // every block read the count before it takes its ticket: the last one
    // to take a ticket is the last reader, and writes
    __threadfence();
    if (atomicAdd(args.ticket, 1u) == gridDim.x - 1) {
      *args.count = step;
      *args.ticket = 0u;
    }
  }
}

// torch's lerp (ATen/native/Lerp.h) in float32: self + w * (end - self) for
// |w| < 0.5, else end - (end - self) * (1 - w); each a + b * c is one fma in
// PyTorch's compiled kernel
__device__ __forceinline__ float lerp_one(float self, float end, float w, float one_minus_w,
                                          bool small) {
  const float diff = __fsub_rn(end, self);
  return small ? fmaf(w, diff, self) : fmaf(-diff, one_minus_w, end);
}

__global__ void __launch_bounds__(kThreads)
lerp_multi_tensor_apply_kernel(const __grid_constant__ LerpTable table, const float w) {
  const bool small = fabsf(w) < 0.5f;
  const float one_minus_w = __fsub_rn(1.0f, w);
  for (int c = blockIdx.x; c < table.chunks(); c += gridDim.x) {
    int64_t start, end;
    const int k = table.find(c, start, end);
    float* t = static_cast<float*>(table.x[0][k]);
    const float* x = static_cast<const float*>(table.x[1][k]);
    int64_t scalar_from = start;
    if (aligned(t, 16) && aligned(x, 16)) {
      const int64_t vec_end = start + (end - start) / kVec * kVec;
      float4 tv[kSweeps], xv[kSweeps];
#pragma unroll
      for (int s = 0; s < kSweeps; ++s) {
        const int64_t i = start + (s * kThreads + threadIdx.x) * kVec;
        if (i < vec_end) {
          tv[s] = *reinterpret_cast<const float4*>(t + i);
          xv[s] = *reinterpret_cast<const float4*>(x + i);
        }
      }
#pragma unroll
      for (int s = 0; s < kSweeps; ++s) {
        const int64_t i = start + (s * kThreads + threadIdx.x) * kVec;
        if (i < vec_end) {
          float4 r;
          r.x = lerp_one(tv[s].x, xv[s].x, w, one_minus_w, small);
          r.y = lerp_one(tv[s].y, xv[s].y, w, one_minus_w, small);
          r.z = lerp_one(tv[s].z, xv[s].z, w, one_minus_w, small);
          r.w = lerp_one(tv[s].w, xv[s].w, w, one_minus_w, small);
          *reinterpret_cast<float4*>(t + i) = r;
        }
      }
      scalar_from = vec_end;
    }
    for (int64_t i = scalar_from + threadIdx.x; i < end; i += kThreads) {
      t[i] = lerp_one(t[i], x[i], w, one_minus_w, small);
    }
  }
}

// The launch's table from the lists' addresses and the sizes: the number of
// chunks, or -1 for a negative size or more chunks than an int counts.
template <typename T, int kLists>
int fill(T& table, int tensors, void* const* const (&lists)[kLists], const long long* n) {
  table.tensors = tensors;
  long long chunks = 0;
  for (int i = 0; i < tensors; ++i) {
    if (n[i] < 0) return -1;
    chunks += (n[i] + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return -1;
    table.n[i] = n[i];
    table.chunk_end[i] = static_cast<int>(chunks);
    for (int l = 0; l < kLists; ++l) table.x[l][i] = lists[l][i];
  }
  return static_cast<int>(chunks);
}

// Launch `kernel` over `chunks` chunks, with a grid of at most a block a chunk
// and as many as the card holds at once (resident blocks per SM x SMs,
// computed once into `cap`: one kind of card).
template <typename T, typename... Args>
int launch(void (*kernel)(T, Args...), int* cap, int chunks, cudaStream_t stream,
           const T& table, Args... args) {
  if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (*cap <= 0) {
    int device = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&device) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, reinterpret_cast<const void*>(kernel), kThreads, 0) != cudaSuccess) {
      const int err = static_cast<int>(cudaGetLastError());
      return err != 0 ? err : static_cast<int>(cudaErrorUnknown);
    }
    *cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = chunks < 1 ? 1 : (chunks < *cap ? chunks : *cap);
  kernel<<<grid, kThreads, 0, stream>>>(table, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each returns a CUDA error code (0 on success); the
// launchers launch on the given stream, do not synchronise and allocate
// nothing.

extern "C" {

// The most tensors one launch takes: kernel 0 Adam, 1 lerp.
int optim_max_tensors(int kernel) { return kernel == 0 ? kAdamMaxTensors : kLerpMaxTensors; }

// One Adam launch over `tensors` tensors (float32 p, g, nu; mu float32, or
// bfloat16 where mu_bf16 != 0; each contiguous with n[i] elements).
// advance != 0 on the step's last launch: its last block stores count + 1.
// count is int32 and ticket uint32 in device memory, the ticket 0 between
// launches.
int optim_adam(int mu_bf16, int tensors, void* const* p, void* const* g, void* const* mu,
               void* const* nu, const long long* n, float neg_lr, float b1, float b2,
               float c1, float c2, float eps, void* count, void* ticket, int advance,
               void* stream) {
  static int cap_f32 = 0, cap_bf16 = 0;
  if (tensors < 0 || tensors > kAdamMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  AdamTable table;
  void* const* const lists[4] = {p, g, mu, nu};
  const int chunks = fill(table, tensors, lists, n);
  const AdamArgs args{static_cast<int*>(count), static_cast<unsigned*>(ticket), neg_lr, b1,
                      b2, c1, c2, eps, advance};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mu_bf16
      ? launch(adam_multi_tensor_apply_kernel<__nv_bfloat16>, &cap_bf16, chunks, s, table, args)
      : launch(adam_multi_tensor_apply_kernel<float>, &cap_f32, chunks, s, table, args);
}

// target[i] <- lerp(target[i], src[i], weight) over `tensors` float32
// tensors, contiguous, with n[i] elements.
int optim_lerp(int tensors, void* const* target, void* const* src, const long long* n,
               float weight, void* stream) {
  static int cap = 0;
  if (tensors < 0 || tensors > kLerpMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  LerpTable table;
  void* const* const lists[2] = {target, src};
  const int chunks = fill(table, tensors, lists, n);
  return launch(lerp_multi_tensor_apply_kernel, &cap, chunks,
                static_cast<cudaStream_t>(stream), table, weight);
}

}  // extern "C"
