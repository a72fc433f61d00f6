// The optimizer layer for Hopper (sm_90a): one multi-tensor Adam step and one
// multi-tensor soft-update (lerp) kernel, CUDA C++ with a plain C interface
// (loaded with ctypes by controllable_agent_torch/optim.py), and the cast that
// refreshes the bfloat16 compute copies of parameters written by anything else.
//
//   adam_multi_tensor_apply_kernel<MuT>  <- optim.py:adam_plain, ~16 torch._foreach_*
//                                           calls and the bias corrections' and
//                                           count's small kernels (~23 launches)
//   lerp_multi_tensor_apply_kernel       <- torch._foreach_lerp_ (utils/tree.py)
//   bf16_copy_refresh_kernel             <- one .copy_ a tensor (optim.py:Bf16Copy)
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
// The bfloat16 compute copies (models/networks.py:Dense). A network that
// computes in bfloat16 keeps, beside each float32 Linear weight and bias, a
// bfloat16 copy that its layers read, so autocast casts no weight at a use;
// its Linear gradients are the bfloat16 gradients of the copies. So a tensor
// of Adam's list may come with a bfloat16 gradient, which the kernel widens in
// registers (exactly .float()), and with a copy, which it writes from the new
// parameter in the same pass (round to nearest even, as .to(torch.bfloat16)):
// 2 B less read and 2 B more written a Linear parameter. The soft-update
// writes the target's copy the same way, 14 B a parameter with a copy.
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
constexpr int kAdamMaxTensors = 64;          // Table<5, 64>: 3,396 bytes
constexpr int kLerpMaxTensors = 96;          // Table<3, 96>: 3,556 bytes
static_assert(kChunk % (kThreads * kVec) == 0, "a chunk is whole sweeps");

// A launch's tensors: kLists lists (Adam: p, g, mu, nu, copy; lerp: target,
// src, copy; the refresh: copy, src) of `tensors` tensors each, their sizes,
// the prefix table of their chunks and whether each gradient is bfloat16. A
// copy's address is null where the tensor has none.
template <int kLists, int kMax>
struct Table {
  void* x[kLists][kMax];
  int64_t n[kMax];
  int chunk_end[kMax];  // chunks of tensors 0..i
  unsigned char g_bf16[kMax];  // Adam: the gradient x[1][i] is bfloat16
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

using AdamTable = Table<5, kAdamMaxTensors>;
using LerpTable = Table<3, kLerpMaxTensors>;
using CastTable = Table<2, kLerpMaxTensors>;

struct AdamArgs {
  int* count;      // the step count (int32, device memory)
  unsigned* ticket;  // 0 between launches
  float neg_lr, b1, b2, c1, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2 (rounded from double)
  int advance;     // whether this launch is its step's last, which advances the count
};

__device__ __forceinline__ bool aligned(const void* x, int bytes) {
  return (reinterpret_cast<uintptr_t>(x) & (bytes - 1)) == 0;
}

// Loads and stores of float32 and bfloat16 tensors in float32 registers: one
// element, or 4 from a 16-byte (float32) or 8-byte (bfloat16) aligned address
struct F32 {
  static constexpr int kVecBytes = 16;
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

struct Bf16 {
  static constexpr int kVecBytes = 8;
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

// mu's dtype: its loads and stores, and the decayed moment b1 * mu rounded in it
template <typename MuT> struct Mu;

template <> struct Mu<float> : F32 {
  __device__ static float decay(float mu, float b1) { return __fmul_rn(mu, b1); }
};

template <> struct Mu<__nv_bfloat16> : Bf16 {
  __device__ static float decay(float mu, float b1) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(mu, b1)));
  }
};

// A gradient of either dtype, widened to float32 (exactly: bfloat16 is
// float32's upper half)
__device__ __forceinline__ float4 load4_grad(const void* g, bool bf16, int64_t i) {
  return bf16 ? Bf16::load4(g, i) : F32::load4(g, i);
}

__device__ __forceinline__ float load_grad(const void* g, bool bf16, int64_t i) {
  return bf16 ? Bf16::load(g, i) : F32::load(g, i);
}

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
    const void* g = table.x[1][k];
    void* mu = table.x[2][k];
    float* nu = static_cast<float*>(table.x[3][k]);
    void* copy = table.x[4][k];  // the parameter's bfloat16 copy, or null
    const bool g_bf16 = table.g_bf16[k] != 0;
    int64_t scalar_from = start;
    if (aligned(p, 16) && aligned(g, g_bf16 ? Bf16::kVecBytes : F32::kVecBytes)
        && aligned(nu, 16) && aligned(mu, Mu<MuT>::kVecBytes)
        && (copy == nullptr || aligned(copy, Bf16::kVecBytes))) {
      const int64_t vec_end = start + (end - start) / kVec * kVec;
      float4 pv[kSweeps], gv[kSweeps], mv[kSweeps], nv[kSweeps];
#pragma unroll
      for (int s = 0; s < kSweeps; ++s) {
        const int64_t i = start + (s * kThreads + threadIdx.x) * kVec;
        if (i < vec_end) {
          pv[s] = *reinterpret_cast<const float4*>(p + i);
          gv[s] = load4_grad(g, g_bf16, i);
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
          if (copy != nullptr) Bf16::store4(copy, i, pv[s]);
        }
      }
      scalar_from = vec_end;
    }
    for (int64_t i = scalar_from + threadIdx.x; i < end; i += kThreads) {
      float pi = p[i], mi = Mu<MuT>::load(mu, i), ni = nu[i];
      op.apply<MuT>(pi, load_grad(g, g_bf16, i), mi, ni);
      p[i] = pi;
      Mu<MuT>::store(mu, i, mi);
      nu[i] = ni;
      if (copy != nullptr) Bf16::store(copy, i, pi);
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
    void* copy = table.x[2][k];  // the target's bfloat16 copy, or null
    int64_t scalar_from = start;
    if (aligned(t, 16) && aligned(x, 16)
        && (copy == nullptr || aligned(copy, Bf16::kVecBytes))) {
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
          if (copy != nullptr) Bf16::store4(copy, i, r);
        }
      }
      scalar_from = vec_end;
    }
    for (int64_t i = scalar_from + threadIdx.x; i < end; i += kThreads) {
      const float r = lerp_one(t[i], x[i], w, one_minus_w, small);
      t[i] = r;
      if (copy != nullptr) Bf16::store(copy, i, r);
    }
  }
}

// copy[i] <- bfloat16(src[i]) over a launch's tensors: a refresh of the
// copies of parameters written by something other than the two kernels above
__global__ void __launch_bounds__(kThreads)
bf16_copy_refresh_kernel(const __grid_constant__ CastTable table) {
  for (int c = blockIdx.x; c < table.chunks(); c += gridDim.x) {
    int64_t start, end;
    const int k = table.find(c, start, end);
    void* copy = table.x[0][k];
    const void* src = table.x[1][k];
    int64_t scalar_from = start;
    if (aligned(copy, Bf16::kVecBytes) && aligned(src, F32::kVecBytes)) {
      const int64_t vec_end = start + (end - start) / kVec * kVec;
#pragma unroll
      for (int s = 0; s < kSweeps; ++s) {
        const int64_t i = start + (s * kThreads + threadIdx.x) * kVec;
        if (i < vec_end) Bf16::store4(copy, i, F32::load4(src, i));
      }
      scalar_from = vec_end;
    }
    for (int64_t i = scalar_from + threadIdx.x; i < end; i += kThreads) {
      Bf16::store(copy, i, F32::load(src, i));
    }
  }
}

// The launch's table from the lists' addresses and the sizes: the number of
// chunks, or -1 for a negative size or more chunks than an int counts.
template <typename T, int kLists>
int fill(T& table, int tensors, void* const* const (&lists)[kLists], const long long* n,
         const unsigned char* g_bf16 = nullptr) {
  table.tensors = tensors;
  long long chunks = 0;
  for (int i = 0; i < tensors; ++i) {
    if (n[i] < 0) return -1;
    chunks += (n[i] + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return -1;
    table.n[i] = n[i];
    table.chunk_end[i] = static_cast<int>(chunks);
    table.g_bf16[i] = g_bf16 != nullptr ? g_bf16[i] : 0;
    for (int l = 0; l < kLists; ++l) table.x[l][i] = lists[l] != nullptr ? lists[l][i] : nullptr;
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

// The most tensors one launch takes: kernel 0 Adam, 1 lerp, 2 the refresh.
int optim_max_tensors(int kernel) { return kernel == 0 ? kAdamMaxTensors : kLerpMaxTensors; }

// One Adam launch over `tensors` tensors (float32 p, nu; g float32, or
// bfloat16 where g_bf16[i] != 0; mu float32, or bfloat16 where mu_bf16 != 0;
// copy bfloat16 or null, written with the new p where not null; each
// contiguous with n[i] elements). advance != 0 on the step's last launch: its
// last block stores count + 1. count is int32 and ticket uint32 in device
// memory, the ticket 0 between launches.
int optim_adam(int mu_bf16, int tensors, void* const* p, void* const* g, void* const* mu,
               void* const* nu, void* const* copy, const unsigned char* g_bf16,
               const long long* n, float neg_lr, float b1, float b2, float c1, float c2,
               float eps, void* count, void* ticket, int advance, void* stream) {
  static int cap_f32 = 0, cap_bf16 = 0;
  if (tensors < 0 || tensors > kAdamMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  AdamTable table;
  void* const* const lists[5] = {p, g, mu, nu, copy};
  const int chunks = fill(table, tensors, lists, n, g_bf16);
  const AdamArgs args{static_cast<int*>(count), static_cast<unsigned*>(ticket), neg_lr, b1,
                      b2, c1, c2, eps, advance};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mu_bf16
      ? launch(adam_multi_tensor_apply_kernel<__nv_bfloat16>, &cap_bf16, chunks, s, table, args)
      : launch(adam_multi_tensor_apply_kernel<float>, &cap_f32, chunks, s, table, args);
}

// target[i] <- lerp(target[i], src[i], weight) over `tensors` float32
// tensors, contiguous, with n[i] elements; copy[i] (bfloat16, or null) <- the
// new target[i]. copy itself may be null: no tensor has a copy.
int optim_lerp(int tensors, void* const* target, void* const* src, void* const* copy,
               const long long* n, float weight, void* stream) {
  static int cap = 0;
  if (tensors < 0 || tensors > kLerpMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  LerpTable table;
  void* const* const lists[3] = {target, src, copy};
  const int chunks = fill(table, tensors, lists, n);
  return launch(lerp_multi_tensor_apply_kernel, &cap, chunks,
                static_cast<cudaStream_t>(stream), table, weight);
}

// copy[i] (bfloat16) <- src[i] (float32) over `tensors` contiguous tensors
// with n[i] elements.
int optim_cast(int tensors, void* const* copy, void* const* src, const long long* n,
               void* stream) {
  static int cap = 0;
  if (tensors < 0 || tensors > kLerpMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  CastTable table;
  void* const* const lists[2] = {copy, src};
  const int chunks = fill(table, tensors, lists, n);
  return launch(bf16_copy_refresh_kernel, &cap, chunks, static_cast<cudaStream_t>(stream),
                table);
}

}  // extern "C"
