// Grouped sum of f64 or f32 values by int32 group id, for 1..1024 groups.
//
// Replaces two TPU kernels with one contract: K1,
// arrow_tpu/experimental/pallas_agg.py `_kernel_ff` / `_kernel_f32` (called
// from `grouped_sum_pallas`, at most 128 groups), and K3,
// arrow_tpu/compute/pallas_move.py `_gsum_kernel` (called from
// `grouped_sum_pallas`, 65..1024 groups). The TPU has no f64 unit, so those
// kernels split every f64 value into a float-float pair of f32 planes and
// add with compensation. Hopper adds f64 in hardware: this kernel
// accumulates natively in f64. f32 input is widened on load and the wrapper
// rounds the f64 result once.
//
// Bound: the kernel must read each value (8 or 4 bytes) and each group id
// (4 bytes) once and write S doubles, so it is bound by memory bandwidth.
// Q1 at SF10 holds 60,012,544 rows: 720 MB of f64 values and ids, about
// 215 us at 3.35 TB/s, for each of its 7 launches.
//
// Design: two passes, and every addition in an order fixed by the input, so
// one input gives the same bits on every run (the TPU grid runs in order,
// so the reference's sums repeat too). The first pass is a single wave of
// blocks that walks the input in a grid-stride loop, four rows (one 16-byte
// load) at a time; thread t of the grid takes the rows 4q..4q+3 for
// q = t, t + grid threads, ... Partial sums stay in shared memory, out of
// device memory:
// - few groups (S * 256 threads * 8 bytes within 48 KB, so S <= 24; Q1's
//   12 slots): every thread owns a private column of accumulators and adds
//   its rows in order; one warp a slot then sums the block's 256 columns by
//   a fixed shuffle tree;
// - more groups: each warp owns one copy of the S slots and S int tags (at
//   most 96 KB a block). The loop bounds are uniform over the warp; for
//   each row of a step, the lanes that share a slot add into the warp's
//   copy one after another in lane order, the lowest first, chosen by an
//   integer atomicMax on the slot's tag (`warp_add`). The block then sums
//   its warps' copies in warp order.
// Each block writes its S partials to a (blocks, S) f64 scratch. The second
// pass, one block a slot, sums that column in block order by strided
// partial sums and a fixed shuffle tree, and writes the output. The number
// of blocks is a function of the card, S, the dtype and n (the wrapper asks
// `grouped_sum_wave` once), never of timing. Rows whose group id lies
// outside [0, S) are dropped. Inf and NaN propagate as IEEE addition makes
// them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSegments = 1024;
constexpr size_t kPrivateBytes = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ double load1(const double* p, long long i) {
  return __ldg(p + i);
}

__device__ __forceinline__ double load1(const float* p, long long i) {
  return static_cast<double>(__ldg(p + i));
}

// Rows 4q..4q+3: their values widened to f64 and their group ids. VEC reads
// each array with one 16-byte load (both arrays 16-byte aligned); otherwise
// row by row, over the same rows.
template <bool VEC>
__device__ __forceinline__ void load_quad(const double* values,
                                          const int* gids, long long q,
                                          double v[4], int g[4]) {
  if (VEC) {
    const double2* p2 = reinterpret_cast<const double2*>(values);
    const double2 a = __ldg(p2 + 2 * q);
    const double2 b = __ldg(p2 + 2 * q + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    for (int j = 0; j < 4; ++j) v[j] = load1(values, 4 * q + j);
  }
  if (VEC) {
    const int4 gg = __ldg(reinterpret_cast<const int4*>(gids) + q);
    g[0] = gg.x; g[1] = gg.y; g[2] = gg.z; g[3] = gg.w;
  } else {
    for (int j = 0; j < 4; ++j) g[j] = __ldg(gids + 4 * q + j);
  }
}

template <bool VEC>
__device__ __forceinline__ void load_quad(const float* values,
                                          const int* gids, long long q,
                                          double v[4], int g[4]) {
  if (VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(values) + q);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    const int4 gg = __ldg(reinterpret_cast<const int4*>(gids) + q);
    g[0] = gg.x; g[1] = gg.y; g[2] = gg.z; g[3] = gg.w;
  } else {
    for (int j = 0; j < 4; ++j) {
      v[j] = load1(values, 4 * q + j);
      g[j] = __ldg(gids + 4 * q + j);
    }
  }
}

__device__ __forceinline__ bool in_range(int g, int num_segments) {
  return static_cast<unsigned>(g) < static_cast<unsigned>(num_segments);
}

// Few groups: slot g of thread t at smem[g * kThreads + t].
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
partials_private(const T* __restrict__ values, const int* __restrict__ gids,
                 long long n, int num_segments,
                 double* __restrict__ partials) {
  extern __shared__ double smem[];
  for (int i = threadIdx.x; i < num_segments * kThreads; i += kThreads) {
    smem[i] = 0.0;
  }
  __syncthreads();

  double* acc = smem + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long quads = n / 4;
  for (long long q = first; q < quads; q += stride) {
    double v[4];
    int g[4];
    load_quad<VEC>(values, gids, q, v, g);
    for (int j = 0; j < 4; ++j) {
      if (in_range(g[j], num_segments)) acc[g[j] * kThreads] += v[j];
    }
  }
  for (long long i = quads * 4 + first; i < n; i += stride) {
    const int g = __ldg(gids + i);
    if (in_range(g, num_segments)) acc[g * kThreads] += load1(values, i);
  }
  __syncthreads();

  // one warp a slot: lanes sum the block's columns, then a shuffle tree
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int s = warp; s < num_segments; s += kWarps) {
    double sum = 0.0;
    for (int t = lane; t < kThreads; t += 32) sum += smem[s * kThreads + t];
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_down_sync(kFullMask, sum, off);
    }
    if (lane == 0) {
      partials[static_cast<long long>(blockIdx.x) * num_segments + s] = sum;
    }
  }
}

// One row a lane into the warp's copy, the lanes with one slot in lane
// order: in each round, every lane still pending bids for its slot with an
// integer atomicMax of (round << 5 | 31 - lane), so the lowest pending lane
// of each slot wins (the bid's result does not depend on the order of the
// bids), adds its value, and leaves. A later round's bids exceed every
// earlier one, so the tags need no reset (at most 32 rounds a row: a warp
// stays below 2**26 rounds for inputs below 2**35 rows). Every lane of the
// warp must call it, with the same round counter.
__device__ __forceinline__ void warp_add(double* copy, int* tag, int lane,
                                         int g, double v, int num_segments,
                                         int& round) {
  bool pending = in_range(g, num_segments);
  do {
    const int bid = (++round << 5) | (31 - lane);
    if (pending) atomicMax(tag + g, bid);
    __syncwarp();
    if (pending && tag[g] == bid) {
      copy[g] += v;
      pending = false;
    }
    __syncwarp();
  } while (__any_sync(kFullMask, pending));
}

// More groups: warp w's copy of the slots at smem[w * S], then each warp's
// S int tags.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
partials_shared(const T* __restrict__ values, const int* __restrict__ gids,
                long long n, int num_segments,
                double* __restrict__ partials) {
  extern __shared__ double smem[];
  int* tags = reinterpret_cast<int*>(smem + kWarps * num_segments);
  for (int i = threadIdx.x; i < kWarps * num_segments; i += kThreads) {
    smem[i] = 0.0;
    tags[i] = 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  double* copy = smem + warp * num_segments;
  int* tag = tags + warp * num_segments;
  int round = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // the warp's first thread: the loop bounds below are the same for every
  // lane, as warp_add needs
  const long long warp_first =
      static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
  const long long quads = n / 4;
  for (long long q0 = warp_first; q0 < quads; q0 += stride) {
    const long long q = q0 + lane;
    double v[4] = {0.0, 0.0, 0.0, 0.0};
    int g[4] = {-1, -1, -1, -1};
    if (q < quads) load_quad<VEC>(values, gids, q, v, g);
    for (int j = 0; j < 4; ++j) {
      warp_add(copy, tag, lane, g[j], v[j], num_segments, round);
    }
  }
  for (long long i0 = quads * 4 + warp_first; i0 < n; i0 += stride) {
    const long long i = i0 + lane;
    const bool ok = i < n;
    warp_add(copy, tag, lane, ok ? __ldg(gids + i) : -1,
             ok ? load1(values, i) : 0.0, num_segments, round);
  }
  __syncthreads();

  for (int s = threadIdx.x; s < num_segments; s += kThreads) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += smem[w * num_segments + s];
    partials[static_cast<long long>(blockIdx.x) * num_segments + s] = sum;
  }
}

// Block s sums column s of the (blocks, S) partials in block order.
__global__ void __launch_bounds__(kThreads)
finish(const double* __restrict__ partials, int blocks, int num_segments,
       double* __restrict__ out) {
  __shared__ double warp_sums[kWarps];
  const int s = blockIdx.x;
  double sum = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    sum += partials[static_cast<long long>(b) * num_segments + s];
  }
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(kFullMask, sum, off);
  }
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    out[s] = total;
  }
}

bool private_path(int num_segments) {
  return static_cast<size_t>(num_segments) * kThreads * sizeof(double) <=
         kPrivateBytes;
}

size_t shared_bytes(int num_segments) {
  return private_path(num_segments)
             ? static_cast<size_t>(num_segments) * kThreads * sizeof(double)
             : static_cast<size_t>(kWarps) * num_segments *
                   (sizeof(double) + sizeof(int));
}

template <typename T>
using Kernel = void (*)(const T*, const int*, long long, int, double*);

template <typename T>
Kernel<T> pick(int num_segments, bool vec) {
  if (private_path(num_segments)) {
    return vec ? partials_private<T, true> : partials_private<T, false>;
  }
  return vec ? partials_shared<T, true> : partials_shared<T, false>;
}

// Both variants of the path may take the path's shared memory.
template <typename T>
cudaError_t allow_shared(int num_segments) {
  const int bytes = static_cast<int>(shared_bytes(num_segments));
  cudaError_t err = cudaFuncSetAttribute(
      pick<T>(num_segments, true),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(pick<T>(num_segments, false),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
int wave(int num_segments, int* blocks) {
  if (num_segments < 1 || num_segments > kMaxSegments) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_shared<T>(num_segments);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // the 16-byte variant's occupancy serves both, so that the rows a thread
  // adds do not depend on the inputs' alignment
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pick<T>(num_segments, true), kThreads,
      shared_bytes(num_segments));
  if (err != cudaSuccess) return err;
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  return cudaSuccess;
}

template <typename T>
int launch(const T* values, const int* gids, long long n, int num_segments,
           int blocks, double* partials, double* out, cudaStream_t stream) {
  if (num_segments < 1 || num_segments > kMaxSegments || n < 0 ||
      blocks < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_shared<T>(num_segments);
  if (err != cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gids) % 16 == 0;
  pick<T>(num_segments, vec)<<<blocks, kThreads, shared_bytes(num_segments),
                               stream>>>(values, gids, n, num_segments,
                                         partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish<<<num_segments, kThreads, 0, stream>>>(partials, blocks,
                                                num_segments, out);
  return cudaGetLastError();
}

}  // namespace

// The most blocks that are resident at once for S slots of this dtype (one
// wave); the wrapper launches min(wave, quads / 256 rounded up) blocks.
extern "C" int grouped_sum_wave(int num_segments, int f32, int* blocks) {
  return f32 ? wave<float>(num_segments, blocks)
             : wave<double>(num_segments, blocks);
}

// partials: a (blocks, num_segments) f64 scratch; out: (num_segments,) f64,
// written whole. Returns a cudaError_t; 0 when both launches were accepted.
extern "C" int grouped_sum_f64(const double* values, const int* gids,
                               long long n, int num_segments, int blocks,
                               double* partials, double* out, void* stream) {
  return launch<double>(values, gids, n, num_segments, blocks, partials, out,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int grouped_sum_f32(const float* values, const int* gids,
                               long long n, int num_segments, int blocks,
                               double* partials, double* out, void* stream) {
  return launch<float>(values, gids, n, num_segments, blocks, partials, out,
                       static_cast<cudaStream_t>(stream));
}
