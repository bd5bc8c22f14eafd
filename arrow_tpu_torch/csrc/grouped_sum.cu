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
// Design: one pass. A single wave of blocks walks the input in a
// grid-stride loop with 16-byte loads. Partial sums stay in shared memory,
// out of device memory. For few groups (S * 256 threads * 8 bytes within
// 48 KB, so S <= 24) every thread owns a private column of accumulators, so
// the hot loop has no atomics at all; Q1's 12 slots take this path. For
// more groups the block shares one copy (at most 8 KB) that its threads
// update with shared-memory atomics. Each block then adds its partials into
// the zeroed (S,) f64 output with one global atomicAdd per non-zero slot.
// Rows whose group id lies outside [0, S) are dropped. Inf and NaN
// propagate as IEEE addition makes them.
//
// The order of additions differs from run to run (the global atomics), so
// results agree with a sequential f64 sum to rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 1024;
constexpr size_t kPrivateBytes = 48 * 1024;

// Four consecutive values from a 16-byte aligned array, widened to f64.
__device__ __forceinline__ void load4(const double* p, long long q,
                                      double v[4]) {
  const double2* p2 = reinterpret_cast<const double2*>(p);
  const double2 a = __ldg(p2 + 2 * q);
  const double2 b = __ldg(p2 + 2 * q + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, long long q,
                                      double v[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// acc points at this thread's column (PRIVATE: slot g at acc[g * kThreads])
// or at the block's shared copy (slot g at acc[g]).
template <bool PRIVATE>
__device__ __forceinline__ void accumulate(double* acc, int num_segments,
                                           int g, double v) {
  if (static_cast<unsigned>(g) < static_cast<unsigned>(num_segments)) {
    if (PRIVATE) {
      acc[g * kThreads] += v;
    } else {
      atomicAdd(acc + g, v);
    }
  }
}

template <typename T, bool PRIVATE, bool VEC>
__global__ void __launch_bounds__(kThreads)
grouped_sum_kernel(const T* __restrict__ values, const int* __restrict__ gids,
                   long long n, int num_segments, double* __restrict__ out) {
  extern __shared__ double smem[];
  const int slots = PRIVATE ? num_segments * kThreads : num_segments;
  for (int i = threadIdx.x; i < slots; i += kThreads) smem[i] = 0.0;
  __syncthreads();

  double* acc = PRIVATE ? smem + threadIdx.x : smem;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long quads = n / 4;
    const int4* g4 = reinterpret_cast<const int4*>(gids);
    for (long long q = first; q < quads; q += stride) {
      double v[4];
      load4(values, q, v);
      const int4 g = __ldg(g4 + q);
      accumulate<PRIVATE>(acc, num_segments, g.x, v[0]);
      accumulate<PRIVATE>(acc, num_segments, g.y, v[1]);
      accumulate<PRIVATE>(acc, num_segments, g.z, v[2]);
      accumulate<PRIVATE>(acc, num_segments, g.w, v[3]);
    }
    tail = quads * 4;
  }
  for (long long i = tail + first; i < n; i += stride) {
    accumulate<PRIVATE>(acc, num_segments, __ldg(gids + i),
                        static_cast<double>(__ldg(values + i)));
  }
  __syncthreads();

  if (PRIVATE) {
    // one warp per slot: lanes sum the block's columns, then a shuffle tree
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int s = warp; s < num_segments; s += kThreads / 32) {
      double sum = 0.0;
      for (int t = lane; t < kThreads; t += 32) sum += smem[s * kThreads + t];
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_down_sync(0xffffffffu, sum, off);
      }
      if (lane == 0 && sum != 0.0) atomicAdd(out + s, sum);
    }
  } else {
    for (int s = threadIdx.x; s < num_segments; s += kThreads) {
      const double sum = smem[s];
      if (sum != 0.0) atomicAdd(out + s, sum);
    }
  }
}

template <typename T>
int launch(const T* values, const int* gids, long long n, int num_segments,
           double* out, cudaStream_t stream) {
  if (num_segments < 1 || num_segments > kMaxSegments || n < 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const bool priv = static_cast<size_t>(num_segments) * kThreads *
                        sizeof(double) <= kPrivateBytes;
  const bool vec = reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gids) % 16 == 0;
  using Kernel = void (*)(const T*, const int*, long long, int, double*);
  Kernel kernel = priv ? (vec ? grouped_sum_kernel<T, true, true>
                              : grouped_sum_kernel<T, true, false>)
                       : (vec ? grouped_sum_kernel<T, false, true>
                              : grouped_sum_kernel<T, false, false>);
  const size_t smem =
      (priv ? static_cast<size_t>(num_segments) * kThreads
            : static_cast<size_t>(num_segments)) * sizeof(double);

  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;

  const long long items = vec ? (n + 3) / 4 : n;
  const long long wanted = (items + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(wanted < wave ? wanted : wave);
  kernel<<<grid, kThreads, smem, stream>>>(values, gids, n, num_segments, out);
  return cudaGetLastError();
}

}  // namespace

// out: a zeroed (num_segments,) f64 buffer that the kernel adds into.
// Returns a cudaError_t; 0 when the launch was accepted.
extern "C" int grouped_sum_f64(const double* values, const int* gids,
                               long long n, int num_segments, double* out,
                               void* stream) {
  return launch<double>(values, gids, n, num_segments, out,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int grouped_sum_f32(const float* values, const int* gids,
                               long long n, int num_segments, double* out,
                               void* stream) {
  return launch<float>(values, gids, n, num_segments, out,
                       static_cast<cudaStream_t>(stream));
}
