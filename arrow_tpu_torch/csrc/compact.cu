// Stable stream compaction of up to 64 columns by one keep mask.
//
// Replaces the TPU kernel K2, arrow_tpu/compute/pallas_move.py
// `_compact_kernel` (driven by `compact_planes_pallas` and
// `compact_arrays_pallas`). The TPU kernel splits every column into 32-bit
// planes (the TPU's vector unit is 32-bit), pulls each (256, 128) tile's
// kept rows to the tile's front with a log-depth butterfly, and stitches
// the tiles at exclusive base offsets. Hopper addresses bytes: this kernel
// moves each column at its native width (1, 2, 4 or 8 bytes) and writes every
// kept row straight to its final slot.
//
// Contract (the `direct` movement mode, arrow_tpu/compute/move.py:328-333):
// out[c][0, count) holds column c's kept rows in row order, bit for bit,
// and out[c][count, n) holds zeros; count is written to the device, never
// read back here.
//
// Bound: the work must read the keep mask (1 byte a row) and every column
// once and write every output slot once, tail included: n * (1 + 2 * sum of
// widths) bytes. Q3's lineitem filter at SF10 (60,012,544 rows, columns of
// 8 + 8 + 8 + 4 bytes) moves 3.42 GB, about 1.02 ms at 3.35 TB/s.
//
// Design: three launches, no library scan.
//   1. tile_counts: one block per tile of kTile rows counts the tile's kept
//      rows with warp ballots.
//   2. scan_tiles: one block turns the tile counts into exclusive tile
//      offsets in place and writes the total to *count.
//   3. scatter: one block per tile walks its rows in rounds of kThreads;
//      a warp ballot and a prefix over the block's warp counts give each
//      kept row its slot, and every column's value is copied there. Rows at
//      or past the total write the zero tail at their own index, so each
//      output slot is written exactly once, by one thread.
// The keep mask is read twice (passes 1 and 3); the columns once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // rows per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxColumns = 64;
constexpr int kScanThreads = 1024;

struct Columns {
  const void* src[kMaxColumns];
  void* dst[kMaxColumns];
  int width[kMaxColumns];
  int count;
};

__global__ void __launch_bounds__(kThreads)
tile_counts(const uint8_t* __restrict__ keep, long long n,
            int* __restrict__ counts) {
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int total = 0;  // lane 0 of each warp: its warp's kept rows
  for (int r = 0; r < kRounds; ++r) {
    const long long row = base + r * kThreads + threadIdx.x;
    const bool k = row < n && keep[row] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, k);
    if (lane == 0) total += __popc(mask);
  }
  if (lane == 0) warp_sum[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    counts[blockIdx.x] = s;
  }
}

// One block: exclusive scan of `tiles` counts in place; the sum to *count.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles(int* __restrict__ offsets, int tiles, int* __restrict__ count) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int first = threadIdx.x * per;
  const int last = min(first + per, tiles);
  int mine = 0;
  for (int t = first; t < last; ++t) mine += offsets[t];

  // inclusive scan of `mine` across the block: warps, then warp sums
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int incl = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    warp_sum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int running = incl - mine + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int t = first; t < last; ++t) {
    const int c = offsets[t];
    offsets[t] = running;
    running += c;
  }
  if (threadIdx.x == kScanThreads - 1) *count = running;
}

__device__ __forceinline__ void copy_value(const void* src, void* dst,
                                           int width, long long from,
                                           long long to) {
  switch (width) {
    case 8:
      static_cast<unsigned long long*>(dst)[to] =
          static_cast<const unsigned long long*>(src)[from];
      break;
    case 4:
      static_cast<unsigned int*>(dst)[to] =
          static_cast<const unsigned int*>(src)[from];
      break;
    case 2:
      static_cast<unsigned short*>(dst)[to] =
          static_cast<const unsigned short*>(src)[from];
      break;
    default:
      static_cast<unsigned char*>(dst)[to] =
          static_cast<const unsigned char*>(src)[from];
      break;
  }
}

__device__ __forceinline__ void zero_value(void* dst, int width,
                                           long long to) {
  switch (width) {
    case 8: static_cast<unsigned long long*>(dst)[to] = 0ull; break;
    case 4: static_cast<unsigned int*>(dst)[to] = 0u; break;
    case 2: static_cast<unsigned short*>(dst)[to] = 0; break;
    default: static_cast<unsigned char*>(dst)[to] = 0; break;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter(const uint8_t* __restrict__ keep, long long n,
        const int* __restrict__ offsets, const int* __restrict__ count,
        const Columns cols) {
  // double-buffered by round parity: one barrier a round suffices, since a
  // warp writes buffer r & 1 only after every warp passed round r - 1's
  // barrier and so finished reading round r - 2's copy of that buffer
  __shared__ int warp_count[2][kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long total = *count;
  long long slot = offsets[blockIdx.x];  // first output slot of this round
  for (int r = 0; r < kRounds; ++r) {
    const long long row = base + r * kThreads + threadIdx.x;
    const bool k = row < n && keep[row] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, k);
    int* buf = warp_count[r & 1];
    if (lane == 0) buf[warp] = __popc(mask);
    __syncthreads();
    int before = 0, round_total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = buf[w];
      before += w < warp ? c : 0;
      round_total += c;
    }
    if (k) {
      const long long to = slot + before + __popc(mask & lanes_below);
      for (int c = 0; c < cols.count; ++c) {
        copy_value(cols.src[c], cols.dst[c], cols.width[c], row, to);
      }
    }
    if (row < n && row >= total) {
      for (int c = 0; c < cols.count; ++c) {
        zero_value(cols.dst[c], cols.width[c], row);
      }
    }
    slot += round_total;
  }
}

}  // namespace

// keep: n bytes, 0 or 1. src/dst/widths: `num_columns` column pointers and
// their widths in bytes (1, 2, 4 or 8), each pointer aligned to its width.
// scratch: ceil(n / 4096) ints. count: one int, written on the device.
// Returns a cudaError_t; 0 when all three launches were accepted.
extern "C" int compact_columns(const uint8_t* keep, long long n,
                               const void* const* src, void* const* dst,
                               const int* widths, int num_columns,
                               int* scratch, int* count, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || n >= (1ll << 31) || num_columns < 1 ||
      num_columns > kMaxColumns) {
    return cudaErrorInvalidValue;
  }
  Columns cols;
  cols.count = num_columns;
  for (int c = 0; c < num_columns; ++c) {
    const int w = widths[c];
    if ((w != 1 && w != 2 && w != 4 && w != 8) ||
        reinterpret_cast<uintptr_t>(src[c]) % w != 0 ||
        reinterpret_cast<uintptr_t>(dst[c]) % w != 0) {
      return cudaErrorInvalidValue;
    }
    cols.src[c] = src[c];
    cols.dst[c] = dst[c];
    cols.width[c] = w;
  }
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  tile_counts<<<tiles, kThreads, 0, stream>>>(keep, n, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tiles<<<1, kScanThreads, 0, stream>>>(scratch, tiles, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter<<<tiles, kThreads, 0, stream>>>(keep, n, scratch, count, cols);
  return cudaGetLastError();
}
