// Stable stream compaction of up to 64 columns by one keep mask.
//
// Replaces the TPU kernel K2, arrow_tpu/compute/pallas_move.py:92
// `_compact_kernel` (driven by `compact_planes_pallas` and
// `compact_arrays_pallas`). The TPU kernel splits every column into 32-bit
// planes (the TPU's vector unit is 32-bit), pulls each (256, 128) tile's
// kept rows to the tile's front with a log-depth butterfly, and stitches
// the tiles at exclusive base offsets. Hopper addresses bytes: this kernel
// moves each column at its native width (1, 2, 4 or 8 bytes).
//
// Contract (the `direct` movement mode, arrow_tpu/compute/move.py:328-333):
// out[c][0, count) holds column c's kept rows in row order, bit for bit,
// and out[c][count, n) holds zeros; count is written to the device, never
// read back here.
//
// Bound: the work must read the keep mask (1 byte a row) once, read each
// column's 32-byte sectors that hold a kept row once, and write every
// output slot once, tail included: n * (1 + sum of widths) bytes plus 32
// bytes a sector read, over 3.35 TB/s. At a dense mask every sector holds
// a kept row, so it is about n * (1 + 2 * sum of widths); at a sparse one
// (Q18's HAVING filter, 1 row in 10^4 kept) about n * (1 + sum of widths).
// chip_smoke.py's `compact_bytes` counts it from the data.
//
// Design: two launches, no library scan.
//   count_tiles: a block takes the next count tile of 16,384 rows from a
//     counter; each thread counts its 64 mask rows with four 16-byte loads,
//     and a block scan (warp shuffles, then the warp totals) sums them. The
//     tiles' offsets come from a chained scan with decoupled look-back
//     (Merrill and Garland, 2016) in 64-bit status words (flag and count).
//     It writes the offset of every move tile and the total to *count.
//   move_tiles: a block a move tile of 256 * R rows. Each thread reads its
//     R mask rows again (16-byte loads) for its kept rows' slots in the
//     tile. A column whose tile keeps at least half a row a 32-byte sector
//     is copied whole into shared memory by cp.async (K columns in flight,
//     double-buffered across columns when K = 2); a sparser one is read
//     row by row where kept, so a sparse mask reads only the sectors it
//     keeps. For each column in turn: its kept rows move to their slots in
//     shared memory (rows strided by the block, so a warp reads
//     neighbours; the width a template parameter, dispatched once a
//     column), the copy of column c + K is started into the freed buffer,
//     the block writes its contiguous output range with 16-byte stores,
//     and then zeros over its own rows of [count, n). Shared memory is laid
//     out so that a 16-byte line of device memory is a 16-byte line of the
//     buffer, so a column or an output range that does not start on 16
//     bytes still takes the vector path for its body; its head and tail (at
//     most 15 bytes each) move a byte at a time. A mask whose base is not
//     16-byte aligned is read a byte a row (no path of the port makes one).
// Every column is read at most once and every output byte written once;
// the mask is read twice, 1 byte a row more than the bound counts.
//
// Why two passes: a single pass, with each move tile taking its offset by
// look-back, pays that tile's whole chain of latencies (counter, mask,
// look-back, one column after another) in blocks that shared memory
// limits to 3 an SM, and measured slower at every timed shape (PERF.md
// §6). Here the look-back runs over 16,384-row tiles in light blocks, and
// a move tile waits on nothing.
//
// Tiles and buffers are sized for bytes in flight: R = 16 rows a thread
// for rows with a 4- or 8-byte column, 32 for 2 bytes, 64 for 1 byte; K = 1
// column in flight for up to 4 columns (more blocks an SM), 2 for more
// (hides each column's load).
//
// Resources (nvcc 12.9 -Xptxas -v, sm_90a): count_tiles 32 registers, 48
// bytes of shared memory; move_tiles 40 registers (48 in one of its six
// instances), no stack, 3,104 bytes of static shared memory plus
// (min(K, columns) + 1) * (256 * R * widest + 16) bytes of dynamic shared
// memory: 65,568 for Q3's 28-byte row (3 blocks an SM), 98,352 for Q4's 15
// columns (2), 32,800 at 2 and at 1 byte (6, by registers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxColumns = 64;
constexpr int kCountTile = 64 * kThreads;  // rows a count tile, 16,384
// a tile's status word: flag in the high half, its count or prefix below
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

struct Columns {
  const void* src[kMaxColumns];
  void* dst[kMaxColumns];
  int width[kMaxColumns];
  int count;
};

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits for all but the newest K - 1 groups of copies.
template <int K>
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K - 1) : "memory");
}

// [lo, hi) split into a head of at most 15 bytes, a body of whole 16-byte
// lines and a tail of at most 15 bytes.
struct Lines {
  uintptr_t lo, body_lo, body_hi, hi;
};

__device__ __forceinline__ Lines lines(uintptr_t lo, uintptr_t hi) {
  const uintptr_t up = (lo + 15) & ~uintptr_t(15);
  const uintptr_t body_lo = up < hi ? up : hi;
  const uintptr_t down = hi & ~uintptr_t(15);
  return {lo, body_lo, down > body_lo ? down : body_lo, hi};
}

// The head or tail byte of `r` that thread `t` of 32 moves, or 0.
__device__ __forceinline__ uintptr_t edge_byte(const Lines& r, int t) {
  const uintptr_t x = t < 16 ? r.lo + t : r.body_hi + (t - 16);
  return (t < 16 ? x < r.body_lo : x < r.hi) ? x : 0;
}

// Device bytes [lo, hi) into `buf`, byte x at buf[x - (lo & ~15)]: the
// body by cp.async, 16 bytes a copy, the head and tail by plain loads.
__device__ __forceinline__ void load_lines(uint8_t* buf, uintptr_t lo,
                                           uintptr_t hi) {
  const Lines r = lines(lo, hi);
  const uintptr_t base = lo & ~uintptr_t(15);
  for (uintptr_t x = r.body_lo + 16 * threadIdx.x; x < r.body_hi;
       x += 16 * kThreads) {
    cp_async16(buf + (x - base), reinterpret_cast<const void*>(x));
  }
  if (threadIdx.x < 32) {
    const uintptr_t x = edge_byte(r, threadIdx.x);
    if (x) buf[x - base] = *reinterpret_cast<const uint8_t*>(x);
  }
}

// `buf` to device bytes [lo, hi), byte x from buf[x - (lo & ~15)]: the
// body with 16-byte stores, the head and tail a byte at a time.
__device__ __forceinline__ void store_lines(const uint8_t* buf, uintptr_t lo,
                                            uintptr_t hi) {
  const Lines r = lines(lo, hi);
  const uintptr_t base = lo & ~uintptr_t(15);
  for (uintptr_t x = r.body_lo + 16 * threadIdx.x; x < r.body_hi;
       x += 16 * kThreads) {
    *reinterpret_cast<uint4*>(x) =
        *reinterpret_cast<const uint4*>(buf + (x - base));
  }
  if (threadIdx.x < 32) {
    const uintptr_t x = edge_byte(r, threadIdx.x);
    if (x) *reinterpret_cast<uint8_t*>(x) = buf[x - base];
  }
}

// Zeros to device bytes [lo, hi): the body with 16-byte stores, the head
// and tail a byte at a time.
__device__ __forceinline__ void zero_lines(uintptr_t lo, uintptr_t hi) {
  const Lines r = lines(lo, hi);
  for (uintptr_t x = r.body_lo + 16 * threadIdx.x; x < r.body_hi;
       x += 16 * kThreads) {
    *reinterpret_cast<uint4*>(x) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x < 32) {
    const uintptr_t x = edge_byte(r, threadIdx.x);
    if (x) *reinterpret_cast<uint8_t*>(x) = 0;
  }
}

__device__ __forceinline__ uintptr_t address(const void* p, long long row,
                                             int width) {
  return reinterpret_cast<uintptr_t>(p) + static_cast<uintptr_t>(row) * width;
}

// A 4-bit mask of the nonzero bytes of x.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  unsigned y = __vcmpne4(x, 0u) & 0x08040201u;
  return (y | y >> 8 | y >> 16 | y >> 24) & 15u;
}

// Each row of the tile to its slot. Thread t owns rows [t * R, t * R + R)
// of the mask (`bits[t]`, its first slot `slot[t]`); here it moves rows
// t + k * kThreads, so a warp reads neighbours. kThreads is a multiple of
// R, so a row's bit in its owner's word is t % R for every k.
template <typename T, int R>
__device__ __forceinline__ void place(const uint8_t* in, uint8_t* out,
                                      const unsigned long long* bits,
                                      const int* slot) {
  const T* from = reinterpret_cast<const T*>(in);
  T* to = reinterpret_cast<T*>(out);
  const int bit = threadIdx.x % R;
  const unsigned long long below = (1ull << bit) - 1ull;
#pragma unroll 8
  for (int k = 0; k < R; ++k) {
    const int owner = threadIdx.x / R + k * (kThreads / R);
    const unsigned long long b = bits[owner];
    if (b >> bit & 1ull) {
      to[slot[owner] + __popcll(b & below)] = from[threadIdx.x + k * kThreads];
    }
  }
}

// A thread's R rows of the mask from row `first` on, one bit a row (none
// at or past `end`): 16-byte loads where the rows are whole and aligned.
template <int R>
__device__ __forceinline__ unsigned long long mask_bits(const uint8_t* keep,
                                                        long long first,
                                                        long long end) {
  const uint8_t* m = keep + first;
  unsigned long long bits = 0;
  if (first + R <= end && (reinterpret_cast<uintptr_t>(m) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < R; j += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(m + j));
      bits |= static_cast<unsigned long long>(
                  nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
                  nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12)
              << j;
    }
  } else {
    for (int j = 0; j < R && first + j < end; ++j) {
      bits |= static_cast<unsigned long long>(m[j] != 0) << j;
    }
  }
  return bits;
}

// Exclusive scan of `mine` over the block; `total` gets the block's sum.
// One barrier; `warp_total` is free again after the caller's next one.
__device__ __forceinline__ int block_scan(int mine, int* warp_total,
                                          int& total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_total[w];
    before += w < warp ? c : 0;
    total += c;
  }
  return before + incl - mine;
}

// Pass 1: the offset of every move tile (`sub_rows` rows). A block takes
// the next count tile of kCountTile rows from a counter, so a tile waits
// only on tiles that have started; each thread counts 64 mask rows with
// four 16-byte loads, and the tile's offset comes from a chained scan with
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016): the tile publishes its count,
// then its inclusive prefix, in one 64-bit status word (flag and count),
// and warp 0 reads 32 predecessors' words at a time until it meets a
// prefix. The first thread of each move tile writes that tile's offset;
// the last tile writes the total to *count.
__global__ void __launch_bounds__(kThreads)
count_tiles(const uint8_t* __restrict__ keep, long long n, int sub_rows,
            unsigned long long* __restrict__ status,
            unsigned int* __restrict__ next_tile, int tiles,
            int* __restrict__ offsets, int* __restrict__ count) {
  constexpr int R = kCountTile / kThreads;
  __shared__ int s_tile, s_prefix;
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(next_tile, 1u));
  __syncthreads();
  const int tile = s_tile;
  const long long first = static_cast<long long>(tile) * kCountTile +
                          static_cast<long long>(threadIdx.x) * R;
  int total;
  const int before =
      block_scan(__popcll(mask_bits<R>(keep, first, n)), warp_total, total);
  if (warp == 0) {
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) store_release(status, kPrefix | unsigned(total));
    } else {
      if (lane == 0) {
        store_release(status + tile, kAggregate | unsigned(total));
      }
      for (int pred = tile - 1;; pred -= 32) {
        const int idx = pred - lane;
        unsigned long long s = kPrefix;  // before tile 0: a prefix of 0
        if (idx >= 0) {
          do {
            s = load_acquire(status + idx);
          } while ((s >> 32) == 0);
        }
        const unsigned found = __ballot_sync(0xffffffffu, s >= kPrefix);
        const int last = found ? __ffs(found) - 1 : 31;
        int v = lane <= last ? static_cast<int>(s & 0xffffffffu) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        prefix += v;
        if (found) break;
      }
      if (lane == 0) {
        store_release(status + tile, kPrefix | unsigned(prefix + total));
      }
    }
    if (lane == 0) {
      s_prefix = prefix;
      if (tile == tiles - 1) *count = prefix + total;
    }
  }
  __syncthreads();
  if (first < n && first % sub_rows == 0) {
    offsets[first / sub_rows] = s_prefix + before;
  }
}

// Pass 2: one move tile of R * kThreads rows a block, K columns of it in
// flight at once; see the note at the top.
template <int R, int K>
__global__ void __launch_bounds__(kThreads)
move_tiles(const uint8_t* __restrict__ keep, long long n, const Columns cols,
           int buf_bytes, const int* __restrict__ offsets,
           const int* __restrict__ count) {
  constexpr int kTile = R * kThreads;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned long long s_bits[kThreads];  // each thread's mask
  __shared__ int s_slot[kThreads];  // its first row's slot in the tile
  __shared__ int warp_total[kWarps];
  const int inputs = cols.count < K ? cols.count : K;
  uint8_t* out_buf = smem + inputs * buf_bytes;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile),
                                        n - r0));
  const long long offset = __ldg(offsets + blockIdx.x);
  const long long kept = __ldg(count);
  const unsigned long long bits =
      mask_bits<R>(keep, r0 + threadIdx.x * R, r0 + rows);
  int total;
  const int slot = block_scan(__popcll(bits), warp_total, total);
  // A column whose tile keeps less than half a row a 32-byte sector
  // (total / rows < width / 64) is read row by row where kept; a denser one
  // is copied whole into shared memory, its first K now.
  const auto dense = [&](int w) { return total * 64 >= rows * w; };
  const auto fetch = [&](int c, uint8_t* buf) {
    const int w = cols.width[c];
    if (dense(w)) {
      load_lines(buf, address(cols.src[c], r0, w),
                 address(cols.src[c], r0 + rows, w));
    }
  };
  for (int c = 0; c < K; ++c) {
    if (c < cols.count) fetch(c, smem + c * buf_bytes);
    cp_async_commit();
  }
  s_bits[threadIdx.x] = bits;
  s_slot[threadIdx.x] = slot;
  // this tile's rows of the zero tail [kept, n), if any
  const long long zero_from = kept > r0 ? kept : r0;

  for (int c = 0; c < cols.count; ++c) {
    cp_async_wait_oldest<K>();
    // column c is in its buffer (if dense); the masks and out_buf are set
    __syncthreads();
    const int w = cols.width[c];
    uint8_t* in = smem + (c % K) * buf_bytes;
    const uintptr_t src = address(cols.src[c], r0, w);
    const uintptr_t lo = address(cols.dst[c], offset, w);
    const uint8_t* from = dense(w) ? in + (src & 15)
                                   : reinterpret_cast<const uint8_t*>(src);
    uint8_t* to = out_buf + (lo & 15);
    switch (w) {
      case 8: place<unsigned long long, R>(from, to, s_bits, s_slot); break;
      case 4: place<unsigned int, R>(from, to, s_bits, s_slot); break;
      case 2: place<unsigned short, R>(from, to, s_bits, s_slot); break;
      default: place<unsigned char, R>(from, to, s_bits, s_slot); break;
    }
    __syncthreads();
    if (c + K < cols.count) fetch(c + K, in);
    cp_async_commit();
    store_lines(out_buf, lo, lo + static_cast<uintptr_t>(total) * w);
    if (zero_from < r0 + rows) {
      zero_lines(address(cols.dst[c], zero_from, w),
                 address(cols.dst[c], r0 + rows, w));
    }
  }
}

using Launch = cudaError_t (*)(const uint8_t*, long long, const Columns&,
                               int, int, const int*, const int*, int,
                               cudaStream_t);

template <int R, int K>
cudaError_t launch_moves(const uint8_t* keep, long long n,
                         const Columns& cols, int buf_bytes, int smem,
                         const int* offsets, const int* count, int tiles,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      move_tiles<R, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  move_tiles<R, K><<<tiles, kThreads, smem, stream>>>(keep, n, cols,
                                                      buf_bytes, offsets,
                                                      count);
  return cudaGetLastError();
}

}  // namespace

// keep: n bytes, 0 or 1. src/dst/widths: `num_columns` column pointers and
// their widths in bytes (1, 2, 4 or 8), each pointer aligned to its width.
// scratch: 1 + 2 * ceil(n / 4096) zeroed 64-bit words: the tile counter,
// one status word a count tile, then one int a move tile. count: one int,
// written on the device.
// Returns a cudaError_t; 0 when both launches were accepted.
extern "C" int compact_columns(const uint8_t* keep, long long n,
                               const void* const* src, void* const* dst,
                               const int* widths, int num_columns,
                               unsigned long long* scratch, int* count,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || n >= (1ll << 31) || num_columns < 1 ||
      num_columns > kMaxColumns) {
    return cudaErrorInvalidValue;
  }
  Columns cols;
  cols.count = num_columns;
  int widest = 1;
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
    widest = w > widest ? w : widest;
  }
  // narrow rows take longer move tiles, so that a tile moves enough
  // bytes; a tile of a few columns loads one at a time, which leaves room
  // for more blocks an SM, and of many columns two, which hides each one's
  // latency
  const int rows = widest >= 4 ? 16 : widest == 2 ? 32 : 64;
  const int inputs = num_columns <= 4 ? 1 : 2;
  const int tile_rows = rows * kThreads;
  const int tiles = static_cast<int>((n + tile_rows - 1) / tile_rows);
  const int count_tiles_n =
      static_cast<int>((n + kCountTile - 1) / kCountTile);
  unsigned long long* status = scratch + 1;
  int* offsets = reinterpret_cast<int*>(status + count_tiles_n);
  count_tiles<<<count_tiles_n, kThreads, 0, stream>>>(
      keep, n, tile_rows, status, reinterpret_cast<unsigned int*>(scratch),
      count_tiles_n, offsets, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int buf_bytes = tile_rows * widest + 16;
  const int smem = (inputs + 1) * buf_bytes;
  Launch launch = nullptr;
  if (inputs == 1) {
    launch = rows == 16 ? launch_moves<16, 1>
           : rows == 32 ? launch_moves<32, 1> : launch_moves<64, 1>;
  } else {
    launch = rows == 16 ? launch_moves<16, 2>
           : rows == 32 ? launch_moves<32, 2> : launch_moves<64, 2>;
  }
  return launch(keep, n, cols, buf_bytes, smem, offsets, count, tiles,
                stream);
}
