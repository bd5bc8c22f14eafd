// xxhash32 of one or more 32-bit words per row, joined by the Hashing32
// combiner.
//
// Replaces the TPU kernel K4, arrow_tpu/experimental/pallas_hash.py
// `_pallas_hash_kernel` (driven by `hash32_pallas`), and is bit-exact with
// arrow_tpu/compute/hashing.py `hash32_words`:
//   h(w)        = avalanche(rotl32(PRIME32_5 + 4 + w * PRIME32_3, 17)
//                           * PRIME32_4)
//   out         = h(w0); out = combine(out, h(wi)) for i = 1..k-1
//   combine(p, h) = p ^ (h + 0x9e3779b9 + (p << 6) + (p >> 2))
// all in uint32 arithmetic, which wraps as the reference's does. The TPU
// kernel needed rows in (64, 128) tiles and n a multiple of 8192; here each
// thread hashes whole rows and the ragged edge is masked by the loop bound.
//
// Each word plane is a pointer with an element stride, so the two 32-bit
// halves of an int64 column are read in place (stride 2, offsets 0 and 1)
// with no split copy.
//
// Bound: n * (4k + 4) bytes (each word read once, the hash written once);
// about 25 integer operations a word, far below the card's int32 rate. For
// k = 2 at Q3's lineitem capacity (60,012,544 rows) that is 0.72 GB, about
// 0.215 ms at 3.35 TB/s.
//
// Design: one grid-stride loop over rows, one wave of blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 16;

constexpr uint32_t kPrime2 = 2246822519u;
constexpr uint32_t kPrime3 = 3266489917u;
constexpr uint32_t kPrime4 = 668265263u;
constexpr uint32_t kPrime5 = 374761393u;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Words {
  const uint32_t* ptr[kMaxWords];
  long long stride[kMaxWords];
  int count;
};

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 15;
  h *= kPrime2;
  h ^= h >> 13;
  h *= kPrime3;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_word(uint32_t w) {
  uint32_t h = kPrime5 + 4u + w * kPrime3;
  h = ((h << 17) | (h >> 15)) * kPrime4;
  return avalanche(h);
}

__global__ void __launch_bounds__(kThreads)
hash32_kernel(const Words words, long long n, uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    uint32_t h = hash_word(__ldg(words.ptr[0] + i * words.stride[0]));
    for (int k = 1; k < words.count; ++k) {
      const uint32_t hk = hash_word(__ldg(words.ptr[k] + i * words.stride[k]));
      h ^= hk + kGolden + (h << 6) + (h >> 2);
    }
    out[i] = h;
  }
}

}  // namespace

// planes/strides: `num_words` word planes of n rows, row i of plane k at
// planes[k][i * strides[k]]. out: n uint32. Returns a cudaError_t; 0 when
// the launch was accepted.
extern "C" int hash32_words(const uint32_t* const* planes,
                            const long long* strides, int num_words,
                            long long n, uint32_t* out, void* stream_ptr) {
  if (num_words < 1 || num_words > kMaxWords || n <= 0) {
    return cudaErrorInvalidValue;
  }
  Words words;
  words.count = num_words;
  for (int k = 0; k < num_words; ++k) {
    words.ptr[k] = planes[k];
    words.stride[k] = strides[k];
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash32_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long wanted = (n + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(wanted < wave ? wanted : wave);
  hash32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      words, n, out);
  return cudaGetLastError();
}
