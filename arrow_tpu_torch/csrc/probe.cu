// Start-up probe: y = x * 2 over one (8, 128) f32 tile.
//
// Replaces K5, the TPU compile probe `_probe` in
// arrow_tpu/platform_check.py (`_PALLAS_PROBE_SRC`, run by `self_check`).
// Launched once by arrow_tpu_torch.platform_check.self_check, it shows that
// a library built from this checkout loads and runs on the card.
//
// Bound: 8 KB read and written, well under a microsecond of bandwidth;
// launch latency dominates. The design is one thread per element.

#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

}  // namespace

// Returns a cudaError_t; 0 when the launch was accepted.
extern "C" int probe_double(const float* x, float* y, int n, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return cudaGetLastError();
}
