// Batched dynamic slice: out[v, :] = bank[s_v : s_v + size] for a batch
// of arbitrary sample offsets s_v into one flat bank, each start clamped
// to [0, lim] (lim = N - size - 1024, the JAX function's contract).
//
// Replaces the TPU kernel ops/slicedma.py::batched_slice of the JAX
// package (_kernel), which fetches an 8-row-aligned window per voice by
// DMA and rotates it into place by the residual row and lane offsets (the
// TPU's tiling forbids a DMA at an arbitrary offset).  A Hopper thread
// loads any address, so the copy here is direct: a block per (voice,
// chunk of the window), consecutive threads on consecutive samples, so
// each warp reads one contiguous, unaligned 128-byte span and writes one
// aligned one.
//
// What bounds it: the writes.  At the sampler's 4096 voices x 1024
// samples the function writes 16.8 MB (~5 us at 3.35 TB/s) and reads
// windows of one small bank, which the 50 MB L2 serves.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
slice_kernel(const float* __restrict__ bank, const int* __restrict__ starts,
             float* __restrict__ out, int size, int lim) {
  const int v = blockIdx.x;
  int s = __ldg(&starts[v]);
  s = s < 0 ? 0 : (s > lim ? lim : s);
  const float* src = bank + s;
  float* dst = out + (size_t)v * size;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < size;
       i += gridDim.y * blockDim.x)
    dst[i] = __ldg(&src[i]);
}

}  // namespace

extern "C" {

int lsp_batched_slice(const float* bank, const int* starts, float* out,
                      int v_n, int size, int lim, void* stream) {
  if (v_n <= 0) return 0;
  int chunks = (size + kThreads - 1) / kThreads;
  if (chunks > 65535) chunks = 65535;
  const dim3 grid(v_n, chunks);
  slice_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(bank, starts,
                                                           out, size, lim);
  return (int)cudaGetLastError();
}

}  // extern "C"
