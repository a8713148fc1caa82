// Batched dynamic slice: out[v, :] = bank[s_v : s_v + size] for a batch
// of arbitrary sample offsets s_v into one flat bank, each start clamped
// to [0, lim] (lim = N - size - 1024, the JAX function's contract).
//
// Replaces the TPU kernel ops/slicedma.py::batched_slice of the JAX
// package (_kernel), which fetches an 8-row-aligned window per voice by
// DMA and rotates it into place by the residual row and lane offsets (the
// TPU's tiling forbids a DMA at an arbitrary offset).
//
// What bounds it: the writes.  At the sampler's 4096 voices x 1024
// samples the function writes 16.8 MB (~5 us at 3.35 TB/s) and reads
// windows of one small bank, which the 50 MB L2 serves.  A copy is
// bounded by the bytes in flight, so the design moves 16 bytes per lane
// and keeps a window's loads in flight before its stores:
//
// - one warp per window, kWarps windows per block (4096 voices: 512
//   blocks of 256 threads, one wave); warps past V exit;
// - the warp clamps its start once; r = s & 3 is the same for all its
//   lanes.  Step k of the window is 128 samples: lane l loads the
//   aligned float4 at (s - r) + 128 k + 4 l and takes its right
//   neighbour's float4 by a shuffle (lane 31 gets lane 0's float4 of
//   step k + 1), then composes its four outputs by the shift r, a
//   template argument chosen once per warp, so the composition never
//   diverges.  Lane 0 loads one extra float4 per batch, the step after
//   it, which lies inside the bank's 1024-sample slack;
// - kBatch steps' loads (8 for a 1024-sample window) are issued before
//   the batch's stores;
// - plain 16-byte stores to the 16-byte aligned rows (size is a multiple
//   of 128), no streaming hint: the sampler reads the windows right
//   after the call, from L2.
//
// It is a copy: the output is bitwise the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                   // windows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 128;                  // samples a warp moves per step
constexpr int kBatch = 8;                   // steps whose loads are in flight

// lane's four outputs: samples r .. r + 3 of [a || b]
template <int R>
__device__ __forceinline__ float4 shifted(float4 a, float4 b) {
  if (R == 0) return a;
  if (R == 1) return make_float4(a.y, a.z, a.w, b.x);
  if (R == 2) return make_float4(a.z, a.w, b.x, b.y);
  return make_float4(a.w, b.x, b.y, b.z);
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, src),
                     __shfl_sync(0xffffffffu, v.y, src),
                     __shfl_sync(0xffffffffu, v.z, src),
                     __shfl_sync(0xffffffffu, v.w, src));
}

// One window: src = the lane's first aligned float4, dst = its first
// output float4; steps = size / 128.
template <int R>
__device__ __forceinline__ void copy_window(const float4* __restrict__ src,
                                            float4* __restrict__ dst,
                                            int steps, int lane) {
  const int right = (lane + 1) & 31;
  for (int k0 = 0; k0 < steps; k0 += kBatch) {
    const int n = steps - k0 < kBatch ? steps - k0 : kBatch;
    // a[j] = step k0 + j; a[n] (lane 0 only) the step after the batch
    float4 a[kBatch + 1];
#pragma unroll
    for (int j = 0; j <= kBatch; ++j) {
      if (j < n) {
        a[j] = __ldg(src + 32 * (k0 + j));
      } else if (R != 0 && j == n && lane == 0) {
        a[j] = __ldg(src + 32 * (k0 + j));
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j < n) {
        float4 b = a[j];
        if (R != 0) {
          // lanes 1-31 offer step j, lane 0 step j + 1 (for lane 31)
          b = shfl4(lane == 0 ? a[j + 1] : a[j], right);
        }
        dst[32 * (k0 + j)] = shifted<R>(a[j], b);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
slice_kernel(const float* __restrict__ bank, const int* __restrict__ starts,
             float* __restrict__ out, int v_n, int size, int lim) {
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= v_n) return;
  const int lane = threadIdx.x & 31;
  int s = __ldg(&starts[v]);
  s = s < 0 ? 0 : (s > lim ? lim : s);
  const int r = s & 3;
  const float4* src = reinterpret_cast<const float4*>(bank + (s - r)) + lane;
  float4* dst = reinterpret_cast<float4*>(out + (size_t)v * size) + lane;
  const int steps = size / kStep;
  switch (r) {
    case 0: copy_window<0>(src, dst, steps, lane); break;
    case 1: copy_window<1>(src, dst, steps, lane); break;
    case 2: copy_window<2>(src, dst, steps, lane); break;
    default: copy_window<3>(src, dst, steps, lane); break;
  }
}

bool bad_shape(int v_n, int size) {
  return v_n < 0 || size < 0 || size % kStep;
}

}  // namespace

extern "C" {

// bank 16-byte aligned, N a multiple of 128 and >= size + 1024 (the
// wrapper checks); size a multiple of 128.
int lsp_batched_slice(const float* bank, const int* starts, float* out,
                      int v_n, int size, int lim, void* stream) {
  if (bad_shape(v_n, size)) return (int)cudaErrorInvalidValue;
  if (v_n == 0 || size == 0) return 0;
  slice_kernel<<<(v_n + kWarps - 1) / kWarps, kThreads, 0,
                 (cudaStream_t)stream>>>(bank, starts, out, v_n, size, lim);
  return (int)cudaGetLastError();
}

// The launch shape for v_n windows: out[0] blocks, out[1] threads per
// block, out[2] blocks resident per SM (the occupancy calculator).
int lsp_batched_slice_shape(int v_n, int* out) {
  if (bad_shape(v_n, kStep)) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, slice_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = (v_n + kWarps - 1) / kWarps;
  out[1] = kThreads;
  out[2] = per_sm;
  return 0;
}

}  // extern "C"
