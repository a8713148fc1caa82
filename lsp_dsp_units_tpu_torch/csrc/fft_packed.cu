// Packed real FFT for Hopper: forward (full or zero-padded input) and
// inverse (all, first or last half of the output), one thread block per
// row.
//
// Replaces the TPU kernel ops/pallas_fft.py::_call of the JAX package
// (_fwd_kernel/_inv_kernel -> _fwd_tile/_inv_tile), which ran the
// transform as a four-step of bf16x3 matmuls on the MXU.  Here it is a
// radix-2 FP32 FMA transform in shared memory (fft_packed.cuh).
//
// What bounds it: each row reads and writes N floats once (at the main
// path's 64 x 16384, 4 MB each way: ~2.5 us of HBM at 3.35 TB/s), while
// the log2(M) = 13 butterfly stages run out of shared memory with a
// barrier each.  With one block per row, 64 rows fill under half of the
// card's 132 SMs, so the shared-memory passes, not HBM, set the time.
// The design keeps every intermediate on chip, reads and writes global
// memory coalesced, and needs no permutation pass (see the header).

#include "fft_packed.cuh"

using namespace lspfft;

namespace {

__global__ void __launch_bounds__(kThreads)
rfft_packed_kernel(const float* __restrict__ x, float* __restrict__ out_re,
                   float* __restrict__ out_im, const float2* __restrict__ wst,
                   const float2* __restrict__ wnb, int log_m, int half_input) {
  extern __shared__ float2 buf[];
  const int m = 1 << log_m;
  const int row = blockIdx.x;
  const float2* xz = reinterpret_cast<const float2*>(x) +
                     (size_t)row * (half_input ? (m >> 1) : m);
  if (half_input) {
    // z[n] = 0 for n >= M/2: the first DIF stage reduces to a copy and a
    // twiddle, fused into the load
    for (int n = threadIdx.x; n < (m >> 1); n += blockDim.x) {
      const float2 a = xz[n];
      buf[n] = a;
      buf[n + (m >> 1)] = cmul(a, __ldg(&wst[(m >> 1) + n]));
    }
    __syncthreads();
    dif(buf, wst, log_m, m >> 2);
  } else {
    for (int n = threadIdx.x; n < m; n += blockDim.x) buf[n] = xz[n];
    __syncthreads();
    dif(buf, wst, log_m, m >> 1);
  }
  float* ore = out_re + (size_t)row * m;
  float* oim = out_im + (size_t)row * m;
  for (int t = threadIdx.x; t < (m >> 1) - 1; t += blockDim.x) {
    int j, jp;
    pair_of(t, j, jp);
    float2 xk, xmk;
    untangle(buf[j], buf[jp], __ldg(&wnb[j]), xk, xmk);
    ore[j] = xk.x;
    oim[j] = xk.y;
    ore[jp] = xmk.x;
    oim[jp] = xmk.y;
  }
  if (threadIdx.x == 0) {
    const float2 x0 = untangle0(buf[0]);
    const float2 x1 = cconj(buf[1]);
    ore[0] = x0.x;
    oim[0] = x0.y;
    ore[1] = x1.x;
    oim[1] = x1.y;
  }
}

// half: 0 = all N samples, 1 = first N/2, 2 = last N/2
__global__ void __launch_bounds__(kThreads)
irfft_packed_kernel(const float* __restrict__ in_re,
                    const float* __restrict__ in_im, float* __restrict__ y,
                    const float2* __restrict__ wst,
                    const float2* __restrict__ wnb, int log_m, int half) {
  extern __shared__ float2 buf[];
  const int m = 1 << log_m;
  const int row = blockIdx.x;
  const float* ire = in_re + (size_t)row * m;
  const float* iim = in_im + (size_t)row * m;
  for (int t = threadIdx.x; t < (m >> 1) - 1; t += blockDim.x) {
    int j, jp;
    pair_of(t, j, jp);
    float2 zk, zmk;
    retangle(make_float2(ire[j], iim[j]), make_float2(ire[jp], iim[jp]),
             __ldg(&wnb[j]), zk, zmk);
    buf[j] = zk;
    buf[jp] = zmk;
  }
  if (threadIdx.x == 0) {
    buf[0] = retangle0(make_float2(ire[0], iim[0]));
    buf[1] = make_float2(ire[1], -iim[1]);
  }
  __syncthreads();
  dit_inv(buf, wst, log_m);
  const int n0 = half == 2 ? (m >> 1) : 0;
  const int cnt = half == 0 ? m : (m >> 1);
  float2* yz = reinterpret_cast<float2*>(y) + (size_t)row * cnt;
  const float inv_m = 1.0f / (float)m;
  for (int n = threadIdx.x; n < cnt; n += blockDim.x)
    yz[n] = cscale(buf[n0 + n], inv_m);
}

}  // namespace

extern "C" {

int lsp_rfft_packed(const float* x, float* out_re, float* out_im,
                    const float2* wst, const float2* wnb, int rows, int log_m,
                    int half_input, void* stream) {
  const int smem = (int)((size_t(1) << log_m) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      rfft_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rfft_packed_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      x, out_re, out_im, wst, wnb, log_m, half_input);
  return (int)cudaGetLastError();
}

int lsp_irfft_packed(const float* in_re, const float* in_im, float* y,
                     const float2* wst, const float2* wnb, int rows, int log_m,
                     int half, void* stream) {
  const int smem = (int)((size_t(1) << log_m) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      irfft_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  irfft_packed_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      in_re, in_im, y, wst, wnb, log_m, half);
  return (int)cudaGetLastError();
}

}  // extern "C"
