// Two kernels of the convolver block, one thread block per channel, every
// spectrum kept in shared memory from the transform that makes it to the
// one that consumes it:
//
// eqfdl_kernel — the chain's linear path after the EQ's forward FFT: EQ
// product and first-half inverse plus the carried-state correction (-> u),
// the FDL frame [hist || u] forward FFT (-> S), the ring MAC with slot w
// read as S, the in-place write of S to ring slot w, the last-half inverse
// (-> y), and the EQ's state update.  Replaces the TPU kernel
// ops/pallas_fdl_fused.py::eqfdl_fused_pallas of the JAX package
// (_eqfdl_kernel), minus its first zero-padded forward FFT, which runs as
// the standalone packed FFT (fft_packed.cu) just before this launch, and
// plus the EQ's small state products (g_mat @ sv, m_mat @ sv + w_mat @ x),
// which the TPU path left to XLA: computed here in FP32 FMA they cannot
// change with any global TF32 or matmul-precision setting.
//
// fdl_kernel — the standalone convolver block: the frame [hist || x]
// forward FFT (-> S), the same ring MAC and slot write, the same last-half
// inverse (-> y).  Replaces ops/pallas_fdl_fused.py::fdl_fused_pallas
// (_kernel).  It is eqfdl_kernel without the EQ: both run the shared
// mac_pass and write_last_half below.
//
// What bounds them: HBM.  Per block at 64 channels, N = 16384, P = 6,
// each channel reads P-1 ring slots and P IR spectra (64 KB each) and
// writes one slot: ~25 MB of ring traffic per block, ~7.5 us at 3.35
// TB/s (fdl_kernel's whole traffic with the frame and y: ~32 MB, ~9.5 us).
// With one block per channel, 64 of the 132 SMs carry that traffic, and
// the three (fdl_kernel: two) transforms, 13 shared-memory stages each,
// sit between the loads.  The only global traffic is the inputs, the
// outputs and the ring.  The MAC, untangle and retangle are fused into
// one pass over bin pairs, with ring and IR reads coalesced in the packed
// (bit-reversed) order.  Slot w is never read, only written, so the
// in-place write races with no read of another slot.

#include "fft_packed.cuh"

using namespace lspfft;

namespace {

constexpr int kMaxK2 = 64;                    // 2 x biquad stages
constexpr int kWarps = kThreads / 32;

// (b)-(d) untangle buf (the frame's complex FFT) -> S; acc = sum_p ring'[p]
// H[(w - p) % P] with slot w read as S; ring[w] := S; (e) acc retangled
// into buf for the inverse.  The caller synchronises before the inverse.
__device__ __forceinline__ void mac_pass(
    float2* buf, float* __restrict__ ring_re, float* __restrict__ ring_im,
    const float* __restrict__ h_re, const float* __restrict__ h_im,
    const float2* __restrict__ wnb, int m, int p_n, int w, int c_n,
    size_t row) {
  const int half = m >> 1;
  const size_t plane = (size_t)c_n * m;
  float* wre = ring_re + w * plane + row;
  float* wim = ring_im + w * plane + row;
  // the self-paired positions 0 and 1 (thread 0)
  auto mac = [&](int j, float2 s) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int p = 0; p < p_n; ++p) {
      const int q = (w - p + p_n) % p_n;
      const float2 v = p == w ? s
                              : make_float2(ring_re[p * plane + row + j],
                                            ring_im[p * plane + row + j]);
      const float2 hv = make_float2(__ldg(&h_re[(size_t)q * m + j]),
                                    __ldg(&h_im[(size_t)q * m + j]));
      acc = cadd(acc, pmul(v, hv, j));
    }
    wre[j] = s.x;
    wim[j] = s.y;
    return acc;
  };
  for (int t = threadIdx.x; t < half - 1; t += blockDim.x) {
    int j, jp;
    pair_of(t, j, jp);
    const float2 wk = __ldg(&wnb[j]);
    float2 sk, smk;
    untangle(buf[j], buf[jp], wk, sk, smk);
    // both bins of the pair per partition: four ring and four IR loads
    // in flight per step (bins j, jp >= 2 are complex)
    float2 ak = make_float2(0.0f, 0.0f), amk = make_float2(0.0f, 0.0f);
#pragma unroll 2
    for (int p = 0; p < p_n; ++p) {
      const int q = (w - p + p_n) % p_n;
      const size_t off = p * plane + row;
      float2 vk = sk, vmk = smk;
      if (p != w) {
        vk = make_float2(ring_re[off + j], ring_im[off + j]);
        vmk = make_float2(ring_re[off + jp], ring_im[off + jp]);
      }
      const float* hr = h_re + (size_t)q * m;
      const float* hi = h_im + (size_t)q * m;
      ak = cadd(ak, cmul(vk, make_float2(__ldg(&hr[j]), __ldg(&hi[j]))));
      amk = cadd(amk, cmul(vmk, make_float2(__ldg(&hr[jp]),
                                            __ldg(&hi[jp]))));
    }
    wre[j] = sk.x;
    wim[j] = sk.y;
    wre[jp] = smk.x;
    wim[jp] = smk.y;
    float2 zk, zmk;
    retangle(ak, amk, wk, zk, zmk);
    buf[j] = zk;
    buf[jp] = zmk;
  }
  if (threadIdx.x == 0) {
    const float2 a0 = mac(0, untangle0(buf[0]));
    const float2 a1 = mac(1, cconj(buf[1]));
    buf[0] = retangle0(a0);
    buf[1] = cconj(a1);
  }
}

// y (one [B] row) = the last half of the inverse; buf holds M times the
// complex inverse
__device__ __forceinline__ void write_last_half(const float2* buf,
                                                float* __restrict__ y, int m) {
  const int half = m >> 1;
  const float inv_m = 1.0f / (float)m;
  float2* yz = reinterpret_cast<float2*>(y);
  for (int n = threadIdx.x; n < half; n += blockDim.x)
    yz[n] = cscale(buf[half + n], inv_m);
}

__global__ void __launch_bounds__(kThreads)
eqfdl_kernel(float* __restrict__ ring_re, float* __restrict__ ring_im,
             const float* __restrict__ h_re, const float* __restrict__ h_im,
             const float* __restrict__ heq_re,
             const float* __restrict__ heq_im,
             const float* __restrict__ xs_re,
             const float* __restrict__ xs_im, const float* __restrict__ x,
             const float* __restrict__ sv, const float* __restrict__ g_t,
             const float* __restrict__ m_mat,
             const float* __restrict__ w_mat,
             const float* __restrict__ hist, float* __restrict__ y,
             float* __restrict__ u, float* __restrict__ sv_out,
             const float2* __restrict__ wst, const float2* __restrict__ wnb,
             int log_m, int p_n, int w, int c_n, int k2) {
  extern __shared__ __align__(16) float2 buf[];
  __shared__ float s_sv[kMaxK2];
  __shared__ float s_wx[kMaxK2];
  const int m = 1 << log_m;
  const int half = m >> 1;
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)c * m;          // spectra rows and [C, B] rows

  // EQ state: sv' = M sv + W x.  x is staged in shared memory (buf is
  // free until the EQ pass) and each warp reduces whole rows of W, so W
  // streams from L2 coalesced with two independent accumulators per lane.
  if (threadIdx.x < k2) s_sv[threadIdx.x] = sv[(size_t)c * k2 + threadIdx.x];
  {
    const float4* x4 = reinterpret_cast<const float4*>(x + row);
    float4* xs4 = reinterpret_cast<float4*>(buf);
    for (int q = threadIdx.x; q < (m >> 2); q += blockDim.x) xs4[q] = x4[q];
    __syncthreads();
    for (int k = warp; k < k2; k += kWarps) {
      const float4* wk4 = reinterpret_cast<const float4*>(w_mat + (size_t)k * m);
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int q = lane; q < (m >> 2); q += 32) {
        const float4 wv = __ldg(&wk4[q]);
        const float4 xv = xs4[q];
        acc0 = fmaf(wv.x, xv.x, acc0);
        acc1 = fmaf(wv.y, xv.y, acc1);
        acc0 = fmaf(wv.z, xv.z, acc0);
        acc1 = fmaf(wv.w, xv.w, acc1);
      }
      float acc = acc0 + acc1;
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_wx[k] = acc;
    }
  }
  __syncthreads();
  if (threadIdx.x < k2) {
    const int k = threadIdx.x;
    float acc = s_wx[k];
    for (int jj = 0; jj < k2; ++jj)
      acc = fmaf(__ldg(&m_mat[(size_t)k * k2 + jj]), s_sv[jj], acc);
    sv_out[(size_t)c * k2 + k] = acc;
  }

  // (a) EQ: X * Heq, retangled for the inverse
  {
    const float* xre = xs_re + row;
    const float* xim = xs_im + row;
    for (int t = threadIdx.x; t < half - 1; t += blockDim.x) {
      int j, jp;
      pair_of(t, j, jp);
      const float2 pk = cmul(make_float2(xre[j], xim[j]),
                             make_float2(__ldg(&heq_re[j]), __ldg(&heq_im[j])));
      const float2 pmk = cmul(make_float2(xre[jp], xim[jp]),
                              make_float2(__ldg(&heq_re[jp]),
                                          __ldg(&heq_im[jp])));
      float2 zk, zmk;
      retangle(pk, pmk, __ldg(&wnb[j]), zk, zmk);
      buf[j] = zk;
      buf[jp] = zmk;
    }
    if (threadIdx.x == 0) {
      const float2 p0 = pmul(make_float2(xre[0], xim[0]),
                             make_float2(heq_re[0], heq_im[0]), 0);
      const float2 p1 = cmul(make_float2(xre[1], xim[1]),
                             make_float2(heq_re[1], heq_im[1]));
      buf[0] = retangle0(p0);
      buf[1] = cconj(p1);
    }
  }
  __syncthreads();
  dit_inv(buf, wst, log_m);

  // u = first half + g_mat @ sv; the FDL frame [hist || u] with its first
  // DIF stage fused into the write
  {
    const float inv_m = 1.0f / (float)m;
    const float2* hz = reinterpret_cast<const float2*>(hist + row);
    float2* uz = reinterpret_cast<float2*>(u + row);
    // each thread accumulates kGroup outputs together, so a row of g_t
    // has kGroup loads in flight per thread
    for (int n0 = threadIdx.x; n0 < half; n0 += kGroup * blockDim.x) {
      float2 corr[kGroup];
#pragma unroll
      for (int v = 0; v < kGroup; ++v) corr[v] = make_float2(0.0f, 0.0f);
      for (int k = 0; k < k2; ++k) {
        const float2* gk = reinterpret_cast<const float2*>(g_t + (size_t)k * m);
        const float s = s_sv[k];
#pragma unroll
        for (int v = 0; v < kGroup; ++v) {
          const int n = n0 + v * blockDim.x;
          if (n < half) {
            const float2 g = __ldg(&gk[n]);
            corr[v].x = fmaf(g.x, s, corr[v].x);
            corr[v].y = fmaf(g.y, s, corr[v].y);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < kGroup; ++v) {
        const int n = n0 + v * blockDim.x;
        if (n < half) {
          const float2 un = cadd(cscale(buf[n], inv_m), corr[v]);
          uz[n] = un;
          const float2 h = hz[n];
          buf[n] = cadd(h, un);
          buf[n + half] = cmul(csub(h, un), __ldg(&wst[half + n]));
        }
      }
    }
  }
  __syncthreads();
  dif(buf, wst, log_m, m >> 2);

  mac_pass(buf, ring_re, ring_im, h_re, h_im, wnb, m, p_n, w, c_n, row);
  __syncthreads();
  dit_inv(buf, wst, log_m);
  write_last_half(buf, y + row, m);
}

__global__ void __launch_bounds__(kThreads)
fdl_kernel(float* __restrict__ ring_re, float* __restrict__ ring_im,
           const float* __restrict__ h_re, const float* __restrict__ h_im,
           const float* __restrict__ hist, const float* __restrict__ x,
           float* __restrict__ y, const float2* __restrict__ wst,
           const float2* __restrict__ wnb, int log_m, int p_n, int w,
           int c_n) {
  extern __shared__ __align__(16) float2 buf[];
  const int m = 1 << log_m;
  const int half = m >> 1;
  const size_t row = (size_t)blockIdx.x * m;  // spectra rows and [C, B] rows

  // the frame [hist || x] as M complex values z[n] = (f[2n], f[2n+1]),
  // with the first DIF stage (span M/2: hist half against x half) fused
  // into the load
  {
    const float2* hz = reinterpret_cast<const float2*>(hist + row);
    const float2* xz = reinterpret_cast<const float2*>(x + row);
    for (int n = threadIdx.x; n < half; n += blockDim.x) {
      const float2 h = hz[n];
      const float2 v = xz[n];
      buf[n] = cadd(h, v);
      buf[n + half] = cmul(csub(h, v), __ldg(&wst[half + n]));
    }
  }
  __syncthreads();
  dif(buf, wst, log_m, m >> 2);
  mac_pass(buf, ring_re, ring_im, h_re, h_im, wnb, m, p_n, w, c_n, row);
  __syncthreads();
  dit_inv(buf, wst, log_m);
  write_last_half(buf, y + row, m);
}

}  // namespace

extern "C" {

int lsp_eqfdl_fused(float* ring_re, float* ring_im, const float* h_re,
                    const float* h_im, const float* heq_re,
                    const float* heq_im, const float* xs_re,
                    const float* xs_im, const float* x, const float* sv,
                    const float* g_t, const float* m_mat, const float* w_mat,
                    const float* hist, float* y, float* u, float* sv_out,
                    const float2* wst, const float2* wnb, int log_m, int p_n,
                    int w, int c_n, int k2, void* stream) {
  if (k2 > kMaxK2) return (int)cudaErrorInvalidValue;
  const int smem = (int)((size_t(1) << log_m) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      eqfdl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  eqfdl_kernel<<<c_n, kThreads, smem, (cudaStream_t)stream>>>(
      ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re, xs_im, x, sv, g_t,
      m_mat, w_mat, hist, y, u, sv_out, wst, wnb, log_m, p_n, w, c_n, k2);
  return (int)cudaGetLastError();
}

int lsp_fdl_fused(float* ring_re, float* ring_im, const float* h_re,
                  const float* h_im, const float* hist, const float* x,
                  float* y, const float2* wst, const float2* wnb, int log_m,
                  int p_n, int w, int c_n, void* stream) {
  const int smem = (int)((size_t(1) << log_m) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      fdl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fdl_kernel<<<c_n, kThreads, smem, (cudaStream_t)stream>>>(
      ring_re, ring_im, h_re, h_im, hist, x, y, wst, wnb, log_m, p_n, w, c_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
