// Packed real FFT building blocks, shared by fft_packed.cu and
// fdl_fused.cu.
//
// A real N-point frame x is transformed as the complex M-point FFT
// (M = N/2) of z[n] = x[2n] + i x[2n+1], followed by the real-input
// "untangle".  One thread block owns one row and keeps its M complex
// values in shared memory (64 KB at N = 16384).
//
// Spectrum order ("packed"): position j holds bin rev(j), the log2(M)-bit
// reversal of j, and position 0 holds the two real bins: re = DC,
// im = Nyquist.  The forward transform is an in-place radix-2
// decimation-in-frequency pass (natural in, bit-reversed out) and the
// inverse an in-place decimation-in-time pass (bit-reversed in, natural
// out), so neither direction ever permutes data.  The untangle pairs bin
// k with bin M-k; in bit-reversed positions the partner of j (j >= 2,
// in the octave [2^a, 2^(a+1))) is 3*2^a - 1 - j, so a warp reads both
// halves of each pair from consecutive addresses.
//
// Precision: FP32 FMA throughout; the twiddles are computed in float64
// on the host and rounded once (ops/fft_packed.py::_tables).
//   wst[h + j] = exp(-2 pi i j / 2h), h = 1, 2, 4, ..., M/2, j in [0, h)
//                (per-stage tables: the lanes of a warp read a stage's
//                twiddles from consecutive addresses)
//   wnb[j]     = exp(-2 pi i rev(j) / N), j in [0, M)   (packed order)

#pragma once
#include <cuda_runtime.h>

namespace lspfft {

constexpr int kThreads = 512;
constexpr int kGroup = 8;        // butterflies per thread in flight

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}
__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
// product of two packed spectra at position j: complex everywhere except
// position 0, whose (DC, Nyquist) slots multiply slot-wise
__device__ __forceinline__ float2 pmul(float2 a, float2 b, int j) {
  return j == 0 ? make_float2(a.x * b.x, a.y * b.y) : cmul(a, b);
}

// Forward DIF stages with spans h = h_start, h_start/2, ..., 1 (in place,
// natural in, bit-reversed out once all log2(M) spans have run).  The
// caller has synchronised after filling buf; every stage ends with a
// barrier.  Once the transform has at least kGroup butterflies per
// thread (M = 8192 at 512 threads: exactly kGroup), each thread loads
// kGroup butterflies before it computes and stores any of them (they are
// disjoint within a stage), with no bounds checks in the loop.
__device__ __forceinline__ void dif(float2* buf, const float2* __restrict__ wst,
                                    int log_m, int h_start) {
  const int nb = 1 << (log_m - 1);
  const int bd = blockDim.x;
  const bool grouped = nb >= kGroup * bd;       // powers of two: divides
  for (int h = h_start; h >= 1; h >>= 1) {
    if (grouped) {
      for (int b0 = threadIdx.x; b0 < nb; b0 += kGroup * bd) {
        float2 a[kGroup], c[kGroup], w[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int b = b0 + u * bd;
          const int i = 2 * b - (b & (h - 1));
          a[u] = buf[i];
          c[u] = buf[i + h];
          w[u] = __ldg(&wst[h + (b & (h - 1))]);
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int b = b0 + u * bd;
          const int i = 2 * b - (b & (h - 1));
          buf[i] = cadd(a[u], c[u]);
          buf[i + h] = cmul(csub(a[u], c[u]), w[u]);
        }
      }
    } else {
      for (int b = threadIdx.x; b < nb; b += bd) {
        const int j = b & (h - 1);
        const int i = 2 * b - j;
        const float2 a = buf[i];
        const float2 c = buf[i + h];
        buf[i] = cadd(a, c);
        buf[i + h] = cmul(csub(a, c), __ldg(&wst[h + j]));
      }
    }
    __syncthreads();
  }
}

// Inverse DIT stages, all spans (bit-reversed in, natural out, unscaled:
// the result is M times the inverse DFT).  Same barrier contract and
// grouping as dif.
__device__ __forceinline__ void dit_inv(float2* buf,
                                        const float2* __restrict__ wst,
                                        int log_m) {
  const int m = 1 << log_m;
  const int nb = m >> 1;
  const int bd = blockDim.x;
  const bool grouped = nb >= kGroup * bd;
  for (int h = 1; h < m; h <<= 1) {
    if (grouped) {
      for (int b0 = threadIdx.x; b0 < nb; b0 += kGroup * bd) {
        float2 a[kGroup], c[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int b = b0 + u * bd;
          const int i = 2 * b - (b & (h - 1));
          a[u] = buf[i];
          c[u] = cmulc(buf[i + h], __ldg(&wst[h + (b & (h - 1))]));
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int b = b0 + u * bd;
          const int i = 2 * b - (b & (h - 1));
          buf[i] = cadd(a[u], c[u]);
          buf[i + h] = csub(a[u], c[u]);
        }
      }
    } else {
      for (int b = threadIdx.x; b < nb; b += bd) {
        const int j = b & (h - 1);
        const int i = 2 * b - j;
        const float2 a = buf[i];
        const float2 c = cmulc(buf[i + h], __ldg(&wst[h + j]));
        buf[i] = cadd(a, c);
        buf[i + h] = csub(a, c);
      }
    }
    __syncthreads();
  }
}

// Pair t in [0, M/2 - 1) -> packed positions (j, jp) holding bins k and
// M - k, for every k except 0 and M/2 (positions 0 and 1).
__device__ __forceinline__ void pair_of(int t, int& j, int& jp) {
  const int v = t + 1;
  const int hb = 1 << (31 - __clz(v));
  j = v + hb;
  jp = 6 * hb - 1 - j;
}

// Untangle: Z[k], Z[M-k] of the complex FFT -> X[k], X[M-k] of the real
// N-point FFT.  wk = W_N^k.
__device__ __forceinline__ void untangle(float2 a, float2 b, float2 wk,
                                         float2& xk, float2& xmk) {
  const float2 bc = cconj(b);
  const float2 e = cscale(cadd(a, bc), 0.5f);
  const float2 d = csub(a, bc);
  const float2 o = make_float2(0.5f * d.y, -0.5f * d.x);    // -i d / 2
  const float2 wo = cmul(wk, o);
  xk = cadd(e, wo);
  xmk = cconj(csub(e, wo));
}

// Retangle (inverse of untangle): X[k], X[M-k] -> Z[k], Z[M-k].
__device__ __forceinline__ void retangle(float2 xk, float2 xmk, float2 wk,
                                         float2& zk, float2& zmk) {
  const float2 xc = cconj(xmk);
  const float2 e = cscale(cadd(xk, xc), 0.5f);
  const float2 o = cmulc(cscale(csub(xk, xc), 0.5f), wk);
  const float2 io = make_float2(-o.y, o.x);
  zk = cadd(e, io);
  zmk = cconj(csub(e, io));
}

// The two self-paired positions.  Position 0: Z[0] <-> (DC, Nyquist);
// position 1 (bin M/2): X = conj(Z).
__device__ __forceinline__ float2 untangle0(float2 z0) {
  return make_float2(z0.x + z0.y, z0.x - z0.y);
}
__device__ __forceinline__ float2 retangle0(float2 x0) {
  return make_float2(0.5f * (x0.x + x0.y), 0.5f * (x0.x - x0.y));
}

}  // namespace lspfft
