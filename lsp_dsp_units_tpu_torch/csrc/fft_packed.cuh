// Packed real FFT building blocks, shared by fft_packed.cu and
// fdl_fused.cu: the untangle and the two-block split schedule's register
// passes (radix_pass), which run the butterflies of the in-place radix-2
// transform on the same operands in the same order.
//
// A real N-point frame x is transformed as the complex M-point FFT
// (M = N/2) of z[n] = x[2n] + i x[2n+1], followed by the real-input
// "untangle".  Two thread blocks own one row and keep half of its M
// complex values each in shared memory (34 KB at N = 16384).
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

// ---------------------------------------------------------------------------
// The two-block split schedule.  After the first DIF stage (span M/2) the
// two halves of the M points are independent transforms, and pair_of
// never pairs positions across halves (it maps each octave [2^a, 2^(a+1))
// onto itself; positions 0 and 1 lie in the first half), so a row's two
// blocks (a cluster where a stage crosses the halves) each hold L = M/2
// points in shared memory and run their stages in register passes.
// ---------------------------------------------------------------------------

constexpr int kRadixBits = 4;                  // stages per register pass
constexpr int kPts = 1 << kRadixBits;          // points a pass thread holds

// shared-memory slot of local point i: one float2 of padding per 16, so
// that neither the strided nor the contiguous groups conflict on banks
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int padded(int l) { return l + (l >> 4); }

// One radix-2 stage (span 2^(lo + S)) on the 2^KK points u[r] = point
// base + (r << lo) of one group; jl = base mod 2^lo.  The butterflies are
// the radix-2 DIF's (a + c, (a - c) w) or DIT's (a + c conj(w), a - c
// conj(w)), with the twiddle w = wst[h + (i & (h - 1))] of point i.
template <int KK, int S, bool kInv>
__device__ __forceinline__ void stage(float2* u,
                                      const float2* __restrict__ wst, int jl,
                                      int lo) {
  constexpr int kHalf = 1 << S;
  const int h = 1 << (lo + S);
  float2 tw[kHalf];
#pragma unroll
  for (int q = 0; q < kHalf; ++q) tw[q] = __ldg(&wst[h + jl + (q << lo)]);
#pragma unroll
  for (int r0 = 0; r0 < (1 << KK); r0 += 2 * kHalf) {
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const float2 a = u[r0 + q];
      if (kInv) {
        const float2 c = cmulc(u[r0 + q + kHalf], tw[q]);
        u[r0 + q] = cadd(a, c);
        u[r0 + q + kHalf] = csub(a, c);
      } else {
        const float2 c = u[r0 + q + kHalf];
        u[r0 + q] = cadd(a, c);
        u[r0 + q + kHalf] = cmul(csub(a, c), tw[q]);
      }
    }
  }
}

// The KK stages of a pass in transform order: spans falling (DIF) or
// rising (DIT).
template <int KK, int S, bool kInv>
__device__ __forceinline__ void stages(float2* u,
                                       const float2* __restrict__ wst,
                                       int jl, int lo) {
  stage<KK, S, kInv>(u, wst, jl, lo);
  if constexpr (kInv && S + 1 < KK) stages<KK, S + 1, kInv>(u, wst, jl, lo);
  if constexpr (!kInv && S > 0) stages<KK, S - 1, kInv>(u, wst, jl, lo);
}

// One pass over a block's L local points: stages with spans 2^lo ..
// 2^(lo + KK - 1).  A group is the 2^KK points that differ only in bits
// [lo, lo + KK) of the local index; each of the nt = L / kPts pass
// threads (threadIdx.x < nt) takes kPts / 2^KK groups, loads all its
// points (ld), runs the stages in registers and stores them (st) to the
// same slots, so a pass needs no barrier inside.
template <int KK, bool kInv, class Load, class Store>
__device__ __forceinline__ void radix_pass(const float2* __restrict__ wst,
                                           int lo, int nt, Load ld,
                                           Store st) {
  constexpr int kP = 1 << KK;
  constexpr int kG = kPts / kP;
  const int mask = (1 << lo) - 1;
  int base[kG];
  float2 v[kPts];
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    const int g = threadIdx.x + q * nt;
    base[q] = (g & mask) | ((g >> lo) << (lo + KK));
#pragma unroll
    for (int r = 0; r < kP; ++r) v[q * kP + r] = ld(base[q] + (r << lo));
  }
#pragma unroll
  for (int q = 0; q < kG; ++q)
    stages<KK, kInv ? 0 : KK - 1, kInv>(v + q * kP, wst, base[q] & mask, lo);
#pragma unroll
  for (int q = 0; q < kG; ++q)
#pragma unroll
    for (int r = 0; r < kP; ++r) st(base[q] + (r << lo), v[q * kP + r]);
}

template <bool kInv, class Load, class Store>
__device__ __forceinline__ void pass(int kk, const float2* __restrict__ wst,
                                     int lo, int nt, Load ld, Store st) {
  switch (kk) {
    case 1: radix_pass<1, kInv>(wst, lo, nt, ld, st); break;
    case 2: radix_pass<2, kInv>(wst, lo, nt, ld, st); break;
    case 3: radix_pass<3, kInv>(wst, lo, nt, ld, st); break;
    default: radix_pass<4, kInv>(wst, lo, nt, ld, st); break;
  }
}

// log2(M) outside the split kernels' range: M = 64 (the pair mapping's
// octaves) to 16384 (8192 points per block)
inline bool bad_size(int log_m) { return log_m < 6 || log_m > 14; }

// The packed positions of half b: pairs t0 .. t0 + count - 1 of pair_of
// (half 0 also owns the self-paired positions 0 and 1).
__device__ __forceinline__ void half_pairs(int b, int l, int& t0,
                                           int& count) {
  t0 = b ? (l >> 1) - 1 : 0;
  count = b ? (l >> 1) : (l >> 1) - 1;
}

}  // namespace lspfft
