// The lookahead limiter's gain: ops/limiter.py's limiter, per row
//
//   gbuf = [gcarry (5L) || ones (T)],  lvl[i] = |sc[i]| * gbuf[L + i]
//   1. ALR (optional): e = fma(s > e ? tau_att : tau_rel, s - e, e) over
//      s = lvl[i], and gbuf[L + i] *= knee gain of e;
//   2. while max lvl > thr (and fewer than 1024 passes ran): at the
//      first index of the maximum, peak, with s = lvl[peak]
//        k = (s - fma(thr, knee, -1e-6)) / max(s, 1e-12)
//        gbuf[L + peak - middle + j] *= fma(-k, patch[j], 1),  j < P
//      and knee *= 0.9886 every 32 passes;
//   3. gbuf[L + i] *= min(1, thr / max(lvl[i], 1e-12));
//   gain = gbuf[:T], gcarry' = gbuf[T:].
//
// Replaces the body of the JAX package's models/dynamics/limiter.py
// Limiter.process: the ALR lax.scan (:200-224), the lax.while_loop
// (:228-258) and the clamp and carry (:262-277).  It is no Pallas
// kernel: XLA compiles the scan and the loop.
//
// Rows are independent.  The JAX loop runs every row until no row is
// active (or the most passes any row ran reach 1024); a row inactive
// before a pass has k = 0 and is multiplied by exactly fma(-0, patch, 1)
// = 1 everywhere, so its buffer, and with it its inactivity, stays as it
// was: each row is active for a prefix of the passes, and runs exactly
// min(n_row, 1024) of them, where n_row is the count it needs alone.
// Here each row runs its own loop to that count
// (tests/test_torch_dynamics2.py holds batched rows against each row
// alone in both packages).
//
// What bounds it: the passes.  Each rereads the row's T levels (|sc| and
// gbuf, 8 bytes a sample) to find the maximum: passes x T x 8 bytes from
// shared memory.  The ALR, where it runs, is a serial chain of T steps
// (a compare and select, a subtraction and an FMA).  The bytes (sc in,
// gain out) are far below both.  The design:
//
// - One block of 512 threads per row; the row's gain buffer (W = T + 5L
//   floats), |sc| (T), the patch (P) and, with ALR, its envelopes (T) sit
//   in shared memory where they fit in 227 KB (T up to ~27 000 at L =
//   240, ~18 500 with ALR): smem_kernel.  Longer rows keep the buffer
//   and the envelopes in a global scratch row and read |sc| from sc
//   (global_kernel, the same code).
// - A pass: each thread scans its strided share of the T levels keeping
//   the first maximum, a warp reduces by shuffles (the larger value, the
//   lower index on ties, as argmax keeps the first), and every thread
//   then reduces the 16 warps' partials itself, so the pass needs one
//   barrier before the patch and one after it.
// - The ALR runs before the passes: the levels and the knee gains in
//   parallel, the follower's chain alone on one thread (alr_stage).  A
//   first design ran the whole ALR step on one thread: ~168 cycles a
//   sample, the thread's ~60 instructions a step in order; this one
//   takes ~24 (0.1997 against 1.4040 ms at [64, 16384], EXP_WIDE at 5
//   ms, NVIDIA H100 80GB HBM3 at 700 W, tools/ab_kernels.py).
//
// Every product and sum rounds as the plain version rounds it
// (__fmul_rn, __fadd_rn, __fdiv_rn, and __fmaf_rn where XLA contracts in
// the JAX package), so the two agree bit for bit.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxIters = 1024;       // MAX_PATCH_ITERS
constexpr int kPeaksMax = 32;         // LIMITER_PEAKS_MAX
constexpr float kGainLowering = 0.9886f;
constexpr float kKneeEps = 1e-6f;
constexpr float kTiny = 1e-12f;
constexpr size_t kMaxSmem = 232448 - 1024;   // 227 KB less static
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* sc;      // [rows, T]
  const float* g_in;    // [rows, 5L]
  const float* e_in;    // [rows]
  const float* patch;   // [P]
  float* gain;          // [rows, T]
  float* g_out;         // [rows, 5L]
  float* e_out;         // [rows]
  int* passes;          // [rows]
  float* scratch;       // [rows, 2T + 5L] (global_kernel only)
  int t_n, la, p_n, middle, alr;
  float thr, ks, ke, alr_gain, h0, h1, h2, tau_att, tau_rel;
};

// The patch, the gain buffer (T + 5L), |sc| (T) and, with ALR, the
// envelopes (T).
size_t smem_bytes(int t_n, int la, int p_n, int alr) {
  return sizeof(float) * ((size_t)p_n + (alr ? 3 : 2) * (size_t)t_n
                          + 5 * (size_t)la);
}

// The ALR pre-stage (reference Limiter.cpp:675-693), in three steps:
// every thread stores its levels s = |sc| x g into ebuf; one thread runs
// the peak follower over them in place (the chain alone: a compare and
// select, a subtraction and an FMA a sample, its loads independent of
// it); every thread turns its envelopes into the knee gain and
// multiplies it into g.  Returns the envelope' (thread 0's).
template <class Asc>
__device__ float alr_stage(const Args& a, float* g, float* ebuf, Asc asc,
                           float e) {
  const int tid = threadIdx.x, t_n = a.t_n, la = a.la;
  for (int i = tid; i < t_n; i += kThreads) {
    ebuf[i] = __fmul_rn(asc(i), g[la + i]);
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll 8
    for (int i = 0; i < t_n; ++i) {
      const float s = ebuf[i];
      e = __fmaf_rn(s > e ? a.tau_att : a.tau_rel, __fsub_rn(s, e), e);
      ebuf[i] = e;
    }
  }
  __syncthreads();
  for (int i = tid; i < t_n; i += kThreads) {
    const float ei = ebuf[i];
    const float m = fmaxf(ei, kTiny);
    float gg = 1.f;
    if (ei >= a.ke) {
      gg = __fdiv_rn(a.alr_gain, m);
    } else if (ei > a.ks) {
      gg = __fadd_rn(__fmaf_rn(a.h0, ei, a.h1), __fdiv_rn(a.h2, m));
    }
    g[la + i] = __fmul_rn(g[la + i], gg);
  }
  __syncthreads();
  return e;
}

// (value, index) of the larger; on ties the lower index.
__device__ __forceinline__ void keep_max(float& v, int& i, float ov,
                                         int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) limiter_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int t_n = a.t_n, la = a.la, l5 = 5 * la, w_n = t_n + l5;
  float* patch = smem;
  float* g = kSmem ? smem + a.p_n : a.scratch + (size_t)row * (w_n + t_n);
  float* asc_s = g + w_n;   // kSmem only
  // the ALR's envelopes: after |sc| in shared memory, after the row's
  // buffer in the scratch row
  float* ebuf = kSmem ? asc_s + t_n : g + w_n;
  const float* sc = a.sc + (size_t)row * t_n;

  for (int j = tid; j < a.p_n; j += kThreads) patch[j] = a.patch[j];
  for (int j = tid; j < l5; j += kThreads) g[j] = a.g_in[(size_t)row * l5 + j];
  for (int j = l5 + tid; j < w_n; j += kThreads) g[j] = 1.f;
  if (kSmem) {
    for (int j = tid; j < t_n; j += kThreads) asc_s[j] = fabsf(sc[j]);
  }
  __syncthreads();
  auto asc = [&](int i) { return kSmem ? asc_s[i] : fabsf(__ldg(sc + i)); };

  const float e = a.alr ? alr_stage(a, g, ebuf, asc, a.e_in[row])
                        : a.e_in[row];
  if (tid == 0) a.e_out[row] = e;

  float knee = 1.f;
  int iters = 0;
  while (iters < kMaxIters) {
    float best = -1.f;
    int bi = INT_MAX;
    for (int i = tid; i < t_n; i += kThreads) {
      const float v = __fmul_rn(asc(i), g[la + i]);
      if (v > best) {
        best = v;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      keep_max(best, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = bi;
    }
    __syncthreads();
    float s = red_v[0];
    int peak = red_i[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) keep_max(s, peak, red_v[k], red_i[k]);
    if (!(s > a.thr)) break;   // the same s in every thread
    const float k = __fdiv_rn(__fsub_rn(s, __fmaf_rn(a.thr, knee, -kKneeEps)),
                              fmaxf(s, kTiny));
    const int start = la + peak - a.middle;
    for (int j = tid; j < a.p_n; j += kThreads) {
      const int at = start + j;
      if (at >= 0 && at < w_n) {
        g[at] = __fmul_rn(g[at], __fmaf_rn(-k, patch[j], 1.f));
      }
    }
    ++iters;
    if (iters % kPeaksMax == 0) knee = __fmul_rn(knee, kGainLowering);
    __syncthreads();
  }

  // the clamp: a no-op unless the cap cut the loop short
  for (int i = tid; i < t_n; i += kThreads) {
    const float lvl = __fmul_rn(asc(i), g[la + i]);
    const float corr = fminf(1.f, __fdiv_rn(a.thr, fmaxf(lvl, kTiny)));
    g[la + i] = __fmul_rn(g[la + i], corr);
  }
  __syncthreads();
  float* gain = a.gain + (size_t)row * t_n;
  for (int i = tid; i < t_n; i += kThreads) gain[i] = g[i];
  for (int j = tid; j < l5; j += kThreads) {
    a.g_out[(size_t)row * l5 + j] = g[t_n + j];
  }
  if (tid == 0) a.passes[row] = iters;
}

}  // namespace

extern "C" {

// Dynamic shared memory of smem_kernel for these sizes, or 0 where they
// do not fit (global_kernel then runs, from a scratch row).
int lsp_limiter_smem_bytes(int t_n, int la, int p_n, int alr) {
  const size_t b = smem_bytes(t_n, la, p_n, alr);
  return b <= kMaxSmem ? (int)b : 0;
}

// One block per row.  scratch == nullptr takes smem_kernel; otherwise
// scratch holds rows x (2T + 5L) floats.  Returns a cudaError_t.
int lsp_limiter(const float* sc, const float* g_in, const float* e_in,
                const float* patch, float* gain, float* g_out, float* e_out,
                int* passes, float* scratch, int rows, int t_n, int la,
                int p_n, int middle, float thr, float ks, float ke,
                float alr_gain, float h0, float h1, float h2, float tau_att,
                float tau_rel, int alr, void* stream) {
  Args a{sc, g_in, e_in, patch, gain, g_out, e_out, passes, scratch,
         t_n, la, p_n, middle, alr,
         thr, ks, ke, alr_gain, h0, h1, h2, tau_att, tau_rel};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const size_t b = smem_bytes(t_n, la, p_n, alr);
    if (b > kMaxSmem) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        limiter_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)b);
    if (err != cudaSuccess) return (int)err;
    limiter_kernel<true><<<rows, kThreads, b, s>>>(a);
  } else {
    limiter_kernel<false><<<rows, kThreads, sizeof(float) * p_n, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
