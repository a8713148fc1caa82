// The adjoint of the sequential biquad cascade (csrc/biquad.cu): the
// backward of ops/biquad.py's biquad_cascade_seq / dyn_biquad_cascade_seq.
//
// The forward runs, for each sample t and each stage k in order,
//
//   yi = c0 u + s1;   s1 = (c1 u + c3 yi) + s2;   s2 = c2 u + c4 yi
//
// with u the stage's input (the stage before's yi).  Its transpose runs in
// reverse time, for each sample t and each stage k from the last, on the
// adjoints l1, l2 of s1, s2 (started from the cotangent of the outgoing
// state) and the cotangent g of the stage's output:
//
//   gy  = fma(c3, l1, fma(c4, l2, g))          the stage output's cotangent
//   g_u = fma(c0, gy, fma(c1, l1, c2 l2))      the stage input's, the next g
//   coefficient terms gy u, l1 u, l2 u, l1 yi, l2 yi   (l before the update)
//   (l1, l2) <- (gy, l1)
//
// and the incoming state's cotangent is (l1, l2) at the end.  Shared or
// per-row coefficients (static_kernel's form) take the sum of their terms
// over time, per row in float64 (bwd_kernel<false, true>), then over the
// rows in order by sums_kernel; per-sample coefficients take the terms of
// each sample (bwd_kernel<true, true>), summed over the rows only where
// the rows share them.  The coefficient terms need each stage's input and
// output: the forward's kSave form writes them, save [K + 1, rows, T].
//
// The recurrence rounds as FMAs, as XLA contracts the JAX scan's
// transpose: near a pole at z = 1 (the K-weighting's 38 Hz high-pass) it
// carries every rounding on, and with each product rounded on its own
// x's gradient sat 4.4 dB further from float64 than jax.grad's
// (tests/test_torch_grad_units.py); as FMAs it sits where JAX's does.
//
// Design: the forward's systolic warp, run backwards.  One warp per row,
// lane k runs stage k0 + kg - 1 - k of the launch's group of up to 32
// stages; at step j lane k works on the sample of reverse index j - k
// (t = T - 1 - (j - k)): lane 0 takes g from the cotangent row g_in, every
// other lane the g_u its left neighbour made a step before (one shuffle),
// and the last lane writes g_u.  Groups run last first, each one's g_u the
// next one's g_in.  The signals reach the lanes through a ring in shared
// memory: per tile of 32 steps the warp copies the next tile's 32 samples
// of the kg + 1 signals and of g_in by cp.async (one coalesced 128-byte
// load a row), and each lane reads its stage's two a step.  Per-sample
// coefficients come through a ring of registers kAhead steps ahead, as the
// forward's dyn_kernel takes them.
//
// What bounds it: the adjoint's recurrence within a stage, l1 ->
// fma(c3, l1, .) = the next l1, one dependent FMA a step (T x 1 x 4
// cycles; fma(c4, l2, g) is ready a step earlier).  Across the lanes each
// step also carries g_u -> shuffle -> two FMAs -> g_u.  The bytes (the
// K + 1 signals and the cotangents) are below it at the main path's K = 9.
//
// Every other product and sum rounds once (__fmul_rn, __fadd_rn), the
// FMAs as __fmaf_rn, in the plain PyTorch version's order (its FMAs
// through ops/env_units._mul_add); the float64 sums of the coefficient
// terms add in the same order (time, then rows), so the kernels and the
// plain version agree bit for bit.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;     // stages per launch, one lane each
constexpr int kTile = 32;      // steps per tile
constexpr int kRing = 128;     // samples held by each signal's ring
constexpr int kAhead = 16;     // per-sample coefficients, steps ahead
constexpr int kChainOps = 1;   // fma(c3, l1, .) a step
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRing % kTile == 0 && kRing >= 3 * kTile,
              "the ring holds the tile before, this one and the next");
static_assert(kTile % kAhead == 0, "ring slots repeat within a tile");

struct Args {
  const float* sig;    // save + k0 * rows * T: signal q of the group at q
  const float* g_in;   // [rows, T] cotangent of the group's output
  const float* c;      // coefficients, see row_stride / t_stride
  const float* gs_in;  // [rows, K, 2] cotangent of the outgoing state
  float* g_out;        // [rows, T] cotangent of the group's input
  float* gs_out;       // [rows, K, 2] cotangent of the incoming state
  double* part;        // static form: [rows, K, 5] per-row coefficient sums
  float* gc;           // per-sample form: [rows, T, K, 5] terms
  int t_n, k_n, k0, kg;
  long long row_stride, t_stride;   // in floats
};

// The ring's rows: signal q (0 .. kg) at q, g_in at kg + 1.
__device__ __forceinline__ float* ring_row(float* ring, int q) {
  return ring + q * kRing;
}

// Copy tile n's 32 samples (reverse indices 32 n + lane) of g_in and, with
// kCoef, of the kg + 1 signals into the ring, asynchronously.
template <bool kCoef>
__device__ __forceinline__ void fetch_tile(float* ring, const Args& a,
                                           int n) {
  const int ri = n * kTile + threadIdx.x;
  const int slot = ri & (kRing - 1);
  const int t = a.t_n - 1 - ri;
  const size_t r = blockIdx.x;
  const size_t plane = (size_t)gridDim.x * a.t_n;
  if (t < 0) return;
  __pipeline_memcpy_async(ring_row(ring, a.kg + 1) + slot,
                          a.g_in + r * a.t_n + t, sizeof(float));
  if (kCoef) {
    for (int q = 0; q <= a.kg; ++q)
      __pipeline_memcpy_async(ring_row(ring, q) + slot,
                              a.sig + q * plane + r * a.t_n + t,
                              sizeof(float));
  }
}

struct Lane {
  float l1, l2, g;
  float c0, c1, c2, c3, c4;
  double acc[5];
};

// This lane's stage coefficients at reverse index ri (left as they are
// outside [0, T) or for a lane without a stage).
__device__ __forceinline__ void fetch_c(float (&c)[5], const Args& a,
                                        const float* c_lane, int ri) {
  if ((int)threadIdx.x < a.kg && ri >= 0 && ri < a.t_n) {
    const float* p = c_lane + (size_t)(a.t_n - 1 - ri) * a.t_stride;
#pragma unroll
    for (int q = 0; q < 5; ++q) c[q] = __ldg(p + q);
  }
}

// The 32 steps of tile m.  kGuard: some lane's sample may lie outside [0,
// T).  The per-sample form runs an unguarded copy on the steady tiles, as
// the forward does; the static form one guarded body for every tile,
// which measured faster for it (PERF.md, the backward kernels).
template <bool kGuard, bool kDyn, bool kCoef>
__device__ __forceinline__ void bwd_tile(Lane& l, const Args& a, int m,
                                         const float* ring,
                                         float (&cring)[kAhead][5],
                                         const float* c_lane, int s) {
  const int lane = threadIdx.x;
  const bool live = lane < a.kg;
  const int q = a.kg - 1 - lane;   // the stage's input signal; output q + 1
  const size_t r = blockIdx.x;
  const float* g_ring = ring + (a.kg + 1) * kRing;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int j = m * kTile + i;
    const int ri = j - lane;   // this lane's reverse index
    const int t = a.t_n - 1 - ri;
    if (kDyn) {
      float(&c)[5] = cring[i % kAhead];
      l.c0 = c[0];
      l.c1 = c[1];
      l.c2 = c[2];
      l.c3 = c[3];
      l.c4 = c[4];
      fetch_c(c, a, c_lane, ri + kAhead);
    }
    const float up = __shfl_up_sync(kFull, l.g, 1);
    const float gin = lane == 0 ? g_ring[j & (kRing - 1)] : up;
    const bool in = live && (!kGuard || (ri >= 0 && ri < a.t_n));
    const float gy = __fmaf_rn(l.c3, l.l1, __fmaf_rn(l.c4, l.l2, gin));
    l.g = __fmaf_rn(l.c0, gy, __fmaf_rn(l.c1, l.l1, __fmul_rn(l.c2, l.l2)));
    if (in) {
      if (kCoef) {
        const int slot = ri & (kRing - 1);
        const float u = ring[q * kRing + slot];
        const float yo = ring[(q + 1) * kRing + slot];
        const float t0 = __fmul_rn(gy, u), t1 = __fmul_rn(l.l1, u),
                    t2 = __fmul_rn(l.l2, u), t3 = __fmul_rn(l.l1, yo),
                    t4 = __fmul_rn(l.l2, yo);
        if (kDyn) {
          float* o = a.gc + ((r * a.t_n + t) * a.k_n + s) * 5;
          o[0] = t0;
          o[1] = t1;
          o[2] = t2;
          o[3] = t3;
          o[4] = t4;
        } else {
          l.acc[0] = __dadd_rn(l.acc[0], (double)t0);
          l.acc[1] = __dadd_rn(l.acc[1], (double)t1);
          l.acc[2] = __dadd_rn(l.acc[2], (double)t2);
          l.acc[3] = __dadd_rn(l.acc[3], (double)t3);
          l.acc[4] = __dadd_rn(l.acc[4], (double)t4);
        }
      }
      l.l2 = l.l1;
      l.l1 = gy;
      if (lane == a.kg - 1) a.g_out[r * a.t_n + t] = l.g;
    }
  }
}

template <bool kDyn, bool kCoef>
__global__ void __launch_bounds__(kLanes) bwd_kernel(Args a) {
  extern __shared__ float ring[];   // [kg + 2][kRing]
  const int lane = threadIdx.x;
  const size_t r = blockIdx.x;
  const int s = a.k0 + a.kg - 1 - lane;   // this lane's stage
  const bool live = lane < a.kg;
  const float* c_lane = a.c + r * a.row_stride + (live ? s : 0) * 5;
  const size_t s_at = (r * a.k_n + (live ? s : 0)) * 2;

  Lane l{};
  if (live) {
    l.l1 = a.gs_in[s_at];
    l.l2 = a.gs_in[s_at + 1];
    if (!kDyn) {
      l.c0 = c_lane[0];
      l.c1 = c_lane[1];
      l.c2 = c_lane[2];
      l.c3 = c_lane[3];
      l.c4 = c_lane[4];
    }
  }
  float cring[kAhead][5] = {};
  if (kDyn) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) fetch_c(cring[k], a, c_lane, k - lane);
  }
  fetch_tile<kCoef>(ring, a, 0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  const int steps = a.t_n + a.kg - 1;
  const int tiles = (steps + kTile - 1) / kTile;
  for (int m = 0; m < tiles; ++m) {
    fetch_tile<kCoef>(ring, a, m + 1);
    __pipeline_commit();
    if (kDyn && m > 0 && m * kTile + kTile <= a.t_n)
      bwd_tile<false, kDyn, kCoef>(l, a, m, ring, cring, c_lane, s);
    else
      bwd_tile<true, kDyn, kCoef>(l, a, m, ring, cring, c_lane, s);
    __pipeline_wait_prior(0);
    __syncwarp();
  }
  if (live) {
    a.gs_out[s_at] = l.l1;
    a.gs_out[s_at + 1] = l.l2;
    if (kCoef && !kDyn) {
#pragma unroll
      for (int k = 0; k < 5; ++k) a.part[(r * a.k_n + s) * 5 + k] = l.acc[k];
    }
  }
}

// out[i] = sum over rows of p[row][i], in float64 row after row, rounded
// once to float32.
template <typename T>
__global__ void sums_kernel(const T* p, float* out, int rows, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double acc = (double)p[i];
  for (int r = 1; r < rows; ++r) acc = __dadd_rn(acc, (double)p[r * n + i]);
  out[i] = (float)acc;
}

template <typename T>
int launch_sums(const T* p, float* out, int rows, long long n,
                cudaStream_t s) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  sums_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      p, out, rows, n);
  return (int)cudaGetLastError();
}

template <bool kDyn, bool kCoef>
int launch(const Args& a, int rows, cudaStream_t s) {
  bwd_kernel<kDyn, kCoef>
      <<<rows, kLanes, (a.kg + 2) * kRing * sizeof(float), s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch: the adjoint of stages k0 .. k0 + kg - 1 (kg <= 32) of a
// K-stage cascade over rows x T samples.  save is the forward's [K + 1,
// rows, T] signals (unused without coef); part (static form) and gc
// (per-sample form) receive the coefficient terms when coef is set.
// Returns a cudaError_t.
int lsp_biquad_seq_bwd(const float* save, const float* g_in, const float* c,
                       const float* gs_in, float* g_out, float* gs_out,
                       double* part, float* gc, int rows, int t_n, int k_n,
                       int k0, int kg, long long row_stride,
                       long long t_stride, int dyn, int coef, void* stream) {
  if (kg < 1 || kg > kLanes || k0 < 0 || k0 + kg > k_n || rows < 1 ||
      t_n < 1 || (coef && save == nullptr) ||
      (coef && (dyn ? gc == nullptr : part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)rows * t_n;
  const Args a{coef ? save + k0 * plane : nullptr,
               g_in, c, gs_in, g_out, gs_out, part, gc, t_n, k_n, k0, kg,
               row_stride, t_stride};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dyn) return coef ? launch<true, true>(a, rows, s)
                       : launch<true, false>(a, rows, s);
  return coef ? launch<false, true>(a, rows, s)
              : launch<false, false>(a, rows, s);
}

// Sums over rows in order: out [n] = sum_r p [rows, n], float64 partials
// (the static form's) or float32 terms (the per-sample form's).
int lsp_biquad_seq_bwd_sums(const void* p, float* out, int rows, long long n,
                            int f64, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return f64 ? launch_sums((const double*)p, out, rows, n, s)
             : launch_sums((const float*)p, out, rows, n, s);
}

int lsp_biquad_seq_bwd_chain_ops() { return kChainOps; }

}  // extern "C"
