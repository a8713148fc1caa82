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
// Design: the recurrence alone on a chain lane, everything else off it.
// Write G for the sequence of a stage's gy in reverse time, i = T - 1 - t,
// with G[-1], G[-2] the cotangent of the outgoing state (l1, l2); then at
// step i l1 = G[i - 1], l2 = G[i - 2], the stage's recurrence is
//
//   G[i] = fma(c3, G[i - 1], fma(c4, G[i - 2], g[i]))
//
// and g_u[i] = fma(c0, G[i], fma(c1, G[i - 1], c2 G[i - 2])) and the five
// terms are maps of G and the saved signals.  One block a row, the
// launch's group of up to 32 stages pipelined over chunks of kChunk
// steps, one block barrier a slot:
//
// * warp 0, the chain: lane k runs stage k0 + kg - 1 - k; at slot s it
//   runs chunk s - 2k, reading each step's g (and, per sample, c3 and c4)
//   from shared memory kBatch steps at a time into registers (16-byte
//   loads, the next batch's issued before this one runs), writing each G
//   into the stage's record (which starts with the chunk's incoming l2,
//   l1) as 16-byte stores: two FMAs a step, one on the carried path;
// * the map warps: at slot s, first the cp.async copies of slot s + 1's
//   inputs (lane 0's chunk of g_in, each lane's two signals, its input u
//   and output yo, of the chunk it runs at slot s, and per sample its
//   (c3, c4) of the chunk it runs at slot s + 1); then, for each stage,
//   the chunk its lane ran in slot s - 1: g_u from the record into the g
//   of the next lane (which runs that chunk at slot s + 1) or, for the
//   group's first stage, into g_out, four steps a thread (per sample,
//   consecutive threads on consecutive steps, with the five terms into
//   gc);
// * the sum warps (coefficients shared or per row): a thread per (stage,
//   coefficient) adds that stage's terms of the chunk into its float64
//   sum in reverse time, one accumulator each, from shared memory
//   kBatch steps at a time through registers.
//
// Each of a lane's buffers holds two chunks (by the chunk's parity), the
// lanes' rows spread over the banks so that one step's 32 lanes meet no
// conflict.
//
// What bounds it: the recurrence within a stage, G[i - 1] -> fma(c3,
// G[i - 1], .), one dependent FMA a step (T x 1 x 4 cycles; fma(c4, G[i -
// 2], g) is ready before it), plus 2 (kg - 1) chunks of pipeline fill; with
// the coefficients' sums, each sum's dependent float64 adds, one a step,
// which take longer (PERF.md, PR 23); per sample, the coefficients' and
// terms' records K x 5 floats apart a step, a 32-byte sector each.  The
// bytes (the K + 1 signals and the cotangents) are below the chain at the
// main path's K = 9.
//
// Every other product and sum rounds once (__fmul_rn, __fadd_rn), the
// FMAs as __fmaf_rn, in the plain PyTorch version's order (its FMAs
// through ops/env_units._mul_add); the float64 sums of the coefficient
// terms add in the same order (time, then rows), so the kernels and the
// plain version agree bit for bit.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;      // stages per launch, one chain lane each
constexpr int kChunk = 128;     // steps a slot
constexpr int kBatch = 16;      // the chain's steps a register batch
constexpr int kWarps = 8;       // the chain, then the sum and map warps
constexpr int kThreads = 32 * kWarps;
// a lane's rows: two chunks each, as 16-byte words, the lanes' rows
// spread over the banks so that a step's 32 lanes (16-byte accesses: 8
// at a time) meet no conflict
constexpr int kGStride = 2 * kChunk + 4;          // g, u, yo (floats)
constexpr int kRec = kChunk + 4;                  // a record: 2 free, l2,
constexpr int kRecStride = 2 * kRec + 4;          // l1, then each gy
constexpr int kCStride = 2 * kChunk + 2;          // (c3, c4) (float2)
constexpr int kChainOps = 1;    // fma(c3, l1, .) a step

static_assert(kGStride % 32 == 4 && kRecStride % 32 == 12 &&
                  (2 * kCStride) % 32 == 4,
              "a step's lanes on distinct banks");
static_assert(kChunk % kBatch == 0 && kBatch % 4 == 0,
              "whole 16-byte batches in a whole chunk");

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

// A block's shared memory, each array [kg][stride]: per sample the (c3,
// c4) pairs (float2, first for their alignment), the records, the g, with
// the coefficients' gradient the two signals; the static coefficients
// [kg][5] last.
struct Smem {
  float2* c34;
  float *rec, *g, *u, *yo, *cst;
};

__host__ __device__ constexpr int smem_floats(bool dyn, bool coef, int kg) {
  return kg * ((dyn ? 2 * kCStride : 0) + kRecStride + kGStride +
               (coef ? 2 * kGStride : 0) + 5);
}

template <bool kDyn, bool kCoef>
__device__ __forceinline__ Smem smem_of(float* base, int kg) {
  Smem m;
  m.c34 = reinterpret_cast<float2*>(base);
  m.rec = base + (kDyn ? 2 * kg * kCStride : 0);
  m.g = m.rec + kg * kRecStride;
  m.u = m.g + kg * kGStride;
  m.yo = m.u + (kCoef ? kg * kGStride : 0);
  m.cst = m.yo + (kCoef ? kg * kGStride : 0);
  return m;
}

// lane k's record of chunk n, from its l2: [0] l2, [1] l1, [2 + i] gy_i
__device__ __forceinline__ float* record(const Smem& m, int k, int n) {
  return m.rec + k * kRecStride + (n & 1) * kRec + 2;
}

// steps of chunk n (reverse indices n kChunk ..)
__device__ __forceinline__ int chunk_len(const Args& a, int n) {
  return min(kChunk, a.t_n - n * kChunk);
}

// stage k0 + kg - 1 - k's coefficients at time t (any t without kDyn)
template <bool kDyn>
__device__ __forceinline__ const float* coefs(const Args& a, int k, int t) {
  return a.c + blockIdx.x * a.row_stride + (a.k0 + a.kg - 1 - k) * 5 +
         (kDyn ? (size_t)t * a.t_stride : 0);
}

// kBatch steps of the chain from registers
template <bool kDyn>
__device__ __forceinline__ void chain_batch(float& l1, float& l2, float c3,
                                            float c4, const float (&gv)[kBatch],
                                            const float2 (&cv)[kBatch],
                                            float (&out)[kBatch]) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const float gy = __fmaf_rn(kDyn ? cv[i].x : c3, l1,
                               __fmaf_rn(kDyn ? cv[i].y : c4, l2, gv[i]));
    out[i] = gy;
    l2 = l1;
    l1 = gy;
  }
}

// a whole batch's g and (c3, c4) as 16-byte loads
template <bool kDyn>
__device__ __forceinline__ void chain_load(float (&gv)[kBatch],
                                           float2 (&cv)[kBatch],
                                           const float* g, const float2* cc) {
#pragma unroll
  for (int q = 0; q < kBatch / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(g)[q];
    gv[4 * q] = v.x;
    gv[4 * q + 1] = v.y;
    gv[4 * q + 2] = v.z;
    gv[4 * q + 3] = v.w;
  }
  if (kDyn) {
#pragma unroll
    for (int q = 0; q < kBatch / 2; ++q) {
      const float4 v = reinterpret_cast<const float4*>(cc)[q];
      cv[2 * q] = make_float2(v.x, v.y);
      cv[2 * q + 1] = make_float2(v.z, v.w);
    }
  }
}

// The chain lane's chunk from its carried (l1, l2) into its record: a
// whole chunk kBatch steps at a time through registers (each batch's
// loads issued before the batch before it runs, its gy stored as 16-byte
// words), a partial one step by step.
template <bool kDyn>
__device__ __forceinline__ void chain_chunk(float& l1, float& l2, float c3,
                                            float c4, const float* g,
                                            const float2* cc, float* rec,
                                            int len) {
  rec[0] = l2;
  rec[1] = l1;
  float* out = rec + 2;
  if (len < kChunk) {
    for (int i = 0; i < len; ++i) {
      const float gy = __fmaf_rn(kDyn ? cc[i].x : c3, l1,
                                 __fmaf_rn(kDyn ? cc[i].y : c4, l2, g[i]));
      out[i] = gy;
      l2 = l1;
      l1 = gy;
    }
    return;
  }
  float gv[kBatch], gn[kBatch], ov[kBatch];
  float2 cv[kBatch], cn[kBatch];
  chain_load<kDyn>(gv, cv, g, cc);
#pragma unroll
  for (int b = 0; b < kChunk; b += kBatch) {
    if (b + kBatch < kChunk)
      chain_load<kDyn>(gn, cn, g + b + kBatch, cc + b + kBatch);
    chain_batch<kDyn>(l1, l2, c3, c4, gv, cv, ov);
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q)
      reinterpret_cast<float4*>(out + b)[q] =
          make_float4(ov[4 * q], ov[4 * q + 1], ov[4 * q + 2], ov[4 * q + 3]);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      gv[i] = gn[i];
      cv[i] = cn[i];
    }
  }
}

// The per-sample form's g_u and terms of the chunks the lanes ran in slot
// s - 1: consecutive threads on consecutive steps (the coefficients'
// records and the terms' lie K x 5 floats apart a step), four steps a
// thread at a time, their loads first.
template <bool kCoef>
__device__ __forceinline__ void map_steps(const Args& a, int s, int nch,
                                          const Smem& m, int tid, int n_thr) {
  const size_t r = blockIdx.x;
  constexpr int kItems = 4;
  for (int base = tid; base < a.kg * kChunk; base += kItems * n_thr) {
    float c0[kItems], c1[kItems], c2[kItems], l2[kItems], l1[kItems],
        gy[kItems], u[kItems], yo[kItems];
    bool on[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int it = base + q * n_thr;
      const int k = it / kChunk, i = it % kChunk, n = s - 1 - 2 * k;
      on[q] = it < a.kg * kChunk && n >= 0 && n < nch && i < chunk_len(a, n);
      if (!on[q]) continue;
      const float* c = coefs<true>(a, k, a.t_n - 1 - (n * kChunk + i));
      c0[q] = __ldg(c);
      c1[q] = __ldg(c + 1);
      c2[q] = __ldg(c + 2);
      const float* rc = record(m, k, n) + i;
      l2[q] = rc[0];
      l1[q] = rc[1];
      gy[q] = rc[2];
      if (kCoef) {
        const int at = k * kGStride + (n & 1) * kChunk + i;
        u[q] = m.u[at];
        yo[q] = m.yo[at];
      }
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (!on[q]) continue;
      const int it = base + q * n_thr;
      const int k = it / kChunk, i = it % kChunk, n = s - 1 - 2 * k;
      const int t = a.t_n - 1 - (n * kChunk + i);
      const float gu = __fmaf_rn(c0[q], gy[q],
                                 __fmaf_rn(c1[q], l1[q],
                                           __fmul_rn(c2[q], l2[q])));
      if (k + 1 < a.kg)
        m.g[(k + 1) * kGStride + (n & 1) * kChunk + i] = gu;
      else
        a.g_out[r * a.t_n + t] = gu;
      if (kCoef) {
        float* o = a.gc + ((r * a.t_n + t) * a.k_n + a.k0 + a.kg - 1 - k) * 5;
        o[0] = __fmul_rn(gy[q], u[q]);
        o[1] = __fmul_rn(l1[q], u[q]);
        o[2] = __fmul_rn(l2[q], u[q]);
        o[3] = __fmul_rn(l1[q], yo[q]);
        o[4] = __fmul_rn(l2[q], yo[q]);
      }
    }
  }
}

// The map warps' share of slot s: the copies of slot s + 1's inputs; g_u
// and the per-sample terms of the chunks the lanes ran in slot s - 1.
template <bool kDyn, bool kCoef>
__device__ __forceinline__ void map_slot(const Args& a, int s, int nch,
                                         const Smem& m, int tid, int n_thr) {
  const size_t r = blockIdx.x;
  const size_t plane = (size_t)gridDim.x * a.t_n;
  // first the copies of slot s + 1's inputs, to land while the rest runs:
  // lane 0's g; each lane's signals of chunk s - 2k; per sample each
  // lane's (c3, c4) of chunk s + 1 - 2k
  const int n0 = s + 1;
  if (n0 < nch)
    for (int i = tid; i < chunk_len(a, n0); i += n_thr)
      __pipeline_memcpy_async(
          m.g + (n0 & 1) * kChunk + i,
          a.g_in + r * a.t_n + a.t_n - 1 - (n0 * kChunk + i), sizeof(float));
  for (int it = tid; it < a.kg * kChunk; it += n_thr) {
    const int k = it / kChunk, i = it % kChunk;
    if (kCoef) {
      const int n = s - 2 * k;
      if (n >= 0 && n < nch && i < chunk_len(a, n)) {
        const int q = a.kg - 1 - k;   // the stage's input signal
        const float* src = a.sig + q * plane + r * a.t_n + a.t_n - 1 -
                           (n * kChunk + i);
        const int at = k * kGStride + (n & 1) * kChunk + i;
        __pipeline_memcpy_async(m.u + at, src, sizeof(float));
        __pipeline_memcpy_async(m.yo + at, src + plane, sizeof(float));
      }
    }
    if (kDyn) {
      const int n = s + 1 - 2 * k;
      if (n >= 0 && n < nch && i < chunk_len(a, n)) {
        const float* c = coefs<true>(a, k, a.t_n - 1 - (n * kChunk + i));
        float2* d = m.c34 + k * kCStride + (n & 1) * kChunk + i;
        __pipeline_memcpy_async(&d->x, c + 3, sizeof(float));
        __pipeline_memcpy_async(&d->y, c + 4, sizeof(float));
      }
    }
  }
  __pipeline_commit();
  if (kDyn) {
    map_steps<kCoef>(a, s, nch, m, tid, n_thr);
    return;
  }
  // g_u by quads: four steps of one lane a thread, every load of a quad
  // before its stores
  constexpr int kQuads = kChunk / 4;
  for (int it = tid; it < a.kg * kQuads; it += n_thr) {
    const int k = it / kQuads, i0 = 4 * (it % kQuads), n = s - 1 - 2 * k;
    if (n < 0 || n >= nch) continue;
    const int len = min(4, chunk_len(a, n) - i0);
    if (len <= 0) continue;
    // rb[i0 + q] = l2, rb[i0 + q + 1] = l1, rb[i0 + q + 2] = gy of step
    // i0 + q (8-byte words: the record's rb and i0 are even)
    const float2* rb = reinterpret_cast<const float2*>(record(m, k, n) + i0);
    float v[6];
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const float2 p = rb[w];
      v[2 * w] = p.x;
      v[2 * w + 1] = p.y;
    }
    const float c0 = m.cst[k * 5], c1 = m.cst[k * 5 + 1],
                c2 = m.cst[k * 5 + 2];
    float gu[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gu[q] = __fmaf_rn(c0, v[q + 2], __fmaf_rn(c1, v[q + 1],
                                                __fmul_rn(c2, v[q])));
    const int at = (k + 1) * kGStride + (n & 1) * kChunk + i0;
    const int t0 = a.t_n - 1 - (n * kChunk + i0);
    if (k + 1 < a.kg && len == 4) {
      *reinterpret_cast<float4*>(m.g + at) =
          make_float4(gu[0], gu[1], gu[2], gu[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < len) {
          if (k + 1 < a.kg)
            m.g[at + q] = gu[q];
          else
            a.g_out[r * a.t_n + t0 - q] = gu[q];
        }
    }
  }
}

// A sum thread's share of slot s: (stage k0 + kg - 1 - k, coefficient j)
// over the chunk its lane ran in slot s - 1, in reverse time.
__device__ __forceinline__ void sum_slot(const Args& a, int s, int nch,
                                         const Smem& m, int k, int j,
                                         double& acc) {
  const int n = s - 1 - 2 * k;
  if (n < 0 || n >= nch) return;
  // gy u, l1 u, l2 u, l1 yo, l2 yo: the record's offset and the signal
  const int off = j == 0 ? 2 : (j == 1 || j == 3) ? 1 : 0;
  const float* sv = (j < 3 ? m.u : m.yo) + k * kGStride + (n & 1) * kChunk;
  const float* rc = record(m, k, n) + off;
  const int len = chunk_len(a, n);
  if (len < kChunk) {
    for (int i = 0; i < len; ++i)
      acc = __dadd_rn(acc, (double)__fmul_rn(rc[i], sv[i]));
    return;
  }
  // a whole chunk kBatch steps at a time through registers, each batch's
  // loads issued before the batch before it is added
  float rv[kBatch], xv[kBatch], rn[kBatch], xn[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    rv[i] = rc[i];
    xv[i] = sv[i];
  }
#pragma unroll
  for (int b = 0; b < kChunk; b += kBatch) {
    if (b + kBatch < kChunk) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        rn[i] = rc[b + kBatch + i];
        xn[i] = sv[b + kBatch + i];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      acc = __dadd_rn(acc, (double)__fmul_rn(rv[i], xv[i]));
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      rv[i] = rn[i];
      xv[i] = xn[i];
    }
  }
}

template <bool kDyn, bool kCoef>
__global__ void __launch_bounds__(kThreads) bwd_kernel(Args a) {
  extern __shared__ float smem[];
  const Smem m = smem_of<kDyn, kCoef>(smem, a.kg);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t r = blockIdx.x;
  const int nch = (a.t_n + kChunk - 1) / kChunk;
  const int sum_warps = kCoef && !kDyn ? (a.kg * 5 + 31) / 32 : 0;
  const int map_tid = threadIdx.x - 32 * (1 + sum_warps);
  const int map_thr = kThreads - 32 * (1 + sum_warps);

  // the chain lane's stage and state
  const bool live = warp == 0 && lane < a.kg;
  const size_t s_at = (r * a.k_n + a.k0 + a.kg - 1 - (live ? lane : 0)) * 2;
  float l1 = 0.f, l2 = 0.f, c3 = 0.f, c4 = 0.f;
  if (live) {
    l1 = a.gs_in[s_at];
    l2 = a.gs_in[s_at + 1];
    if (!kDyn) {
      const float* c = coefs<false>(a, lane, 0);
      c3 = c[3];
      c4 = c[4];
    }
  }
  if (!kDyn)
    for (int i = threadIdx.x; i < a.kg * 5; i += kThreads)
      m.cst[i] = coefs<false>(a, i / 5, 0)[i % 5];
  // the sum thread's (stage, coefficient)
  const int sk = (threadIdx.x - 32) / 5, sj = (threadIdx.x - 32) % 5;
  const bool summing = warp >= 1 && warp <= sum_warps && sk < a.kg;
  double acc = 0.0;

  if (map_tid >= 0) {
    map_slot<kDyn, kCoef>(a, -1, nch, m, map_tid, map_thr);
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  const int slots = nch + 2 * (a.kg - 1) + 1;
  for (int s = 0; s < slots; ++s) {
    if (warp == 0) {
      const int n = s - 2 * lane;
      if (live && n >= 0 && n < nch) {
        chain_chunk<kDyn>(l1, l2, c3, c4,
                          m.g + lane * kGStride + (n & 1) * kChunk,
                          m.c34 + lane * kCStride + (n & 1) * kChunk,
                          record(m, lane, n), chunk_len(a, n));
      }
    } else if (summing) {
      sum_slot(a, s, nch, m, sk, sj, acc);
    } else if (map_tid >= 0) {
      map_slot<kDyn, kCoef>(a, s, nch, m, map_tid, map_thr);
      __pipeline_wait_prior(0);
    }
    __syncthreads();
  }
  if (live) {
    a.gs_out[s_at] = l1;
    a.gs_out[s_at + 1] = l2;
  }
  if (summing)
    a.part[(r * a.k_n + a.k0 + a.kg - 1 - sk) * 5 + sj] = acc;
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
  const int bytes = smem_floats(kDyn, kCoef, a.kg) * (int)sizeof(float);
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_kernel<kDyn, kCoef>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(kDyn, kCoef, kLanes) * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  bwd_kernel<kDyn, kCoef><<<rows, kThreads, bytes, s>>>(a);
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
