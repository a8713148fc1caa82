// Fused dynamics tail, one thread block per channel: sidechain sliding
// RMS over a carried window -> peak-hold envelope with release threshold
// -> two-knee compressor gain -> y = x * gain.
//
// Replaces the TPU kernel ops/pallas_env.py::chain_dyn_pallas of the JAX
// package (_chain_dyn_kernel, _accum_skip, _env_step).
//
// What bounds it: the envelope.  It is a nonlinear recurrence, serial in
// time within a channel, so the main path's 64 channels give 64 serial
// chains of T = 8192 dependent steps, one per SM, while HBM traffic is
// only ~4 MB per block: the time is T times the latency of one step.
// Two things keep that short:
//
// * Where the envelope cannot hold (hold 0, a hold time of 0 samples,
//   peak == e and release no faster than attack: always, from env_init,
//   on the main path's compressor) the step is sub -> fma -> min -> max
//   (free_step, ~20 cycles): no compare feeds a select on the envelope's
//   path, since a predicate takes ~13 cycles to reach its select on this
//   card.  Elsewhere env_step, the reference step with each update
//   rounded once.  The values are the reference step's, bit for bit, for
//   finite levels.  More lanes per channel (splitting it in time) is
//   what would shorten it further.
// * Nothing else waits on, or is waited on by, the chain thread except
//   once per chunk of kChunk samples.  The block is a pipeline of warp
//   roles over the channel's chunks: producer warps compute the squares,
//   the rolling sum and the level of chunk k+1 (and the carried window);
//   one thread, alone in warp 0, runs the envelope over chunk k in
//   registers, 32 levels at a time with vector loads from shared memory;
//   consumer warps (polling with a back-off) compute the knee gain
//   and y = x * gain of chunk k-1 and write y coalesced.  The hand-offs
//   are one mbarrier per chunk and direction (level ready, envelope
//   ready), each completing once, so there is no block-wide barrier
//   after the set-up.
//
// The rolling sum runs in float64 (rsum[t] = the window's sum + a scan of
// per-sample (new - old) squares; the carry passes from chunk to chunk),
// rounded to float32 before the float32 scale by 1/N, so that where the
// sums are exact in float32 the levels are those of a float32 scan.
// Against the plain version's float32 two-level prefix differences it is
// a rounding difference only (see ops/env.py).
//
// Under autograd chain_dyn_save_kernel runs the same body and also writes
// the level and the envelope (chain_dyn_kernel's instantiation is
// unchanged); chain_dyn_bwd, below, is the backward, from those.

#include <cuda_runtime.h>

#include <cstdint>

#include "env_bwd.cuh"

// Passed by value from ops/env.py (ctypes structures of the same layout).
struct LspKnee {
  float start, end, gain, tilt0, tilt1, herm0, herm1, herm2;
};

struct LspDynParams {
  float g;          // sidechain gain
  float ta, tr, rt; // attack / release taus, release threshold
  float inv_n;      // 1 / window length
  int nh;           // hold samples
  LspKnee k0, k1;
};

namespace {

constexpr int kChunk = 256;                    // samples per pipeline stage
constexpr int kMaxChunks = 128;                // T <= 32768
// Warps w with w % 4 == 0 share warp 0's scheduler: warp 0 runs the
// chain, warps 4 and 8 leave at once, so no other warp takes the chain's
// dispatch slots.  The others, in order, are 4 producer and 4 consumer
// warps.
constexpr int kProducers = 128;                // warps 1, 2, 3, 5
constexpr int kConsumers = 128;                // warps 6, 7, 9, 10
constexpr int kThreads = 11 * 32;
constexpr int kProdWarps = kProducers / 32;
constexpr int kItems = kChunk / kProducers;    // scan items per producer
constexpr int kBatch = 32;                     // envelope levels in registers
constexpr int kProdBar = 1;                    // named barrier of producers
constexpr int kConsumerSleepNs = 256;          // a chunk takes ~2-3 us

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// release: the caller's shared-memory writes are visible to the waiters
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// acquire: until the barrier's first phase completes (each completes
// once).  kSleepNs > 0 backs off between polls, for waiters whose polling
// would take dispatch slots from the chain thread.
template <int kSleepNs = 0>
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    if (kSleepNs > 0) __nanosleep(kSleepNs);
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  }
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "r"(kProdBar), "r"(kProducers)
               : "memory");
}

__device__ __forceinline__ float knee_gain(const LspKnee& k, float ax,
                                           float lx) {
  if (ax <= k.start) return k.gain;
  if (ax >= k.end) return expf(lx * k.tilt0 + k.tilt1);
  return expf((k.herm0 * lx + k.herm1) * lx + k.herm2);
}

struct EnvRegs {
  float e, peak;
  int hold;
};

// One peak-hold envelope step (reference Compressor.cpp:231-256), falling
// below the release threshold with the attack tau, as the TPU kernel's
// _env_step with use_rt.  Returns the new envelope.  Each update is one
// rounding (__fmaf_rn), as in the plain version.
__device__ __forceinline__ float env_step(float x, EnvRegs& s,
                                          const LspDynParams& p) {
  const float e = s.e;
  const float d = __fsub_rn(x, e);
  const bool falling = d < 0.0f;
  const bool holding = s.hold > 0;
  const float tau_dn = e > p.rt ? p.tr : p.ta;
  const float e_fall = __fmaf_rn(tau_dn, d, e);
  const float e_rise = __fmaf_rn(p.ta, d, e);
  const bool rise_peaked = !falling && e_rise >= s.peak;
  const float new_e = falling ? (holding ? e : e_fall) : e_rise;
  s.peak = falling ? (holding ? s.peak : e_fall)
                   : (rise_peaked ? e_rise : s.peak);
  s.hold = falling ? (holding ? s.hold - 1 : s.hold)
                   : (rise_peaked ? p.nh : s.hold);
  s.e = new_e;
  return new_e;
}

// The same step where it cannot hold: peak == e, hold == 0 and nh == 0
// (the chain starts there from env_init with a hold of 0 samples, and
// stays there).  A step that does not fall then rises to e_rise >= e =
// peak, so peak follows the envelope, the hold stays 0, and the step is
// e' = falling && e > rt ? e_rel : e_rise.  With tr <= ta (release no
// faster than attack) that is max(e_rise, min(e_rel, b)), b = +inf above
// the threshold and -inf otherwise: where d < 0, e_rel >= e_rise, and
// where d >= 0, e_rise >= e_rel, each FMA rounding monotonically in its
// tau.  So the envelope's path is sub -> fma -> min -> max, with no
// predicate on it (a compare feeding a select costs ~13 cycles on this
// card).  Bit for bit the reference step for finite levels.
__device__ __forceinline__ float free_step(float x, float& e,
                                           const LspDynParams& p,
                                           uint32_t inf_bits) {
  const float d = __fsub_rn(x, e);
  const float u = __fsub_rn(p.rt, e);          // < 0 (sign set): e > rt
  // b = (~u & 0x80000000) | 0x7f800000 in one lop3
  uint32_t bb;
  asm("lop3.b32 %0, %1, 0x80000000, %2, 0xae;"
      : "=r"(bb) : "r"(__float_as_uint(u)), "r"(inf_bits));
  const float b = __uint_as_float(bb);
  const float e_rise = __fmaf_rn(p.ta, d, e);
  const float e_rel = __fmaf_rn(p.tr, d, e);
  e = fmaxf(e_rise, fminf(e_rel, b));
  return e;
}

// Producers: squares (and the carried window) then the level of each
// chunk in order; each warp arrives once on full[k] when its share of
// chunk k's levels is in lev.
// One barrier per chunk: iteration k scans chunk k (its squares stored in
// iteration k-1), stores chunk k+1's squares from x loaded at the start
// of the iteration, and syncs once before combining the warp totals.
template <bool kSave>
__device__ __forceinline__ void produce(
    const float* __restrict__ xr, const float* __restrict__ wr,
    float* __restrict__ wo, float* lev, float* sq, uint64_t* full,
    double (*s_tot)[kProdWarps], double* s_win, int t_n, int n_win,
    const LspDynParams& p, int q, float* __restrict__ lev_save) {
  const int lane = q & 31;
  const int pw = q >> 5;
  const int n_chunks = (t_n + kChunk - 1) / kChunk;
  // squares of chunk k from x loaded into xv (strided, coalesced)
  auto load = [&](int k, float (&xv)[kItems]) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int t = k * kChunk + q + j * kProducers;
      xv[j] = (k < n_chunks && t < t_n) ? xr[t] : 0.0f;
    }
  };
  auto store_sq = [&](int k, const float (&xv)[kItems]) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int t = k * kChunk + q + j * kProducers;
      if (k < n_chunks && t < t_n) {
        const float v = __fmul_rn(fabsf(xv[j]), p.g);
        const float s = __fmul_rn(v, v);
        sq[t] = s;
        if (t >= t_n - n_win) wo[t - (t_n - n_win)] = s;
      }
    }
  };

  float xv[kItems];
  load(0, xv);
  // rolling sum at t = -1: the sum of the carried window
  double part = 0.0;
  for (int i = q; i < n_win; i += kProducers) part += (double)wr[i];
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) s_win[pw] = part;
  store_sq(0, xv);
  producers_sync();
  double carry = 0.0;
  for (int w = 0; w < kProdWarps; ++w) carry += s_win[w];

  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, t_n - t0);
    load(k + 1, xv);
    // contiguous items per thread, then a scan across the producers
    double pre[kItems];
    double run = 0.0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int t = t0 + q * kItems + j;
      if (t < t0 + len) {
        const float old = t < n_win ? wr[t] : sq[t - n_win];
        run += (double)sq[t] - (double)old;
      }
      pre[j] = run;
    }
    double incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_tot[k & 1][pw] = incl;
    store_sq(k + 1, xv);
    producers_sync();
    double base = carry;
    double tot = 0.0;
    for (int w = 0; w < kProdWarps; ++w) {
      const double v = s_tot[k & 1][w];
      if (w < pw) base += v;
      tot += v;
    }
    base += incl - run;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int t = t0 + q * kItems + j;
      if (t < t0 + len) {
        lev[t] = sqrtf(fmaxf((float)(base + pre[j]) * p.inv_n, 0.0f));
        if (kSave) lev_save[t] = lev[t];
      }
    }
    carry += tot;
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[k]);
  }
}

// The chain thread: the envelope over each chunk in place in lev,
// arriving on done[k] when chunk k's envelopes are there.  A batch of
// kBatch steps that starts where the envelope cannot hold runs free_step
// (and ends with peak == e); any other runs env_step.  Neither has a
// branch inside.
__device__ __forceinline__ void run_chain(float* lev, uint64_t* full,
                                          uint64_t* done, int t_n,
                                          EnvRegs& s, const LspDynParams& p) {
  const int n_chunks = (t_n + kChunk - 1) / kChunk;
  const bool free = p.nh == 0 && p.tr <= p.ta;
  uint32_t inf_bits;                 // 0x7f800000, kept in a register
  asm volatile("mov.b32 %0, 0x7f800000;" : "=r"(inf_bits));
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, t_n - t0);
    const int whole = len - len % kBatch;
    float4* l4 = reinterpret_cast<float4*>(lev + t0);   // 16-byte aligned
    mbar_wait(&full[k]);
    for (int b = 0; b < whole; b += kBatch) {
      float4* b4 = l4 + b / 4;
      float4 cur[kBatch / 4];
#pragma unroll
      for (int j = 0; j < kBatch / 4; ++j) cur[j] = b4[j];
      if (free && s.e == s.peak && s.hold == 0) {
#pragma unroll
        for (int j = 0; j < kBatch / 4; ++j) {
          cur[j].x = free_step(cur[j].x, s.e, p, inf_bits);
          cur[j].y = free_step(cur[j].y, s.e, p, inf_bits);
          cur[j].z = free_step(cur[j].z, s.e, p, inf_bits);
          cur[j].w = free_step(cur[j].w, s.e, p, inf_bits);
        }
        s.peak = s.e;
      } else {
#pragma unroll
        for (int j = 0; j < kBatch / 4; ++j) {
          cur[j].x = env_step(cur[j].x, s, p);
          cur[j].y = env_step(cur[j].y, s, p);
          cur[j].z = env_step(cur[j].z, s, p);
          cur[j].w = env_step(cur[j].w, s, p);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch / 4; ++j) b4[j] = cur[j];
    }
    for (int t = t0 + whole; t < t0 + len; ++t)
      lev[t] = env_step(lev[t], s, p);
    mbar_arrive(&done[k]);
  }
}

// Consumers: y = x * gain(envelope) for each chunk once its envelopes are
// in (and, kSave, the envelope to env_save).
template <bool kSave>
__device__ __forceinline__ void consume(const float* __restrict__ xr,
                                        float* __restrict__ yr,
                                        const float* lev, uint64_t* done,
                                        int t_n, const LspDynParams& p,
                                        int q, float* __restrict__ env_save) {
  const int n_chunks = (t_n + kChunk - 1) / kChunk;
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, t_n - t0);
    mbar_wait<kConsumerSleepNs>(&done[k]);
    for (int i = q; i < len; i += kConsumers) {
      const int t = t0 + i;
      if (kSave) env_save[t] = lev[t];
      const float ax = fabsf(lev[t]);
      const float lx = logf(fmaxf(ax, 1e-36f));
      yr[t] = xr[t] * (knee_gain(p.k0, ax, lx) * knee_gain(p.k1, ax, lx));
    }
  }
}

// The forward's body; kSave: the level and the envelope also go to
// level_save and env_save (producers and consumers write them, off the
// chain), for the backward under autograd.
template <bool kSave>
__device__ __forceinline__ void chain_dyn_body(
    const float* __restrict__ x, const float* __restrict__ win,
    const float* __restrict__ env_in, const float* __restrict__ peak_in,
    const int* __restrict__ hold_in, float* __restrict__ y,
    float* __restrict__ win_out, float* __restrict__ env_out,
    float* __restrict__ peak_out, int* __restrict__ hold_out,
    float* __restrict__ level_save, float* __restrict__ env_save, int t_n,
    int n_win, const LspDynParams& p) {
  extern __shared__ __align__(16) float smem[];
  float* lev = smem;                   // [t_n]: level -> envelope
  float* sq = smem + t_n;              // [t_n]: squared detector samples
  __shared__ __align__(8) uint64_t full[kMaxChunks];
  __shared__ __align__(8) uint64_t done[kMaxChunks];
  __shared__ double s_tot[2][kProdWarps];
  __shared__ double s_win[kProdWarps];
  const int c = blockIdx.x;
  const int n_chunks = (t_n + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int k = 0; k < n_chunks; ++k) {
      mbar_init(&full[k], kProdWarps);
      mbar_init(&done[k], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const float* xr = x + (size_t)c * t_n;
  const int warp = threadIdx.x >> 5;
  const int role = (warp - 1 - warp / 4) * 32 + (threadIdx.x & 31);
  if (threadIdx.x == 0) {
    EnvRegs s{env_in[c], peak_in[c], hold_in[c]};
    run_chain(lev, full, done, t_n, s, p);
    env_out[c] = s.e;
    peak_out[c] = s.peak;
    hold_out[c] = s.hold;
  } else if (warp % 4 == 0) {
    return;
  } else if (role < kProducers) {
    produce<kSave>(xr, win + (size_t)c * n_win, win_out + (size_t)c * n_win,
                   lev, sq, full, s_tot, s_win, t_n, n_win, p, role,
                   kSave ? level_save + (size_t)c * t_n : nullptr);
  } else {
    consume<kSave>(xr, y + (size_t)c * t_n, lev, done, t_n, p,
                   role - kProducers,
                   kSave ? env_save + (size_t)c * t_n : nullptr);
  }
}

__global__ void __launch_bounds__(kThreads)
chain_dyn_kernel(const float* __restrict__ x, const float* __restrict__ win,
                 const float* __restrict__ env_in,
                 const float* __restrict__ peak_in,
                 const int* __restrict__ hold_in, float* __restrict__ y,
                 float* __restrict__ win_out, float* __restrict__ env_out,
                 float* __restrict__ peak_out, int* __restrict__ hold_out,
                 int t_n, int n_win, LspDynParams p) {
  chain_dyn_body<false>(x, win, env_in, peak_in, hold_in, y, win_out,
                        env_out, peak_out, hold_out, nullptr, nullptr, t_n,
                        n_win, p);
}

// kernel #3 under autograd: the same, saving the level and the envelope
__global__ void __launch_bounds__(kThreads)
chain_dyn_save_kernel(const float* __restrict__ x,
                      const float* __restrict__ win,
                      const float* __restrict__ env_in,
                      const float* __restrict__ peak_in,
                      const int* __restrict__ hold_in, float* __restrict__ y,
                      float* __restrict__ win_out,
                      float* __restrict__ env_out,
                      float* __restrict__ peak_out, int* __restrict__ hold_out,
                      float* __restrict__ level_save,
                      float* __restrict__ env_save, int t_n, int n_win,
                      LspDynParams p) {
  chain_dyn_body<true>(x, win, env_in, peak_in, hold_in, y, win_out, env_out,
                       peak_out, hold_out, level_save, env_save, t_n, n_win,
                       p);
}

// ---------------------------------------------------------------------------
// Backward: chain_dyn_bwd, one block a channel, from the level and the
// envelope that chain_dyn_save_kernel saved in the forward (the same
// values kernel #3 computes, so nothing is replayed here).
//   0. the level and the envelope staged in shared memory (cp.async);
//      the envelope's branch codes (csrc/env_bwd.cuh: by the block where
//      the hold time is 0, thread 0 alone before the envelope is free and
//      after a break; by thread 0 in batches otherwise), beside
//   1. all threads: the knee gain and its adjoint per sample, y's
//      cotangent into the gain (g_y x) and x (g_y gain), the envelope's
//      cotangent, and the knee fields' partial sums (float64, reduced in
//      a fixed order: each thread's samples in time order, then the
//      warps' in warp order);
//   2. thread 0: the envelope's adjoint in reverse time, each product and
//      sum rounded alone in peak_envelope_bwd_kernel's order (so against
//      ops/env_units.peak_envelope_bwd_plain on the saved level, envelope
//      and cotangent it is bit for bit), giving each step's lv and the
//      carried envelope's and peak's cotangents; thread 32 behind it the
//      taus' partials;
//   3. all threads: the level's cotangent kind ? lv tau : 0, the RMS's
//      adjoint a[t] = ((g (0.5 / level)) mask) / N, and the frame's
//      cotangent gf[j] = a[j - N] + ... + a[j - 1] as a float64 scan of
//      a[j - 1] - a[j - 1 - N] in tiles of the block, plus window''s
//      cotangent for j >= T; the window takes gf[j < N], x takes
//      2 (gf v) g sign(x) beside its part from 1.
// chain_dyn_sums then adds the channels' partials in channel order (the
// taus in float32 as tau_sums_kernel does, the knee fields in float64).
// What bounds it: the reverse pass of thread 0, T steps of 3-4 dependent
// operations; the parallel phases (1, 3) come before and after it.  The
// block's 160 threads fix the order in which the knee fields' float64
// sums and the RMS's scan add (another count rounds them otherwise).
// Shared memory: level, envelope, cotangent (then lv) and codes, 13 T
// bytes (T rounded up to 4).
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 1 + kProdWarps;       // 5: the sums' order
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdItems = 4;                    // scan items per thread
constexpr int kKneeFields = 8;                  // LspKnee's
constexpr int kMaxBwdT = 16384;                 // 13 T bytes of smem
constexpr int kBwdBrkWords = kMaxBwdT / envbwd::kTile / 32;
constexpr int kKneeAhead = 4;                   // samples loaded ahead

// One knee's gain at |e| and its adjoint: with cg the cotangent of the
// gain, adds the log's cotangent to *glx and each field's to f[8] (the
// order of LspKnee; start and end only steer: zero).
__device__ __forceinline__ void knee_adjoint(const LspKnee& k, float ax,
                                             float lx, float cg, float* glx,
                                             double* f) {
  if (ax <= k.start) {
    f[2] += (double)cg;
  } else if (ax >= k.end) {
    const float cl = cg * expf(lx * k.tilt0 + k.tilt1);
    f[3] += (double)(cl * lx);
    f[4] += (double)cl;
    *glx += cl * k.tilt0;
  } else {
    const float a = k.herm0 * lx + k.herm1;
    const float ch = cg * expf(a * lx + k.herm2);
    const float chl = ch * lx;
    f[5] += (double)(chl * lx);
    f[6] += (double)chl;
    f[7] += (double)ch;
    *glx += ch * a + chl * k.herm0;
  }
}

template <bool kFree>
__global__ void __launch_bounds__(kBwdThreads)
chain_dyn_bwd(const float* __restrict__ x, const float* __restrict__ env_in,
              const float* __restrict__ peak_in,
              const int* __restrict__ hold_in,
              const float* __restrict__ level,
              const float* __restrict__ envl, const float* __restrict__ g_y,
              const float* __restrict__ g_wout,
              const float* __restrict__ g_e, const float* __restrict__ g_p,
              float* __restrict__ g_x, float* __restrict__ g_win,
              float* __restrict__ ge_out, float* __restrict__ gp_out,
              float* __restrict__ tau_part, double* __restrict__ knee_part,
              float* __restrict__ genv_out, float* __restrict__ glev_out,
              float* __restrict__ y_out, int c_n, int t_n, int n_win,
              LspDynParams p) {
  extern __shared__ __align__(16) float smem[];
  const int t_pad = (t_n + 3) & ~3;       // each array 16-byte aligned
  __shared__ uint32_t s_brk[kBwdBrkWords];
  __shared__ double s_red[kBwdWarps][2 * kKneeFields];
  __shared__ double s_scan[kBwdWarps];
  __shared__ int s_done;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = (size_t)c * t_n;
  const float* xr = x + row;
  envbwd::Seg s{smem, smem + t_pad, smem + 2 * t_pad,
                reinterpret_cast<uint8_t*>(smem + 3 * t_pad), s_brk, t_n,
                env_in[c], 0, 0};
  float* lev = s.x;                       // the level, then the RMS adjoint

  // 0. the level and the envelope
  if (tid < kBwdBrkWords) s_brk[tid] = 0;
  if (tid == 0) s_done = t_n;
  envbwd::stage(s.x, level + row, t_n);
  envbwd::stage(s.env, envl + row, t_n);
  envbwd::stage_wait();
  __syncthreads();

  // the codes, beside 1. the gain and the apply (thread 0 takes its share
  // of 1 after its part of the codes)
  const float* gyr = g_y + row;
  float* gxr = g_x + row;
  double f[2 * kKneeFields];
#pragma unroll
  for (int i = 0; i < 2 * kKneeFields; ++i) f[i] = 0.0;
  auto gain_adjoint = [&] {
    for (int t0 = tid; t0 < t_n; t0 += kKneeAhead * kBwdThreads) {
      float xa[kKneeAhead], ga[kKneeAhead];
#pragma unroll
      for (int u = 0; u < kKneeAhead; ++u) {
        const int t = t0 + u * kBwdThreads;
        xa[u] = t < t_n ? xr[t] : 0.0f;
        ga[u] = t < t_n ? gyr[t] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kKneeAhead; ++u) {
        const int t = t0 + u * kBwdThreads;
        if (t >= t_n) break;
        const float e = s.env[t];
        const float ax = fabsf(e);
        const float lx = logf(fmaxf(ax, 1e-36f));
        const float g0 = knee_gain(p.k0, ax, lx);
        const float g1 = knee_gain(p.k1, ax, lx);
        const float xv = xa[u];
        const float gy = ga[u];
        const float gain = g0 * g1;
        gxr[t] = gy * gain;
        const float gg = gy * xv;
        float glx = 0.0f;
        knee_adjoint(p.k0, ax, lx, gg * g1, &glx, f);
        knee_adjoint(p.k1, ax, lx, gg * g0, &glx, f + kKneeFields);
        const float gax = ax > 1e-36f ? glx / ax : 0.0f;
        const float ge = e > 0.0f ? gax : (e < 0.0f ? -gax : 0.0f);
        s.lv[t] = ge;
        if (genv_out) {
          genv_out[row + t] = ge;
          y_out[row + t] =
              xv * (knee_gain(p.k0, ax, lx) * knee_gain(p.k1, ax, lx));
        }
      }
    }
  };
  float peak = peak_in[c];
  int hold = hold_in[c];
  envbwd::segment_codes<true, kFree>(s, p.rt, p.nh, peak, hold,
                                     gain_adjoint);
#pragma unroll
  for (int i = 0; i < 2 * kKneeFields; ++i) {
    double v = f[i];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) s_red[warp][i] = v;
  }
  __syncthreads();
  if (tid < 2 * kKneeFields) {
    double v = 0.0;
    for (int wi = 0; wi < kBwdWarps; ++wi) v += s_red[wi][tid];
    knee_part[(size_t)tid * c_n + c] = v;
  }

  // 2. the envelope, in reverse time (thread 0 lam's chain, thread 32 the
  // taus' sums behind it)
  if (tid == 0) {
    float lam = g_e[c], lp = g_p[c];
    envbwd::reverse_lam(s, p.ta, p.tr, lam, lp, &s_done);
    ge_out[c] = lam;
    gp_out[c] = lp;
  } else if (tid == 32) {
    float acc_ta = 0.0f, acc_tr = 0.0f;
    envbwd::reverse_acc(s, acc_ta, acc_tr, &s_done);
    tau_part[c] = acc_ta;
    tau_part[c_n + c] = acc_tr;
  }
  __syncthreads();

  // 3. the RMS: a[t] in place of the level, then the frame's cotangent
  const float n_f = (float)n_win;
  for (int t = tid; t < t_n; t += kBwdThreads) {
    const float l = lev[t];
    const float gl = envbwd::gx_of(s.codes[t], s.lv[t], p.ta, p.tr);
    float a = __fmul_rn(gl, __fdiv_rn(0.5f, l));
    if (l == 0.0f) a = __fmul_rn(a, 0.5f);
    lev[t] = __fdiv_rn(a, n_f);
    if (glev_out) glev_out[row + t] = gl;
  }
  __syncthreads();
  auto a_at = [&](int i) { return i >= 0 && i < t_n ? (double)lev[i] : 0.0; };
  const float* gwo = g_wout + (size_t)c * n_win;
  float* gwr = g_win + (size_t)c * n_win;
  double carry = 0.0;                       // gf just before the tile
  const int l_n = t_n + n_win;
  constexpr int kTile = kBwdThreads * kBwdItems;
  for (int j0 = 0; j0 < l_n; j0 += kTile) {
    const int jb = j0 + tid * kBwdItems;
    // this thread's x, g_x and window' cotangent, loaded ahead
    float xp[kBwdItems], gp[kBwdItems], wp[kBwdItems];
#pragma unroll
    for (int i = 0; i < kBwdItems; ++i) {
      const int j = jb + i;
      const int t = j - n_win;
      xp[i] = j >= n_win && j < l_n ? xr[t] : 0.0f;
      gp[i] = j >= n_win && j < l_n ? gxr[t] : 0.0f;
      wp[i] = j >= t_n && j < l_n ? gwo[j - t_n] : 0.0f;
    }
    double pre[kBwdItems];
    double run = 0.0;
#pragma unroll
    for (int i = 0; i < kBwdItems; ++i) {
      const int j = jb + i;
      if (j >= 1 && j < l_n) run += a_at(j - 1) - a_at(j - 1 - n_win);
      pre[i] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    double base = carry + (incl - run), tot = 0.0;
    for (int wi = 0; wi < kBwdWarps; ++wi) {
      if (wi < warp) base += s_scan[wi];
      tot += s_scan[wi];
    }
#pragma unroll
    for (int i = 0; i < kBwdItems; ++i) {
      const int j = jb + i;
      if (j >= l_n) continue;
      double gd = base + pre[i];
      if (j >= t_n) gd += (double)wp[i];
      const float gf = (float)gd;
      if (j < n_win) {
        gwr[j] = gf;
      } else {
        const int t = j - n_win;
        const float xv = xp[i];
        const float q = __fmul_rn(gf, __fmul_rn(fabsf(xv), p.g));
        const float gx = __fmul_rn(__fadd_rn(q, q), p.g);
        gxr[t] = __fadd_rn(gp[i], xv < 0.0f ? -gx : gx);
      }
    }
    carry += tot;
    __syncthreads();
  }
}

// The channels' partials summed in channel order: the taus (attack,
// release) in float32, as tau_sums_kernel does, the knee fields in
// float64; kSumRows channels at a time staged in shared memory by the
// block (loads in parallel, then a thread a sum adds in order).
constexpr int kSumThreads = 256, kSumRows = 256;

__global__ void __launch_bounds__(kSumThreads)
chain_dyn_sums(const float* __restrict__ tau_part,
               const double* __restrict__ knee_part,
               float* __restrict__ g_tau, float* __restrict__ g_knee,
               int c_n) {
  __shared__ float s_t[2][kSumRows];
  __shared__ double s_k[2 * kKneeFields][kSumRows];
  const int i = threadIdx.x;
  float acc_t = 0.0f;
  double acc_k = 0.0;
  for (int r0 = 0; r0 < c_n; r0 += kSumRows) {
    const int n = min(kSumRows, c_n - r0);
    for (int j = i; j < n; j += kSumThreads) {
      s_t[0][j] = tau_part[r0 + j];
      s_t[1][j] = tau_part[c_n + r0 + j];
#pragma unroll
      for (int f = 0; f < 2 * kKneeFields; ++f)
        s_k[f][j] = knee_part[(size_t)f * c_n + r0 + j];
    }
    __syncthreads();
    if (i < 2) {
      for (int j = 0; j < n; ++j) acc_t = __fadd_rn(acc_t, s_t[i][j]);
    } else if (i < 2 + 2 * kKneeFields) {
      for (int j = 0; j < n; ++j) acc_k += s_k[i - 2][j];
    }
    __syncthreads();
  }
  if (i < 2)
    g_tau[i] = acc_t;
  else if (i < 2 + 2 * kKneeFields)
    g_knee[i - 2] = (float)acc_k;
}

}  // namespace

extern "C" {

int lsp_chain_dyn(const float* x, const float* win, const float* env_in,
                  const float* peak_in, const int* hold_in, float* y,
                  float* win_out, float* env_out, float* peak_out,
                  int* hold_out, int c_n, int t_n, int n_win, LspDynParams p,
                  void* stream) {
  if (t_n < n_win || n_win < 1 || t_n > kMaxChunks * kChunk)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)((size_t)2 * t_n * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chain_dyn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chain_dyn_kernel<<<c_n, kThreads, smem, (cudaStream_t)stream>>>(
      x, win, env_in, peak_in, hold_in, y, win_out, env_out, peak_out,
      hold_out, t_n, n_win, p);
  return (int)cudaGetLastError();
}

int lsp_chain_dyn_save(const float* x, const float* win,
                       const float* env_in, const float* peak_in,
                       const int* hold_in, float* y, float* win_out,
                       float* env_out, float* peak_out, int* hold_out,
                       float* level_save, float* env_save, int c_n, int t_n,
                       int n_win, LspDynParams p, void* stream) {
  if (t_n < n_win || n_win < 1 || t_n > kMaxChunks * kChunk)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)((size_t)2 * t_n * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chain_dyn_save_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  chain_dyn_save_kernel<<<c_n, kThreads, smem, (cudaStream_t)stream>>>(
      x, win, env_in, peak_in, hold_in, y, win_out, env_out, peak_out,
      hold_out, level_save, env_save, t_n, n_win, p);
  return (int)cudaGetLastError();
}

int lsp_chain_dyn_bwd(const float* x, const float* env_in,
                      const float* peak_in, const int* hold_in,
                      const float* level, const float* env, const float* g_y,
                      const float* g_wout, const float* g_e, const float* g_p,
                      float* g_x, float* g_win, float* ge_out, float* gp_out,
                      float* tau_part, double* knee_part, float* g_tau,
                      float* g_knee, float* genv_out, float* glev_out,
                      float* y_out, int c_n, int t_n, int n_win,
                      LspDynParams p, void* stream) {
  if (t_n < n_win || n_win < 1 || t_n > kMaxBwdT || c_n < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = 13 * ((t_n + 3) & ~3);
  // a hold time of 0: the codes by the whole block (a route; both exact)
  auto kernel = p.nh == 0 ? chain_dyn_bwd<true> : chain_dyn_bwd<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<c_n, kBwdThreads, smem, (cudaStream_t)stream>>>(
      x, env_in, peak_in, hold_in, level, env, g_y, g_wout, g_e, g_p, g_x,
      g_win, ge_out, gp_out, tau_part, knee_part, genv_out, glev_out, y_out,
      c_n, t_n, n_win, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  chain_dyn_sums<<<1, kSumThreads, 0, (cudaStream_t)stream>>>(
      tau_part, knee_part, g_tau, g_knee, c_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
