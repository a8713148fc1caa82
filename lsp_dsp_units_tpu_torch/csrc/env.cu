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

#include <cuda_runtime.h>

#include <cstdint>

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
__device__ __forceinline__ void produce(
    const float* __restrict__ xr, const float* __restrict__ wr,
    float* __restrict__ wo, float* lev, float* sq, uint64_t* full,
    double (*s_tot)[kProdWarps], double* s_win, int t_n, int n_win,
    const LspDynParams& p, int q) {
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
      if (t < t0 + len)
        lev[t] = sqrtf(fmaxf((float)(base + pre[j]) * p.inv_n, 0.0f));
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
// in.
__device__ __forceinline__ void consume(const float* __restrict__ xr,
                                        float* __restrict__ yr,
                                        const float* lev, uint64_t* done,
                                        int t_n, const LspDynParams& p,
                                        int q) {
  const int n_chunks = (t_n + kChunk - 1) / kChunk;
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, t_n - t0);
    mbar_wait<kConsumerSleepNs>(&done[k]);
    for (int i = q; i < len; i += kConsumers) {
      const int t = t0 + i;
      const float ax = fabsf(lev[t]);
      const float lx = logf(fmaxf(ax, 1e-36f));
      yr[t] = xr[t] * (knee_gain(p.k0, ax, lx) * knee_gain(p.k1, ax, lx));
    }
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
    produce(xr, win + (size_t)c * n_win, win_out + (size_t)c * n_win, lev,
            sq, full, s_tot, s_win, t_n, n_win, p, role);
  } else {
    consume(xr, y + (size_t)c * t_n, lev, done, t_n, p, role - kProducers);
  }
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

}  // extern "C"
