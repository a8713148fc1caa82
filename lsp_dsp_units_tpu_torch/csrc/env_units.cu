// Sidechain level and envelope followers on [C, T] float32 blocks: the
// three single-purpose kernels of the JAX package's ops/pallas_env.py.
//
//   lsp_sliding_rms    replaces sliding_rms_pallas   (_rms_kernel)
//   lsp_peak_envelope  replaces peak_envelope_pallas (_kernel, _env_step)
//   lsp_gate_envelope  replaces gate_envelope_pallas (_gate_kernel,
//                      _gate_step)
//
// The envelope update ``e + tau * d`` is one fused multiply-add,
// __fmaf_rn: a single rounding, as XLA contracts it in the JAX package.
// The plain PyTorch versions form the same correctly rounded value from
// float64 tensors (ops/env_units.py::_mul_add), so kernel and plain
// version agree bit for bit.  csrc/env.cu, the fused tail of step_ring,
// is a different kernel with its own tolerance.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// sliding RMS
//
// level[t] = sqrt(S[t] / N), S[t] = frame[t + 1] + ... + frame[t + N] over
// frame = [window || squares].  The TPU kernel carried the running sum
// along a serial row loop.  But the sum has finite memory: a tile that
// starts at t0 needs only the N frame values before it,
// S[t0 - 1] = frame[t0] + ... + frame[t0 + N - 1] (its halo), and then
// S[t] = S[t0 - 1] + sum over u in [t0, t] of (frame[u + N] - frame[u]).
// So the tiles are independent blocks.
//
// What bounds it: bytes.  A [64, 16384] block moves ~8.4 MB (x in, level
// out; 2.5 us of HBM), and the work per sample is a few operations.  The
// design keeps the card full and every access coalesced:
//
// - a 1-D grid of C x ceil(T / kRmsTile) blocks, kRmsTile samples each
//   (512 blocks of 512 threads at [64, 16384]).  On the H100 tiles of
//   512, 1024 and 2048 samples ran within 1.2 % of each other, 2048 the
//   fastest: its halo re-reads a quarter of the tile, 1024's a half;
// - each thread owns four consecutive samples.  Where the rows allow it
//   (T and N multiples of 4, 16-byte aligned pointers) it reads x[t] and
//   frame[t] as one float4 each and writes its levels as one float4, so
//   a warp's access is 512 contiguous bytes and needs no staging through
//   shared memory; elsewhere (T = 300 is aligned, T = 301 is not) the
//   same four samples go one by one;
// - the halo is summed by the whole block, kRmsThreads consecutive
//   frame values per round, in double; the squares are recomputed from x
//   (the same two __fmul_rn as the plain version), so window' stays
//   exact;
// - S is a double: the thread's four differences, a shuffle scan of the
//   thread totals per warp, then one barrier, after which every warp
//   scans the warp totals and sums the warp halo parts by shuffles (no
//   serial loop over warps).  Each level is that double rounded once.
// - window' (frame[T .. T + N - 1]) is written by a slice of the grid:
//   block (c, tile) writes entries tile * kRmsThreads + threadIdx.x, ...
// Any T >= 1 and N >= 1: frame[j] is read from the window for j < N and
// recomputed from x otherwise, so T < N needs no special case.
// ---------------------------------------------------------------------------

constexpr int kRmsItems = 4;                       // samples per thread
constexpr int kRmsTile = 2048;                     // samples per block
constexpr int kRmsThreads = kRmsTile / kRmsItems;
constexpr int kRmsWarps = kRmsThreads / 32;

__device__ __forceinline__ float square_of(float x, float g) {
  const float v = __fmul_rn(fabsf(x), g);
  return __fmul_rn(v, v);
}

__device__ __forceinline__ float frame_at(const float* wr, const float* xr,
                                          int j, int n_win, float g) {
  return j < n_win ? wr[j] : square_of(xr[j - n_win], g);
}

template <bool kVec>
__global__ void __launch_bounds__(kRmsThreads)
sliding_rms_kernel(const float* __restrict__ x, const float* __restrict__ win,
                   float* __restrict__ level, float* __restrict__ win_out,
                   int t_n, int n_win, int tiles, float g) {
  __shared__ double s_tot[kRmsWarps];
  __shared__ double s_halo[kRmsWarps];
  const int c = blockIdx.x / tiles;
  const int tile = blockIdx.x - c * tiles;
  const int t0 = tile * kRmsTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* xr = x + (size_t)c * t_n;
  const float* wr = win + (size_t)c * n_win;
  float* lr = level + (size_t)c * t_n;
  const int tb = t0 + threadIdx.x * kRmsItems;     // the thread's first t

  // the differences frame[t + N] - frame[t] of the thread's samples
  float nw[kRmsItems], od[kRmsItems];
  if (kVec) {
    if (tb < t_n) {      // T % 4 == 0: the thread's four are all in range
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + tb));
      const float4 ov = tb < n_win   // N % 4 == 0: all four on one side
          ? __ldg(reinterpret_cast<const float4*>(wr + tb))
          : __ldg(reinterpret_cast<const float4*>(xr + tb - n_win));
      const bool sq = tb >= n_win;
      nw[0] = square_of(xv.x, g); nw[1] = square_of(xv.y, g);
      nw[2] = square_of(xv.z, g); nw[3] = square_of(xv.w, g);
      od[0] = sq ? square_of(ov.x, g) : ov.x;
      od[1] = sq ? square_of(ov.y, g) : ov.y;
      od[2] = sq ? square_of(ov.z, g) : ov.z;
      od[3] = sq ? square_of(ov.w, g) : ov.w;
    } else {
#pragma unroll
      for (int k = 0; k < kRmsItems; ++k) nw[k] = od[k] = 0.0f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRmsItems; ++k) {
      const int t = tb + k;
      nw[k] = t < t_n ? square_of(xr[t], g) : 0.0f;
      od[k] = t < t_n ? frame_at(wr, xr, t, n_win, g) : 0.0f;
    }
  }
  double pre[kRmsItems];
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < kRmsItems; ++k) {
    run += (double)nw[k] - (double)od[k];
    pre[k] = run;
  }

  // the halo frame[t0 .. t0 + N - 1], summed by the block
  double halo = 0.0;
  for (int j = t0 + threadIdx.x; j < t0 + n_win; j += kRmsThreads)
    halo += (double)frame_at(wr, xr, j, n_win, g);

  // per warp: inclusive scan of the thread totals, sum of the halo parts
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
    halo += __shfl_xor_sync(0xffffffffu, halo, off);
  }
  if (lane == 31) s_tot[warp] = incl;
  if (lane == 0) s_halo[warp] = halo;
  __syncthreads();

  // across warps, in every warp: the halo's sum and the exclusive scan
  // of the warp totals, by shuffles over lanes 0 .. kRmsWarps - 1
  double wt = lane < kRmsWarps ? s_tot[lane] : 0.0;
  double wh = lane < kRmsWarps ? s_halo[lane] : 0.0;
#pragma unroll
  for (int off = 1; off < kRmsWarps; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, wt, off);
    if (lane >= off) wt += v;
    wh += __shfl_xor_sync(0xffffffffu, wh, off);
  }
  const double before = __shfl_sync(0xffffffffu, wt, warp > 0 ? warp - 1 : 0);
  const double base = __shfl_sync(0xffffffffu, wh, 0) +
                      (warp > 0 ? before : 0.0) + (incl - run);

  const double n_d = (double)n_win;
  float lv[kRmsItems];
#pragma unroll
  for (int k = 0; k < kRmsItems; ++k)
    lv[k] = sqrtf((float)fmax((base + pre[k]) / n_d, 0.0));
  if (kVec) {
    if (tb < t_n)
      *reinterpret_cast<float4*>(lr + tb) = make_float4(lv[0], lv[1], lv[2],
                                                        lv[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kRmsItems; ++k)
      if (tb + k < t_n) lr[tb + k] = lv[k];
  }

  // window' = the last N samples of [window || squares]
  for (int i = tile * kRmsThreads + threadIdx.x; i < n_win;
       i += tiles * kRmsThreads)
    win_out[(size_t)c * n_win + i] = frame_at(wr, xr, t_n + i, n_win, g);
}

// ---------------------------------------------------------------------------
// peak-hold envelope and gate envelope
//
// What bounds them: the latency of the recurrence.  Each step depends on
// the last, so a channel is one serial chain of T steps, and the card's
// width does not help: the main path's 64 channels are 64 chains.  The
// design runs each chain on one thread with its state in registers and
// keeps everything else off it, as csrc/env.cu does: one block per
// channel; thread 0 runs the recurrence over a chunk of the channel's
// signal in shared memory, reading 32 levels at a time into registers with
// vector loads and writing the envelopes back the same way; meanwhile
// warps 1-3 write the previous chunk out and read the next one in
// (coalesced), so the chain never waits on device memory (a load or store
// on the chain costs its latency every step, see PERF.md).  Two buffers of
// kChunk samples take any T.
//
// The step itself: on this card a compare that feeds a select costs ~13
// cycles, against ~4 for FADD, FFMA or FMNMX, so the reference step
// (subtract, compare, select tau, FMA, selects) is ~28 cycles.  Where the
// envelope cannot hold (hold 0, a hold time of 0 samples, peak == e,
// release no faster than attack and attack tau >= 0: the chain's
// compressor from env_init, and any unit with hold_ms 0, which is the
// gate's default) a batch runs env.cu's free step instead, sub -> fma ->
// min -> max with no predicate on the envelope's path, and ends with
// peak := e; every other batch and each chunk's tail run the reference
// step.  There is no branch inside a batch.  Coefficients that allow the
// free step select a kernel of its own (kFree), so that the others run
// the reference step's code alone, scheduled as before.
//
// The gate's curve track is no part of the chain: the curve never feeds
// back into the envelope, it is a two-state automaton driven by the
// finished envelope.  So the gate's chain is the peak envelope's without
// a release threshold, and the curves of a chunk are computed afterwards
// from its envelopes by a mover warp, as a scan: each sample is a map on
// {0, 1} (to 1 above curve 0's end, to 0 below curve 1's start, else
// stay), maps compose associatively, so each lane composes its four
// consecutive samples, a shuffle scan composes the lanes, and the curve
// carried from the tile before is applied.  The curves go from registers
// to device memory.  The scan of chunk j - 1 runs while the chain runs
// chunk j; a named barrier among the mover warps alone orders it before
// the refill of that buffer, and the chain thread still meets the block
// at one __syncthreads per chunk.
// Mapping the serial chain better onto the card (e.g. splitting a channel
// where the envelope provably resets) is later work.
// ---------------------------------------------------------------------------

constexpr int kEnvThreads = 128;              // warp 0: the chain
constexpr int kMovers = kEnvThreads - 32;     // warps 1-3: data
constexpr int kChunk = 2048;                  // samples per buffer
constexpr int kBatch = 32;                    // levels held in registers

struct EnvCoef {
  float ta, tr, rt;
  int nh;
  float k0_end, k1_start;  // the gate's curve switch points
};

// One step of the reference Compressor.cpp:231-256 recurrence (the TPU
// kernel's _env_step).  kUseRt: below the release threshold the fall
// uses the attack tau; without it (the gate's form) it uses tau_release.
template <bool kUseRt>
__device__ __forceinline__ float env_step(float x, float& e, float& peak,
                                          int& hold, const EnvCoef& k) {
  const float d = __fsub_rn(x, e);
  const bool falling = d < 0.0f;
  const bool holding = hold > 0;
  const float tau_dn = kUseRt ? (e > k.rt ? k.tr : k.ta) : k.tr;
  const float e_fall = __fmaf_rn(tau_dn, d, e);
  const float e_rise = __fmaf_rn(k.ta, d, e);
  const bool rise_peaked = !falling && e_rise >= peak;
  const float new_e = falling ? (holding ? e : e_fall) : e_rise;
  peak = falling ? (holding ? peak : e_fall) : (rise_peaked ? e_rise : peak);
  hold = falling ? (holding ? hold - 1 : hold) : (rise_peaked ? k.nh : hold);
  e = new_e;
  return e;
}

// The same step where it cannot hold: peak == e, hold == 0, nh == 0,
// tr <= ta and ta >= 0.  A step that does not fall then rises to e_rise >=
// e = peak, so peak follows the envelope and the hold stays 0, and the
// step is e' = falling && (!kUseRt || e > rt) ? e_rel : e_rise.  With tr
// <= ta that is max(e_rise, min(e_rel, b)), b = +inf where the release
// tau applies and -inf otherwise: where d < 0, e_rel >= e_rise, and where
// d >= 0, e_rise >= e_rel, each FMA rounding monotonically in its tau.
// b is +inf from the sign of rt - e (set: e > rt; the host passes rt + 0
// so that rt = -0 compares as +0), or always +inf without a threshold.
// Bit for bit the reference step for finite levels (csrc/env.cu's
// free_step).
template <bool kUseRt>
__device__ __forceinline__ float free_step(float x, float& e,
                                           const EnvCoef& k,
                                           uint32_t inf_bits) {
  if (kUseRt) {
    const float u = __fsub_rn(k.rt, e);          // < 0 (sign set): e > rt
    // b = (~u & 0x80000000) | 0x7f800000 in one lop3
    uint32_t bb;
    asm("lop3.b32 %0, %1, 0x80000000, %2, 0xae;"
        : "=r"(bb) : "r"(__float_as_uint(u)), "r"(inf_bits));
    const float d = __fsub_rn(x, e);
    const float e_rel = __fmaf_rn(k.tr, d, e);
    const float e_rise = __fmaf_rn(k.ta, d, e);
    e = fmaxf(e_rise, fminf(e_rel, __uint_as_float(bb)));
  } else {
    const float d = __fsub_rn(x, e);
    e = fmaxf(__fmaf_rn(k.ta, d, e), __fmaf_rn(k.tr, d, e));
  }
  return e;
}

// The hysteresis curve switch of the gate (the TPU kernel's _gate_step)
// as a map on the curve {0, 1}: to curve 1 when the envelope rises above
// curve 0's end, back to 0 when it falls below curve 1's start.  Bit s of
// the map is the curve after the sample for curve s before it; a NaN
// level keeps the curve.
__device__ __forceinline__ uint32_t curve_map(float e, float k0_end,
                                              float k1_start) {
  return (e > k0_end ? 1u : 0u) | (e < k1_start ? 0u : 2u);
}

// the map "f, then g"
__device__ __forceinline__ uint32_t then(uint32_t f, uint32_t g) {
  return ((g >> (f & 1u)) & 1u) | (((g >> (f >> 1)) & 1u) << 1);
}

constexpr uint32_t kStay = 2u;                // the identity map
constexpr int kRun = 4;                       // samples per lane
constexpr int kTile = 32 * kRun;              // samples per scan step

// The curve track of one chunk from its finished envelopes (one warp):
// tiles of kTile samples, lane i holding samples 4 i .. 4 i + 3 of the
// tile.  cur is the curve before the chunk; returns the curve after it,
// the same in every lane.  A carried curve other than 0 or 1 never
// switches (neither does the reference step's).  Full runs go out as
// 16-byte stores where the row allows them.  Not inlined: inside the
// kernel's body the scan's registers and code cost the chain thread's
// batch ~2.6 cycles a step in ptxas's schedule.
__device__ __noinline__ int curve_scan(const float* buf, int len,
                                       int* __restrict__ out, int cur,
                                       float k0_end, float k1_start) {
  const int lane = threadIdx.x & 31;
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const bool stuck = (cur & ~1) != 0;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int t = t0 + kRun * lane;
    const float4 e = *reinterpret_cast<const float4*>(buf + t);
    // inclusive maps of the lane's run; samples past the end stay
    uint32_t m0 = t < len ? curve_map(e.x, k0_end, k1_start) : kStay;
    uint32_t m1 = then(m0, t + 1 < len
                               ? curve_map(e.y, k0_end, k1_start) : kStay);
    uint32_t m2 = then(m1, t + 2 < len
                               ? curve_map(e.z, k0_end, k1_start) : kStay);
    uint32_t m3 = then(m2, t + 3 < len
                               ? curve_map(e.w, k0_end, k1_start) : kStay);
    uint32_t incl = m3;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t before = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = then(before, incl);
    }
    uint32_t excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = kStay;
    // the curve before the lane's run
    const uint32_t in = stuck ? 0u : (excl >> cur) & 1u;
    int4 c;
    c.x = stuck ? cur : (int)((m0 >> in) & 1u);
    c.y = stuck ? cur : (int)((m1 >> in) & 1u);
    c.z = stuck ? cur : (int)((m2 >> in) & 1u);
    c.w = stuck ? cur : (int)((m3 >> in) & 1u);
    if (aligned && t + kRun <= len) {
      *reinterpret_cast<int4*>(out + t) = c;
    } else {
      if (t < len) out[t] = c.x;
      if (t + 1 < len) out[t + 1] = c.y;
      if (t + 2 < len) out[t + 2] = c.z;
      if (t + 3 < len) out[t + 3] = c.w;
    }
    cur = __shfl_sync(0xffffffffu, c.w, 31);
  }
  return cur;
}

struct EnvRegs {
  float e, peak;
  int hold;
};

// The chain over one chunk in shared memory, in place: levels in,
// envelopes out.  Full batches move through registers with 16-byte loads
// and stores (the buffers are 16-byte aligned and batches start at
// multiples of kBatch).  With kFree (the coefficients allow it), once a
// full batch starts where the envelope cannot hold, it cannot hold for
// the rest of the chunk either (a free step keeps peak == e and the hold
// at 0), so the chunk's remaining full batches run free_step in a loop of
// their own, each batch's levels loaded while the one before runs, and
// end with peak := e.  Every other batch, and the tail, runs env_step.
template <bool kUseRt, bool kFree>
__device__ __forceinline__ void run_chunk(float* buf, int len, EnvRegs& s,
                                          const EnvCoef& k,
                                          uint32_t inf_bits) {
  auto step = [&](float v) {
    return env_step<kUseRt>(v, s.e, s.peak, s.hold, k);
  };
  const int full = len - len % kBatch;
  int t0 = 0;
  for (; t0 < full; t0 += kBatch) {
    if (kFree && s.e == s.peak && s.hold == 0) break;
    float4 lv[kBatch / 4];
    float4* l4 = reinterpret_cast<float4*>(buf + t0);
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) lv[q] = l4[q];
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) {
      lv[q].x = step(lv[q].x);
      lv[q].y = step(lv[q].y);
      lv[q].z = step(lv[q].z);
      lv[q].w = step(lv[q].w);
    }
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) l4[q] = lv[q];
  }
  if (kFree && t0 < full) {
    float4 lv[kBatch / 4];
    const float4* first = reinterpret_cast<const float4*>(buf + t0);
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) lv[q] = first[q];
    for (; t0 < full; t0 += kBatch) {
      // the next batch's levels (the last one again at the end)
      const float4* n4 = reinterpret_cast<const float4*>(
          buf + min(t0 + kBatch, full - kBatch));
      float4 nv[kBatch / 4];
#pragma unroll
      for (int q = 0; q < kBatch / 4; ++q) nv[q] = n4[q];
#pragma unroll
      for (int q = 0; q < kBatch / 4; ++q) {
        lv[q].x = free_step<kUseRt>(lv[q].x, s.e, k, inf_bits);
        lv[q].y = free_step<kUseRt>(lv[q].y, s.e, k, inf_bits);
        lv[q].z = free_step<kUseRt>(lv[q].z, s.e, k, inf_bits);
        lv[q].w = free_step<kUseRt>(lv[q].w, s.e, k, inf_bits);
      }
      float4* l4 = reinterpret_cast<float4*>(buf + t0);
#pragma unroll
      for (int q = 0; q < kBatch / 4; ++q) {
        l4[q] = lv[q];
        lv[q] = nv[q];
      }
    }
    s.peak = s.e;
  }
  for (int t = full; t < len; ++t) buf[t] = step(buf[t]);
}

// kGate: the curve track beside the envelope (warp 1 scans each finished
// chunk).  kFree: the coefficients allow free_step.
template <bool kUseRt, bool kGate, bool kFree>
__global__ void __launch_bounds__(kEnvThreads)
envelope_kernel(const float* __restrict__ x, const float* __restrict__ e_in,
                const float* __restrict__ p_in, const int* __restrict__ h_in,
                const int* __restrict__ cur_in, float* __restrict__ env,
                int* __restrict__ curves, float* __restrict__ e_out,
                float* __restrict__ p_out, int* __restrict__ h_out,
                int* __restrict__ cur_out, int t_n, EnvCoef k) {
  __shared__ __align__(16) float s_x[2][kChunk];
  const int c = blockIdx.x;
  const float* xr = x + (size_t)c * t_n;
  float* er = env + (size_t)c * t_n;
  int* cr = kGate ? curves + (size_t)c * t_n : nullptr;
  const int n_chunks = (t_n + kChunk - 1) / kChunk;
  const bool scanner = kGate && (threadIdx.x >> 5) == 1;

  for (int i = threadIdx.x; i < min(kChunk, t_n); i += kEnvThreads)
    s_x[0][i] = xr[i];
  EnvRegs s{0.0f, 0.0f, 0};
  if (threadIdx.x == 0) s = EnvRegs{e_in[c], p_in[c], h_in[c]};
  int cur = scanner ? cur_in[c] : 0;
  uint32_t inf_bits = 0;               // 0x7f800000, kept in a register
  if (kFree) asm volatile("mov.b32 %0, 0x7f800000;" : "=r"(inf_bits));
  __syncthreads();
  for (int j = 0; j < n_chunks; ++j) {
    const int b = j & 1;
    const int t0 = j * kChunk;
    if (threadIdx.x == 0) {
      run_chunk<kUseRt, kFree>(s_x[b], min(kChunk, t_n - t0), s, k, inf_bits);
    } else if (threadIdx.x >= 32) {
      if (kGate) {
        // the curves of chunk j - 1, before any mover refills its buffer
        if (scanner && j > 0)
          cur = curve_scan(s_x[b ^ 1], kChunk, cr + t0 - kChunk, cur, k.k0_end,
                           k.k1_start);
        asm volatile("bar.sync 1, %0;" ::"n"(kMovers) : "memory");
      }
      // chunk j - 1 out of the other buffer, chunk j + 1 into it: each
      // element is written out before the same thread refills it
      const int prev_len = j > 0 ? kChunk : 0;
      const int next_len = j + 1 < n_chunks ? min(kChunk, t_n - t0 - kChunk)
                                            : 0;
      for (int i = threadIdx.x - 32; i < kChunk; i += kMovers) {
        if (i < prev_len) er[t0 - kChunk + i] = s_x[b ^ 1][i];
        if (i < next_len) s_x[b ^ 1][i] = xr[t0 + kChunk + i];
      }
    }
    __syncthreads();
  }
  const int last = n_chunks - 1;
  const int tl = last * kChunk;
  for (int i = threadIdx.x; i < t_n - tl; i += kEnvThreads)
    er[tl + i] = s_x[last & 1][i];
  if (scanner) {
    cur = curve_scan(s_x[last & 1], t_n - tl, cr + tl, cur, k.k0_end,
                     k.k1_start);
    if ((threadIdx.x & 31) == 0) cur_out[c] = cur;
  }
  if (threadIdx.x == 0) {
    e_out[c] = s.e;
    p_out[c] = s.peak;
    h_out[c] = s.hold;
  }
}

// coefficients under which an envelope with peak == e and no hold left
// cannot hold: free_step's conditions
bool allows_free_step(float ta, float tr, int nh) {
  return nh == 0 && tr <= ta && ta >= 0.0f;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

int lsp_sliding_rms(const float* x, const float* win, float* level,
                    float* win_out, int c_n, int t_n, int n_win, float g,
                    void* stream) {
  if (c_n < 1 || t_n < 1 || n_win < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (t_n + kRmsTile - 1) / kRmsTile;
  const bool vec = t_n % kRmsItems == 0 && n_win % kRmsItems == 0 &&
                   aligned16(x) && aligned16(win) && aligned16(level);
  auto kernel = vec ? sliding_rms_kernel<true> : sliding_rms_kernel<false>;
  kernel<<<c_n * tiles, kRmsThreads, 0, (cudaStream_t)stream>>>(
      x, win, level, win_out, t_n, n_win, tiles, g);
  return (int)cudaGetLastError();
}

// The launch shape at [c_n, t_n]: out[0] blocks, out[1] threads per
// block, out[2] blocks resident per SM (the occupancy calculator, for
// the vector kernel).
int lsp_sliding_rms_shape(int c_n, int t_n, int* out) {
  if (c_n < 1 || t_n < 1) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sliding_rms_kernel<true>, kRmsThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = c_n * ((t_n + kRmsTile - 1) / kRmsTile);
  out[1] = kRmsThreads;
  out[2] = per_sm;
  return 0;
}

int lsp_peak_envelope(const float* x, const float* e_in, const float* p_in,
                      const int* h_in, float* env, float* e_out,
                      float* p_out, int* h_out, int c_n, int t_n, float ta,
                      float tr, float rt, int nh, int use_rt, void* stream) {
  if (c_n < 1 || t_n < 1) return (int)cudaErrorInvalidValue;
  // rt + 0: -0 becomes +0, which compares the same and keeps free_step's
  // sign test exact
  const EnvCoef k{ta, tr, rt + 0.0f, nh, 0.0f, 0.0f};
  const bool free = allows_free_step(ta, tr, nh);
  auto kernel = use_rt ? (free ? envelope_kernel<true, false, true>
                               : envelope_kernel<true, false, false>)
                       : (free ? envelope_kernel<false, false, true>
                               : envelope_kernel<false, false, false>);
  kernel<<<c_n, kEnvThreads, 0, (cudaStream_t)stream>>>(
      x, e_in, p_in, h_in, nullptr, env, nullptr, e_out, p_out, h_out,
      nullptr, t_n, k);
  return (int)cudaGetLastError();
}

int lsp_gate_envelope(const float* x, const float* e_in, const float* p_in,
                      const int* h_in, const int* cur_in, float* env,
                      int* curves, float* e_out, float* p_out, int* h_out,
                      int* cur_out, int c_n, int t_n, float ta, float tr,
                      int nh, float k0_end, float k1_start, void* stream) {
  if (c_n < 1 || t_n < 1) return (int)cudaErrorInvalidValue;
  const EnvCoef k{ta, tr, 0.0f, nh, k0_end, k1_start};
  auto kernel = allows_free_step(ta, tr, nh)
                    ? envelope_kernel<false, true, true>
                    : envelope_kernel<false, true, false>;
  kernel<<<c_n, kEnvThreads, 0, (cudaStream_t)stream>>>(
      x, e_in, p_in, h_in, cur_in, env, curves, e_out, p_out, h_out, cur_out,
      t_n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
