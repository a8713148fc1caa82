// Serial gain riders: one state-dependent chain per row over T, the step
// a functor of rider_kernel<Step> (ops/riders.py):
//
//   AutoGainStep        AutoGain's rider (3 inputs: long, short and
//                       expected loudness; gain, out_gain, surge up/down)
//   SimpleAutoGainStep  SimpleAutoGain (level, target; gain)
//   SurgeStep           SurgeProtector (|x|; on, shutdown and transition
//                       counters, the sqrt ramp)
//   PeakMeterStep       PeakMeter (|x|; peak, hold counter)
//   DynProcStep         DynamicProcessor's envelope (x; envelope, peak,
//                       hold; tau looked up from up to 5 attack and 5
//                       release levels)
//   TriggerStep<kType>  Trigger (x; previous sample, state, hold counter,
//                       disarm and lock; the int32 state a sample out)
//   DepopperStep        Depopper's forward machine (env; state, counter,
//                       delay; the raw fade-in gain, the fall flag and
//                       the fall's patch length out)
//
// Replaces the lax.scan steps of the JAX package's models/dynamics/
// autogain.py (:97-147, :178-191), surge_protector.py (:48-71),
// models/meters/peak.py (:43-59), dynamic_processor.py (:155-175),
// models/util/trigger.py (:114-164) and models/util/depopper.py
// (:137-186).  They are no Pallas kernels: XLA compiles each scan into a
// loop over samples.
//
// What bounds it: the chain.  Each step's state depends on the last
// step's through compares, selects and arithmetic (AutoGain's through
// two curve evaluations and divisions), so a row costs T x the step's
// dependent latency; the bytes (the inputs read, the outputs written)
// are far below it.  Rows are the only parallelism, one block a row.
// On this card a single thread that also loads the inputs, computes
// what does not depend on the state and stores the outputs spends most
// of each step issuing that work (the first one-thread body ran 3-8x its
// chain bound, and prefetching its loads moved it by -16 % to +7 %).  So
// every step functor is split in three, each part run where it belongs:
//
// * pre(x...): what a step computes from its inputs alone (|x|, the
//   compares of an input against a constant threshold, packed as bits,
//   AutoGain's le * dev and max(le, 1e-18), the Trigger's edge terms from
//   the sample and the one before).  Producer warps stage chunk k + 1's
//   inputs into shared memory with cp.async (each thread reads back only
//   what it copied) and write chunk k + 1's pre words, a field at a time
//   (structure of arrays).
// * next(state, pre): the transition and nothing else.  One thread, alone
//   on warp 0's scheduler (warps 4 and 8, which share it, only wait at
//   the barriers), runs it over chunk k: kBatch steps at a time, their
//   pre words by 16-byte loads from shared memory, and each step's record
//   (what out() needs of the state: the state after the step where that
//   is the output, the state before it for Surge's ramp and the
//   Depopper's outputs) by 16-byte stores into a ring of chunk slots.
// * out(pre, record): each step's outputs, recomputed by consumer warps
//   from the record over chunk k - 1 (AutoGain's gain * out_gain and its
//   max-gain division, Surge's sqrt ramp, the Depopper's fade-in gain
//   with its double sin and exp, its fall and patch length) and written
//   coalesced.  They compute the same function on the same operands, so
//   the outputs are the one-thread body's bit for bit.
//
// The three roles meet at one block barrier a chunk of kChunk samples:
// stage k writes chunk k's pre (slot k % 3), runs the chain over chunk
// k - 1 and the outputs of chunk k - 2, so no slot is written while it is
// read.  The chain waits at a barrier only where the other roles take
// longer over a chunk than it does.  Chunks of 512 ran 1-3 % faster than
// 256 at [64, 16384] on the H100, 128 3-6 % slower and 1024 1-4 %
// faster (tools/ab_kernels.py); 512 keeps a block of 1024 samples
// pipelined over two chunks.
//
// Every product, sum and quotient rounds as the plain version rounds it
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, and __fmaf_rn where XLA
// contracts in the JAX package), so the two agree bit for bit; the
// depopper's sine and gaussian fade-ins take sin and exp in double,
// rounded once, as the plain version does.  State flags are torch.bool,
// read and written as bytes.
//
// A step's output a sample is a float or an int (out[0]), or a DepopOut
// (out[0..2]); put() writes each to its own array.
//
// Each functor's kChainOps is the longest chain of dependent operations
// from its state at one step to its state at the next, counted over its
// next(); lsp_rider_chain_ops returns it, and the chain bound is T x
// kChainOps x 4 cycles.  Change it with next().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFloats = 24, kInts = 8, kState = 5;   // ops/riders.py
constexpr int kMaxLevels = 5;
constexpr float kTinyLevel = 1e-18f;
constexpr uint32_t kPosInf = 0x7f800000u, kNegInf = 0xff800000u;
constexpr uint32_t kNaN = 0x7fffffffu;

constexpr int kChunk = 512;                    // samples a pipeline stage
constexpr int kSlots = 3;                      // pre and record slots
// warp 0 runs the chain (lane 0); warps 4 and 8 share its scheduler and
// only wait; the others, in order, are 4 producer and 4 consumer warps
constexpr int kProducers = 128;                // warps 1, 2, 3, 5
constexpr int kConsumers = 128;                // warps 6, 7, 9, 10
constexpr int kThreads = 11 * 32;

struct Args {
  const float* in[3];     // [rows, T] each
  void* out[3];           // [rows, T] each, the step's own types
  void* st_in[kState];    // [rows] each, the step's own types
  void* st_out[kState];
  float p[kFloats];
  int ip[kInts];
  int rows, t_n;
};

template <class T>
__device__ __forceinline__ T ld(const Args& a, int f, int r) {
  return static_cast<const T*>(a.st_in[f])[r];
}

template <class T>
__device__ __forceinline__ void st(const Args& a, int f, int r, T v) {
  static_cast<T*>(a.st_out[f])[r] = v;
}

__device__ __forceinline__ float f32(uint32_t v) { return __uint_as_float(v); }
__device__ __forceinline__ uint32_t u32(float v) { return __float_as_uint(v); }

// Masks (all ones or 0) for the chains' selects as bit operations: no
// predicate, ~13 cycles from compare to select on this card (csrc/env.cu),
// sits on a chain.  neg(v): v < 0 by its sign (the chains' counts stay
// far inside int32).
__device__ __forceinline__ uint32_t mask(bool c) { return c ? ~0u : 0u; }
__device__ __forceinline__ uint32_t neg(int v) { return (uint32_t)(v >> 31); }

struct DepopOut {
  float raw;
  int patch;
  bool fall;
};

__device__ __forceinline__ void put(const Args& a, size_t i, float v) {
  static_cast<float*>(a.out[0])[i] = v;
}

__device__ __forceinline__ void put(const Args& a, size_t i, int v) {
  static_cast<int*>(a.out[0])[i] = v;
}

__device__ __forceinline__ void put(const Args& a, size_t i,
                                    const DepopOut& v) {
  static_cast<float*>(a.out[0])[i] = v.raw;
  static_cast<uint8_t*>(a.out[1])[i] = v.fall;
  static_cast<int*>(a.out[2])[i] = v.patch;
}

// AutoGain's compressor curve gain, c = (x1, x2, t, d, c, b, a):
// curve(x) / max(x, 1e-18) with the curve ((a v + b) v + c v) + d
// contracted as XLA contracts it, fma(fma(a, v, b), v, c v) + d.
__device__ __forceinline__ float curve_gain(const float* c, float x) {
  const float v = __fsub_rn(x, c[0]);
  const float mid = __fadd_rn(
      __fmaf_rn(__fmaf_rn(c[6], v, c[5]), v, __fmul_rn(c[4], v)), c[3]);
  const float cur = x >= c[1] ? c[2] : (x <= c[0] ? x : mid);
  return __fdiv_rn(cur, fmaxf(x, kTinyLevel));
}

// Each functor: kIn inputs, kPre pre words and kRec record words a step,
// kBatch steps a chain batch (a multiple of 4); load() / store() the
// state (the chain thread); pre(a, x, x_prev, p) from the step's inputs
// (x_prev: the sample before, read where kPrev); next(a, p, r, t) the
// transition at step t of the call, writing the step's record r; out(a,
// p, r) the step's output.
struct StepBase {
  static constexpr bool kPrev = false;
};

// p: dev, short kfall, short kgrow, long kfall, long kgrow, silence,
// max_gain, short_comp[7], out_comp[7]; ip: quick_amp, use_max_gain (the
// template's kQuick, kMax).  pre: sl, ss, le, le * dev, max(le, 1e-18),
// the silence flag.  record: the gain after the step and, without
// max_gain, out_gain (its own chain, which feeds no gain); with it the
// consumers form out_gain from the gain.
//
// The chain is the step itself: two curve evaluations and four IEEE
// divisions (each a reciprocal, its refinement and a range check whose
// slow path is a call).  Riding g through the out curve for each timing
// factor the step may take, beside the short curve's surge decision,
// measured slower (838 and 674 cycles a step against 462 and 507 on the
// H100): the divisions' range-check branches keep the two halves from
// overlapping, and the chain thread issues twice the instructions.
template <bool kQuick, bool kMax>
struct AutoGainStep : StepBase {
  static constexpr int kChainOps = 21;
  static constexpr int kIn = 3, kPre = 6, kRec = kMax ? 1 : 2, kBatch = 8;
  float g, og;
  bool up, down;
  __device__ void load(const Args& a, int r) {
    g = ld<float>(a, 0, r);
    og = ld<float>(a, 1, r);
    up = ld<uint8_t>(a, 2, r) != 0;
    down = ld<uint8_t>(a, 3, r) != 0;
  }
  __device__ static float max_gain_og(const Args& a, float gain) {
    return gain >= a.p[6] ? __fdiv_rn(a.p[6], gain) : 1.f;
  }
  __device__ void store(const Args& a, int r) {
    if (kMax) og = max_gain_og(a, g);
    st<float>(a, 0, r, g);
    st<float>(a, 1, r, og);
    st<uint8_t>(a, 2, r, up);
    st<uint8_t>(a, 3, r, down);
  }
  __device__ static void pre(const Args& a, const float* x, float,
                             uint32_t* p) {
    p[0] = u32(x[0]);
    p[1] = u32(x[1]);
    p[2] = u32(x[2]);
    p[3] = u32(__fmul_rn(x[2], a.p[0]));
    p[4] = u32(fmaxf(x[2], kTinyLevel));
    p[5] = x[1] <= a.p[5];
  }
  __device__ void next(const Args& a, const uint32_t* p, uint32_t* r, int) {
    const float* c = a.p;
    const float sl = f32(p[0]), ss = f32(p[1]), le = f32(p[2]);
    const float lim = f32(p[4]);
    const float dev = c[0];
    const float nl = __fmul_rn(sl, g), ns = __fmul_rn(ss, g);
    bool u = up && !down && ns > f32(p[3]);
    const bool ns_low = __fmul_rn(ns, dev) <= le;
    bool d = kQuick && down && !up && ns_low;
    const float red = curve_gain(c + 7, __fdiv_rn(ns, lim));
    u = u || __fmul_rn(red, dev) < 1.f;
    if (kQuick) d = d || (!u && ns_low);
    // g * 1 is g: one product for the four timing factors and none
    const float k = u ? c[1] : d ? c[2] : nl > le ? c[3] : nl < le ? c[4]
                                                                 : 1.f;
    float gain = __fmul_rn(g, k);
    gain = __fmul_rn(gain, curve_gain(c + 14,
                                      __fdiv_rn(__fmul_rn(ss, gain), lim)));
    if (p[5]) {   // silence: keep the previous gain and flags
      gain = g;
      u = up;
      d = down;
    }
    if (!kMax) og = fminf(__fmul_rn(og, c[4]), 1.f);
    g = gain;
    up = u;
    down = d;
    r[0] = u32(gain);
    if (!kMax) r[kRec - 1] = u32(og);
  }
  __device__ static float out(const Args& a, const uint32_t*,
                              const uint32_t* r) {
    const float gain = f32(r[0]);
    return __fmul_rn(gain, kMax ? max_gain_og(a, gain) : f32(r[kRec - 1]));
  }
};

// p: deviation, kgrow, kfall, silence, min_gain, max_gain.  pre: the
// level, and the target and target * deviation, or -inf and +inf where
// the level is silent (then neither compare holds: the gain stays).
// next() clamps the three gains the step may take (g kgrow, g kfall, g)
// beside the compares, which then pick one.  record: the gain after the
// step.
struct SimpleAutoGainStep : StepBase {
  static constexpr int kChainOps = 7;
  static constexpr int kIn = 2, kPre = 3, kRec = 1, kBatch = 16;
  float g;
  __device__ void load(const Args& a, int r) { g = ld<float>(a, 0, r); }
  __device__ void store(const Args& a, int r) { st<float>(a, 0, r, g); }
  __device__ static void pre(const Args& a, const float* x, float,
                             uint32_t* p) {
    const bool silent = x[0] <= a.p[3];
    p[0] = u32(x[0]);
    p[1] = silent ? kNegInf : u32(x[1]);
    p[2] = silent ? kPosInf : u32(__fmul_rn(x[1], a.p[0]));
  }
  __device__ void next(const Args& a, const uint32_t* p, uint32_t* r, int) {
    const float* c = a.p;
    const float nl = __fmul_rn(f32(p[0]), g);
    const float g_grow = fminf(fmaxf(__fmul_rn(g, c[1]), c[4]), c[5]);
    const float g_fall = fminf(fmaxf(__fmul_rn(g, c[2]), c[4]), c[5]);
    const float g_stay = fminf(fmaxf(g, c[4]), c[5]);
    g = __fmul_rn(nl, c[0]) < f32(p[1]) ? g_grow
      : nl > f32(p[2]) ? g_fall : g_stay;
    r[0] = u32(g);
  }
  __device__ static float out(const Args&, const uint32_t*,
                              const uint32_t* r) {
    return f32(r[0]);
  }
};

// p: on_threshold, off_threshold, 1 / transition_max (XLA's product for
// the JAX package's division by the constant); ip: transition_max,
// shutdown_max.  pre: the masks |x| >= off_threshold and |x| >=
// on_threshold.  next() keeps the on flag as a mask.  record: the
// transition counter before the step, the on mask after it (the ramp
// reads both).
struct SurgeStep : StepBase {
  static constexpr int kChainOps = 4;
  static constexpr int kIn = 1, kPre = 2, kRec = 2, kBatch = 32;
  uint32_t on;   // a mask
  int sd, tt;
  __device__ void load(const Args& a, int r) {
    on = mask(ld<uint8_t>(a, 0, r) != 0);
    sd = ld<int>(a, 1, r);
    tt = ld<int>(a, 2, r);
  }
  __device__ void store(const Args& a, int r) {
    st<uint8_t>(a, 0, r, on != 0);
    st<int>(a, 1, r, sd);
    st<int>(a, 2, r, tt);
  }
  __device__ static void pre(const Args& a, const float* x, float,
                             uint32_t* p) {
    const float ax = fabsf(x[0]);
    p[0] = mask(ax >= a.p[1]);
    p[1] = mask(ax >= a.p[0]);
  }
  __device__ void next(const Args& a, const uint32_t* p, uint32_t* r, int) {
    const uint32_t f_off = p[0], f_on = p[1];
    // on: stays on while the shutdown count (f_off ? 0 : sd + 1) stays
    // below its max; off: turns on where the level reaches on_threshold,
    // the count to 0
    const uint32_t keep = (f_off & mask(a.ip[1] > 0))
                        | (~f_off & neg(sd + 1 - a.ip[1]));
    sd = (int)((on & ((uint32_t)(sd + 1) & ~f_off))
               | (~on & ((uint32_t)sd & ~f_on)));
    on = (on & keep) | (~on & f_on);
    r[0] = (uint32_t)tt;
    r[1] = on;
    tt = (int)((on & (uint32_t)min(tt + 1, a.ip[0]))
               | (~on & (uint32_t)max(tt - 1, 0)));
  }
  __device__ static float out(const Args& a, const uint32_t*,
                              const uint32_t* r) {
    const int tt = (int)r[0];
    const float ramp = __fsqrt_rn(__fmul_rn((float)tt, a.p[2]));
    return r[1] ? (tt < a.ip[0] ? ramp : 1.f) : (tt > 0 ? ramp : 0.f);
  }
};

// p: tau; ip: hold.  pre: |x|.  record: the peak after the step.
struct PeakMeterStep : StepBase {
  static constexpr int kChainOps = 3;
  static constexpr int kIn = 1, kPre = 1, kRec = 1, kBatch = 32;
  float peak;
  int cnt;
  __device__ void load(const Args& a, int r) {
    peak = ld<float>(a, 0, r);
    cnt = ld<int>(a, 1, r);
  }
  __device__ void store(const Args& a, int r) {
    st<float>(a, 0, r, peak);
    st<int>(a, 1, r, cnt);
  }
  __device__ static void pre(const Args&, const float* x, float,
                             uint32_t* p) {
    p[0] = u32(fabsf(x[0]));
  }
  __device__ void next(const Args& a, const uint32_t* p, uint32_t* r, int) {
    const float ax = f32(p[0]);
    const bool rising = ax >= peak;
    const float decayed = cnt <= 0 ? __fmul_rn(peak, a.p[0]) : peak;
    peak = rising ? ax : decayed;
    cnt = rising ? a.ip[0] : max(cnt - 1, 0);
    r[0] = u32(peak);
  }
  __device__ static float out(const Args&, const uint32_t*,
                              const uint32_t* r) {
    return f32(r[0]);
  }
};

// p: attack levels[5], attack taus[5], release levels[5], release
// taus[5] (the levels ascending, ops/riders.py sorts them; the taus in
// the caller's order); ip: attack count, release count, hold.  pre: x.
// record: the envelope after the step.
struct DynProcStep : StepBase {
  static constexpr int kChainOps = 10;
  static constexpr int kIn = 1, kPre = 1, kRec = 1, kBatch = 16;
  float e, peak;
  int hold;
  // the levels, NaN past each count (no envelope reaches them)
  float la[kMaxLevels], lr[kMaxLevels];
  __device__ void load(const Args& a, int r) {
    e = ld<float>(a, 0, r);
    peak = ld<float>(a, 1, r);
    hold = ld<int>(a, 2, r);
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
      la[i] = i < a.ip[0] ? a.p[i] : f32(kNaN);
      lr[i] = i < a.ip[1] ? a.p[10 + i] : f32(kNaN);
    }
  }
  __device__ void store(const Args& a, int r) {
    st<float>(a, 0, r, e);
    st<float>(a, 1, r, peak);
    st<int>(a, 2, r, hold);
  }
  // tau[c - 1] for the c levels <= e, tau[0] where c < 2 (reference
  // solve_reaction): over ascending levels the levels <= e are the first
  // c, so the highest i with e >= lv[i] is c - 1, and a ladder of selects
  // on compares that read e alone finds it
  __device__ static float solve(const float* lv, const float* tau, float e) {
    float t = tau[0];
#pragma unroll
    for (int i = 1; i < kMaxLevels; ++i) t = e >= lv[i] ? tau[i] : t;
    return t;
  }
  __device__ static void pre(const Args&, const float* x, float,
                             uint32_t* p) {
    p[0] = u32(x[0]);
  }
  __device__ void next(const Args& a, const uint32_t* p, uint32_t* r, int) {
    const float d = __fsub_rn(f32(p[0]), e);
    const bool falling = d < 0.f, holding = hold > 0;
    const float tr = solve(lr, a.p + 15, e);
    const float ta = solve(la, a.p + 5, e);
    const float e_fall = __fmaf_rn(tr, d, e);
    const float e_rise = __fmaf_rn(ta, d, e);
    const bool rise_peaked = !falling && e_rise >= peak;
    const bool fall_free = falling && !holding;
    hold = falling ? (holding ? hold - 1 : hold)
                   : (rise_peaked ? a.ip[2] : hold);
    peak = fall_free ? e_fall : (rise_peaked ? e_rise : peak);
    e = falling ? (holding ? e : e_fall) : e_rise;
    r[0] = u32(e);
  }
  __device__ static float out(const Args&, const uint32_t*,
                              const uint32_t* r) {
    return f32(r[0]);
  }
};

// Trigger's machine (reference Trigger.cpp:80-215) for one trigger type
// (models/util/trigger.py TriggerType: 0 NONE, 1 and 2 the simple rising
// and falling edges, 3 and 4 the advanced ones).  p: threshold,
// threshold - hysteresis, threshold + hysteresis; ip: one-shot (SINGLE or
// MANUAL mode), hold samples.  A held lock freezes prev, the counter and
// the disarm flag and reads WAITING.  pre: the edge terms from the
// sample and the one before (bit 0 the edge, or the arming edge; bit 1
// the firing edge; bit 2 out of the window): while a row is unlocked its
// previous sample is the one before, and once locked it stays locked and
// reads no edge, so they serve every step.  The chain keeps the last
// unlocked step's index in place of prev.  record: the state after the
// step (the output).
enum { kWaiting = 0, kArmed = 1, kFired = 2 };

template <int kType>
struct TriggerStep : StepBase {
  // the counter through: its compare, the fire's logic (the advanced
  // edges: arming, the armed test and the fire; a simple edge: one), the
  // unlocked fire, a select and an add
  static constexpr int kChainOps = kType == 0 ? 4 : kType < 3 ? 5 : 7;
  static constexpr int kIn = 1, kPre = 1, kRec = 1, kBatch = 32;
  static constexpr bool kPrev = true;
  float prev;
  int state, cnt, last;
  bool disarm, locked;
  __device__ void load(const Args& a, int r) {
    prev = ld<float>(a, 0, r);
    state = ld<int>(a, 1, r);
    cnt = ld<int>(a, 2, r);
    disarm = ld<uint8_t>(a, 3, r) != 0;
    locked = ld<uint8_t>(a, 4, r) != 0;
    last = -1;
  }
  __device__ void store(const Args& a, int r) {
    st<float>(a, 0, r, last < 0 ? prev
                                : __ldg(a.in[0] + (size_t)r * a.t_n + last));
    st<int>(a, 1, r, state);
    st<int>(a, 2, r, cnt);
    st<uint8_t>(a, 3, r, disarm);
    st<uint8_t>(a, 4, r, locked);
  }
  __device__ static void pre(const Args& a, const float* x, float prev,
                             uint32_t* p) {
    const float xt = x[0];
    const float th = a.p[0], lo = a.p[1], hi = a.p[2];
    const float diff = __fsub_rn(xt, prev);
    bool e0 = false, e1 = false, e2 = false;
    if (kType == 1) {
      e0 = diff > 0.f && xt >= th;
    } else if (kType == 2) {
      e0 = diff < 0.f && xt <= th;
    } else if (kType == 3) {
      e0 = diff > 0.f && xt >= lo && prev < lo && xt < th;
      e1 = diff > 0.f && xt >= hi && prev < hi;
      e2 = xt < lo;
    } else if (kType == 4) {
      e0 = diff < 0.f && xt <= hi && prev > hi && xt > th;
      e1 = diff < 0.f && xt <= lo && prev > lo;
      e2 = xt > hi;
    }
    p[0] = (e0 ? 1u : 0u) | (e1 ? 2u : 0u) | (e2 ? 4u : 0u);
  }
  __device__ void next(const Args& a, const uint32_t* p, uint32_t* r,
                       int t) {
    const bool hold_ok = cnt >= a.ip[1];
    bool fire, dis = disarm;
    int nst;
    if (kType == 0) {
      fire = hold_ok;
      nst = fire ? kFired : kWaiting;
    } else if (kType == 1 || kType == 2) {
      fire = (p[0] & 1u) && hold_ok;
      nst = fire ? kFired : kWaiting;
    } else {
      const int st1 = disarm ? kWaiting : state;
      const int st2 = ((p[0] & 1u) && hold_ok) ? kArmed : st1;
      fire = st2 == kArmed && (p[0] & 2u);
      nst = fire ? kFired : st2;
      dis = fire || (p[0] & 4u);
    }
    fire = fire && !locked;
    const int o = locked ? kWaiting : nst;
    if (!locked) {
      last = t;
      cnt = (fire ? 0 : cnt) + 1;
      disarm = dis;
    }
    locked = locked || (a.ip[0] != 0 && fire);
    state = o;
    r[0] = (uint32_t)o;
  }
  __device__ static int out(const Args&, const uint32_t*, const uint32_t* r) {
    return (int)r[0];
  }
};

// Depopper's forward machine (reference Depopper.cpp:550-640; states
// CLOSED 0, FADE 1, OPENED 2, WAIT 3).  p: fade-in threshold, fade-out
// threshold, then the fade-in curve's constants: k = 1 / n_in, the cubic's
// 3 k^2 and -2 k^3, the sine's pi k / 2, the gaussian's 4 k, 1 / (1 - f0)
// and f0 = exp(-16), the parabola's k^2; ip: n_in, n_out, the fade-in
// delay, the fade-out delay, the fade-in mode (models/util/depopper.py
// DepopperMode).  pre: the masks env >= fade-in threshold and env <
// fade-out threshold.  record: the state before the step, packed: the
// counter, and delay x 4 + state.  The outputs (the fade-in gain, which
// reads the counter, the fall and its patch length) feed no state: the
// consumers form them from the record as the reference step does.
//
// next() runs the same transition on masks: the state one-hot (closed,
// fade, opened, wait), each compare of a counter the sign of a
// difference, each select a bit operation.  The machine's counters and
// delays stay far inside +-2^29 (the record's packing and the signs rely
// on it).
struct DepopperStep : StepBase {
  // the state through: the delay's difference and sign, the fade's fall,
  // the fall, and the new fade mask (two operations); the counter's five
  // (its cap's difference and sign, the increment's mask, the add, the
  // opening's select) beside it
  static constexpr int kChainOps = 6;
  static constexpr int kIn = 1, kPre = 2, kRec = 2, kBatch = 16;
  uint32_t closed, fade, open, wait;   // masks, one set
  int cnt, dly;
  __device__ int state() const {
    return (int)((fade & 1u) | (open & 2u) | (wait & 3u));
  }
  __device__ void load(const Args& a, int r) {
    const int s = ld<int>(a, 0, r);
    closed = mask(s == 0);
    fade = mask(s == 1);
    open = mask(s == 2);
    wait = mask(s == 3);
    cnt = ld<int>(a, 1, r);
    dly = ld<int>(a, 2, r);
  }
  __device__ void store(const Args& a, int r) {
    st<int>(a, 0, r, state());
    st<int>(a, 1, r, cnt);
    st<int>(a, 2, r, dly);
  }
  // the fade-in gain at x samples (x >= 0), rounded as XLA rounds the
  // JAX step, sin and exp in double rounded once to float, as
  // ops/riders.py::_fade_in computes them
  __device__ static float fade_in(const Args& a, int x) {
    const float* p = a.p;
    const int n = a.ip[0];
    if (x >= n) return 1.f;
    const float xf = (float)x;
    switch (a.ip[4]) {
      case 0: return __fmul_rn(p[2], xf);
      case 1: return __fmaf_rn(__fmul_rn(p[3], xf), xf,
                               __fmul_rn(__fmul_rn(__fmul_rn(p[4], xf), xf),
                                         xf));
      case 2: {
        const float s = (float)sin((double)__fmul_rn(p[5], xf));
        return __fmul_rn(s, s);
      }
      case 3: {
        const float u = __fmaf_rn(p[6], xf, -4.f);
        const float e = (float)exp((double)__fmul_rn(-u, u));
        return __fmaf_rn(e, p[7], -p[8]);
      }
      default: return __fmul_rn(p[9], __fmul_rn(xf, xf));
    }
  }
  // What a step's outputs read of the reference step from the state
  // before it and the pre masks: the counter after it, whether it opens,
  // whether it falls.
  struct Move {
    int cnt;
    bool open_now, fall;
  };
  __device__ static Move move(const Args& a, int state, int cnt, int dly,
                              bool above_in, bool below_out) {
    const bool closed = state == 0, fade = state == 1, open = state == 2;
    Move m;
    m.open_now = closed && above_in;
    m.cnt = (open && cnt < a.ip[1]) ? cnt + 1 : cnt;
    m.cnt = m.open_now ? 1 : m.cnt;
    m.cnt = fade ? cnt + 1 : m.cnt;
    const int dly_f = below_out ? dly - 1 : a.ip[2];
    m.fall = (fade && below_out && dly_f <= 0) || (open && below_out);
    return m;
  }
  __device__ static void pre(const Args& a, const float* x, float,
                             uint32_t* p) {
    p[0] = mask(x[0] >= a.p[0]);
    p[1] = mask(x[0] < a.p[1]);
  }
  __device__ void next(const Args& a, const uint32_t* p, uint32_t* r, int) {
    const uint32_t above_in = p[0], below_out = p[1];
    r[0] = (uint32_t)cnt;
    r[1] = ((uint32_t)dly << 2) | (uint32_t)state();
    const uint32_t open_now = closed & above_in;
    // the counter: + 1 fading, or opened below n_out (cnt - mask adds 1);
    // 1 where it opens
    const uint32_t inc = fade | (open & neg(cnt - a.ip[1]));
    const int cnt1 = (int)((open_now & 1u)
                           | (~open_now & (uint32_t)(cnt - (int)inc)));
    // a fade falls where below_out and dly - 1 <= 0; a wait ends where
    // dly - 1 <= 0; a fade is done where not below_out and cnt + 1 >= n_in
    const uint32_t low = neg(dly - 2);
    const uint32_t fade_fall = fade & below_out & low;
    const uint32_t open_fall = open & below_out;
    const uint32_t fall = fade_fall | open_fall;
    const uint32_t fade_done = fade & ~below_out & ~neg(cnt + 1 - a.ip[0]);
    const uint32_t wait_done = wait & low;
    const uint32_t dly_f = (below_out & (uint32_t)(dly - 1))
                         | (~below_out & (uint32_t)a.ip[2]);
    const uint32_t moved = open_fall | fade | open_now | wait;
    dly = (int)((open_fall & (uint32_t)a.ip[3]) | (fade & dly_f)
                | (open_now & (uint32_t)a.ip[2])
                | (wait & (uint32_t)(dly - 1)) | (~moved & (uint32_t)dly));
    const uint32_t c = wait_done | (closed & ~open_now);
    const uint32_t f = open_now | (fade & ~(fall | fade_done));
    const uint32_t o = fade_done | (open & ~open_fall);
    wait = fall | (wait & ~wait_done);
    closed = c;
    fade = f;
    open = o;
    cnt = cnt1;
  }
  __device__ static DepopOut out(const Args& a, const uint32_t* p,
                                 const uint32_t* r) {
    const int cnt = (int)r[0], state = (int)(r[1] & 3u);
    const int dly = (int)r[1] >> 2;
    const Move m = move(a, state, cnt, dly, p[0] != 0, p[1] != 0);
    const bool fade = state == 1, open = state == 2;
    DepopOut o;
    o.raw = (fade || m.open_now) ? fade_in(a, m.open_now ? 0 : cnt)
                                 : (open ? 1.f : 0.f);
    o.fall = m.fall;
    o.patch = m.fall ? min(m.cnt, a.ip[1]) : 0;
    return o;
  }
};

template <class Step>
constexpr int smem_bytes() {
  return (2 * Step::kIn + kSlots * (Step::kPre + Step::kRec)) * kChunk * 4;
}

// Producers: stage() copies chunk k's inputs into its staging buffer
// (cp.async, this thread's samples only); produce() forms chunk k's pre
// words from them.
template <class Step>
__device__ __forceinline__ void stage(const Args& a, float* xin, size_t base,
                                      int k, int q) {
  const int t0 = k * kChunk;
  const int len = min(kChunk, a.t_n - t0);
  float* buf = xin + (k & 1) * Step::kIn * kChunk;
  for (int i = q; i < len; i += kProducers) {
#pragma unroll
    for (int j = 0; j < Step::kIn; ++j)
      __pipeline_memcpy_async(buf + j * kChunk + i, a.in[j] + base + t0 + i,
                              sizeof(float));
  }
}

template <class Step>
__device__ __forceinline__ void produce(const Args& a, const float* xin,
                                        uint32_t* pre, size_t base, int k,
                                        int q, float prev0) {
  const int t0 = k * kChunk;
  const int len = min(kChunk, a.t_n - t0);
  const float* buf = xin + (k & 1) * Step::kIn * kChunk;
  for (int i = q; i < len; i += kProducers) {
    float x[Step::kIn];
#pragma unroll
    for (int j = 0; j < Step::kIn; ++j) x[j] = buf[j * kChunk + i];
    float xp = 0.f;
    if (Step::kPrev)   // the sample before: another thread's
      xp = t0 + i == 0 ? prev0 : __ldg(a.in[0] + base + t0 + i - 1);
    uint32_t p[Step::kPre];
    Step::pre(a, x, xp, p);
#pragma unroll
    for (int f = 0; f < Step::kPre; ++f) pre[f * kChunk + i] = p[f];
  }
}

// The chain thread over one chunk: kBatch steps at a time through
// registers (16-byte loads of the pre words, 16-byte stores of the
// records), then the tail step by step.
template <class Step>
__device__ __forceinline__ void run_chain(Step& s, const Args& a,
                                          const uint32_t* pre, uint32_t* rec,
                                          int t0, int len) {
  constexpr int kB = Step::kBatch, kP = Step::kPre, kR = Step::kRec;
  const int whole = len - len % kB;
  int i = 0;
  for (; i < whole; i += kB) {
    uint32_t pv[kP][kB], rv[kR][kB];
#pragma unroll
    for (int f = 0; f < kP; ++f) {
#pragma unroll
      for (int j = 0; j < kB; j += 4) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(pre + f * kChunk + i + j);
        pv[f][j] = v.x;
        pv[f][j + 1] = v.y;
        pv[f][j + 2] = v.z;
        pv[f][j + 3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      uint32_t p[kP], r[kR];
#pragma unroll
      for (int f = 0; f < kP; ++f) p[f] = pv[f][j];
      s.next(a, p, r, t0 + i + j);
#pragma unroll
      for (int f = 0; f < kR; ++f) rv[f][j] = r[f];
    }
#pragma unroll
    for (int f = 0; f < kR; ++f) {
#pragma unroll
      for (int j = 0; j < kB; j += 4)
        *reinterpret_cast<uint4*>(rec + f * kChunk + i + j) =
            make_uint4(rv[f][j], rv[f][j + 1], rv[f][j + 2], rv[f][j + 3]);
    }
  }
  for (; i < len; ++i) {
    uint32_t p[kP], r[kR];
#pragma unroll
    for (int f = 0; f < kP; ++f) p[f] = pre[f * kChunk + i];
    s.next(a, p, r, t0 + i);
#pragma unroll
    for (int f = 0; f < kR; ++f) rec[f * kChunk + i] = r[f];
  }
}

// Consumers: chunk k's outputs from its pre words and records, coalesced.
template <class Step>
__device__ __forceinline__ void consume(const Args& a, const uint32_t* pre,
                                        const uint32_t* rec, size_t base,
                                        int k, int q) {
  const int t0 = k * kChunk;
  const int len = min(kChunk, a.t_n - t0);
  for (int i = q; i < len; i += kConsumers) {
    uint32_t p[Step::kPre], r[Step::kRec];
#pragma unroll
    for (int f = 0; f < Step::kPre; ++f) p[f] = pre[f * kChunk + i];
#pragma unroll
    for (int f = 0; f < Step::kRec; ++f) r[f] = rec[f * kChunk + i];
    put(a, base + t0 + i, Step::out(a, p, r));
  }
}

template <class Step>
__global__ void __launch_bounds__(kThreads) rider_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  float* xin = reinterpret_cast<float*>(smem);   // [2][kIn][kChunk]
  uint32_t* pre = smem + 2 * Step::kIn * kChunk;  // [kSlots][kPre][kChunk]
  uint32_t* rec = pre + kSlots * Step::kPre * kChunk;   // [kSlots][kRec][.]
  const int r = blockIdx.x;
  const size_t base = (size_t)r * a.t_n;
  const int n = (a.t_n + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5;
  const int role = (warp - 1 - warp / 4) * 32 + (threadIdx.x & 31);
  const bool chain = threadIdx.x == 0;
  const bool producer = warp % 4 != 0 && role < kProducers;
  const bool consumer = warp % 4 != 0 && role >= kProducers;
  Step s;
  float prev0 = 0.f;
  if (chain) s.load(a, r);
  if (producer) {
    if (Step::kPrev) prev0 = ld<float>(a, 0, r);
    stage<Step>(a, xin, base, 0, role);
    __pipeline_commit();
  }
  // stage it: chunk it's pre words, the chain over chunk it - 1, the
  // outputs of chunk it - 2
  for (int it = 0; it <= n + 1; ++it) {
    if (chain && it >= 1 && it <= n) {
      const int k = it - 1;
      run_chain(s, a, pre + (k % kSlots) * Step::kPre * kChunk,
                rec + (k % kSlots) * Step::kRec * kChunk, k * kChunk,
                min(kChunk, a.t_n - k * kChunk));
    } else if (producer && it < n) {
      if (it + 1 < n) stage<Step>(a, xin, base, it + 1, role);
      __pipeline_commit();
      __pipeline_wait_prior(1);
      produce<Step>(a, xin, pre + (it % kSlots) * Step::kPre * kChunk, base,
                    it, role, prev0);
    } else if (consumer && it >= 2) {
      const int k = it - 2;
      consume<Step>(a, pre + (k % kSlots) * Step::kPre * kChunk,
                    rec + (k % kSlots) * Step::kRec * kChunk, base, k,
                    role - kProducers);
    }
    __syncthreads();
  }
  if (chain) s.store(a, r);
}

template <class Step>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int smem = smem_bytes<Step>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rider_kernel<Step>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  rider_kernel<Step><<<a.rows, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_autogain(const Args& a, cudaStream_t s) {
  if (a.ip[0])
    return a.ip[1] ? launch<AutoGainStep<true, true>>(a, s)
                   : launch<AutoGainStep<true, false>>(a, s);
  return a.ip[1] ? launch<AutoGainStep<false, true>>(a, s)
                 : launch<AutoGainStep<false, false>>(a, s);
}

}  // namespace

extern "C" {

// kind: 0 AutoGain, 1 SimpleAutoGain, 2 SurgeProtector, 3 PeakMeter,
// 4 DynamicProcessor's envelope, 5 + t Trigger of type t (0-4), 10
// Depopper.  out: a host array of 3 device pointers (those the step
// writes); st_in / st_out: host arrays of kState device pointers; p, ip:
// host arrays of kFloats floats, kInts ints.  Returns a cudaError_t.
int lsp_rider(int kind, const float* in0, const float* in1, const float* in2,
              void* const* out, void* const* st_in, void* const* st_out,
              const float* p, const int* ip, int rows, int t_n,
              void* stream) {
  Args a{};
  a.in[0] = in0;
  a.in[1] = in1;
  a.in[2] = in2;
  for (int i = 0; i < 3; ++i) a.out[i] = out[i];
  for (int i = 0; i < kState; ++i) {
    a.st_in[i] = st_in[i];
    a.st_out[i] = st_out[i];
  }
  for (int i = 0; i < kFloats; ++i) a.p[i] = p[i];
  for (int i = 0; i < kInts; ++i) a.ip[i] = ip[i];
  a.rows = rows;
  a.t_n = t_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return (int)launch_autogain(a, s);
    case 1: return (int)launch<SimpleAutoGainStep>(a, s);
    case 2: return (int)launch<SurgeStep>(a, s);
    case 3: return (int)launch<PeakMeterStep>(a, s);
    case 4: return (int)launch<DynProcStep>(a, s);
    case 5: return (int)launch<TriggerStep<0>>(a, s);
    case 6: return (int)launch<TriggerStep<1>>(a, s);
    case 7: return (int)launch<TriggerStep<2>>(a, s);
    case 8: return (int)launch<TriggerStep<3>>(a, s);
    case 9: return (int)launch<TriggerStep<4>>(a, s);
    case 10: return (int)launch<DepopperStep>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The step functor of kind's kChainOps (see above); -1 for no such kind.
int lsp_rider_chain_ops(int kind) {
  switch (kind) {
    case 0: return AutoGainStep<true, true>::kChainOps;
    case 1: return SimpleAutoGainStep::kChainOps;
    case 2: return SurgeStep::kChainOps;
    case 3: return PeakMeterStep::kChainOps;
    case 4: return DynProcStep::kChainOps;
    case 5: return TriggerStep<0>::kChainOps;
    case 6: return TriggerStep<1>::kChainOps;
    case 7: return TriggerStep<2>::kChainOps;
    case 8: return TriggerStep<3>::kChainOps;
    case 9: return TriggerStep<4>::kChainOps;
    case 10: return DepopperStep::kChainOps;
    default: return -1;
  }
}

}  // extern "C"
