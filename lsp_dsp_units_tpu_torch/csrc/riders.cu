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
//
// Replaces the lax.scan steps of the JAX package's models/dynamics/
// autogain.py (:97-147, :178-191), surge_protector.py (:48-71),
// models/meters/peak.py (:43-59) and dynamic_processor.py (:155-175).
// They are no Pallas kernels: XLA compiles each scan into a loop over
// samples.
//
// What bounds it: the chain.  Each step's state depends on the last
// step's through compares, selects and arithmetic (AutoGain's through
// two curve evaluations and divisions), so a row costs T x the step's
// dependent latency; the bytes (the inputs read, one output written) are
// far below it.  Rows are the only parallelism.  The design is the
// simple one: one thread per row, one row per block (its loads touch one
// row's lines, not 32 rows').  Each tile of kTile steps loads its inputs into
// registers before the chain runs over them; the last partial tile runs
// step by step.  A second design that loaded the next tile while the
// chain ran over this one, with an L2 prefetch 256 samples on, measured
// within -16 % and +7 % of this one, step by step (SimpleAutoGain 0.742
// against 0.885 ms, AutoGain 4.337 against 4.045, [64, 16384], NVIDIA
// H100 80GB HBM3 at 700 W, tools/ab_kernels.py): the steps are bound by
// their own instruction streams (IEEE divisions, selects, the levels'
// lookups), not by their loads, so the simpler form stays.  Staging
// tiles through shared memory for coalesced loads, and more than one lane
// per row, are later work.
//
// Every product, sum and quotient rounds as the plain version rounds it
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, and __fmaf_rn where XLA
// contracts in the JAX package), so the two agree bit for bit.  State
// flags are torch.bool, read and written as bytes.
//
// Each functor's kChainOps is the longest chain of dependent operations
// from its state at one step to its state at the next, counted over its
// step(); lsp_rider_chain_ops returns it, and the chain bound is T x
// kChainOps x 4 cycles.  Change it with the step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;
constexpr int kFloats = 24, kInts = 4, kState = 4;   // ops/riders.py
constexpr int kMaxLevels = 5;
constexpr float kTinyLevel = 1e-18f;

struct Args {
  const float* in[3];     // [rows, T] each
  float* out;             // [rows, T]
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

// p: dev, short kfall, short kgrow, long kfall, long kgrow, silence,
// max_gain, short_comp[7], out_comp[7]; ip: quick_amp, use_max_gain.
struct AutoGainStep {
  static constexpr int kChainOps = 21;
  float g, og;
  bool up, down;
  __device__ void load(const Args& a, int r) {
    g = ld<float>(a, 0, r);
    og = ld<float>(a, 1, r);
    up = ld<uint8_t>(a, 2, r) != 0;
    down = ld<uint8_t>(a, 3, r) != 0;
  }
  __device__ void store(const Args& a, int r) const {
    st<float>(a, 0, r, g);
    st<float>(a, 1, r, og);
    st<uint8_t>(a, 2, r, up);
    st<uint8_t>(a, 3, r, down);
  }
  __device__ float step(const Args& a, float sl, float ss, float le) {
    const float* p = a.p;
    const float dev = p[0];
    const bool quick = a.ip[0] != 0;
    const float nl = __fmul_rn(sl, g), ns = __fmul_rn(ss, g);
    bool u = up && !down && ns > __fmul_rn(le, dev);
    const bool ns_low = __fmul_rn(ns, dev) <= le;
    bool d = quick && down && !up && ns_low;
    const float lim = fmaxf(le, kTinyLevel);
    const float red = curve_gain(p + 7, __fdiv_rn(ns, lim));
    u = u || __fmul_rn(red, dev) < 1.f;
    if (quick) d = d || (!u && ns_low);
    float gain = u ? __fmul_rn(g, p[1])
               : d ? __fmul_rn(g, p[2])
               : nl > le ? __fmul_rn(g, p[3])
               : nl < le ? __fmul_rn(g, p[4]) : g;
    gain = __fmul_rn(gain, curve_gain(p + 14,
                                      __fdiv_rn(__fmul_rn(ss, gain), lim)));
    if (ss <= p[5]) {   // silence: keep the previous gain and flags
      gain = g;
      u = up;
      d = down;
    }
    if (a.ip[1]) {
      og = gain >= p[6] ? __fdiv_rn(p[6], gain) : 1.f;
    } else {
      og = fminf(__fmul_rn(og, p[4]), 1.f);
    }
    g = gain;
    up = u;
    down = d;
    return __fmul_rn(gain, og);
  }
};

// p: deviation, kgrow, kfall, silence, min_gain, max_gain.
struct SimpleAutoGainStep {
  static constexpr int kChainOps = 7;
  float g;
  __device__ void load(const Args& a, int r) { g = ld<float>(a, 0, r); }
  __device__ void store(const Args& a, int r) const {
    st<float>(a, 0, r, g);
  }
  __device__ float step(const Args& a, float lv, float tg, float) {
    const float* p = a.p;
    const float nl = __fmul_rn(lv, g);
    const float ng = lv <= p[3] ? g
                   : __fmul_rn(nl, p[0]) < tg ? __fmul_rn(g, p[1])
                   : nl > __fmul_rn(tg, p[0]) ? __fmul_rn(g, p[2]) : g;
    g = fminf(fmaxf(ng, p[4]), p[5]);
    return g;
  }
};

// p: on_threshold, off_threshold, 1 / transition_max (XLA's product for
// the JAX package's division by the constant); ip: transition_max,
// shutdown_max.
struct SurgeStep {
  static constexpr int kChainOps = 4;
  bool on;
  int sd, tt;
  __device__ void load(const Args& a, int r) {
    on = ld<uint8_t>(a, 0, r) != 0;
    sd = ld<int>(a, 1, r);
    tt = ld<int>(a, 2, r);
  }
  __device__ void store(const Args& a, int r) const {
    st<uint8_t>(a, 0, r, on);
    st<int>(a, 1, r, sd);
    st<int>(a, 2, r, tt);
  }
  __device__ float step(const Args& a, float x, float, float) {
    const float ax = fabsf(x);
    const int tmax = a.ip[0];
    if (on) sd = ax >= a.p[1] ? 0 : sd + 1;
    const bool turn_off = on && sd >= a.ip[1];
    const bool turn_on = !on && ax >= a.p[0];
    on = turn_off ? false : (turn_on || on);
    if (turn_on) sd = 0;
    const float ramp = __fsqrt_rn(__fmul_rn((float)tt, a.p[2]));
    float gain;
    if (on) {
      gain = tt < tmax ? ramp : 1.f;
      tt = min(tt + 1, tmax);
    } else {
      gain = tt > 0 ? ramp : 0.f;
      tt = max(tt - 1, 0);
    }
    return gain;
  }
};

// p: tau; ip: hold.
struct PeakMeterStep {
  static constexpr int kChainOps = 3;
  float peak;
  int cnt;
  __device__ void load(const Args& a, int r) {
    peak = ld<float>(a, 0, r);
    cnt = ld<int>(a, 1, r);
  }
  __device__ void store(const Args& a, int r) const {
    st<float>(a, 0, r, peak);
    st<int>(a, 1, r, cnt);
  }
  __device__ float step(const Args& a, float x, float, float) {
    const float ax = fabsf(x);
    if (ax >= peak) {
      peak = ax;
      cnt = a.ip[0];
    } else {
      if (cnt <= 0) peak = __fmul_rn(peak, a.p[0]);
      cnt = max(cnt - 1, 0);
    }
    return peak;
  }
};

// p: attack levels[5], attack taus[5], release levels[5], release
// taus[5] (ascending levels, the first 0); ip: attack count, release
// count, hold.
struct DynProcStep {
  static constexpr int kChainOps = 10;
  float e, peak;
  int hold;
  __device__ void load(const Args& a, int r) {
    e = ld<float>(a, 0, r);
    peak = ld<float>(a, 1, r);
    hold = ld<int>(a, 2, r);
  }
  __device__ void store(const Args& a, int r) const {
    st<float>(a, 0, r, e);
    st<float>(a, 1, r, peak);
    st<int>(a, 2, r, hold);
  }
  // the tau of the highest level <= e (reference solve_reaction)
  __device__ static float solve(const float* lv, const float* tau, int n,
                                float e) {
    int c = 0;
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) c += (i < n && e >= lv[i]) ? 1 : 0;
    float t = tau[0];
#pragma unroll
    for (int i = 1; i < kMaxLevels; ++i) t = (c - 1 == i) ? tau[i] : t;
    return t;
  }
  __device__ float step(const Args& a, float x, float, float) {
    const float* p = a.p;
    const float d = __fsub_rn(x, e);
    const bool falling = d < 0.f, holding = hold > 0;
    const float tr = solve(p + 10, p + 15, a.ip[1], e);
    const float ta = solve(p, p + 5, a.ip[0], e);
    const float e_fall = __fmaf_rn(tr, d, e);
    const float e_rise = __fmaf_rn(ta, d, e);
    if (falling) {
      if (holding) {
        --hold;
      } else {
        e = e_fall;
        peak = e_fall;
      }
    } else {
      e = e_rise;
      if (e_rise >= peak) {
        peak = e_rise;
        hold = a.ip[2];
      }
    }
    return e;
  }
};

template <class Step, int kIn>
__global__ void __launch_bounds__(1) rider_kernel(Args a) {
  const int r = blockIdx.x;
  const size_t base = (size_t)r * a.t_n;
  const float* in0 = a.in[0] + base;
  const float* in1 = kIn > 1 ? a.in[1] + base : nullptr;
  const float* in2 = kIn > 2 ? a.in[2] + base : nullptr;
  float* out = a.out + base;
  Step s;
  s.load(a, r);
  int t0 = 0;
  for (; t0 + kTile <= a.t_n; t0 += kTile) {
    float x0[kTile], x1[kTile], x2[kTile], y[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      x0[j] = __ldg(in0 + t0 + j);
      x1[j] = kIn > 1 ? __ldg(in1 + t0 + j) : 0.f;
      x2[j] = kIn > 2 ? __ldg(in2 + t0 + j) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) y[j] = s.step(a, x0[j], x1[j], x2[j]);
#pragma unroll
    for (int j = 0; j < kTile; ++j) out[t0 + j] = y[j];
  }
  for (; t0 < a.t_n; ++t0) {
    out[t0] = s.step(a, __ldg(in0 + t0), kIn > 1 ? __ldg(in1 + t0) : 0.f,
                     kIn > 2 ? __ldg(in2 + t0) : 0.f);
  }
  s.store(a, r);
}

template <class Step, int kIn>
cudaError_t launch(const Args& a, cudaStream_t s) {
  // one thread a block, running one row
  rider_kernel<Step, kIn><<<a.rows, 1, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 AutoGain, 1 SimpleAutoGain, 2 SurgeProtector, 3 PeakMeter,
// 4 DynamicProcessor's envelope.  st_in / st_out: host arrays of kState
// device pointers; p, ip: host arrays of kFloats floats, kInts ints.
// Returns a cudaError_t.
int lsp_rider(int kind, const float* in0, const float* in1, const float* in2,
              float* out, void* const* st_in, void* const* st_out,
              const float* p, const int* ip, int rows, int t_n,
              void* stream) {
  Args a{};
  a.in[0] = in0;
  a.in[1] = in1;
  a.in[2] = in2;
  a.out = out;
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
    case 0: return (int)launch<AutoGainStep, 3>(a, s);
    case 1: return (int)launch<SimpleAutoGainStep, 2>(a, s);
    case 2: return (int)launch<SurgeStep, 1>(a, s);
    case 3: return (int)launch<PeakMeterStep, 1>(a, s);
    case 4: return (int)launch<DynProcStep, 1>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The step functor of kind's kChainOps (see above); -1 for no such kind.
int lsp_rider_chain_ops(int kind) {
  switch (kind) {
    case 0: return AutoGainStep::kChainOps;
    case 1: return SimpleAutoGainStep::kChainOps;
    case 2: return SurgeStep::kChainOps;
    case 3: return PeakMeterStep::kChainOps;
    case 4: return DynProcStep::kChainOps;
    default: return -1;
  }
}

}  // extern "C"
