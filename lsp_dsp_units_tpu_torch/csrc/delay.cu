// The dynamic delay line with in-buffer feedback: ops/delay.py's
// dynamic_delay, per row, over a ring of M = max_delay + 1 samples:
//
//   per sample n, with d = clip(delay[n], 0, max_delay) and
//   f = clip(fdelay[n], 0, d):
//     head = head + 1 (mod M);  ring[head] = x[n]
//     s = ring[head - d];  ring[head - d + f] += s * fgain[n]
//     y[n] = ring[head - d]      (s + s * fgain[n] where f == 0, else s)
//
// Replaces the lax.scan of the JAX package's models/util/delay.py
// DynamicDelay.process (:104-122).  It is no Pallas kernel: XLA compiles
// the scan into a loop over samples, each step a whole-buffer shift.
//
// What bounds it: in the serial order, the chain through memory.  A
// step's reads of the ring may alias an earlier step's feedback write,
// so each step loads after the last one stored: a shared-memory load, a
// multiply, an add and a store a sample (kChainOps = 4).  The bytes (x,
// the delay, gain and feedback delay in, y out, the ring in and out) are
// far below it.  But few reads alias: on the drive of chip_smoke.py (the
// delays swept by an LFO, the feedback delays uniform) 1.7 % of the
// steps' tail and feed reads take the r of a step at most 31 before them
// (tools/serial_profile.py, forward_rounds), so the design below runs a
// batch of 32 steps at once and settles only the dependent steps.
//
// delay_kernel: a block a row, slots of kFwdChunk steps, one block
// barrier a slot, a batch a warp of 32 steps.  At slot s:
//
// - the producer warps (a thread a step, a warp a batch) turn chunk s + 1's
//   delays into its slots (head, tail, feed), beside its x and fgain, and
//   into a code: for each of the step's two reads (tail, feed) the last
//   write before it in the batch: the step's own head (its x, where d = 0
//   or f = d), else the latest step before it in the batch that wrote
//   the slot, a head write (its x) or a feed write (its r; the feed where
//   a step wrote both), or none (the value is in the ring at the batch's
//   start); the step's depth (0 where no read takes an r, else one more
//   than its sources' most); and whether its head and feed writes are the
//   batch's last of those slots (no later step writes them: the next
//   head on a slot comes M steps on, or M - (d - f) on the feed, which a
//   later head overwrites where d - f >= M - 31).  Their inputs are loaded
//   a slot ahead and prefetched into L2 two slots ahead;
// - the chain warp runs chunk s on the ring a batch at a time, a lane a
//   step: each lane loads what its step reads from the ring, takes x
//   values from the lanes the code names (shuffles), and computes r = the
//   feed's value + s * fgain; a first round from the loads and the x
//   values, then as many as the batch's deepest step, each read that
//   takes an r from the r of the round before, so the dependent steps
//   alone are serial, as chains of shuffles; then each slot the batch
//   wrote is stored once, by the lane that wrote it last (x or r);
// - the consumer warps (the producers, after their records) write chunk
//   s - 1's y (and s, in the saving form) coalesced, from the chain's
//   records.
//
// The records take kFwdRecWords of shared memory, so the ring lives
// there up to 227 KB less them (max_delay <= 52991) and in a global
// scratch row above (delay_kernel<false, *>).  The first design ran
// every step on one lane of one warp a row, index work included: 153.4
// cycles a step at [64, 16384] with a ring of 4801 (1.2600 ms on the
// H100 at 700 W); a step-ahead form of it with register forwarding took
// 1.0385 ms against its 1.1021 in one call (tools/ab_kernels.py).
//
// Every product and sum rounds as the plain version and the JAX step
// round them (s * g rounded, then added; __fmul_rn, __fadd_rn), in any
// order of the steps that gives each read the serial order's value, so
// the three agree bit for bit.
//
// Under autograd delay_kernel's kSave form also writes each step's s, and
// delay_bwd_kernel runs the adjoint of the step in reverse time over a
// ring of adjoints lam (the same circular layout, in shared memory or the
// scratch row), started from the outgoing ring's cotangent:
//
//   lam[tail] += g_y[n];   g_s = lam[feed] * fgain[n];
//   g_fgain[n] = lam[feed] * s[n];   lam[tail] += g_s;
//   g_x[n] = lam[head];    lam[head] = 0
//
// and the incoming ring's cotangent is what is left of lam.  In the serial
// order a step's chain is a load, an add and a store of lam[tail], the
// load of lam[feed], the multiply and the second add and store
// (kBwdChainOps = 6), and the next step's loads wait on its stores,
// since its slots may be the same.  On the drive of chip_smoke.py (the
// delays swept by an LFO, the feedback delays uniform) 7.5 % of the steps
// read a slot that the step before wrote, 11.4 % one of the 8 before, 17.0
// % one of the 32 before (tools/serial_profile.py): mostly the tail,
// which stays put for a step wherever the delay grows by one.
//
// delay_bwd_kernel: a block a row, slots of kBwdChunk steps (in reverse
// time), one block barrier a slot, a batch a warp of 32 steps.  At slot s:
//
// - the producer warps (a thread a step, a warp a batch) turn chunk s + 1's
//   delays into its slots (tail, feed, head), beside its g_y and fgain,
//   and into a code: for each slot the step reads, the step before it in
//   the batch that wrote it last (its W, or the zero of its head), or none
//   (the value is in lam at the batch's start); and whether the step's
//   tail and head writes are the batch's last of those slots.  Their
//   inputs are loaded a slot ahead and prefetched into L2 two slots ahead;
// - the chain warp runs chunk s on lam a batch at a time, a lane a step:
//   each lane loads what its step reads from lam, the rest from the lanes
//   the code names (shuffles): a first round from the loads alone, then
//   as many as the batch's deepest step (its depth in the code: one more
//   than its sources'), each step's W from its sources' W of the round
//   before, so the dependent steps alone are serial, as chains of
//   shuffles; then each slot the batch wrote is stored once, by the lane
//   that wrote it last;
// - the consumer warps (the producers, after their records) write chunk
//   s - 1's g_x and fgain's cotangent (lam[feed] s, rounded as the plain
//   version does) coalesced, from the chain's records.
//
// The records take kBwdRecWords of shared memory, so lam lives there up to
// 227 KB less them (max_delay <= 54015) and in the global scratch row
// above (delay_bwd_kernel<false>).  Every product and sum rounds as
// ops/delay.py's dynamic_delay_bwd_plain, in its order, bit for bit.
//
// Why batches: the whole step on one lane, the slots' clamps and wraps
// and five global loads a step on its chain, takes 239 cycles a step at
// [64, 16384] on the H100; a chain thread that runs the steps the
// producers cleared from the batch's loads and the others in the serial
// order still ~57 (every instruction of a step on the one thread).

#include <cuda_runtime.h>

#include "smem_attr.cuh"

namespace {

constexpr int kChainOps = 4;          // load, multiply, add, store
constexpr int kBwdChainOps = 6;       // load, add, load, multiply, add, store
constexpr size_t kMaxSmem = 232448;   // 227 KB a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdWarps = 8;          // the forward's producer warps
constexpr int kFwdChunk = 32 * kFwdWarps;      // its steps a slot
constexpr int kFwdThreads = 32 + kFwdChunk;    // the chain warp first
constexpr int kBwdWarps = 8;          // the adjoint's producer warps
constexpr int kBwdChunk = 32 * kBwdWarps;      // its steps a slot
constexpr int kBwdThreads = 32 + kBwdChunk;    // the chain warp first

struct Args {
  const float* x;        // [rows, T]
  const int* delay;      // [rows, T]
  const float* fgain;    // [rows, T]
  const int* fdelay;     // [rows, T]
  const float* buf_in;   // [rows, M], newest at M - 1
  float* buf_out;        // [rows, M]
  float* y;              // [rows, T]
  float* scratch;        // [rows, M] where the ring is not in smem
  float* s_save;         // kSave: [rows, T] each step's s
  int t_n, max_delay;
};

// The forward's records in shared memory, two chunks each (by the
// chunk's parity), indexed by the step's place in its chunk: from the
// producers (tail, feed, head, code) and (x, fgain, the x its tail read
// takes, the x its feed read takes); from the chain (y, s).  The ring
// follows them.
struct FwdSmem {
  int4* rec;
  float4* xg;
  float2* ys;
  float* ring;
};

constexpr int kFwdRecWords = 2 * 10 * kFwdChunk;

__device__ __forceinline__ FwdSmem fwd_smem(float* base) {
  FwdSmem m;
  m.rec = reinterpret_cast<int4*>(base);
  m.xg = reinterpret_cast<float4*>(base + 8 * kFwdChunk);
  m.ys = reinterpret_cast<float2*>(base + 16 * kFwdChunk);
  m.ring = base + kFwdRecWords;
  return m;
}

// A forward step's code: where its two reads (tail, feed) take their
// values, each in seven bits (a kind, then a lane of the batch), then
// its flags and its batch's depth: the most of its steps' (a step's: 0
// where no read takes an r, else one more than its sources' most).
constexpr int kFromRing = 0, kFromX = 1, kFromR = 2;   // kinds
constexpr int kFSrcT = 0, kFSrcF = 7;
constexpr int kFF0 = 1 << 14;       // f == 0: y is r
constexpr int kStoreX = 1 << 15;    // the batch's last write of its head
constexpr int kStoreR = 1 << 16;    // the batch's last write of its feed
constexpr int kFDepth = 17;         // 5 bits: the rounds after the first

// A producer's inputs of one step, as loaded
struct FwdIn {
  float x, g;
  int d, f;
};

__device__ __forceinline__ FwdIn fwd_load(const Args& a, size_t tb, int j) {
  FwdIn v{0.f, 0.f, 0, 0};
  if (j < a.t_n) {
    v.x = __ldg(a.x + tb + j);
    v.g = __ldg(a.fgain + tb + j);
    v.d = __ldg(a.delay + tb + j);
    v.f = __ldg(a.fdelay + tb + j);
  }
  return v;
}

// The L2 prefetch of chunk n's inputs: each warp the lines of its 32
// steps in the four rows it reads, at both ends of its samples.
__device__ __forceinline__ void fwd_prefetch(const Args& a, size_t tb, int n,
                                             int i) {
  const int j0 = n * kFwdChunk + (i & ~31), q = i & 31;
  if (q >= 8 || j0 >= a.t_n) return;
  const size_t t = tb + (q < 4 ? min(j0 + 31, a.t_n - 1) : j0);
  const int r = q & 3;
  const void* p = r == 0 ? (const void*)(a.x + t)
                  : r == 1 ? (const void*)(a.fgain + t)
                  : r == 2 ? (const void*)(a.delay + t)
                           : (const void*)(a.fdelay + t);
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The producers' records of chunk n: thread i the step j = n kFwdChunk +
// i at head j mod M, a warp a batch (lane p = i % 32; the steps before it
// in the batch are the lanes below).  A read of the step's own head
// takes its x; any other slot the last write before it in the batch:
// among the feed writes, from the batch's feeds (shuffles); among the
// head writes, by arithmetic (the heads before run head - 1, head - 2,
// ... mod M, so the one on the slot back steps behind is lane p - back);
// a feed write where both are on one step (it comes after the head).
__device__ __forceinline__ void fwd_produce(const Args& a, const FwdSmem& m,
                                            int n, const FwdIn& v, int i) {
  const int mm = a.max_delay + 1, p = i & 31;
  const int j = n * kFwdChunk + i;
  const bool on = j < a.t_n;
  const int d = min(max(v.d, 0), a.max_delay);
  const int f = min(max(v.f, 0), d);
  const int head = on ? j % mm : 0;
  int tail = head - d;
  if (tail < 0) tail += mm;
  int feed = tail + f;
  if (feed >= mm) feed -= mm;
  const unsigned onm = __ballot_sync(kFull, on);
  const int last = 31 - __clz(onm);   // the batch's last step (onm != 0)
  const unsigned below = (1u << p) - 1u;   // the steps before it
  const int fo = on ? feed : -1 - p;       // the steps beyond T write none
  const unsigned same_f = __match_any_sync(kFull, fo);
  // the batch's steps whose feed is this step's tail, its head
  unsigned eq_t = 0u, eq_h = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int fk = __shfl_sync(kFull, fo, k);
    eq_t |= fk == tail ? 1u << k : 0u;
    eq_h |= fk == head ? 1u << k : 0u;
  }
  // a read of a slot back > 0 steps behind the head: the latest feed
  // write before it in the batch (eq) or head write (lane p - back)
  auto source = [&](unsigned eq, int back, bool own) {
    if (own) return kFromX | p << 2;
    const unsigned w = eq & below;
    const int kw = w ? 31 - __clz(w) : -1, kx = p - back;
    if (kw >= 0 && kw >= kx) return kFromR | kw << 2;
    return kx >= 0 ? kFromX | kx << 2 : kFromRing;
  };
  const int st = source(eq_t, d, d == 0);
  const int sf = source(same_f, d - f, f == d);
  // later writes of its slots: the next head on its head M steps on, on
  // its feed M - (d - f) on (M where the feed is its head); a later feed
  const int back_r = d > f ? mm - (d - f) : mm;
  const bool store_x = on && feed != head && p + mm > last &&
                       (eq_h >> p) <= 1u;
  const bool store_r = on && p + back_r > last && (same_f >> p) <= 1u;
  const int code = st << kFSrcT | sf << kFSrcF | (f == 0 ? kFF0 : 0) |
                   (store_x ? kStoreX : 0) | (store_r ? kStoreR : 0);
  // the depth, settled in rounds from the lanes below (sources lie below)
  const int lt = (st & 3) == kFromR ? st >> 2 : -1;
  const int lf = (sf & 3) == kFromR ? sf >> 2 : -1;
  int depth = 0;
  bool moved = __any_sync(kFull, lt >= 0 || lf >= 0);
  while (moved) {
    const int ut = __shfl_sync(kFull, depth, lt & 31);
    const int uf = __shfl_sync(kFull, depth, lf & 31);
    const int nd = max(lt >= 0 ? ut + 1 : 0, lf >= 0 ? uf + 1 : 0);
    moved = __any_sync(kFull, nd != depth);
    depth = nd;
  }
  depth = __reduce_max_sync(kFull, depth);
  // the x values its reads take (where they take one)
  const float xt = __shfl_sync(kFull, v.x, st >> 2);
  const float xf = __shfl_sync(kFull, v.x, sf >> 2);
  const int at = (n & 1) * kFwdChunk + i;
  m.rec[at] = make_int4(tail, feed, head, code | depth << kFDepth);
  m.xg[at] = make_float4(v.x, v.g, xt, xf);
}

// The chain warp's chunk of len steps from the records of parity par, a
// batch of 32 at a time, lane q on step b + q (each batch's records
// loaded a batch ahead).  Each lane loads the slots its step reads that
// no step before it in the batch wrote; a slot that one did (or its own
// head), it takes from that step: its x (in the records) or its r (a
// shuffle).  The first round computes every r from the loads and the x
// values; each round
// after recomputes them from their sources' r of the round before, in
// the serial order's rounding, so a step is right after as many rounds
// as its depth: the batch runs its steps' most.  Each slot the batch
// writes is stored once, by the step that writes it last (x or r).
template <bool kSmem>
__device__ __forceinline__ void fwd_chain_chunk(const FwdSmem& m, float* ring,
                                                int par, int len) {
  const int lane = threadIdx.x & 31;
  int4 rn = m.rec[par * kFwdChunk + lane];
  float4 vn = m.xg[par * kFwdChunk + lane];
  for (int b = 0; b < len; b += 32) {
    const int at = par * kFwdChunk + b + lane;
    const int4 r = rn;
    const float4 v = vn;
    if (b + 32 < len) {
      rn = m.rec[at + 32];
      vn = m.xg[at + 32];
    }
    const int code = r.w;
    const int st = code >> kFSrcT & 127, sf = code >> kFSrcF & 127;
    const int kt = st & 3, kf = sf & 3, lt = st >> 2, lf = sf >> 2;
    const unsigned depth = (unsigned)code >> kFDepth;
    // (the slots are always in the ring: the loads need no guard)
    const float bt = kt == kFromX ? v.z : ring[r.x];
    const float bf = kf == kFromX ? v.w : ring[r.y];
    float s = bt;
    float w = __fadd_rn(bf, __fmul_rn(s, v.y));
    for (unsigned q = 0; q < depth; ++q) {
      const float wt = __shfl_sync(kFull, w, lt);
      const float wf = __shfl_sync(kFull, w, lf);
      s = kt == kFromR ? wt : bt;
      w = __fadd_rn(kf == kFromR ? wf : bf, __fmul_rn(s, v.y));
    }
    // a warp's shared-memory accesses run in order: the batch's loads
    // before its stores (the scratch row's take a barrier)
    if (!kSmem) __syncwarp();
    if (code & kStoreX) ring[r.z] = v.x;
    if (code & kStoreR) ring[r.y] = w;
    m.ys[at] = make_float2(code & kFF0 ? w : s, s);
    __syncwarp();
  }
}

// A worker's share of slot s: the loads of chunk s + 2's inputs (into
// nxt), the L2 prefetch of chunk s + 3's, the records of chunk s + 1
// (from cur), chunk s - 1's y (and s).
template <bool kSave>
__device__ __forceinline__ void fwd_work(const Args& a, const FwdSmem& m,
                                         size_t tb, int s, int nch, int i,
                                         const FwdIn& cur, FwdIn& nxt) {
  nxt = fwd_load(a, tb, (s + 2) * kFwdChunk + i);
  fwd_prefetch(a, tb, s + 3, i);
  if (s + 1 < nch) fwd_produce(a, m, s + 1, cur, i);
  const int jo = (s - 1) * kFwdChunk + i;
  if (s > 0 && jo < a.t_n) {
    const float2 o = m.ys[((s - 1) & 1) * kFwdChunk + i];
    a.y[tb + jo] = o.x;
    if (kSave) a.s_save[tb + jo] = o.y;
  }
}

template <bool kSmem, bool kSave>
__global__ void __launch_bounds__(kFwdThreads) delay_kernel(Args a) {
  extern __shared__ __align__(16) float fwd_base[];
  const FwdSmem m = fwd_smem(fwd_base);
  const int row = blockIdx.x;
  const int mm = a.max_delay + 1;
  const size_t rb = (size_t)row * mm, tb = (size_t)row * a.t_n;
  float* ring = kSmem ? m.ring : a.scratch + rb;
  // the state's layout is the circular one at the head M - 1
  for (int j = threadIdx.x; j < mm; j += blockDim.x) ring[j] = a.buf_in[rb + j];
  const int nch = (a.t_n + kFwdChunk - 1) / kFwdChunk;
  const int warp = threadIdx.x >> 5, i = threadIdx.x - 32;
  // a worker's inputs of two chunks, in two register sets that the slots
  // take in turns
  FwdIn in0{}, in1{};
  if (warp > 0) {
    in0 = fwd_load(a, tb, i);
    in1 = fwd_load(a, tb, kFwdChunk + i);
    fwd_prefetch(a, tb, 2, i);
    fwd_produce(a, m, 0, in0, i);
  }
  __syncthreads();
  // slot s: the chain runs chunk s, the producers chunk s + 1, the
  // consumers write chunk s - 1 out
  for (int s = 0; s <= nch; ++s) {
    if (warp == 0) {
      if (s < nch)
        fwd_chain_chunk<kSmem>(m, ring, s & 1,
                               min(kFwdChunk, a.t_n - s * kFwdChunk));
    } else if (s & 1) {
      fwd_work<kSave>(a, m, tb, s, nch, i, in0, in1);
    } else {
      fwd_work<kSave>(a, m, tb, s, nch, i, in1, in0);
    }
    __syncthreads();
  }
  // back to the state's layout: the newest sample (at the final head
  // (M - 1 + T) mod M) at index M - 1
  const int h_end = (int)(((long long)mm - 1 + a.t_n) % mm);
  for (int j = threadIdx.x; j < mm; j += blockDim.x) {
    int k = h_end + 1 + j;
    if (k >= mm) k -= mm;
    a.buf_out[rb + j] = ring[k];
  }
}

struct BwdArgs {
  const float* g_y;      // [rows, T]
  const int* delay;      // [rows, T]
  const float* fgain;    // [rows, T]
  const int* fdelay;     // [rows, T]
  const float* s_save;   // [rows, T] the forward's s
  const float* g_out;    // [rows, M] cotangent of the outgoing ring
  float* g_in;           // [rows, M] cotangent of the incoming ring
  float* g_x;            // [rows, T]
  float* g_g;            // [rows, T] cotangent of fgain
  float* scratch;        // [rows, M] where lam is not in smem
  int t_n, max_delay;
};

// The adjoint's records in shared memory, two chunks each (by the chunk's
// parity), indexed by the step's place in its chunk (steps in reverse
// time): from the producers the slots (tail, feed, head), a code (where
// each read takes its value, see bwd_produce), g_y and fgain; from the
// chain g_x and lam[feed].  lam follows them.
struct BwdSmem {
  int *tail, *feed, *head, *code;
  float *gy, *g, *gx, *lf;
  float* lam;
};

constexpr int kBwdRecWords = 2 * 8 * kBwdChunk;

__device__ __forceinline__ BwdSmem bwd_smem(float* base) {
  BwdSmem m;
  int* w = reinterpret_cast<int*>(base);
  m.tail = w;
  m.feed = w + 2 * kBwdChunk;
  m.head = w + 4 * kBwdChunk;
  m.code = w + 6 * kBwdChunk;
  m.gy = base + 8 * kBwdChunk;
  m.g = base + 10 * kBwdChunk;
  m.gx = base + 12 * kBwdChunk;
  m.lf = base + 14 * kBwdChunk;
  m.lam = base + kBwdRecWords;
  return m;
}

// A step's code: where its three reads take their values, each as src + 1
// in six bits (src: -1 the batch's load, 0 .. 31 the W of that lane of
// the batch, 32 zero), then its flags and its depth: 0 where its tail
// and feed take no W from a lane, else one more than its sources' most.
constexpr int kSrcT = 0, kSrcF = 6, kSrcH = 12;
constexpr int kF0 = 1 << 18;        // f == 0: lam[feed] is its own lt
constexpr int kD0 = 1 << 19;        // d == 0: g_x is its own W
constexpr int kFD = 1 << 20;        // f == d != 0: g_x is its lam[feed]
constexpr int kStoreW = 1 << 21;    // the batch's last write of its tail
constexpr int kStoreZ = 1 << 22;    // the batch's last write of its head
constexpr int kDepth = 23;          // 5 bits: its W's rounds after the first

__device__ __forceinline__ int src_of(int code, int at) {
  return ((code >> at) & 63) - 1;
}

// src's value: the batch's load, zero, or lane src's w
__device__ __forceinline__ float take(int src, float pre, float w) {
  const float v = __shfl_sync(0xffffffffu, w, src & 31);
  return src < 0 ? pre : src == 32 ? 0.f : v;
}

// The chain warp's chunk of len steps from the records of parity par, a
// batch of 32 at a time, lane q on step b + q.  Each lane loads the slots
// its step reads that no step before it in the batch wrote; a slot that
// one did, it takes from that step: its W (a shuffle) or a zero.  The
// first round computes every W from the loads alone; each round after
// recomputes them from their sources' W of the round before, in the
// serial order's rounding, so a step is right after as many rounds as its
// depth: the batch runs its steps' most.  Each slot the batch writes is
// stored once, by the step that writes it last (W or zero).
__device__ __forceinline__ void bwd_chain_chunk(const BwdSmem& m, int par,
                                                int len) {
  const int lane = threadIdx.x & 31;
  float* lam = m.lam;
  for (int b = 0; b < len; b += 32) {
    const bool on = lane < len - b;
    const int at = par * kBwdChunk + b + lane;
    int ti = 0, fi = 0, hi = 0, code = 0;
    float gy = 0.f, gv = 0.f;
    if (on) {
      ti = m.tail[at];
      fi = m.feed[at];
      hi = m.head[at];
      code = m.code[at];
      gy = m.gy[at];
      gv = m.g[at];
    }
    const int st = src_of(code, kSrcT), sf = src_of(code, kSrcF),
              sh = src_of(code, kSrcH);
    const bool f0 = code & kF0;
    const unsigned depth = __reduce_max_sync(0xffffffffu,
                                             (unsigned)code >> kDepth);
    const bool h_lane = __any_sync(
        0xffffffffu, sh >= 0 && sh < 32 && !(code & (kD0 | kFD)));
    float a_pre = 0.f, lf_pre = 0.f, gx_pre = 0.f;
    if (on && st < 0) a_pre = lam[ti];
    if (on && !f0 && sf < 0) lf_pre = lam[fi];
    if (on && !(code & (kD0 | kFD)) && sh < 0) gx_pre = lam[hi];
    float lt = __fadd_rn(st < 0 ? a_pre : 0.f, gy);
    float lf = f0 ? lt : sf < 0 ? lf_pre : 0.f;
    float w = __fadd_rn(lt, __fmul_rn(lf, gv));
    for (unsigned r = 0; r < depth; ++r) {
      lt = __fadd_rn(take(st, a_pre, w), gy);
      const float tf = take(sf, lf_pre, w);
      lf = f0 ? lt : tf;
      w = __fadd_rn(lt, __fmul_rn(lf, gv));
    }
    const float th = h_lane ? take(sh, gx_pre, w) : sh < 0 ? gx_pre : 0.f;
    const float gx = code & kD0 ? w : code & kFD ? lf : th;
    if (code & kStoreW) lam[ti] = w;
    if (code & kStoreZ) lam[hi] = 0.f;
    if (on) {
      m.gx[at] = gx;
      m.lf[at] = lf;
    }
    __syncwarp();
  }
}

// A producer's inputs of one step: the delays, g_y and fgain as loaded
struct BwdIn {
  int d, f;
  float gy, g;
};

__device__ __forceinline__ BwdIn bwd_load(const BwdArgs& a, size_t tb,
                                          int j) {
  BwdIn v{0, 0, 0.f, 0.f};
  if (j < a.t_n) {
    const size_t t = tb + (a.t_n - 1 - j);
    v.d = __ldg(a.delay + t);
    v.f = __ldg(a.fdelay + t);
    v.gy = __ldg(a.g_y + t);
    v.g = __ldg(a.fgain + t);
  }
  return v;
}

// The L2 prefetch of chunk n's inputs: each warp the lines of its 32
// steps in the five rows it reads (the delays, g_y, fgain, s), at both
// ends of its samples.
__device__ __forceinline__ void bwd_prefetch(const BwdArgs& a, size_t tb,
                                             int n, int i) {
  const int j0 = n * kBwdChunk + (i & ~31), q = i & 31;
  if (q >= 10 || j0 >= a.t_n) return;
  const int j = q < 5 ? min(j0 + 31, a.t_n - 1) : j0;
  const size_t t = tb + (a.t_n - 1 - j);
  const int r = q % 5;
  const void* p = r == 0 ? (const void*)(a.delay + t)
                  : r == 1 ? (const void*)(a.fdelay + t)
                  : r == 2 ? (const void*)(a.g_y + t)
                  : r == 3 ? (const void*)(a.fgain + t)
                           : (const void*)(a.s_save + t);
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The producers' records of chunk n: thread i the step j = n kBwdChunk +
// i, sample t = T - 1 - j, a warp a batch (lane p = i % 32; the steps
// before it in the batch, at the samples t + 1 .. t + p, are the lanes
// below).  For each slot the step reads (tail; feed unless f == 0; head
// unless d == 0 or f == d), the step before it in the batch that wrote
// that slot last: a tail among the batch's tails (read back from shared
// memory), a head from the sample alone (the heads before run t + 1, t +
// 2, ... mod M), the head if both (a step writes its tail, then zeroes its
// head); and whether the step writes its tail or head last in the batch
// (no later step writes it: a tail among the later ones, the zero of the
// step d on, or of the step itself where d == 0; a later step M on zeroes
// the head again).
__device__ __forceinline__ void bwd_produce(const BwdArgs& a,
                                            const BwdSmem& m, int n,
                                            const BwdIn& v, int i) {
  const int mm = a.max_delay + 1, par = n & 1, p = i & 31;
  const int j = n * kBwdChunk + i;
  const bool on = j < a.t_n;
  const int t = a.t_n - 1 - j;
  const int d = min(max(v.d, 0), a.max_delay);
  const int f = min(max(v.f, 0), d);
  const int head = on ? t % mm : 0;
  int tail = head - d;
  if (tail < 0) tail += mm;
  int feed = tail + f;
  if (feed >= mm) feed -= mm;
  const int at = par * kBwdChunk + i, base = at - p;
  m.tail[at] = tail;
  m.feed[at] = feed;
  m.head[at] = head;
  m.gy[at] = v.gy;
  m.g[at] = v.g;
  const unsigned onm = __ballot_sync(0xffffffffu, on);
  const int last = 31 - __clz(onm);   // the batch's last step (onm != 0)
  const unsigned below = (1u << p) - 1u;   // the steps before it
  // the batch's steps with this tail (those beyond T with none)
  const unsigned same = __match_any_sync(0xffffffffu, on ? tail : -1 - p);
  const int kw_t = same & below ? 31 - __clz(same & below) : -1;
  const bool later_t = (same >> p) > 1u;
  __syncwarp();
  // the batch's steps whose tail is this step's feed, its head
  unsigned eq_f = 0u, eq_h = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int tk = m.tail[base + k];
    eq_f |= (unsigned)(tk == feed) << k;
    eq_h |= (unsigned)(tk == head) << k;
  }
  const int kw_f = eq_f & below ? 31 - __clz(eq_f & below) : -1;
  const int kw_h = eq_h & below ? 31 - __clz(eq_h & below) : -1;
  const bool later_h = (eq_h & onm & ~below) >> p > 1u;
  // the step before whose head is x
  auto zero_before = [&](int x) {
    int u = x - head;
    if (u < 0) u += mm;
    return p - (u == 0 ? mm : u);
  };
  auto src = [](int kw, int kz) {
    return kw < 0 && kz < 0 ? -1 : kz >= kw ? 32 : kw;
  };
  const int code =
      ((src(kw_t, zero_before(tail)) + 1) << kSrcT) |
      ((src(kw_f, zero_before(feed)) + 1) << kSrcF) |
      ((src(kw_h, zero_before(head)) + 1) << kSrcH) | (f == 0 ? kF0 : 0) |
      (d == 0 ? kD0 : 0) | (f == d && d != 0 ? kFD : 0) |
      (on && !later_t && p + d > last ? kStoreW : 0) |
      (on && !later_h && p + mm > last ? kStoreZ : 0);
  // the depth, settled in rounds from the lanes below (sources lie below)
  const int ls_t = src_of(code, kSrcT), ls_f = src_of(code, kSrcF);
  const int dt = on && ls_t >= 0 && ls_t < 32 ? ls_t : -1;
  const int df = on && f != 0 && ls_f >= 0 && ls_f < 32 ? ls_f : -1;
  int depth = 0;
  bool moved = __any_sync(0xffffffffu, dt >= 0 || df >= 0);
  while (moved) {
    const int ut = __shfl_sync(0xffffffffu, depth, dt & 31);
    const int uf = __shfl_sync(0xffffffffu, depth, df & 31);
    const int nd = max(dt >= 0 ? ut + 1 : 0, df >= 0 ? uf + 1 : 0);
    moved = __any_sync(0xffffffffu, nd != depth);
    depth = nd;
  }
  m.code[at] = code | depth << kDepth;
}

// A worker's share of slot s: the loads of chunk s + 2's inputs (into nxt)
// and s of chunk s (into sn), the L2 prefetch of chunk s + 3's, the
// records of chunk s + 1 (from cur), chunk s - 1's g_x and fgain's
// cotangent (with s from sv).
__device__ __forceinline__ void bwd_work(const BwdArgs& a, const BwdSmem& m,
                                         size_t tb, int s, int nch, int i,
                                         const BwdIn& cur, BwdIn& nxt,
                                         float sv, float& sn) {
  nxt = bwd_load(a, tb, (s + 2) * kBwdChunk + i);
  const int js = s * kBwdChunk + i;
  sn = js < a.t_n ? __ldg(a.s_save + tb + (a.t_n - 1 - js)) : 0.f;
  bwd_prefetch(a, tb, s + 3, i);
  if (s + 1 < nch) bwd_produce(a, m, s + 1, cur, i);
  const int jo = (s - 1) * kBwdChunk + i;
  if (s > 0 && jo < a.t_n) {
    const size_t t = tb + (a.t_n - 1 - jo);
    const int at = ((s - 1) & 1) * kBwdChunk + i;
    a.g_x[t] = m.gx[at];
    a.g_g[t] = __fmul_rn(m.lf[at], sv);
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kBwdThreads) delay_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float bwd_base[];
  BwdSmem m = bwd_smem(bwd_base);
  const int row = blockIdx.x;
  const int mm = a.max_delay + 1;
  const size_t rb = (size_t)row * mm, tb = (size_t)row * a.t_n;
  if (!kSmem) m.lam = a.scratch + rb;
  // the outgoing ring's cotangent, from the state's layout (index j at
  // the final head + 1 + j) to the circular one
  const int h_end = (int)(((long long)mm - 1 + a.t_n) % mm);
  for (int j = threadIdx.x; j < mm; j += blockDim.x) {
    int k = h_end + 1 + j;
    if (k >= mm) k -= mm;
    m.lam[k] = a.g_out[rb + j];
  }
  const int nch = (a.t_n + kBwdChunk - 1) / kBwdChunk;
  const int warp = threadIdx.x >> 5, i = threadIdx.x - 32;
  // a worker's inputs of two chunks and s of one, in two register sets
  // that the slots take in turns
  BwdIn in0{}, in1{};
  float s0 = 0.f, s1 = 0.f;
  if (warp > 0) {
    in0 = bwd_load(a, tb, i);
    in1 = bwd_load(a, tb, kBwdChunk + i);
    bwd_prefetch(a, tb, 2, i);
    bwd_produce(a, m, 0, in0, i);
  }
  __syncthreads();
  // slot s: the chain runs chunk s, the producers chunk s + 1, the
  // consumers write chunk s - 1 out
  for (int s = 0; s <= nch; ++s) {
    if (warp == 0) {
      if (s < nch)
        bwd_chain_chunk(m, s & 1, min(kBwdChunk, a.t_n - s * kBwdChunk));
    } else if (s & 1) {
      bwd_work(a, m, tb, s, nch, i, in0, in1, s1, s0);
    } else {
      bwd_work(a, m, tb, s, nch, i, in1, in0, s0, s1);
    }
    __syncthreads();
  }
  // what is left: the incoming ring's cotangent (its head was M - 1, so
  // the circular layout is the state's)
  for (int j = threadIdx.x; j < mm; j += blockDim.x) a.g_in[rb + j] = m.lam[j];
}

// The ring (or lam) in shared memory beside rec_words of records, or 0
// where it does not fit
size_t ring_smem_bytes(int rec_words, int max_delay) {
  const size_t b = sizeof(float) * ((size_t)rec_words + max_delay + 1);
  return b <= kMaxSmem ? b : 0;
}

template <bool kSave>
int launch_fwd(const Args& a, int rows, int max_delay, bool in_smem,
               cudaStream_t s) {
  if (in_smem) {
    const size_t b = ring_smem_bytes(kFwdRecWords, max_delay);
    if (b == 0) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem<delay_kernel<true, kSave>>(b);
    if (err != cudaSuccess) return (int)err;
    delay_kernel<true, kSave><<<rows, kFwdThreads, b, s>>>(a);
  } else {
    delay_kernel<false, kSave><<<rows, kFwdThreads,
                                 sizeof(float) * kFwdRecWords, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward's dynamic shared memory with the ring in it, or 0 where the
// ring does not fit beside its records (the wrapper then passes a scratch
// row).
int lsp_delay_smem_bytes(int max_delay) {
  return (int)ring_smem_bytes(kFwdRecWords, max_delay);
}

// The adjoint's dynamic shared memory with lam in it, or 0 where lam does
// not fit beside its records (the wrapper then passes a scratch row).
int lsp_delay_bwd_smem_bytes(int max_delay) {
  return (int)ring_smem_bytes(kBwdRecWords, max_delay);
}

int lsp_delay_chain_ops() { return kChainOps; }

int lsp_delay_bwd_chain_ops() { return kBwdChainOps; }

int lsp_dynamic_delay_save(const float* x, const int* delay,
                           const float* fgain, const int* fdelay,
                           const float* buf_in, float* buf_out, float* y,
                           float* scratch, float* s_save, int rows, int t_n,
                           int max_delay, void* stream) {
  const Args a{x, delay, fgain, fdelay, buf_in, buf_out, y, scratch, s_save,
               t_n, max_delay};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s_save == nullptr)
    return launch_fwd<false>(a, rows, max_delay, scratch == nullptr, s);
  return launch_fwd<true>(a, rows, max_delay, scratch == nullptr, s);
}

// The adjoint, a block a row, lam in shared memory beside the records
// (scratch == nullptr; lsp_delay_bwd_smem_bytes > 0) or in a global
// scratch row.  Returns a cudaError_t.
int lsp_dynamic_delay_bwd(const float* g_y, const int* delay,
                          const float* fgain, const int* fdelay,
                          const float* s_save, const float* g_out,
                          float* g_in, float* g_x, float* g_g,
                          float* scratch, int rows, int t_n, int max_delay,
                          void* stream) {
  const BwdArgs a{g_y, delay, fgain, fdelay, s_save, g_out, g_in, g_x, g_g,
                  scratch, t_n, max_delay};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const size_t b = ring_smem_bytes(kBwdRecWords, max_delay);
    if (b == 0) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem<delay_bwd_kernel<true>>(b);
    if (err != cudaSuccess) return (int)err;
    delay_bwd_kernel<true><<<rows, kBwdThreads, b, s>>>(a);
  } else {
    delay_bwd_kernel<false><<<rows, kBwdThreads,
                              sizeof(float) * kBwdRecWords, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// A block a row.  scratch == nullptr keeps the ring in shared memory
// beside the records (lsp_delay_smem_bytes > 0); s_save != nullptr also
// writes each step's s.  Returns a cudaError_t.
int lsp_dynamic_delay(const float* x, const int* delay, const float* fgain,
                      const int* fdelay, const float* buf_in, float* buf_out,
                      float* y, float* scratch, int rows, int t_n,
                      int max_delay, void* stream) {
  return lsp_dynamic_delay_save(x, delay, fgain, fdelay, buf_in, buf_out, y,
                                scratch, nullptr, rows, t_n, max_delay,
                                stream);
}

}  // extern "C"
