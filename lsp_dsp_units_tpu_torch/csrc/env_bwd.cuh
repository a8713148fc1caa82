// The peak-hold envelope's adjoint on one thread block, shared by
// csrc/env_units.cu (peak_envelope_bwd_kernel) and csrc/env.cu
// (chain_dyn_bwd): the branch each step took, then the cotangent in
// reverse time.
//
// The adjoint of the scan body (lsp_dsp_units_tpu/ops/dynamics.py:102-123)
// needs each step's branch, a code a sample (bits 0-1: the tau of the
// update, 0 none, 1 release, 2 attack; bit 2: the step set the peak; the
// codes of ops/env_units.py).  The step's new envelope is the forward's
// output, so the codes follow from the level x, the envelope env and the
// incoming state by the peak and hold recurrences alone (code_step).
//
// What bounds the backward: the reverse cotangent, serial in time within a
// row: lam + g, + lp, * tau, lv - gx a step, of which 3 stay on the chain
// once lp is 0 (below).  Everything else is moved off that chain:
//
// * The codes in parallel.  Call a step "free" when the peak equals the
//   envelope before it and no hold is left.  From a free step the code is
//   a function of x[t], e[t - 1] and e[t] alone (free_code): a fall sets
//   the peak with the release or attack tau, a rise that reaches e[t - 1]
//   sets it with the attack tau; and with a hold time of 0 samples both
//   leave the next step free.  The one exception is a rise that stays
//   below e[t - 1] (a "break": code _RISE; it cannot happen where the forward
//   computed env with a tau >= 0 from finite levels, but a NaN or an
//   envelope from elsewhere makes one).  So with a hold time of 0 every
//   thread derives free_code for its samples; thread 0 runs code_step from
//   the incoming state until a batch boundary at which the state is free
//   (the serial prefix), and again from each break until the state is
//   free once more.  Since the codes are discrete, the result is the serial
//   pass's, exactly.  Where the envelope can hold (a hold time > 0) the
//   serial pass runs over the whole row, kBatch steps at a time from
//   registers.
// * The reverse pass keeps only lam's chain on thread 0, kBatch steps at
//   a time from registers (16-byte shared-memory loads and stores), every
//   select made a mask of the code's bits (rel_mask), none on the chain; a
//   batch whose codes all set the peak with a tau (every code of the free
//   route) is an add, a multiply and a subtraction a step (reverse_lam).
//   Thread 32 carries the taus' sums behind it (reverse_acc).  Each
//   step's lv is stored; the x cotangent, kind ? lv * tau : 0, is formed
//   afterwards by the whole block (gx_of).
// * The row is staged in shared memory once, with cp.async where the rows
//   are 16-byte aligned, so no load waits on device memory inside a serial
//   pass.
//
// Every product and sum is rounded alone in the order of the loop of
// ops/env_units.peak_envelope_bwd_plain, the adds of a zero lp included,
// so the outputs are bit for bit that plain version's.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace envbwd {

// The codes of ops/env_units.py (0, 2, 5, 6) in bits 0-2, with two flags
// for masks (rel_mask): bit 7 marks the release tau, bit 6 any tau.
constexpr uint32_t kHoldCode = 0, kRiseCode = 0x42, kFallTrCode = 0xc5,
                   kSetTaCode = 0x46;
constexpr int kBatch = 32;        // steps a serial batch holds in registers
constexpr int kTile = 128;        // samples a break flag covers (a warp)

// One row (or a segment of one) in shared memory.  env[i] is the envelope
// after step i, eb the one before step 0; lv starts as the envelope's
// cotangent and ends as each step's lv.  Each array 16-byte aligned.
struct Seg {
  float* x;            // [len] the level
  float* env;          // [len]
  float* lv;           // [len]
  uint8_t* codes;      // [len]
  uint32_t* brk;       // a bit a tile: its free codes hold a break
  int len;
  float eb;
  // steps [free_lo, free_hi) hold free codes with no break (thread 0's,
  // from segment_codes; empty unless set there)
  int free_lo, free_hi;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// dst[i] = src[i], i < n, by the block: 16-byte cp.async where both are
// aligned, else plain loads.  The caller waits with stage_wait().
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int n) {
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (vec) {
    for (int i = 4 * threadIdx.x; i + 4 <= n; i += 4 * blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_u32(dst + i)), "l"(src + i) : "memory");
    const int tail = n & ~3;
    if ((int)threadIdx.x < n - tail) dst[tail + threadIdx.x] =
        src[tail + threadIdx.x];
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The envelope before step i.
__device__ __forceinline__ float e_before(const Seg& s, int i) {
  return i > 0 ? s.env[i - 1] : s.eb;
}

// One step of the peak and hold recurrences from the saved envelope
// (e before the step, en after it): the step's code.
template <bool kUseRt>
__device__ __forceinline__ uint32_t code_step(float xv, float e, float en,
                                              float rt, int nh, float& peak,
                                              int& hold) {
  const bool falling = __fsub_rn(xv, e) < 0.0f;
  const bool holding = hold > 0;
  const bool peaked = !falling && en >= peak;
  const uint32_t fall = (!kUseRt || e > rt) ? kFallTrCode : kSetTaCode;
  const uint32_t code = falling ? (holding ? kHoldCode : fall)
                                : (peaked ? kSetTaCode : kRiseCode);
  peak = (falling && !holding) || peaked ? en : peak;
  hold = falling ? (holding ? hold - 1 : hold) : (peaked ? nh : hold);
  return code;
}

// The code of a step that starts free (peak == e, no hold left).
template <bool kUseRt>
__device__ __forceinline__ uint32_t free_code(float xv, float e, float en,
                                              float rt) {
  const bool falling = __fsub_rn(xv, e) < 0.0f;
  const uint32_t fall = (!kUseRt || e > rt) ? kFallTrCode : kSetTaCode;
  return falling ? fall : (en >= e ? kSetTaCode : kRiseCode);
}

// kBatch steps of code_step from step i (a multiple of kBatch), x and env
// in registers, the codes stored four to a word.
template <bool kUseRt>
__device__ __forceinline__ void code_batch(const Seg& s, int i, float rt,
                                           int nh, float& peak, int& hold) {
  float xv[kBatch], ev[kBatch];
  const float4* x4 = reinterpret_cast<const float4*>(s.x + i);
  const float4* e4 = reinterpret_cast<const float4*>(s.env + i);
#pragma unroll
  for (int j = 0; j < kBatch / 4; ++j) {
    const float4 a = x4[j], b = e4[j];
    xv[4 * j] = a.x; xv[4 * j + 1] = a.y; xv[4 * j + 2] = a.z;
    xv[4 * j + 3] = a.w;
    ev[4 * j] = b.x; ev[4 * j + 1] = b.y; ev[4 * j + 2] = b.z;
    ev[4 * j + 3] = b.w;
  }
  float e = e_before(s, i);
  uint32_t cw[kBatch / 4];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const uint32_t code = code_step<kUseRt>(xv[k], e, ev[k], rt, nh, peak,
                                            hold);
    cw[k / 4] = (k & 3) ? cw[k / 4] | code << (8 * (k & 3)) : code;
    e = ev[k];
  }
  uint4* c4 = reinterpret_cast<uint4*>(s.codes + i);
#pragma unroll
  for (int j = 0; j < kBatch / 16; ++j)
    c4[j] = make_uint4(cw[4 * j], cw[4 * j + 1], cw[4 * j + 2],
                       cw[4 * j + 3]);
}

__device__ __forceinline__ bool is_free(const Seg& s, int i, float peak,
                                        int hold) {
  return hold == 0 && peak == e_before(s, i);
}

// code_step from step i over the segment (thread 0).  kStop: return the
// first batch boundary (or the tail's start) at which the state is free;
// else run to the end.  Returns the step reached.
template <bool kUseRt, bool kStop>
__device__ int serial_codes(const Seg& s, int i, float rt, int nh,
                            float& peak, int& hold) {
  const int n = s.len;
  for (; i < n && i % kBatch != 0; ++i)
    s.codes[i] = (uint8_t)code_step<kUseRt>(s.x[i], e_before(s, i), s.env[i],
                                            rt, nh, peak, hold);
  for (; i + kBatch <= n; i += kBatch) {
    if (kStop && is_free(s, i, peak, hold)) return i;
    code_batch<kUseRt>(s, i, rt, nh, peak, hold);
  }
  if (kStop && i < n && is_free(s, i, peak, hold)) return i;
  for (; i < n; ++i)
    s.codes[i] = (uint8_t)code_step<kUseRt>(s.x[i], e_before(s, i), s.env[i],
                                            rt, nh, peak, hold);
  return n;
}

// Every step's free_code by the block, four a thread, a warp a tile, and
// a flag a tile with a break.  The caller zeroes s.brk before.
template <bool kUseRt>
__device__ void free_codes(const Seg& s, float rt) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int tile = threadIdx.x >> 5; tile * kTile < s.len; tile += warps) {
    const int i = tile * kTile + 4 * lane;
    uint32_t cw = 0;
    bool brk = false;
    if (i < s.len) {
      const float4 xv = *reinterpret_cast<const float4*>(s.x + i);
      const float4 ev = *reinterpret_cast<const float4*>(s.env + i);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const float es[4] = {ev.x, ev.y, ev.z, ev.w};
      float e = e_before(s, i);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t code = free_code<kUseRt>(xs[k], e, es[k], rt);
        brk = brk || (i + k < s.len && code == kRiseCode);
        cw |= code << (8 * k);
        e = es[k];
      }
      *reinterpret_cast<uint32_t*>(s.codes + i) = cw;
    }
    if (__ballot_sync(0xffffffffu, brk) != 0 && lane == 0)
      atomicOr(&s.brk[tile >> 5], 1u << (tile & 31));
  }
}

// The first break at or after step i (where s.codes still holds
// free_code), or s.len.
__device__ int next_break(const Seg& s, int i) {
  int tile = i / kTile;
  while (tile * kTile < s.len) {
    const uint32_t bits = s.brk[tile >> 5] >> (tile & 31);
    if (bits == 0) {
      tile = ((tile >> 5) + 1) << 5;
      continue;
    }
    tile += __ffs(bits) - 1;
    const int end = min(s.len, (tile + 1) * kTile);
    for (int j = max(i, tile * kTile); j < end; ++j)
      if (s.codes[j] == kRiseCode) return j;
    ++tile;
  }
  return s.len;
}

// The segment's codes in s.codes, from the state (peak, hold) before its
// first step, which becomes the state after its last (thread 0's).  With
// kFree (a hold time of 0 samples): free codes by the block, thread 0 from
// the incoming state until free and from each break until free again;
// else thread 0 alone over the segment.  The block's work begins and ends
// at a __syncthreads; between them, threads other than 0 run `beside`.
template <bool kUseRt, bool kFree, typename Beside>
__device__ void segment_codes(Seg& s, float rt, int nh, float& peak,
                              int& hold, Beside beside) {
  if (kFree) {
    free_codes<kUseRt>(s, rt);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (kFree) {
      int i = serial_codes<kUseRt, true>(s, 0, rt, nh, peak, hold);
      bool first = true;
      while (i < s.len) {
        const int tb = next_break(s, i);
        if (first) {
          s.free_lo = i;
          s.free_hi = tb;
          first = false;
        }
        if (tb >= s.len) {             // free to the end
          peak = s.env[s.len - 1];
          hold = 0;
          break;
        }
        peak = e_before(s, tb);        // the free state before the break
        hold = 0;
        s.codes[tb] = (uint8_t)code_step<kUseRt>(s.x[tb], peak, s.env[tb],
                                                 rt, nh, peak, hold);
        i = serial_codes<kUseRt, true>(s, tb + 1, rt, nh, peak, hold);
      }
    } else {
      serial_codes<kUseRt, false>(s, 0, rt, nh, peak, hold);
    }
  }
  beside();
  __syncthreads();
}

// All ones where byte `byte` of w has bit 7 set, else 0 (prmt's sign
// mode): of a code word, the release tau; of it shifted left by 1, any
// tau (bit 6); shifted by 5, a step that sets the peak (bit 2).
__device__ __forceinline__ uint32_t rel_mask(uint32_t w, int byte) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(m) : "r"(w), "r"(0u), "r"(0x8888u | (uint32_t)byte * 0x1111u));
  return m;
}

// v where the mask is all ones, +0 where it is 0 (a select without a
// predicate: the bits of +0 are 0)
__device__ __forceinline__ float masked(float v, uint32_t m) {
  return __uint_as_float(__float_as_uint(v) & m);
}

// x's cotangent of a step from its code and lv (the reverse step's gx).
__device__ __forceinline__ float gx_of(uint32_t code, float lv, float ta,
                                       float tr) {
  const uint32_t kind = code & 3;
  return kind ? __fmul_rn(lv, kind == 1 ? tr : ta) : 0.0f;
}

// The reverse pass is the plain loop's step split over two threads: thread
// 0 carries the envelope's and the peak's cotangents (lam, lp) and stores
// each step's lv; thread 32 (warp 1, on another scheduler) follows batch
// by batch and carries the taus' sums, lv (x - e) added into the release
// or the attack tau's.  `done` is the lowest step whose lv is stored.
constexpr int kPublish = 8 * kBatch;   // steps between thread 0's reports

// lam's step for any code (the plain loop's roundings in its order).
__device__ __forceinline__ float lam_step(uint32_t code, float g, float ta,
                                          float tr, float& lam, float& lp) {
  float lv = __fadd_rn(lam, g);
  const bool sets = (code & 4) != 0;
  lv = sets ? __fadd_rn(lv, lp) : lv;
  lp = sets ? 0.0f : lp;
  const uint32_t kind = code & 3;
  const float gx = kind ? __fmul_rn(lv, kind == 1 ? tr : ta) : 0.0f;
  lam = kind ? __fsub_rn(lv, gx) : lv;
  return lv;
}

// The taus' step for any code: d = x - e before the step.
__device__ __forceinline__ void acc_step(uint32_t code, float lv, float d,
                                         float& acc_ta, float& acc_tr) {
  const uint32_t kind = code & 3;
  const float pp = __fmul_rn(lv, d);
  acc_tr = __fadd_rn(acc_tr, kind == 1 ? pp : 0.0f);
  acc_ta = __fadd_rn(acc_ta, kind == 2 ? pp : 0.0f);
}

__device__ __forceinline__ void publish(int* done, int i) {
  asm volatile("fence.acq_rel.cta;" ::: "memory");
  *reinterpret_cast<volatile int*>(done) = i;
}

__device__ __forceinline__ void await(const int* done, int i) {
  while (*reinterpret_cast<const volatile int*>(done) > i) {
  }
  asm volatile("fence.acq_rel.cta;" ::: "memory");
}

// kN floats (and a batch's codes, below) from a 16-byte aligned address
// into registers, the top first: the reverse pass starts there
template <int kN>
__device__ __forceinline__ void load4(const float* src, float* v) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int j = kN / 4 - 1; j >= 0; --j) {
    const float4 a = s4[j];
    v[4 * j] = a.x; v[4 * j + 1] = a.y; v[4 * j + 2] = a.z;
    v[4 * j + 3] = a.w;
  }
}

__device__ __forceinline__ void load_codes(const uint8_t* src,
                                           uint32_t* cw) {
  const uint4* c4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int j = kBatch / 16 - 1; j >= 0; --j) {
    const uint4 v = c4[j];
    cw[4 * j] = v.x; cw[4 * j + 1] = v.y; cw[4 * j + 2] = v.z;
    cw[4 * j + 3] = v.w;
  }
}

// A batch whose codes all set the peak with a tau (5 or 6 of
// ops/env_units.py: every free code but a break).
__device__ __forceinline__ bool all_set(const uint32_t* cw) {
  uint32_t all = cw[0];
#pragma unroll
  for (int j = 1; j < kBatch / 4; ++j) all &= cw[j];
  return (all & 0x04040404u) == 0x04040404u;
}

// Thread 0: lam over the segment in reverse time, the ragged end one step
// at a time, then batches of kBatch from registers.  In a batch of codes
// that set the peak, lp is +0 after its first step, and (lam + g) + 0
// rounds as lam + (g + 0) (the sum is -0 only where both are), so g + 0
// is formed off the chain, which is then an add, a multiply and a
// subtraction a step; the tau comes from a mask (rel_mask), not a select.
__device__ void reverse_lam(const Seg& s, float ta, float tr, float& lam,
                            float& lp, int* done) {
  const int whole = s.len / kBatch * kBatch;
  for (int i = s.len - 1; i >= whole; --i)
    s.lv[i] = lam_step(s.codes[i], s.lv[i], ta, tr, lam, lp);
  publish(done, whole);
  const uint32_t ta_u = __float_as_uint(ta);
  const uint32_t flip = ta_u ^ __float_as_uint(tr);
  for (int b = whole - kBatch; b >= 0; b -= kBatch) {
    float g[kBatch];
    uint32_t cw[kBatch / 4];
    load_codes(s.codes + b, cw);
    load4<kBatch>(s.lv + b, g);
    if ((b >= s.free_lo && b + kBatch <= s.free_hi) || all_set(cw)) {
      constexpr int k0 = kBatch - 1;
      float lv = __fadd_rn(__fadd_rn(lam, g[k0]), lp);
      lp = 0.0f;
      float tau = __uint_as_float(ta_u ^ (flip & rel_mask(cw[k0 / 4], 3)));
      lam = __fsub_rn(lv, __fmul_rn(lv, tau));
      g[k0] = lv;
#pragma unroll
      for (int k = k0 - 1; k >= 0; --k) {
        const float g0 = __fadd_rn(g[k], 0.0f);
        lv = __fadd_rn(lam, g0);
        tau = __uint_as_float(ta_u ^ (flip & rel_mask(cw[k / 4], k & 3)));
        lam = __fsub_rn(lv, __fmul_rn(lv, tau));
        g[k] = lv;
        if (k % 4 == 0)
          reinterpret_cast<float4*>(s.lv + b)[k / 4] =
              make_float4(g[k], g[k + 1], g[k + 2], g[k + 3]);
      }
    } else {
      // masks for the same values as lam_step's selects: lv + (-0) is lv,
      // and lv - (+0) too
      uint32_t lp_u = __float_as_uint(lp);
#pragma unroll
      for (int k = kBatch - 1; k >= 0; --k) {
        const uint32_t w = cw[k / 4];
        const uint32_t m_set = rel_mask(w << 5, k & 3);
        const uint32_t m_kind = rel_mask(w << 1, k & 3);
        const float tau =
            __uint_as_float(ta_u ^ (flip & rel_mask(w, k & 3)));
        const float lpz =
            __uint_as_float((lp_u & m_set) | (0x80000000u & ~m_set));
        lp_u &= ~m_set;
        const float lv = __fadd_rn(__fadd_rn(lam, g[k]), lpz);
        lam = __fsub_rn(lv, masked(__fmul_rn(lv, tau), m_kind));
        g[k] = lv;
        if (k % 4 == 0)
          reinterpret_cast<float4*>(s.lv + b)[k / 4] =
              make_float4(g[k], g[k + 1], g[k + 2], g[k + 3]);
      }
      lp = __uint_as_float(lp_u);
    }
    if (b % kPublish == 0) publish(done, b);
  }
}

// Thread 32: the taus' sums behind thread 0, in the same order.
__device__ void reverse_acc(const Seg& s, float& acc_ta, float& acc_tr,
                            const int* done) {
  const int whole = s.len / kBatch * kBatch;
  await(done, whole);
  for (int i = s.len - 1; i >= whole; --i)
    acc_step(s.codes[i], s.lv[i], __fsub_rn(s.x[i], e_before(s, i)), acc_ta,
             acc_tr);
  for (int b = whole - kBatch; b >= 0; b -= kBatch) {
    if (b % kPublish == kPublish - kBatch || b == whole - kBatch)
      await(done, b - b % kPublish);
    float lv[kBatch], xv[kBatch], ev[kBatch];
    uint32_t cw[kBatch / 4];
    load4<kBatch>(s.lv + b, lv);
    load4<kBatch>(s.x + b, xv);
    load4<kBatch>(s.env + b, ev);
    load_codes(s.codes + b, cw);
    const float e0 = e_before(s, b);
    if (all_set(cw)) {
#pragma unroll
      for (int k = kBatch - 1; k >= 0; --k) {
        const float pp = __fmul_rn(
            lv[k], __fsub_rn(xv[k], k > 0 ? ev[k - 1] : e0));
        const uint32_t m = rel_mask(cw[k / 4], k & 3);
        acc_tr = __fadd_rn(acc_tr, masked(pp, m));
        acc_ta = __fadd_rn(acc_ta, masked(pp, ~m));
      }
    } else {
#pragma unroll
      for (int k = kBatch - 1; k >= 0; --k)
        acc_step((cw[k / 4] >> (8 * (k & 3))) & 0xffu, lv[k],
                 __fsub_rn(xv[k], k > 0 ? ev[k - 1] : e0), acc_ta, acc_tr);
    }
  }
}

}  // namespace envbwd
