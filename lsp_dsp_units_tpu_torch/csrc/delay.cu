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
// What bounds it: the chain through memory.  A step's reads of the ring
// may alias the previous step's feedback write, so each step loads after
// the last one stored: a shared-memory load, a multiply, an add and a
// store a sample (kChainOps = 4; the load's latency is well above the 4
// cycles the chain bound gives each operation).  The bytes (x, the
// delay, gain and feedback delay in, y out, the ring in and out) are far
// below it.  Rows are the only parallelism.  The design is the simple
// one: one warp per row, one row per block; the warp moves the ring
// between the state's layout and shared memory, one lane runs the chain
// over register tiles of kTile samples.  The ring is circular in shared
// memory with a head index, so a step touches three slots where the JAX
// step shifts the whole buffer; the state keeps the JAX layout (the
// newest sample at index M - 1), converted at the call's ends only.
// Rings above what shared memory holds (227 KB) live in a global scratch
// row instead (delay_kernel<false>, the same code).  A design that loaded
// a step ahead and forwarded the two values those loads miss from
// registers (no shared-memory round trip on the chain) took 1.0385 ms
// at [64, 16384] against this one's 1.1021, in turns in one call
// (NVIDIA H100 80GB HBM3, 700 W; tools/ab_kernels.py against a variant
// tree): the step's index arithmetic, issued by one lane, costs more
// than the round trip.
//
// Every product and sum rounds as the plain version and the JAX step
// round them (s * g rounded, then added; __fmul_rn, __fadd_rn), so the
// three agree bit for bit.
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
// and the incoming ring's cotangent is what is left of lam.  Its chain is
// a load, an add and a store of lam[tail], the load of lam[feed], the
// multiply and the second add and store (kBwdChainOps = 6), on lane 0 as
// the forward's.  It rounds as ops/delay.py's dynamic_delay_bwd_plain, bit
// for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kChainOps = 4;          // load, multiply, add, store
constexpr int kBwdChainOps = 6;       // load, add, load, multiply, add, store
constexpr size_t kMaxSmem = 232448;   // 227 KB a block

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

// The slots a step reads and writes at head h: tail = h - d, feed = tail
// + f (mod m).
__device__ __forceinline__ void slots(int m, int h, int maxd, int dv, int fv,
                                      int& tail, int& feed, int& f) {
  const int d = min(max(dv, 0), maxd);
  f = min(max(fv, 0), d);
  tail = h - d;
  if (tail < 0) tail += m;
  feed = tail + f;
  if (feed >= m) feed -= m;
}

// One step on ring[0, m) at head h (already advanced); returns y, and s.
__device__ __forceinline__ float step(float* ring, int m, int h, int maxd,
                                      float xv, int dv, float gv, int fv,
                                      float& s) {
  ring[h] = xv;
  int tail, feed, f;
  slots(m, h, maxd, dv, fv, tail, feed, f);
  s = ring[tail];
  const float r = __fadd_rn(ring[feed], __fmul_rn(s, gv));
  ring[feed] = r;
  return f == 0 ? r : s;
}

template <bool kSmem, bool kSave>
__global__ void __launch_bounds__(32) delay_kernel(Args a) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const int m = a.max_delay + 1;
  const size_t rb = (size_t)row * m, tb = (size_t)row * a.t_n;
  float* ring = kSmem ? smem : a.scratch + rb;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    ring[j] = a.buf_in[rb + j];
  }
  __syncwarp();
  int h = m - 1;
  if (threadIdx.x == 0) {
    const float* x = a.x + tb;
    const int* dl = a.delay + tb;
    const float* g = a.fgain + tb;
    const int* fd = a.fdelay + tb;
    float* y = a.y + tb;
    float* sv_row = kSave ? a.s_save + tb : nullptr;
    int t0 = 0;
    for (; t0 + kTile <= a.t_n; t0 += kTile) {
      float xv[kTile], gv[kTile], yv[kTile], sv[kTile];
      int dv[kTile], fv[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        xv[j] = __ldg(x + t0 + j);
        dv[j] = __ldg(dl + t0 + j);
        gv[j] = __ldg(g + t0 + j);
        fv[j] = __ldg(fd + t0 + j);
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        h = h + 1 == m ? 0 : h + 1;
        yv[j] = step(ring, m, h, a.max_delay, xv[j], dv[j], gv[j], fv[j],
                     sv[j]);
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) y[t0 + j] = yv[j];
      if (kSave) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) sv_row[t0 + j] = sv[j];
      }
    }
    for (; t0 < a.t_n; ++t0) {
      h = h + 1 == m ? 0 : h + 1;
      float s;
      y[t0] = step(ring, m, h, a.max_delay, __ldg(x + t0), __ldg(dl + t0),
                   __ldg(g + t0), __ldg(fd + t0), s);
      if (kSave) sv_row[t0] = s;
    }
  }
  __syncwarp();
  // back to the state's layout: the newest sample (at the final head
  // (M - 1 + T) mod M) at index M - 1
  const int h_end = (int)(((long long)m - 1 + a.t_n) % m);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    int k = h_end + 1 + j;
    if (k >= m) k -= m;
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

// One step of the adjoint at head h on lam[0, m); returns g_x, and fgain's
// cotangent in gg.
__device__ __forceinline__ float bwd_step(float* lam, int m, int h, int maxd,
                                          float gy, int dv, float gv, int fv,
                                          float sv, float& gg) {
  int tail, feed, f;
  slots(m, h, maxd, dv, fv, tail, feed, f);
  const float lt = __fadd_rn(lam[tail], gy);
  lam[tail] = lt;
  const float lf = lam[feed];
  gg = __fmul_rn(lf, sv);
  lam[tail] = __fadd_rn(lt, __fmul_rn(lf, gv));
  const float gx = lam[h];
  lam[h] = 0.f;
  return gx;
}

template <bool kSmem>
__global__ void __launch_bounds__(32) delay_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const int m = a.max_delay + 1;
  const size_t rb = (size_t)row * m, tb = (size_t)row * a.t_n;
  float* lam = kSmem ? smem : a.scratch + rb;
  // the outgoing ring's cotangent, from the state's layout (index j at
  // the final head + 1 + j) to the circular one
  const int h_end = (int)(((long long)m - 1 + a.t_n) % m);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    int k = h_end + 1 + j;
    if (k >= m) k -= m;
    lam[k] = a.g_out[rb + j];
  }
  __syncwarp();
  if (threadIdx.x == 0) {
    const float* gyr = a.g_y + tb;
    const int* dl = a.delay + tb;
    const float* g = a.fgain + tb;
    const int* fd = a.fdelay + tb;
    const float* sr = a.s_save + tb;
    float* gx = a.g_x + tb;
    float* gg = a.g_g + tb;
    int t1 = a.t_n;   // steps t1 - 1 down to 0 remain
    for (; t1 % kTile; --t1) {
      const int t = t1 - 1;
      float ggv;
      gx[t] = bwd_step(lam, m, t % m, a.max_delay, __ldg(gyr + t),
                       __ldg(dl + t), __ldg(g + t), __ldg(fd + t),
                       __ldg(sr + t), ggv);
      gg[t] = ggv;
    }
    for (; t1 > 0; t1 -= kTile) {
      const int t0 = t1 - kTile;
      float yv[kTile], gv[kTile], sv[kTile], xo[kTile], go[kTile];
      int dv[kTile], fv[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        yv[j] = __ldg(gyr + t0 + j);
        dv[j] = __ldg(dl + t0 + j);
        gv[j] = __ldg(g + t0 + j);
        fv[j] = __ldg(fd + t0 + j);
        sv[j] = __ldg(sr + t0 + j);
      }
      int h = (t1 - 1) % m;
#pragma unroll
      for (int j = kTile - 1; j >= 0; --j) {
        xo[j] = bwd_step(lam, m, h, a.max_delay, yv[j], dv[j], gv[j], fv[j],
                         sv[j], go[j]);
        h = h == 0 ? m - 1 : h - 1;
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        gx[t0 + j] = xo[j];
        gg[t0 + j] = go[j];
      }
    }
  }
  __syncwarp();
  // what is left: the incoming ring's cotangent (its head was M - 1, so
  // the circular layout is the state's)
  for (int j = threadIdx.x; j < m; j += blockDim.x) a.g_in[rb + j] = lam[j];
}

size_t smem_bytes(int max_delay) {
  const size_t b = sizeof(float) * ((size_t)max_delay + 1);
  return b <= kMaxSmem ? b : 0;
}

template <bool kSave>
int launch_fwd(const Args& a, int rows, int max_delay, bool in_smem,
               cudaStream_t s) {
  if (in_smem) {
    const size_t b = smem_bytes(max_delay);
    if (b == 0) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        delay_kernel<true, kSave>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b);
    if (err != cudaSuccess) return (int)err;
    delay_kernel<true, kSave><<<rows, 32, b, s>>>(a);
  } else {
    delay_kernel<false, kSave><<<rows, 32, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the ring for max_delay, or 0 where it does not
// fit (the wrapper then passes a scratch row).
int lsp_delay_smem_bytes(int max_delay) { return (int)smem_bytes(max_delay); }

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

// The adjoint, one warp a row, lam where the forward keeps its ring
// (scratch == nullptr: shared memory).  Returns a cudaError_t.
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
    const size_t b = smem_bytes(max_delay);
    if (b == 0) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        delay_bwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)b);
    if (err != cudaSuccess) return (int)err;
    delay_bwd_kernel<true><<<rows, 32, b, s>>>(a);
  } else {
    delay_bwd_kernel<false><<<rows, 32, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// One warp a row.  scratch == nullptr keeps the ring in shared memory;
// s_save != nullptr also writes each step's s.  Returns a cudaError_t.
int lsp_dynamic_delay(const float* x, const int* delay, const float* fgain,
                      const int* fdelay, const float* buf_in, float* buf_out,
                      float* y, float* scratch, int rows, int t_n,
                      int max_delay, void* stream) {
  return lsp_dynamic_delay_save(x, delay, fgain, fdelay, buf_in, buf_out, y,
                                scratch, nullptr, rows, t_n, max_delay,
                                stream);
}

}  // extern "C"
