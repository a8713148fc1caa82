// The sequential biquad cascade: the exact per-sample DF2T recurrence of
// ops/biquad.py's biquad_cascade_seq / dyn_biquad_cascade_seq.
//
//   for each sample t, for each stage k (in order):
//     yi      = c0 * y + s1
//     s1      = (c1 * y + c3 * yi) + s2
//     s2      = c2 * y + c4 * yi
//     y       = yi
//
// with the state [rows, K, 2] carried in and out and the coefficients
// shared (row stride 0) or per row (static_kernel), or per sample
// ([rows, T, K, 5], a time stride of K * 5: dyn_kernel).
//
// Replaces the lax.scan of the JAX package's ops/biquad.py
// (biquad_cascade_seq, dyn_biquad_cascade_seq), which XLA compiles into a
// loop over samples; it is no Pallas kernel.
//
// What bounds it: the recurrence.  Within a stage, s1 feeds the next
// sample through four dependent operations (+ s1, c3 * yi, + c1 * y,
// + s2): T x 4 x 4 cycles.  The bytes (x in, y out, the per-sample
// coefficients) are far below that.  The parallelism is only the rows
// (64 channels in the main configuration) and the stages, so both kernels
// pipeline the stages of a row over chunks of time:
//
// - One block a row: the chain warp, whose lane k runs stage k0 + k of
//   the launch's group of up to 32 stages, and kIoWarps copy warps.  The
//   block moves in slots, one block barrier each.  At slot s lane k runs
//   chunk s - k (kChunk samples) of its stage: it reads the chunk's input
//   from shared memory, where stage k - 1 wrote it at slot s - 1 (stage
//   0's, x, the copy warps), and writes its output there for stage k + 1.
//   Each stage's input has two chunk buffers, by the chunk's parity, so a
//   stage writes one while the next reads the other.  A chunk's only
//   dependent path is the stage's own recurrence: its inputs come from
//   shared memory kBatch steps at a time (16-byte loads, the next batch's
//   issued before this one runs), its outputs go back as 16-byte stores,
//   and no shuffle or load waits on the chain.  The pipeline fills and
//   drains over kg - 1 slots.  A cascade of K > 32 stages runs as
//   ceil(K / 32) launches, each group's output the next one's input (the
//   wrapper chains them).
// - The copy warps, at slot s: the inputs of slot s + 1 by cp.async (x's
//   chunk s + 1; per sample each stage k's coefficients of its chunk
//   s + 1 - k, into two chunk buffers of [5][kChunk] per stage, so that
//   the chain reads each coefficient of four steps as one 16-byte word),
//   with an L2 prefetch of chunk s + 2; then the outputs of slot s - 1
//   from shared memory, coalesced: the last stage's chunk into y and,
//   saving, every stage's chunk into its signal.
// - A partial last chunk runs step by step; no stage ever runs a sample
//   outside [0, T), so the state is left as the plain loop leaves it.
//
// Why chunks: a stage's input passed a sample at a time (a shuffle from
// the lane before) puts the shuffle on every step's dependent path (~42
// cycles a step at K = 9 on the H100 against the recurrence's 16), and
// per-sample coefficients loaded by the chain lanes, from records 80 B
// apart, ~204.
//
// Every product and sum rounds once (__fmul_rn, __fadd_rn, no FMA
// contraction) in the plain PyTorch loop's order, as torch's separate
// element-wise ops do, so the kernels and their plain versions agree bit
// for bit.
//
// Under autograd (lsp_biquad_seq_save) each kernel's kSave form also
// writes every stage's output: stage k0 + k's y at save[k0 + k + 1][row]
// [t], so that save [K + 1, rows, T] (row 0 the input, copied by the
// wrapper) holds each stage's input and output for the adjoint of
// csrc/biquad_bwd.cu.  The copy warps store them; the chain is the same
// in both forms.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "smem_attr.cuh"

namespace {

constexpr int kLanes = 32;     // stages per launch, one chain lane each
constexpr int kChunk = 128;    // samples a slot
constexpr int kBatch = 16;     // static_kernel's steps a register batch
constexpr int kDynBatch = 8;   // dyn_kernel's (five coefficients a step)
// the copy warps: more for the per-sample form's coefficients (6 and 3
// measured best against 4 and 8, NVIDIA H100 80GB HBM3 at 700 W,
// tools/ab_kernels.py against variant trees)
template <bool kDyn>
constexpr int kIoWarps = kDyn ? 6 : 3;
template <bool kDyn>
constexpr int kThreads = 32 * (1 + kIoWarps<kDyn>);
// a stage's buffers: two chunks each, the lanes' rows spread over the
// banks so that a step's lanes (16-byte words: 8 at a time) meet no
// conflict
constexpr int kSigStride = 2 * kChunk + 4;        // input, by parity
constexpr int kCoefStride = 2 * 5 * kChunk + 4;   // [parity][5][kChunk]

static_assert(kSigStride % 32 == 4 && kCoefStride % 32 == 4,
              "a step's lanes on distinct banks");
static_assert(kChunk % kBatch == 0 && kChunk % kDynBatch == 0 &&
                  kDynBatch % 4 == 0 && kBatch % 4 == 0,
              "whole 16-byte batches in a whole chunk");

struct Args {
  const float* x;      // [rows, T]
  const float* c;      // coefficients, see row_stride / t_stride
  const float* s_in;   // [rows, K, 2]
  float* y;            // [rows, T]
  float* s_out;        // [rows, K, 2]
  float* save;         // kSave: [K + 1, rows, T] stage signals
  int t_n, k_n, k0, kg;
  long long row_stride, t_stride;   // in floats
};

struct Lane {
  float s1, s2, y;
  float c0, c1, c2, c3, c4;
};

// One stage of one sample, rounded as the plain loop rounds it.
__device__ __forceinline__ void stage(Lane& l, float yin) {
  const float yi = __fadd_rn(__fmul_rn(l.c0, yin), l.s1);
  const float n1 =
      __fadd_rn(__fadd_rn(__fmul_rn(l.c1, yin), __fmul_rn(l.c3, yi)), l.s2);
  const float n2 = __fadd_rn(__fmul_rn(l.c2, yin), __fmul_rn(l.c4, yi));
  l.s1 = n1;
  l.s2 = n2;
  l.y = yi;
}

__host__ __device__ constexpr size_t smem_floats(bool dyn, int kg) {
  return (size_t)(kg + 1) * kSigStride + (dyn ? (size_t)kg * kCoefStride : 0);
}

__device__ __forceinline__ int chunk_len(const Args& a, int n) {
  return min(kChunk, a.t_n - n * kChunk);
}

// stage k's input buffer of chunk n (stage kg's: the group's output)
__device__ __forceinline__ float* sig_buf(float* sig, int k, int n) {
  return sig + k * kSigStride + (n & 1) * kChunk;
}

// stage k's coefficients of chunk n, [5][kChunk]
__device__ __forceinline__ float* coef_buf(float* coef, int k, int n) {
  return coef + k * kCoefStride + (n & 1) * 5 * kChunk;
}

template <int kB>
__device__ __forceinline__ void load4(float (&v)[kB], const float* p) {
#pragma unroll
  for (int q = 0; q < kB / 4; ++q) {
    const float4 w = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
}

// a batch's inputs (and per sample its coefficients) from shared memory
template <bool kDyn, int kB>
__device__ __forceinline__ void load_batch(float (&xv)[kB],
                                           float (&cv)[5][kB],
                                           const float* in, const float* cs,
                                           int b) {
  load4<kB>(xv, in + b);
  if (kDyn) {
#pragma unroll
    for (int q = 0; q < 5; ++q) load4<kB>(cv[q], cs + q * kChunk + b);
  }
}

// The chain lane's chunk of len steps: input in, output out, per sample
// the coefficients cs [5][kChunk].  A whole chunk runs kB steps at a time
// through registers, a partial one step by step.
template <bool kDyn>
__device__ __forceinline__ void chain_chunk(Lane& l, const float* in,
                                            float* out, const float* cs,
                                            int len) {
  if (len < kChunk) {
    for (int i = 0; i < len; ++i) {
      if (kDyn) {
        l.c0 = cs[i];
        l.c1 = cs[kChunk + i];
        l.c2 = cs[2 * kChunk + i];
        l.c3 = cs[3 * kChunk + i];
        l.c4 = cs[4 * kChunk + i];
      }
      stage(l, in[i]);
      out[i] = l.y;
    }
    return;
  }
  constexpr int kB = kDyn ? kDynBatch : kBatch;
  float xv[kB], xn[kB], yv[kB];
  float cv[5][kB], cn[5][kB];
  load_batch<kDyn, kB>(xv, cv, in, cs, 0);
#pragma unroll
  for (int b = 0; b < kChunk; b += kB) {
    if (b + kB < kChunk) load_batch<kDyn, kB>(xn, cn, in, cs, b + kB);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      if (kDyn) {
        l.c0 = cv[0][i];
        l.c1 = cv[1][i];
        l.c2 = cv[2][i];
        l.c3 = cv[3][i];
        l.c4 = cv[4][i];
      }
      stage(l, xv[i]);
      yv[i] = l.y;
    }
#pragma unroll
    for (int q = 0; q < kB / 4; ++q)
      reinterpret_cast<float4*>(out + b)[q] =
          make_float4(yv[4 * q], yv[4 * q + 1], yv[4 * q + 2], yv[4 * q + 3]);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      xv[i] = xn[i];
      if (kDyn) {
#pragma unroll
        for (int q = 0; q < 5; ++q) cv[q][i] = cn[q][i];
      }
    }
  }
}

// The copy warps' share of slot s: the copies of slot s + 1's inputs and
// the L2 prefetch of chunk s + 2's; the outputs of the chunks the chain
// ran in slot s - 1; then the wait for the copies.
template <bool kDyn, bool kSave>
__device__ __forceinline__ void io_slot(const Args& a, int s, int nch,
                                        float* sig, float* coef, int tid,
                                        int n_thr) {
  const size_t r = blockIdx.x;
  const size_t row = r * a.t_n;
  const int n1 = s + 1, n2 = s + 2;
  if (n1 < nch) {
    const float* src = a.x + row + (size_t)n1 * kChunk;
    float* dst = sig_buf(sig, 0, n1);
    for (int i = tid; i < chunk_len(a, n1); i += n_thr)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
  }
  if (n2 < nch && tid * 32 < chunk_len(a, n2))
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        a.x + row + (size_t)n2 * kChunk + tid * 32));
  if (kDyn) {
    const float* c_row = a.c + r * a.row_stride + a.k0 * 5;
    // stage k's coefficients of chunk s + 1 - k
    for (int k = 0; k < a.kg; ++k) {
      const int n = n1 - k;
      if (n < 0 || n >= nch) continue;
      const int len5 = chunk_len(a, n) * 5;
      const float* src = c_row + (size_t)n * kChunk * a.t_stride + k * 5;
      float* dst = coef_buf(coef, k, n);
      for (int e = tid; e < len5; e += n_thr) {
        const int i = e / 5, q = e - 5 * i;
        __pipeline_memcpy_async(dst + q * kChunk + i,
                                src + (size_t)i * a.t_stride + q,
                                sizeof(float));
      }
    }
    // the records of chunk s + 2 (all of the group's stages; the later
    // stages read them from L2 on their slots)
    if (n2 < nch) {
      const char* lo = reinterpret_cast<const char*>(
          c_row + (size_t)n2 * kChunk * a.t_stride);
      const size_t bytes =
          ((size_t)(chunk_len(a, n2) - 1) * a.t_stride + a.kg * 5) *
          sizeof(float);
      for (size_t o = (size_t)tid * 128; o < bytes; o += (size_t)n_thr * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(lo + o));
    }
  }
  __pipeline_commit();
  // the last stage's chunk s - kg into y; saving, each stage k's chunk
  // s - 1 - k into its signal
  const int ny = s - a.kg;
  if (ny >= 0 && ny < nch) {
    const float* src = sig_buf(sig, a.kg, ny);
    float* dst = a.y + row + (size_t)ny * kChunk;
    for (int i = tid; i < chunk_len(a, ny); i += n_thr) dst[i] = src[i];
  }
  if (kSave) {
    const size_t plane = (size_t)gridDim.x * a.t_n;
    for (int it = tid; it < a.kg * kChunk; it += n_thr) {
      const int k = it / kChunk, i = it % kChunk, n = s - 1 - k;
      if (n < 0 || n >= nch || i >= chunk_len(a, n)) continue;
      a.save[(a.k0 + k + 1) * plane + row + (size_t)n * kChunk + i] =
          sig_buf(sig, k + 1, n)[i];
    }
  }
  __pipeline_wait_prior(0);
}

template <bool kDyn, bool kSave>
__device__ __forceinline__ void run(const Args& a, float* smem) {
  float* sig = smem;
  float* coef = smem + (size_t)(a.kg + 1) * kSigStride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t r = blockIdx.x;
  const int nch = (a.t_n + kChunk - 1) / kChunk;
  const bool live = warp == 0 && lane < a.kg;
  const size_t s_at = (r * a.k_n + a.k0 + lane) * 2;

  Lane l{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    l.s1 = a.s_in[s_at];
    l.s2 = a.s_in[s_at + 1];
    if (!kDyn) {
      const float* c = a.c + r * a.row_stride + (a.k0 + lane) * 5;
      l.c0 = c[0];
      l.c1 = c[1];
      l.c2 = c[2];
      l.c3 = c[3];
      l.c4 = c[4];
    }
  }
  const int io_tid = threadIdx.x - 32, io_thr = kThreads<kDyn> - 32;
  if (warp > 0) io_slot<kDyn, kSave>(a, -1, nch, sig, coef, io_tid, io_thr);
  __syncthreads();
  // the last stage runs the last chunk at slot nch + kg - 2; the copy
  // warps write it out at the next
  const int slots = nch + a.kg;
  for (int s = 0; s < slots; ++s) {
    if (warp == 0) {
      const int n = s - lane;
      if (live && n >= 0 && n < nch)
        chain_chunk<kDyn>(l, sig_buf(sig, lane, n), sig_buf(sig, lane + 1, n),
                          coef_buf(coef, lane, n), chunk_len(a, n));
    } else {
      io_slot<kDyn, kSave>(a, s, nch, sig, coef, io_tid, io_thr);
    }
    __syncthreads();
  }
  if (live) {
    a.s_out[s_at] = l.s1;
    a.s_out[s_at + 1] = l.s2;
  }
}

template <bool kSave>
__global__ void __launch_bounds__(kThreads<false>) static_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  run<false, kSave>(a, smem);
}

template <bool kSave>
__global__ void __launch_bounds__(kThreads<true>) dyn_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  run<true, kSave>(a, smem);
}

template <bool kDyn, bool kSave>
int launch_form(const Args& a, int rows, cudaStream_t s) {
  constexpr auto kernel = kDyn ? dyn_kernel<kSave> : static_kernel<kSave>;
  const size_t bytes = smem_floats(kDyn, a.kg) * sizeof(float);
  const cudaError_t err = allow_smem<kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows, kThreads<kDyn>, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kSave>
int launch(const Args& a, int rows, int dyn, cudaStream_t s) {
  return dyn ? launch_form<true, kSave>(a, rows, s)
             : launch_form<false, kSave>(a, rows, s);
}

bool bad(int rows, int t_n, int k_n, int k0, int kg) {
  return kg < 1 || kg > kLanes || k0 < 0 || k0 + kg > k_n || rows < 1 ||
         t_n < 1;
}

}  // namespace

extern "C" {

// One launch: stages k0 .. k0 + kg - 1 (kg <= 32) of a K-stage cascade
// over rows x T samples.  Returns a cudaError_t.
int lsp_biquad_seq(const float* x, const float* c, const float* s_in,
                   float* y, float* s_out, int rows, int t_n, int k_n,
                   int k0, int kg, long long row_stride, long long t_stride,
                   int dyn, void* stream) {
  if (bad(rows, t_n, k_n, k0, kg)) return (int)cudaErrorInvalidValue;
  const Args a{x,  c,  s_in, y,  s_out,      nullptr, t_n,
               k_n, k0, kg,   row_stride, t_stride};
  return launch<false>(a, rows, dyn, (cudaStream_t)stream);
}

// The same launch, also writing each stage's output y into
// save[k + 1] [rows, T] (save [K + 1, rows, T]).
int lsp_biquad_seq_save(const float* x, const float* c, const float* s_in,
                        float* y, float* s_out, float* save, int rows,
                        int t_n, int k_n, int k0, int kg,
                        long long row_stride, long long t_stride, int dyn,
                        void* stream) {
  if (bad(rows, t_n, k_n, k0, kg) || save == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{x,  c,  s_in, y,  s_out,      save,    t_n,
               k_n, k0, kg,   row_stride, t_stride};
  return launch<true>(a, rows, dyn, (cudaStream_t)stream);
}

}  // extern "C"
