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
// sample through four dependent operations (c3 * yi, + c1 * y, + s2, and
// the next sample's + s1): T x 4 x 4 cycles.  The bytes (x in, y out,
// the per-sample coefficients) are far below that.  The parallelism is
// only the rows (64 channels in the main configuration), so both kernels
// run the stages of a row side by side as a systolic pipeline:
//
// - One warp per row (one block each), lane k runs stage k0 + k of the
//   launch's group of up to 32 stages.  At step j lane k works on sample
//   j - k: lane 0 takes x[j], every other lane the y its left neighbour
//   made at step j - 1 (one shuffle).  The last lane writes y.  A cascade
//   of K > 32 stages runs as ceil(K / 32) launches, each group's output
//   the next one's input (the wrapper chains them).
// - No load from global memory is waited on in a step.  static_kernel:
//   x reaches a ring in shared memory by one coalesced load a lane per
//   tile of 32 steps, stored a tile later, and lane 0 reads it with a
//   broadcast load a step.  dyn_kernel: x stays in the tile's registers
//   and reaches lane 0 by a second shuffle; each lane's five per-sample
//   coefficients come through a ring of registers kAhead steps ahead, and
//   the launch's part of the row kL2Ahead samples on is prefetched into
//   L2 (a 128-byte line a lane).
// - Steps where some lane's sample lies outside [0, T) (the first tile,
//   whose lanes start one by one, and the last tiles, whose lanes drain)
//   run a guarded body that leaves such lanes' state alone; the steady
//   tiles run the body without the guard.
//
// On the H100 the step's chain runs through the shuffle: ~42 cycles a
// step for static_kernel at the chain's K = 9, against the recurrence's
// 16.  ptxas's schedule of that chain moves with the code around it, so
// each form has its own kernel, of the design that measured best for it
// (NVIDIA H100 80GB HBM3 at 700 W, [64, 16384], tools/ab_kernels.py:
// static, the x ring 0.351 ms against x by shuffle 0.433; per sample, x
// by shuffle with the register ring 1.59 ms in one kernel that ran both
// forms (its static form the 0.433), against 1.80 with the x ring and
// 3.45 and 2.73 with the coefficient rows through shared memory, by
// cp.async a step or stored from registers in chunks of 8).  As a
// kernel of its own beside static_kernel, as here, dyn_kernel measures
// 1.68-1.69 ms: the split keeps the static form at 0.351 ms and costs
// the per-sample form ~6 %.  Each kernel writes out its own tile loop:
// one templated loop shared by both, the tile bodies passed as lambdas,
// moved ptxas's schedule of dyn_kernel to 1.787 ms against 1.689
// (static_kernel 0.343 against 0.350), same card, same call.
//
// Every product and sum rounds once (__fmul_rn, __fadd_rn, no FMA
// contraction) in the plain PyTorch loop's order, as torch's separate
// element-wise ops do, so the kernels and their plain versions agree bit
// for bit.
//
// Under autograd (lsp_biquad_seq_save) each kernel's kSave form also
// writes every stage's output: lane k stores the y of stage k0 + k at
// save[k0 + k + 1][row][t], so that save [K + 1, rows, T] (row 0 the
// input, copied by the wrapper) holds each stage's input and output for
// the adjoint of csrc/biquad_bwd.cu.  The stores leave the chain alone;
// kSave = false is the inference kernel as it was.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;     // stages per launch, one lane each
constexpr int kTile = 32;      // steps per tile
constexpr int kRing = 128;     // samples held by static_kernel's x ring
constexpr int kAhead = 16;     // dyn_kernel's coefficients, steps ahead
constexpr int kL2Ahead = 96;   // their L2 prefetch, samples ahead
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRing % kTile == 0, "x ring of whole tiles");
static_assert(kTile % kAhead == 0, "ring slots repeat within a tile");

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
__device__ __forceinline__ void stage(Lane& l, float yin, bool keep) {
  const float yi = __fadd_rn(__fmul_rn(l.c0, yin), l.s1);
  const float n1 =
      __fadd_rn(__fadd_rn(__fmul_rn(l.c1, yin), __fmul_rn(l.c3, yi)), l.s2);
  const float n2 = __fadd_rn(__fmul_rn(l.c2, yin), __fmul_rn(l.c4, yi));
  if (keep) {
    l.s1 = n1;
    l.s2 = n2;
  }
  l.y = yi;
}

__device__ __forceinline__ float load_x(const float* x_row, int t, int t_n) {
  return t < t_n ? __ldg(x_row + t) : 0.f;
}

__device__ __forceinline__ void load_state(Lane& l, const Args& a,
                                           size_t s_at) {
  if (threadIdx.x < a.kg) {
    l.s1 = a.s_in[s_at];
    l.s2 = a.s_in[s_at + 1];
  }
}

__device__ __forceinline__ void store_state(const Lane& l, const Args& a,
                                            size_t s_at) {
  if (threadIdx.x < a.kg) {
    a.s_out[s_at] = l.s1;
    a.s_out[s_at + 1] = l.s2;
  }
}

// This lane's stage output at sample t, into the saved signals.
template <bool kSave>
__device__ __forceinline__ void save_y(const Lane& l, const Args& a,
                                       bool in, int t) {
  if (kSave && in && (int)threadIdx.x < a.kg)
    a.save[((size_t)(a.k0 + threadIdx.x + 1) * gridDim.x + blockIdx.x) *
               a.t_n + t] = l.y;
}

// static_kernel's 32 steps of tile m (steps j = 32 m + i).  kGuard: some
// lane's sample j - lane may lie outside [0, T).
template <bool kGuard, bool kSave>
__device__ __forceinline__ void static_tile(Lane& l, const Args& a, int m,
                                            const float* xs, float* y_row) {
  const int lane = threadIdx.x;
  const float* xt = xs + ((m * kTile) & (kRing - 1));
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int t = m * kTile + i - lane;   // this lane's sample
    const float up = __shfl_up_sync(kFull, l.y, 1);
    const float yin = lane == 0 ? xt[i] : up;
    const bool in = !kGuard || (t >= 0 && t < a.t_n);
    stage(l, yin, in);
    if (in && lane == a.kg - 1) y_row[t] = l.y;
    save_y<kSave>(l, a, in, t);
  }
}

template <bool kSave>
__global__ void __launch_bounds__(kLanes) static_kernel(Args a) {
  extern __shared__ float xs[];   // [kRing] x by sample
  const int lane = threadIdx.x;
  const size_t r = blockIdx.x;
  const float* x_row = a.x + r * a.t_n;
  float* y_row = a.y + r * a.t_n;
  const float* c_lane = a.c + r * a.row_stride + (a.k0 + lane) * 5;
  const size_t s_at = (r * a.k_n + a.k0 + lane) * 2;

  Lane l{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  load_state(l, a, s_at);
  if (lane < a.kg) {
    l.c0 = c_lane[0];
    l.c1 = c_lane[1];
    l.c2 = c_lane[2];
    l.c3 = c_lane[3];
    l.c4 = c_lane[4];
  }
  // x of tile 0 stored, tile 1's in flight in a register
  xs[lane] = load_x(x_row, lane, a.t_n);
  float x_next = load_x(x_row, kTile + lane, a.t_n);
  __syncwarp();

  const int steps = a.t_n + a.kg - 1;
  const int tiles = (steps + kTile - 1) / kTile;
  for (int m = 0; m < tiles; ++m) {
    // tile m + 1's x (loaded a tile ago) to the ring, tile m + 2's loaded
    xs[((m + 1) * kTile + lane) & (kRing - 1)] = x_next;
    x_next = load_x(x_row, (m + 2) * kTile + lane, a.t_n);
    __syncwarp();
    if (m == 0 || m * kTile + kTile > a.t_n)
      static_tile<true, kSave>(l, a, m, xs, y_row);
    else
      static_tile<false, kSave>(l, a, m, xs, y_row);
  }
  store_state(l, a, s_at);
}

// This lane's stage coefficients of sample t (left as they are outside
// [0, T) or for a lane without a stage).
__device__ __forceinline__ void fetch(float (&c)[5], const Args& a,
                                      const float* c_lane, int t) {
  if (threadIdx.x < a.kg && t >= 0 && t < a.t_n) {
    const float* p = c_lane + t * a.t_stride;
#pragma unroll
    for (int q = 0; q < 5; ++q) c[q] = __ldg(p + q);
  }
}

// dyn_kernel's 32 steps of tile m; xt holds x[32 m + lane].
template <bool kGuard, bool kSave>
__device__ __forceinline__ void dyn_tile(Lane& l, const Args& a, int m,
                                         float xt, float (&ring)[kAhead][5],
                                         const float* c_grp, float* y_row) {
  const int lane = threadIdx.x;
  const float* c_lane = c_grp + lane * 5;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int t = m * kTile + i - lane;   // this lane's sample
    float(&c)[5] = ring[i % kAhead];
    l.c0 = c[0];
    l.c1 = c[1];
    l.c2 = c[2];
    l.c3 = c[3];
    l.c4 = c[4];
    fetch(c, a, c_lane, t + kAhead);
    const int tp = m * kTile + i + kL2Ahead;
    if (lane * 32 < a.kg * 5 && tp < a.t_n)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          c_grp + tp * a.t_stride + lane * 32));
    const float xin = __shfl_sync(kFull, xt, i);
    const float up = __shfl_up_sync(kFull, l.y, 1);
    const float yin = lane == 0 ? xin : up;
    const bool in = !kGuard || (t >= 0 && t < a.t_n);
    stage(l, yin, in);
    if (in && lane == a.kg - 1) y_row[t] = l.y;
    save_y<kSave>(l, a, in, t);
  }
}

template <bool kSave>
__global__ void __launch_bounds__(kLanes) dyn_kernel(Args a) {
  const int lane = threadIdx.x;
  const size_t r = blockIdx.x;
  const float* x_row = a.x + r * a.t_n;
  float* y_row = a.y + r * a.t_n;
  const float* c_grp = a.c + r * a.row_stride + a.k0 * 5;
  const float* c_lane = c_grp + lane * 5;
  const size_t s_at = (r * a.k_n + a.k0 + lane) * 2;

  Lane l{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  load_state(l, a, s_at);
  float ring[kAhead][5] = {};
#pragma unroll
  for (int s = 0; s < kAhead; ++s) fetch(ring[s], a, c_lane, s - lane);

  // x of this lane's sample in the current tile and the next (the next
  // one's load issued a tile before its use, and never moved while in
  // flight)
  float x0 = load_x(x_row, lane, a.t_n);
  float x1 = load_x(x_row, kTile + lane, a.t_n);
  const int steps = a.t_n + a.kg - 1;
  const int tiles = (steps + kTile - 1) / kTile;
  for (int m = 0; m < tiles; ++m) {
    if (m == 0 || m * kTile + kTile > a.t_n)
      dyn_tile<true, kSave>(l, a, m, x0, ring, c_grp, y_row);
    else
      dyn_tile<false, kSave>(l, a, m, x0, ring, c_grp, y_row);
    x0 = x1;
    x1 = load_x(x_row, (m + 2) * kTile + lane, a.t_n);
  }
  store_state(l, a, s_at);
}

template <bool kSave>
int launch(const Args& a, int rows, int dyn, cudaStream_t s) {
  if (dyn)
    dyn_kernel<kSave><<<rows, kLanes, 0, s>>>(a);
  else
    static_kernel<kSave><<<rows, kLanes, kRing * sizeof(float), s>>>(a);
  return (int)cudaGetLastError();
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
