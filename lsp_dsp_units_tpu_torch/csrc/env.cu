// Fused dynamics tail, one thread block per channel: sidechain sliding
// RMS over a carried window -> peak-hold envelope with release threshold
// -> two-knee compressor gain -> y = x * gain.
//
// Replaces the TPU kernel ops/pallas_env.py::chain_dyn_pallas of the JAX
// package (_chain_dyn_kernel, _accum_skip, _env_step).
//
// What bounds it: the envelope.  It is a nonlinear recurrence, serial in
// time within a channel, so the main path's 64 channels give 64 serial
// chains of T = 8192 dependent steps (a few FP32 latencies each), one per
// SM, while HBM traffic is only ~4 MB per block.  The design takes
// everything else off that chain: the squares, the rolling sum (a block
// scan of the per-sample window differences), the level sweep and the
// exp/log knee gain run across all threads of the block; one thread runs
// only the envelope, reading levels from and writing envelopes to shared
// memory.  Mapping the serial chain better onto the card is later work.
//
// Tolerance: the rolling sum is associated as rsum0 + an inclusive scan
// of (new - old) squares, where the TPU kernel added per-8-sample skip
// prefixes to a running sum; both differ from the staged cumsum form by
// float32 rounding only (see ops/env.py).

#include <cuda_runtime.h>

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

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;       // envelope levels held in registers

__device__ __forceinline__ float knee_gain(const LspKnee& k, float ax,
                                           float lx) {
  if (ax <= k.start) return k.gain;
  if (ax >= k.end) return expf(lx * k.tilt0 + k.tilt1);
  return expf((k.herm0 * lx + k.herm1) * lx + k.herm2);
}

// One peak-hold envelope step (reference Compressor.cpp:231-256): returns
// the new envelope.  Falling below the release threshold uses the attack
// tau, as the TPU kernel's _env_step with use_rt.
__device__ __forceinline__ float env_step(float x, float& e, float& peak,
                                          int& hold, const LspDynParams& p) {
  const float d = x - e;
  const bool falling = d < 0.0f;
  const bool holding = hold > 0;
  const float tau_dn = e > p.rt ? p.tr : p.ta;
  const float e_fall = e + tau_dn * d;
  const float e_rise = e + p.ta * d;
  const bool rise_peaked = !falling && e_rise >= peak;
  const float new_e = falling ? (holding ? e : e_fall) : e_rise;
  peak = falling ? (holding ? peak : e_fall) : (rise_peaked ? e_rise : peak);
  hold = falling ? (holding ? hold - 1 : hold) : (rise_peaked ? p.nh : hold);
  e = new_e;
  return e;
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
  float* lev = smem;                   // [t_n]: rsum -> level -> envelope
  float* frame = smem + t_n;           // [n_win + t_n]: window || squares
  __shared__ float s_tot[kWarps];
  __shared__ float s_rsum0;
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* xr = x + (size_t)c * t_n;

  float part = 0.0f;
  for (int i = threadIdx.x; i < n_win; i += blockDim.x) {
    const float v = win[(size_t)c * n_win + i];
    frame[i] = v;
    part += v;
  }
  for (int t = threadIdx.x; t < t_n; t += blockDim.x) {
    const float v = fabsf(xr[t]) * p.g;
    frame[n_win + t] = v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) s_tot[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = 0.0f;
    for (int i = 0; i < kWarps; ++i) r += s_tot[i];
    s_rsum0 = r;
  }
  __syncthreads();

  // rolling sum: rsum[t] = rsum0 + sum_{s <= t} (sq[s] - old[s]), as a
  // block scan over contiguous per-thread chunks
  const int chunk = (t_n + blockDim.x - 1) / blockDim.x;
  const int t0 = threadIdx.x * chunk;
  const int t1 = min(t0 + chunk, t_n);
  float run = 0.0f;
  for (int t = t0; t < t1; ++t) {
    run += frame[n_win + t] - frame[t];
    lev[t] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_tot[warp] = incl;
  __syncthreads();
  float base = s_rsum0;
  for (int i = 0; i < warp; ++i) base += s_tot[i];
  base += incl - run;                  // exclusive prefix of this thread
  for (int t = t0; t < t1; ++t)
    lev[t] = sqrtf(fmaxf((base + lev[t]) * p.inv_n, 0.0f));
  __syncthreads();

  // envelope: serial in t, one thread.  Levels come through registers,
  // kBatch at a time with vector loads (lev starts the 16-byte aligned
  // shared block), so no step waits on shared memory and no step of a
  // full batch carries a bounds check.
  if (threadIdx.x == 0) {
    float e = env_in[c], peak = peak_in[c];
    int hold = hold_in[c];
    const int t_full = t_n - t_n % kBatch;
    for (int t0 = 0; t0 < t_full; t0 += kBatch) {
      float4 lv[kBatch / 4];
      float4* l4 = reinterpret_cast<float4*>(lev + t0);
#pragma unroll
      for (int q = 0; q < kBatch / 4; ++q) lv[q] = l4[q];
#pragma unroll
      for (int q = 0; q < kBatch / 4; ++q) {
        lv[q].x = env_step(lv[q].x, e, peak, hold, p);
        lv[q].y = env_step(lv[q].y, e, peak, hold, p);
        lv[q].z = env_step(lv[q].z, e, peak, hold, p);
        lv[q].w = env_step(lv[q].w, e, peak, hold, p);
      }
#pragma unroll
      for (int q = 0; q < kBatch / 4; ++q) l4[q] = lv[q];
    }
    for (int t = t_full; t < t_n; ++t)
      lev[t] = env_step(lev[t], e, peak, hold, p);
    env_out[c] = e;
    peak_out[c] = peak;
    hold_out[c] = hold;
  }
  __syncthreads();

  float* yr = y + (size_t)c * t_n;
  for (int t = threadIdx.x; t < t_n; t += blockDim.x) {
    const float ax = fabsf(lev[t]);
    const float lx = logf(fmaxf(ax, 1e-36f));
    yr[t] = xr[t] * (knee_gain(p.k0, ax, lx) * knee_gain(p.k1, ax, lx));
  }
  for (int i = threadIdx.x; i < n_win; i += blockDim.x)
    win_out[(size_t)c * n_win + i] = frame[t_n + i];
}

}  // namespace

extern "C" {

int lsp_chain_dyn(const float* x, const float* win, const float* env_in,
                  const float* peak_in, const int* hold_in, float* y,
                  float* win_out, float* env_out, float* peak_out,
                  int* hold_out, int c_n, int t_n, int n_win, LspDynParams p,
                  void* stream) {
  if (t_n < n_win) return (int)cudaErrorInvalidValue;
  const int smem = (int)((size_t)(n_win + 2 * t_n) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chain_dyn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chain_dyn_kernel<<<c_n, kThreads, smem, (cudaStream_t)stream>>>(
      x, win, env_in, peak_in, hold_in, y, win_out, env_out, peak_out,
      hold_out, t_n, n_win, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
