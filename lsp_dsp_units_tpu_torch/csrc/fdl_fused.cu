// Two kernels of the convolver block, every spectrum kept in shared memory
// from the transform that makes it to the one that consumes it:
//
// eqfdl_kernel — the chain's linear path after the EQ's forward FFT: EQ
// product and first-half inverse plus the carried-state correction (-> u),
// the FDL frame [hist || u] forward FFT (-> S), the ring MAC with slot w
// read as S, the in-place write of S to ring slot w, the last-half inverse
// (-> y), and the EQ's state update.  Replaces the TPU kernel
// ops/pallas_fdl_fused.py::eqfdl_fused_pallas of the JAX package
// (_eqfdl_kernel), minus its first zero-padded forward FFT, which runs as
// the standalone packed FFT (fft_packed.cu) just before this launch, and
// plus the EQ's small state products (g_mat @ sv, m_mat @ sv + w_mat @ x),
// which the TPU path left to XLA: computed here in FP32 FMA they cannot
// change with any global TF32 or matmul-precision setting.
//
// fdl_kernel — the standalone convolver block: the frame [hist || x]
// forward FFT (-> S), the same ring MAC and slot write, the same last-half
// inverse (-> y).  Replaces ops/pallas_fdl_fused.py::fdl_fused_pallas
// (_kernel).
//
// What bounds them: memory traffic.  Per block at 64 channels, N = 16384,
// P = 6, each channel reads P-1 ring slots and P IR spectra (64 KB each)
// and writes one slot: ~25 MB of ring traffic per block, ~7.5 us at 3.35
// TB/s (fdl_kernel's whole traffic with the frame and y: ~32 MB, ~9.5
// us); eqfdl_kernel also reads the EQ's w_mat and g_t, 2K x M floats each
// (K biquads; 2K = 18 on the chain: ~1.2 MB per channel), from L2.
//
// Both run the split schedule of fft_packed.cu: the two blocks of a
// channel form a cluster, block b holding packed positions
// [b L, (b+1) L), L = M/2, in its own shared memory.  The EQ product,
// the retangle, the MAC pass and every stage but the frame's first and
// the inverses' last run on the block's own half (pair_of pairs positions
// within an octave); the transforms run up to four radix-2 stages per
// register pass.  So each block reads half of its channel's ring: 128 SMs
// carry the traffic instead of 64.  From the frame's second stage on, the
// two kernels share one function (fdl_tail); its last stage, the FDL
// inverse's, crosses the cluster through distributed shared memory (block
// b writes y's quarter).
//
// In eqfdl_kernel the EQ inverse's last stage crosses the cluster too,
// fused with the u correction and the frame's first DIF stage: block b
// computes u for a quarter of the outputs and writes both halves' frame
// values.  The work of the EQ matrices is split as well (rows of W x,
// outputs of g_mat @ sv), so each block reads half of them.  fdl_kernel's
// frame is in device memory already, so each of its blocks reads hist and
// x and forms its own half of the first stage (h + x, or (h - x) w) as it
// loads the first register pass: no exchange, hist and x read twice (the
// second time from L2).
//
// Same butterflies on the same operands in the same order as a one-block
// radix-2 schedule, and every sum in the same order, so the outputs are
// bitwise those of that schedule.  The only global traffic is the inputs,
// the outputs and the ring.  The MAC, untangle and retangle are fused
// into one pass over bin pairs, with ring and IR reads coalesced in the
// packed (bit-reversed) order.  Slot w is never read, only written, so
// the in-place write races with no read of another slot.  What is left
// of their time on the H100 is latency: the L2 streams (ring and IR in
// the MAC; eqfdl_kernel's W x and g_t), each with several loads in flight
// per thread, and the register passes' shared-memory rounds.

// The backward passes of both (fdl_bwd, and eqfdl_bwd with
// eqfdl_bwd_sums) are below the forward kernels and share nothing with
// them; see the note there.

#include <cooperative_groups.h>

#include <utility>

#include "fft_packed.cuh"

namespace cg = cooperative_groups;
using namespace lspfft;

namespace {

constexpr int kMaxK2 = 64;                    // 2 x biquad stages
constexpr int kWarps = kThreads / 32;
// loads in flight per thread in eqfdl_kernel's L2 streams, each summed
// in its order: W x (float4 per lane), g_mat @ sv (rows x outputs), and
// the MAC (partitions of the ring)
constexpr int kRowLoads = 16;
constexpr int kRows = 6;
constexpr int kCorr = 4;
constexpr int kMacLoads = 6;

// acc + v h with every rounding pinned: re = fma(v.x, h.x, -(v.y h.y)),
// im = fma(v.y, h.x, v.x h.y), each added to acc once.  That is how
// nvcc contracted cadd(acc, cmul(v, h)) in the MAC's earlier loop (one
// partition per step); pinned, the sums no longer depend on how a loop
// is shaped.
__device__ __forceinline__ float2 cmac(float2 acc, float2 v, float2 h) {
  const float re = __fmaf_rn(v.x, h.x, -__fmul_rn(v.y, h.y));
  const float im = __fmaf_rn(v.y, h.x, __fmul_rn(v.x, h.y));
  return make_float2(__fadd_rn(acc.x, re), __fadd_rn(acc.y, im));
}

// (b)-(d) untangle the frame's complex FFT -> S; acc = sum_p ring'[p]
// H[(w - p) % P] with slot w read as S; ring[w] := S; (e) acc retangled
// in place for the inverse.  Over pairs t0 .. t0 + count - 1 of pair_of,
// plus the self-paired positions 0 and 1 where self0; at(j) is the
// shared-memory slot of packed position j.  The caller synchronises
// before the inverse.  kU partitions' ring and IR loads are issued
// before their products, summed in the order of p.
template <int kU, class At>
__device__ __forceinline__ void mac_pass(
    At at, float* __restrict__ ring_re, float* __restrict__ ring_im,
    const float* __restrict__ h_re, const float* __restrict__ h_im,
    const float2* __restrict__ wnb, int m, int p_n, int w, int c_n,
    size_t row, int t0, int count, bool self0) {
  const size_t plane = (size_t)c_n * m;
  float* wre = ring_re + w * plane + row;
  float* wim = ring_im + w * plane + row;
  // the self-paired positions 0 and 1 (thread 0)
  auto mac = [&](int j, float2 s) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int p = 0; p < p_n; ++p) {
      const int q = (w - p + p_n) % p_n;
      const float2 v = p == w ? s
                              : make_float2(ring_re[p * plane + row + j],
                                            ring_im[p * plane + row + j]);
      const float2 hv = make_float2(__ldg(&h_re[(size_t)q * m + j]),
                                    __ldg(&h_im[(size_t)q * m + j]));
      acc = cadd(acc, pmul(v, hv, j));
    }
    wre[j] = s.x;
    wim[j] = s.y;
    return acc;
  };
  for (int u = threadIdx.x; u < count; u += blockDim.x) {
    int j, jp;
    pair_of(t0 + u, j, jp);
    const float2 wk = __ldg(&wnb[j]);
    float2 sk, smk;
    untangle(at(j), at(jp), wk, sk, smk);
    // both bins of the pair per partition: four ring and four IR loads
    // per partition, kU partitions in flight (bins j, jp >= 2 are complex)
    float2 ak = make_float2(0.0f, 0.0f), amk = make_float2(0.0f, 0.0f);
    for (int p0 = 0; p0 < p_n; p0 += kU) {
      float2 vk[kU], vmk[kU], hk[kU], hmk[kU];
#pragma unroll
      for (int r = 0; r < kU; ++r) {
        const int p = p0 + r;
        if (p < p_n) {
          const int q = (w - p + p_n) % p_n;
          const size_t off = p * plane + row;
          vk[r] = sk;
          vmk[r] = smk;
          if (p != w) {
            vk[r] = make_float2(ring_re[off + j], ring_im[off + j]);
            vmk[r] = make_float2(ring_re[off + jp], ring_im[off + jp]);
          }
          const float* hr = h_re + (size_t)q * m;
          const float* hi = h_im + (size_t)q * m;
          hk[r] = make_float2(__ldg(&hr[j]), __ldg(&hi[j]));
          hmk[r] = make_float2(__ldg(&hr[jp]), __ldg(&hi[jp]));
        }
      }
#pragma unroll
      for (int r = 0; r < kU; ++r) {
        if (p0 + r < p_n) {
          ak = cmac(ak, vk[r], hk[r]);
          amk = cmac(amk, vmk[r], hmk[r]);
        }
      }
    }
    wre[j] = sk.x;
    wim[j] = sk.y;
    wre[jp] = smk.x;
    wim[jp] = smk.y;
    float2 zk, zmk;
    retangle(ak, amk, wk, zk, zmk);
    at(j) = zk;
    at(jp) = zmk;
  }
  if (self0 && threadIdx.x == 0) {
    const float2 a0 = mac(0, untangle0(at(0)));
    const float2 a1 = mac(1, cconj(at(1)));
    at(0) = retangle0(a0);
    at(1) = cconj(a1);
  }
}

// From the frame's first-stage outputs in the two blocks' shared memory
// (block b: its half, local points 0 .. L - 1, synchronised) to y: the
// DIF stages with spans below 2^rem locally, the MAC pass on the block's
// own pairs, the DIT stages but the last locally, and the last stage
// (span L: a - c of point i of each half, the last half of the inverse)
// for this block's quarter of y across the cluster.
template <class At, class Load, class Store>
__device__ __forceinline__ void fdl_tail(
    cg::cluster_group& cluster, float2* buf, At at, Load ld, Store st,
    float* __restrict__ ring_re, float* __restrict__ ring_im,
    const float* __restrict__ h_re, const float* __restrict__ h_im,
    float* __restrict__ y, const float2* __restrict__ wst,
    const float2* __restrict__ wnb, int log_m, int rem, int p_n, int w,
    int c_n, size_t row) {
  const int m = 1 << log_m;
  const int log_l = log_m - 1;
  const int l = m >> 1;
  const int q4 = l >> 1;
  const int b = (int)cluster.block_rank();
  const int nt = l / kPts;
  const bool passer = threadIdx.x < nt;
  while (rem > 0) {
    const int kk = min(kRadixBits, rem);
    rem -= kk;
    if (passer) pass<false>(kk, wst, rem, nt, ld, st);
    __syncthreads();
  }

  {
    int t0, count;
    half_pairs(b, l, t0, count);
    mac_pass<kMacLoads>(at, ring_re, ring_im, h_re, h_im, wnb, m, p_n, w,
                        c_n, row, t0, count, b == 0);
  }
  // the FDL inverse: every DIT stage but the last, locally
  for (int lo = 0; lo < log_l;) {
    __syncthreads();
    const int kk = min(kRadixBits, log_l - lo);
    if (passer) pass<true>(kk, wst, lo, nt, ld, st);
    lo += kk;
  }
  cluster.sync();

  // its last stage: y (the last half, a - c of the span-L butterflies),
  // this block's quarter
  {
    const float2* lower = b ? cluster.map_shared_rank(buf, 0) : buf;
    const float2* upper = b ? buf : cluster.map_shared_rank(buf, 1);
    const float inv_m = 1.0f / (float)m;
    float2* yz = reinterpret_cast<float2*>(y + row);
    const int i0 = b * q4;
    for (int i = i0 + threadIdx.x; i < i0 + q4; i += blockDim.x) {
      const float2 a = lower[pad(i)];
      const float2 cc = cmulc(upper[pad(i)], __ldg(&wst[l + i]));
      yz[i] = cscale(csub(a, cc), inv_m);
    }
  }
  // the partner reads this block's shared memory until it passes here
  cluster.sync();
}

// blockIdx.x = 2 * channel + b, b the block's rank in its cluster: block
// b owns packed positions [b L, (b+1) L), L = M/2.  Threads: kThreads;
// the nt = L / kPts lowest run the register passes.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads)
eqfdl_kernel(float* __restrict__ ring_re, float* __restrict__ ring_im,
             const float* __restrict__ h_re, const float* __restrict__ h_im,
             const float* __restrict__ heq_re,
             const float* __restrict__ heq_im,
             const float* __restrict__ xs_re,
             const float* __restrict__ xs_im, const float* __restrict__ x,
             const float* __restrict__ sv, const float* __restrict__ g_t,
             const float* __restrict__ m_mat,
             const float* __restrict__ w_mat,
             const float* __restrict__ hist, float* __restrict__ y,
             float* __restrict__ u, float* __restrict__ sv_out,
             const float2* __restrict__ wst, const float2* __restrict__ wnb,
             int log_m, int p_n, int w, int c_n, int k2) {
  extern __shared__ __align__(16) float2 buf[];
  __shared__ float s_sv[kMaxK2];
  __shared__ float s_wx[kMaxK2];
  cg::cluster_group cluster = cg::this_cluster();
  const int m = 1 << log_m;
  const int log_l = log_m - 1;
  const int l = m >> 1;
  const int q4 = l >> 1;                     // cross-stage outputs per block
  const int c = blockIdx.x >> 1;
  const int b = (int)cluster.block_rank();
  const int off = b * l;
  const int nt = l / kPts;                   // register-pass threads
  const bool passer = threadIdx.x < nt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)c * m;          // spectra rows and [C, B] rows
  auto at = [&](int j) -> float2& { return buf[pad(j - off)]; };
  auto ld = [&](int i) { return buf[pad(i)]; };
  auto st = [&](int i, float2 v) { buf[pad(i)] = v; };

  // EQ state: sv' = M sv + W x, rows k = b, b + 2, ... in this block,
  // each reduced by one warp, so W streams from L2 coalesced with two
  // independent accumulators per lane; x comes through the read-only
  // cache.  Warps without a row go on to the EQ product at once.
  if (threadIdx.x < k2) s_sv[threadIdx.x] = sv[(size_t)c * k2 + threadIdx.x];
  {
    const float4* x4 = reinterpret_cast<const float4*>(x + row);
    const int m4 = m >> 2;
    for (int k = 2 * warp + b; k < k2; k += 2 * kWarps) {
      const float4* wk4 = reinterpret_cast<const float4*>(w_mat + (size_t)k * m);
      float acc0 = 0.0f, acc1 = 0.0f;
      // kRowLoads loads in flight per lane, summed in the order of q
      for (int q0 = lane; q0 < m4; q0 += 32 * kRowLoads) {
        float4 wv[kRowLoads];
#pragma unroll
        for (int r = 0; r < kRowLoads; ++r) {
          const int q = q0 + 32 * r;
          wv[r] = q < m4 ? __ldg(&wk4[q]) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < kRowLoads; ++r) {
          const int q = q0 + 32 * r;
          if (q < m4) {
            const float4 xv = __ldg(&x4[q]);
            acc0 = fmaf(wv[r].x, xv.x, acc0);
            acc1 = fmaf(wv[r].y, xv.y, acc1);
            acc0 = fmaf(wv[r].z, xv.z, acc0);
            acc1 = fmaf(wv[r].w, xv.w, acc1);
          }
        }
      }
      float acc = acc0 + acc1;
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) s_wx[k] = acc;
    }
  }

  // (a) EQ: X * Heq on the block's own pairs, retangled for the inverse
  {
    const float* xre = xs_re + row;
    const float* xim = xs_im + row;
    int t0, count;
    half_pairs(b, l, t0, count);
    for (int t = threadIdx.x; t < count; t += blockDim.x) {
      int j, jp;
      pair_of(t0 + t, j, jp);
      const float2 pk = cmul(make_float2(xre[j], xim[j]),
                             make_float2(__ldg(&heq_re[j]), __ldg(&heq_im[j])));
      const float2 pmk = cmul(make_float2(xre[jp], xim[jp]),
                              make_float2(__ldg(&heq_re[jp]),
                                          __ldg(&heq_im[jp])));
      float2 zk, zmk;
      retangle(pk, pmk, __ldg(&wnb[j]), zk, zmk);
      at(j) = zk;
      at(jp) = zmk;
    }
    if (b == 0 && threadIdx.x == 0) {
      const float2 p0 = pmul(make_float2(xre[0], xim[0]),
                             make_float2(heq_re[0], heq_im[0]), 0);
      const float2 p1 = cmul(make_float2(xre[1], xim[1]),
                             make_float2(heq_re[1], heq_im[1]));
      at(0) = retangle0(p0);
      at(1) = cconj(p1);
    }
  }
  // the EQ inverse: every DIT stage but the last, locally
  for (int lo = 0; lo < log_l;) {
    __syncthreads();
    const int kk = min(kRadixBits, log_l - lo);
    if (passer) pass<true>(kk, wst, lo, nt, ld, st);
    lo += kk;
  }
  cluster.sync();
  if (threadIdx.x < k2 && (threadIdx.x & 1) == b) {
    const int k = threadIdx.x;
    float acc = s_wx[k];
    for (int jj = 0; jj < k2; ++jj)
      acc = fmaf(__ldg(&m_mat[(size_t)k * k2 + jj]), s_sv[jj], acc);
    sv_out[(size_t)c * k2 + k] = acc;
  }

  // The EQ inverse's last stage (span L: point i of each half) for this
  // block's quarter i in [b L/2, (b+1) L/2), its lower output scaled plus
  // g_mat @ sv -> u, and the FDL frame [hist || u] with its first DIF
  // stage (span L) fused in: h + u to half 0, (h - u) w to half 1.  Each
  // point is read and written by one thread of the cluster.
  {
    float2* lower = b ? cluster.map_shared_rank(buf, 0) : buf;
    float2* upper = b ? buf : cluster.map_shared_rank(buf, 1);
    const float inv_m = 1.0f / (float)m;
    const int i0 = b * q4;
    const float2* hz = reinterpret_cast<const float2*>(hist + row) + i0;
    float2* uz = reinterpret_cast<float2*>(u + row) + i0;
    // each thread accumulates kCorr outputs together over kRows rows of
    // g_t at a time
    for (int n0 = threadIdx.x; n0 < q4; n0 += kCorr * blockDim.x) {
      float2 corr[kCorr];
#pragma unroll
      for (int v = 0; v < kCorr; ++v) corr[v] = make_float2(0.0f, 0.0f);
      for (int k0 = 0; k0 < k2; k0 += kRows) {
        float2 g[kRows][kCorr];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float2* gk = reinterpret_cast<const float2*>(
                                 g_t + (size_t)(k0 + r) * m) + i0;
#pragma unroll
          for (int v = 0; v < kCorr; ++v) {
            const int n = n0 + v * blockDim.x;
            g[r][v] = k0 + r < k2 && n < q4 ? __ldg(&gk[n])
                                            : make_float2(0.0f, 0.0f);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (k0 + r < k2) {
            const float s = s_sv[k0 + r];
#pragma unroll
            for (int v = 0; v < kCorr; ++v) {
              corr[v].x = fmaf(g[r][v].x, s, corr[v].x);
              corr[v].y = fmaf(g[r][v].y, s, corr[v].y);
            }
          }
        }
      }
#pragma unroll
      for (int v = 0; v < kCorr; ++v) {
        const int n = n0 + v * blockDim.x;
        if (n < q4) {
          const int i = i0 + n;
          const float2 tw = __ldg(&wst[l + i]);
          const float2 a = lower[pad(i)];
          const float2 cc = cmulc(upper[pad(i)], tw);
          const float2 un = cadd(cscale(cadd(a, cc), inv_m), corr[v]);
          uz[n] = un;
          const float2 h = hz[n];
          lower[pad(i)] = cadd(h, un);
          upper[pad(i)] = cmul(csub(h, un), tw);
        }
      }
    }
  }
  cluster.sync();

  // the frame's other stages, the MAC and the FDL inverse (-> y)
  fdl_tail(cluster, buf, at, ld, st, ring_re, ring_im, h_re, h_im, y, wst,
           wnb, log_m, log_l, p_n, w, c_n, row);
}

// blockIdx.x = 2 * channel + b as in eqfdl_kernel.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads)
fdl_kernel(float* __restrict__ ring_re, float* __restrict__ ring_im,
           const float* __restrict__ h_re, const float* __restrict__ h_im,
           const float* __restrict__ hist, const float* __restrict__ x,
           float* __restrict__ y, const float2* __restrict__ wst,
           const float2* __restrict__ wnb, int log_m, int p_n, int w,
           int c_n) {
  extern __shared__ __align__(16) float2 buf[];
  cg::cluster_group cluster = cg::this_cluster();
  const int log_l = log_m - 1;
  const int l = 1 << log_l;
  const int b = (int)cluster.block_rank();
  const int off = b * l;
  const int nt = l / kPts;
  const size_t row = (size_t)(blockIdx.x >> 1) << log_m;
  auto at = [&](int j) -> float2& { return buf[pad(j - off)]; };
  auto ld = [&](int i) { return buf[pad(i)]; };
  auto st = [&](int i, float2 v) { buf[pad(i)] = v; };

  // the frame [hist || x] as M complex values z[n] = (f[2n], f[2n+1]);
  // its first DIF stage (span L: hist half against x half) is fused into
  // the first register pass's load, this block's half of it
  const float2* hz = reinterpret_cast<const float2*>(hist + row);
  const float2* xz = reinterpret_cast<const float2*>(x + row);
  auto ld_first = [&](int i) {
    const float2 h = hz[i];
    const float2 v = xz[i];
    return b ? cmul(csub(h, v), __ldg(&wst[l + i])) : cadd(h, v);
  };
  const int kk = min(kRadixBits, log_l);
  if (threadIdx.x < nt) pass<false>(kk, wst, log_l - kk, nt, ld_first, st);
  __syncthreads();
  fdl_tail(cluster, buf, at, ld, st, ring_re, ring_im, h_re, h_im, y, wst,
           wnb, log_m, log_l - kk, p_n, w, c_n, row);
}

// both kernels' dynamic shared memory: half a channel's M points, padded
int half_smem(int log_m) {
  return padded(1 << (log_m - 1)) * (int)sizeof(float2);
}

// A kernel's launch shape at log2(M) = log_m for c_n channels: out[0]
// blocks per channel (the cluster size), out[1] threads per block, out[2]
// dynamic shared memory per block (bytes), out[3] blocks resident per SM
// by the occupancy calculator, out[4] clusters of the whole launch
// resident at once (cudaOccupancyMaxActiveClusters).
template <class Kernel>
int launch_shape(Kernel kernel, int log_m, int c_n, int* out) {
  if (bad_size(log_m) || c_n < 1) return (int)cudaErrorInvalidValue;
  const int smem = half_smem(log_m);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * c_n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = 2;
  out[1] = kThreads;
  out[2] = smem;
  out[3] = per_sm;
  out[4] = clusters;
  return 0;
}

// ---------------------------------------------------------------------------
// Backward (the adjoints of the contracts of ops/fdl_fused.py; the JAX
// package differentiates its XLA forms with jax.grad, the Pallas kernels
// have no backward of their own).
//
// A backward runs as a few launches (ops/fdl_fused.py): kernel #1's
// zero-pad forward transform of y's cotangent, then fdl_bwd (the MAC's
// adjoint), then frame_bwd_kernel: the inverse of S's cotangent (the
// frame's cotangent: hist's first half, u's or x's second) and, for
// eqfdl, the zero-pad forward transform of u's whole cotangent; then for
// eqfdl eqfdl_bwd (the EQ's adjoint but for sv's and m_mat's sums) and
// eqfdl_bwd_sums.
//
// The channel split.  Both wide kernels cut the C channels into G =
// min(4, C) contiguous groups (group r: channels [r C / G, (r + 1) C / G), in
// order), one block each, and launch the G blocks of a position tile as
// one thread block cluster.  A block sums its own group's channels in
// order; after cluster.sync() each rank sums its 1/G share of the tile's
// sums over ranks 0 .. G - 1 in rank order, reading the others' shared
// memory, and writes it.  The order depends on C and G alone, so a
// gradient is the same from run to run; the cluster's sums take no
// atomics and no scratch.  So a thread's channel loop is C / G long, and
// G times as many blocks carry the loads (fdl_bwd: 192 blocks at 64
// channels, N = 16384, P = 6; eqfdl_bwd: 256).  Of G = 2, 4 and 8, four
// ran both kernels fastest at 64 channels on the H100: more groups give
// more blocks, but each block pays its tile's fixed costs (the staged
// tiles, the cluster's syncs and sums) for fewer channels.
//
// fdl_bwd: blocks (tile of kFdlTile packed positions, partition p, group
// r), a thread four positions (float4 loads).  With g the cotangent of
// acc (the transform of y's cotangent weighted 1/N at position 0 and 2/N
// elsewhere, negated at the odd natural bins, j >= M/2), slot p's
// cotangent is g conj(H[(w - p) % P]) plus that of the ring written; slot
// w's is S's, written weighted (N at position 0, N/2 elsewhere) for the
// inverse, and the incoming slot w gets 0; H[(w - p) % P] takes the sum
// over channels of g conj(ring'[p]).  Position 0's two real bins multiply
// slot-wise.  What bounds it: bytes, ring' read and the ring's cotangent
// read and written (3 x 2P planes), g read and S's cotangent written (4
// planes), H: at 64 channels, N = 16384, P = 6 ~80 MB, ~24 us at 3.35
// TB/s.  Each partition's blocks read g again, from L2.
//
// eqfdl_bwd: blocks (tile of kEqTile positions, group r), a thread a
// position (packed position j of the spectra, sample b of the [C, B]
// rows).  u = first half of irfft(xs Heq) + sv g_t, sv' = sv m^T + x
// w^T; g is the transform of u's cotangent gu weighted 1/N at position 0,
// 2/N elsewhere.  Elementwise: xs's cotangent g conj(Heq) and x's sum_k
// gsv'[c, k] w_mat[k, b] (k in order); over the cluster: Heq's sum_c g
// conj(xs), g_t's sum_c sv[c, k] gu[c, b] and w_mat's sum_c gsv'[c, k]
// x[c, b] (2K + 2K + 2 rows of the tile in shared memory, the 2K x 2
// products in registers); over the tile: each (c, k) partial of sum_b
// gu[c, b] g_t[k, b], the positions in order, a thread a channel and
// two rows, from gu and g_t staged in shared memory, into a scratch
// [tiles, C, 2K].  A thread first loads all of a chunk of kEqSub
// channels' values, so that they are in flight together.
// eqfdl_bwd_sums, a warp an output, then sums those partials with the
// terms gsv'[c, j] m[j, k] (sv's cotangent), and m_mat's terms gsv'[c,
// k] sv[c, j] over the channels (lane l terms l, l + 32, ... in order,
// the lanes by a fixed shuffle tree).  What
// bounds the two: bytes, g, xs and xs's cotangent (6 planes), gu, x and
// x's cotangent (3), g_t, w_mat and their cotangents (4 x 2K rows): ~21
// MB at 64 channels, N = 16384, 2K = 18, ~6 us.  All in FP32 FMA in
// code, so no library matmul (and no TF32 setting) touches them.
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;      // fdl_bwd, eqfdl_bwd_sums
constexpr int kMaxGroups = 4;         // channel groups: a cluster's blocks
constexpr int kFdlTile = 1024;        // fdl_bwd: packed positions a block
constexpr int kFdlVec = kFdlTile / kBwdThreads;  // a thread's: one float4
constexpr int kEqTile = 128;          // eqfdl_bwd: positions a block
constexpr int kEqSub = 8;             // eqfdl_bwd: channels staged at once
static_assert(kFdlVec == 4, "fdl_bwd reads a float4 of each plane");

// g conj(h) at packed position j (slot-wise at 0)
__device__ __forceinline__ float2 pmulc(float2 g, float2 h, int j) {
  return j == 0 ? make_float2(g.x * h.x, g.y * h.y) : cmulc(g, h);
}

// the first channel of group r of `groups` over c_n channels
__host__ __device__ __forceinline__ int group_start(int r, int groups,
                                                    int c_n) {
  return (int)((long long)r * c_n / groups);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float& elem(float4& v, int e) {
  return (&v.x)[e];
}

// Each rank of the cluster sums its share of the n values of `part` (at
// the same place in every rank's shared memory, 16-byte aligned; n a
// multiple of 4) over ranks 0 .. groups - 1 in order, four values a
// thread, and put(v, sums) writes values v .. v + 3.  The caller
// synchronises the cluster before (the sums are written) and after (the
// others have read them).
template <class Put>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            float* part, int n, int groups,
                                            Put put) {
  const int r = (int)cluster.block_rank();
  const int n4 = n >> 2;
  const int v1 = group_start(r + 1, groups, n4);
  for (int v = group_start(r, groups, n4) + threadIdx.x; v < v1;
       v += blockDim.x) {
    float4 acc =
        reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0))[v];
#pragma unroll
    for (int k = 1; k < kMaxGroups; ++k) {
      if (k < groups) {
        const float4 o = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, k))[v];
        acc.x += o.x;
        acc.y += o.y;
        acc.z += o.z;
        acc.w += o.w;
      }
    }
    put(4 * v, acc);
  }
}

// blockIdx.x the tile of kFdlTile packed positions, blockIdx.y the
// partition p, blockIdx.z the channel group: the block's rank in its
// cluster (1, 1, groups).
__global__ void __launch_bounds__(kBwdThreads)
fdl_bwd(const float* __restrict__ ring_re, const float* __restrict__ ring_im,
        const float* __restrict__ h_re, const float* __restrict__ h_im,
        const float* __restrict__ ga_re, const float* __restrict__ ga_im,
        const float* __restrict__ go_re, const float* __restrict__ go_im,
        float* __restrict__ gi_re, float* __restrict__ gi_im,
        float* __restrict__ gh_re, float* __restrict__ gh_im,
        float* __restrict__ gs_re, float* __restrict__ gs_im, int log_m,
        int p_n, int w, int c_n, int groups) {
  __shared__ __align__(16) float part[2 * kFdlTile];  // H's sums: re, im
  cg::cluster_group cluster = cg::this_cluster();
  const int m = 1 << log_m;
  const int p = blockIdx.y;
  const int q = (w - p + p_n) % p_n;
  const int r = (int)cluster.block_rank();
  const int j0 = blockIdx.x * kFdlTile + threadIdx.x * kFdlVec;
  float4 ar = make_float4(0.0f, 0.0f, 0.0f, 0.0f), ai = ar;
  if (j0 < m) {
    const float n_f = (float)(2 * m);
    float wa[kFdlVec], ws[kFdlVec];
#pragma unroll
    for (int e = 0; e < kFdlVec; ++e) {
      const int j = j0 + e;
      wa[e] = j == 0 ? 1.0f / n_f : 2.0f / n_f;    // powers of two: exact
      if (j >= (m >> 1)) wa[e] = -wa[e];
      ws[e] = j == 0 ? n_f : 0.5f * n_f;
    }
    float4 hr = ld4(h_re + (size_t)q * m + j0);
    float4 hi = ld4(h_im + (size_t)q * m + j0);
    const size_t plane = (size_t)c_n * m;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int c1 = group_start(r + 1, groups, c_n);
#pragma unroll 2
    for (int c = group_start(r, groups, c_n); c < c1; ++c) {
      const size_t rc = (size_t)c * m + j0;
      const size_t off = p * plane + rc;
      float4 gar = ld4(ga_re + rc), gai = ld4(ga_im + rc);
      float4 gor = ld4(go_re + off), goi = ld4(go_im + off);
      float4 rr = ld4(ring_re + off), ri = ld4(ring_im + off);
      float4 outr, outi;
#pragma unroll
      for (int e = 0; e < kFdlVec; ++e) {
        const int j = j0 + e;
        const float2 g = make_float2(elem(gar, e) * wa[e],
                                     elem(gai, e) * wa[e]);
        const float2 gv = pmulc(g, make_float2(elem(hr, e), elem(hi, e)), j);
        const float ox = elem(gor, e) + gv.x;
        const float oy = elem(goi, e) + gv.y;
        elem(outr, e) = p == w ? ox * ws[e] : ox;
        elem(outi, e) = p == w ? oy * ws[e] : oy;
        const float2 gh = pmulc(g, make_float2(elem(rr, e), elem(ri, e)), j);
        elem(ar, e) += gh.x;
        elem(ai, e) += gh.y;
      }
      if (p == w) {
        st4(gs_re + rc, outr);
        st4(gs_im + rc, outi);
        st4(gi_re + off, zero);
        st4(gi_im + off, zero);
      } else {
        st4(gi_re + off, outr);
        st4(gi_im + off, outi);
      }
    }
  }
  reinterpret_cast<float4*>(part)[threadIdx.x] = ar;
  reinterpret_cast<float4*>(part + kFdlTile)[threadIdx.x] = ai;
  cluster.sync();
  const int base = blockIdx.x * kFdlTile;
  cluster_sum(cluster, part, 2 * kFdlTile, groups, [&](int v, float4 s) {
    const int j = base + (v & (kFdlTile - 1));
    if (j < m) st4((v < kFdlTile ? gh_re : gh_im) + (size_t)q * m + j, s);
  });
  cluster.sync();
}

// eqfdl_bwd's dynamic shared memory at 2K = k2 (floats): sv's and
// gsv''s rows of kEqSub channels, interleaved [kEqSub][k2] float2; the
// cluster's sums [2 + 2 k2][kEqTile] (Heq's re and im, g_t's rows,
// w_mat's rows); g_t's and w_mat's tiles [k2][kEqTile + 1] and gu's of
// the kEqSub channels [kEqSub][kEqTile + 1] (rows padded by one against
// bank conflicts).  k2 is even, so the sums start 16-byte aligned.
__host__ __device__ constexpr int eq_smem_floats(int k2) {
  return 2 * kEqSub * k2 + (2 + 2 * k2) * kEqTile +
         (2 * k2 + kEqSub) * (kEqTile + 1);
}

// blockIdx.x the tile of kEqTile positions, blockIdx.z the channel group:
// the block's rank in its cluster (1, 1, groups).  kR >= k2: the rows of
// the sums over the channels a thread holds in registers.
template <int kR>
__global__ void __launch_bounds__(kEqTile)
eqfdl_bwd(const float* __restrict__ gp_re, const float* __restrict__ gp_im,
          const float* __restrict__ gu, const float* __restrict__ heq_re,
          const float* __restrict__ heq_im, const float* __restrict__ xs_re,
          const float* __restrict__ xs_im, const float* __restrict__ x,
          const float* __restrict__ sv, const float* __restrict__ g_t,
          const float* __restrict__ w_mat, const float* __restrict__ gsv2,
          float* __restrict__ gxs_re, float* __restrict__ gxs_im,
          float* __restrict__ gheq_re, float* __restrict__ gheq_im,
          float* __restrict__ g_gt, float* __restrict__ g_w,
          float* __restrict__ g_x, float* __restrict__ part_sv, int log_m,
          int c_n, int k2, int groups) {
  constexpr int kLd = kEqTile + 1;
  constexpr int kQuads = kEqTile / 4;
  extern __shared__ __align__(16) float smem[];
  float2* s_sg = reinterpret_cast<float2*>(smem);
  float* sums = smem + 2 * kEqSub * k2;
  float* s_gt = sums + (2 + 2 * k2) * kEqTile;
  float* s_wm = s_gt + k2 * kLd;
  float* s_gu = s_wm + k2 * kLd;
  cg::cluster_group cluster = cg::this_cluster();
  const int m = 1 << log_m;
  const int r = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int j0 = tile * kEqTile;
  const int j = j0 + t;               // packed position j, and sample b = j
  const bool live = j < m;
  const float n_f = (float)(2 * m);
  const float wp = j == 0 ? 1.0f / n_f : 2.0f / n_f;
  const float2 hv = live ? make_float2(heq_re[j], heq_im[j])
                         : make_float2(0.0f, 0.0f);
  // g_t's and w_mat's tiles, a float4 a thread and row at a time
  for (int i = t; i < k2 * kQuads; i += kEqTile) {
    const int k = i / kQuads;
    const int b = 4 * (i - k * kQuads);
    const bool on = j0 + b < m;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 gv = on ? ld4(g_t + (size_t)k * m + j0 + b) : zero;
    float4 wv = on ? ld4(w_mat + (size_t)k * m + j0 + b) : zero;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s_gt[k * kLd + b + e] = elem(gv, e);
      s_wm[k * kLd + b + e] = elem(wv, e);
    }
  }
  float agt[kR], aw[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) agt[k] = aw[k] = 0.0f;
  float2 aheq = make_float2(0.0f, 0.0f);
  const float* wmt = s_wm + t;
  const int c1 = group_start(r + 1, groups, c_n);
  for (int cs = group_start(r, groups, c_n); cs < c1; cs += kEqSub) {
    const int cn = min(kEqSub, c1 - cs);
    // the chunk's loads first, all in flight together
    float lpr[kEqSub], lpi[kEqSub], lxr[kEqSub], lxi[kEqSub], lu[kEqSub],
        lx[kEqSub];
#pragma unroll
    for (int cl = 0; cl < kEqSub; ++cl) {
      const bool on = live && cl < cn;
      const size_t rc = (size_t)(cs + cl) * m + j;
      lpr[cl] = on ? gp_re[rc] : 0.0f;
      lpi[cl] = on ? gp_im[rc] : 0.0f;
      lxr[cl] = on ? xs_re[rc] : 0.0f;
      lxi[cl] = on ? xs_im[rc] : 0.0f;
      lu[cl] = on ? gu[rc] : 0.0f;
      lx[cl] = on ? x[rc] : 0.0f;
    }
    __syncthreads();     // the tiles written; the last chunk is done
    for (int i = t; i < cn * k2; i += kEqTile)
      s_sg[i] = make_float2(sv[(size_t)cs * k2 + i],
                            gsv2[(size_t)cs * k2 + i]);
#pragma unroll
    for (int cl = 0; cl < kEqSub; ++cl)
      if (cl < cn) s_gu[cl * kLd + t] = lu[cl];
    __syncthreads();
#pragma unroll
    for (int cl = 0; cl < kEqSub; ++cl) {
      if (!live || cl >= cn) continue;
      const size_t rc = (size_t)(cs + cl) * m + j;
      const float2 g = make_float2(lpr[cl] * wp, lpi[cl] * wp);
      const float2 gx = pmulc(g, hv, j);
      gxs_re[rc] = gx.x;
      gxs_im[rc] = gx.y;
      const float2 gh = pmulc(g, make_float2(lxr[cl], lxi[cl]), j);
      aheq.x += gh.x;
      aheq.y += gh.y;
      const float2* sg = s_sg + cl * k2;
      float gxx = 0.0f;
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        if (k < k2) {
          const float2 v = sg[k];          // (sv[c, k], gsv'[c, k])
          agt[k] = fmaf(v.x, lu[cl], agt[k]);
          aw[k] = fmaf(v.y, lx[cl], aw[k]);
          gxx = fmaf(v.y, wmt[k * kLd], gxx);
        }
      }
      g_x[rc] = gxx;
    }
    // sv's partials over this tile: a thread a channel and two rows (k,
    // k + 1), the tile's positions in order, even and odd positions
    // summed apart, then added
    const int kp = (k2 + 1) >> 1;
    for (int task = t; task < cn * kp; task += kEqTile) {
      const int cl = task / kp;
      const int k = 2 * (task - cl * kp);
      const bool two = k + 1 < k2;
      const float* a = s_gu + cl * kLd;
      const float* b0 = s_gt + k * kLd;
      const float* b1 = two ? b0 + kLd : b0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 8
      for (int i = 0; i < kEqTile; i += 2) {
        const float a0 = a[i], a1 = a[i + 1];
        s0 = fmaf(a0, b0[i], s0);
        s1 = fmaf(a1, b0[i + 1], s1);
        s2 = fmaf(a0, b1[i], s2);
        s3 = fmaf(a1, b1[i + 1], s3);
      }
      float* out = part_sv + ((size_t)tile * c_n + cs + cl) * k2 + k;
      out[0] = s0 + s1;
      if (two) out[1] = s2 + s3;
    }
  }
  sums[t] = aheq.x;
  sums[kEqTile + t] = aheq.y;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    if (k < k2) {
      sums[(2 + k) * kEqTile + t] = agt[k];
      sums[(2 + k2 + k) * kEqTile + t] = aw[k];
    }
  }
  cluster.sync();
  cluster_sum(cluster, sums, (2 + 2 * k2) * kEqTile, groups,
              [&](int v, float4 s) {
    const int row = v / kEqTile;
    const int b = j0 + (v - row * kEqTile);
    if (b >= m) return;
    float* dst = row == 0 ? gheq_re + b
                 : row == 1 ? gheq_im + b
                 : row < 2 + k2 ? g_gt + (size_t)(row - 2) * m + b
                                : g_w + (size_t)(row - 2 - k2) * m + b;
    st4(dst, s);
  });
  cluster.sync();
}

// A warp an output, lane l taking terms l, l + 32, ... in order and the
// lanes summed by a fixed shuffle tree (lane 0's sum): sv's cotangent
// (warps i < C 2K: (c, k)), the tiles' partials and the terms gsv'[c, j]
// m[j, k]; m_mat's (warps C 2K + (k, j)), the terms gsv'[c, k] sv[c, j].
__global__ void __launch_bounds__(kBwdThreads)
eqfdl_bwd_sums(const float* __restrict__ part_sv,
               const float* __restrict__ gsv2,
               const float* __restrict__ m_mat,
               const float* __restrict__ sv, float* __restrict__ g_sv,
               float* __restrict__ g_m, int tiles, int c_n, int k2) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int n_sv = c_n * k2;
  if (i >= n_sv + k2 * k2) return;
  float acc = 0.0f;
  if (i < n_sv) {
    const int c = i / k2;
    const int k = i - c * k2;
    for (int tl = lane; tl < tiles; tl += 32)
      acc += part_sv[(size_t)tl * n_sv + i];
    for (int jj = lane; jj < k2; jj += 32)
      acc = fmaf(gsv2[(size_t)c * k2 + jj], m_mat[(size_t)jj * k2 + k], acc);
  } else {
    const int k = (i - n_sv) / k2;
    const int jj = (i - n_sv) - k * k2;
    for (int c = lane; c < c_n; c += 32)
      acc = fmaf(gsv2[(size_t)c * k2 + k], sv[(size_t)c * k2 + jj], acc);
  }
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    if (i < n_sv) g_sv[i] = acc;
    else g_m[i - n_sv] = acc;
  }
}

// The frame's transforms in the backward, one cluster of two blocks a
// channel (blockIdx.x = 2 * channel + b), block b holding packed positions
// [b L, (b+1) L), L = M/2, as irfft_packed_kernel: the inverse of S's
// cotangent gs (fdl_bwd wrote it weighted), its half's retangle and local
// DIT stages, then the last stage (span L) for this block's quarter i in
// [b L/2, (b+1) L/2), whose a + c is hist's cotangent and a - c the frame
// input's.  fdl_fused_bwd (kEq false) writes the two halves as g_hist and
// g_x.  eqfdl_fused_bwd (kEq true) adds u's own cotangent gu to the last
// half (g_ut, one rounding: __fadd_rn, never an FMA with the scaling),
// writes it, and forms the zero-pad forward transform's first DIF stage
// of it in place (g_ut to half 0, g_ut w to half 1, as
// rfft_packed_kernel's first load does), so that after one more cluster
// barrier each block runs that transform's other stages and untangle on
// its own half (-> gp).  The frame never leaves shared memory between
// the two transforms, and the outputs are bit for bit those of the chain
// of launches it replaces (kernel #1's inverse, the halves copied out,
// the add, kernel #1's zero-pad forward): the same operations on the
// same operands.  What bounds it: like kernel #1, its passes' latency
// and barriers, not its bytes (7 planes of [C, M] at the EQ route).
template <bool kEq>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads)
frame_bwd_kernel(const float* __restrict__ gs_re,
                 const float* __restrict__ gs_im,
                 const float* __restrict__ gu, float* __restrict__ g_hist,
                 float* __restrict__ g_last, float* __restrict__ gp_re,
                 float* __restrict__ gp_im, const float2* __restrict__ wst,
                 const float2* __restrict__ wnb, int log_m) {
  extern __shared__ __align__(16) float2 buf[];
  cg::cluster_group cluster = cg::this_cluster();
  const int log_l = log_m - 1;
  const int l = 1 << log_l;
  const int m = l << 1;
  const int b = (int)cluster.block_rank();
  const int off = b * l;
  const size_t row = (size_t)(blockIdx.x >> 1) << log_m;
  int t0, count;
  half_pairs(b, l, t0, count);
  {
    const float* ire = gs_re + row;
    const float* iim = gs_im + row;
    for (int u = threadIdx.x; u < count; u += blockDim.x) {
      int j, jp;
      pair_of(t0 + u, j, jp);
      float2 zk, zmk;
      retangle(make_float2(ire[j], iim[j]), make_float2(ire[jp], iim[jp]),
               __ldg(&wnb[j]), zk, zmk);
      buf[pad(j - off)] = zk;
      buf[pad(jp - off)] = zmk;
    }
    if (b == 0 && threadIdx.x == 0) {
      buf[0] = retangle0(make_float2(ire[0], iim[0]));
      buf[1] = make_float2(ire[1], -iim[1]);
    }
  }
  auto ld = [&](int i) { return buf[pad(i)]; };
  auto st = [&](int i, float2 v) { buf[pad(i)] = v; };
  for (int lo = 0; lo < log_l;) {
    __syncthreads();
    const int kk = min(kRadixBits, log_l - lo);
    pass<true>(kk, wst, lo, blockDim.x, ld, st);
    lo += kk;
  }
  cluster.sync();

  {
    float2* lower = b ? cluster.map_shared_rank(buf, 0) : buf;
    float2* upper = b ? buf : cluster.map_shared_rank(buf, 1);
    float2* hz = reinterpret_cast<float2*>(g_hist + row);
    float2* lz = reinterpret_cast<float2*>(g_last + row);
    const float2* uz = reinterpret_cast<const float2*>(gu + row);
    const float inv_m = 1.0f / (float)m;
    const int i0 = b * (l >> 1);
    for (int i = i0 + threadIdx.x; i < i0 + (l >> 1); i += blockDim.x) {
      const float2 tw = __ldg(&wst[l + i]);
      const float2 a = lower[pad(i)];
      const float2 c = cmulc(upper[pad(i)], tw);
      hz[i] = cscale(cadd(a, c), inv_m);
      const float2 d = cscale(csub(a, c), inv_m);
      if constexpr (kEq) {
        const float2 g = uz[i];
        const float2 ut = make_float2(__fadd_rn(d.x, g.x),
                                      __fadd_rn(d.y, g.y));
        lz[i] = ut;
        lower[pad(i)] = ut;
        upper[pad(i)] = cmul(ut, tw);
      } else {
        lz[i] = d;
      }
    }
  }
  // the partner reads or writes this block's shared memory until here
  cluster.sync();
  if constexpr (kEq) {
    int rem = log_l;
    while (rem > 0) {
      const int kk = min(kRadixBits, rem);
      rem -= kk;
      pass<false>(kk, wst, rem, blockDim.x, ld, st);
      __syncthreads();
    }
    float* ore = gp_re + row;
    float* oim = gp_im + row;
    for (int u = threadIdx.x; u < count; u += blockDim.x) {
      int j, jp;
      pair_of(t0 + u, j, jp);
      float2 xk, xmk;
      untangle(buf[pad(j - off)], buf[pad(jp - off)], __ldg(&wnb[j]), xk,
               xmk);
      ore[j] = xk.x;
      oim[j] = xk.y;
      ore[jp] = xmk.x;
      oim[jp] = xmk.y;
    }
    if (b == 0 && threadIdx.x == 0) {
      const float2 x0 = untangle0(buf[0]);
      const float2 x1 = cconj(buf[1]);
      ore[0] = x0.x;
      oim[0] = x0.y;
      ore[1] = x1.x;
      oim[1] = x1.y;
    }
  }
}

// a launch of `kernel` as clusters of `groups` blocks along the grid's z
template <class... Exp, class... Act>
cudaError_t cluster_launch(void (*kernel)(Exp...), dim3 grid, int threads,
                           int smem, int groups, cudaStream_t st,
                           Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = groups;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}

template <int kR>
cudaError_t launch_eqfdl_bwd(dim3 grid, int groups, cudaStream_t st,
                             const float* gp_re, const float* gp_im,
                             const float* gu, const float* heq_re,
                             const float* heq_im, const float* xs_re,
                             const float* xs_im, const float* x,
                             const float* sv, const float* g_t,
                             const float* w_mat, const float* gsv2,
                             float* gxs_re, float* gxs_im, float* gheq_re,
                             float* gheq_im, float* g_gt, float* g_w,
                             float* g_x, float* part_sv, int log_m, int c_n,
                             int k2) {
  const int smem = eq_smem_floats(k2) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      eqfdl_bwd<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cluster_launch(eqfdl_bwd<kR>, grid, kEqTile, smem, groups, st,
                        gp_re, gp_im, gu, heq_re, heq_im, xs_re, xs_im, x,
                        sv, g_t, w_mat, gsv2, gxs_re, gxs_im, gheq_re,
                        gheq_im, g_gt, g_w, g_x, part_sv, log_m, c_n, k2,
                        groups);
}

// the channel groups of c_n channels: a cluster's blocks
int groups_of(int c_n) { return c_n < kMaxGroups ? c_n : kMaxGroups; }

int tiles_of(int m, int tile) { return (m + tile - 1) / tile; }

}  // namespace

extern "C" {

// eqfdl_bwd's position tiles at M = 2^log_m: part_sv is [tiles, C, 2K]
int lsp_eqfdl_bwd_tiles(int log_m) {
  return bad_size(log_m) ? -1 : tiles_of(1 << log_m, kEqTile);
}

int lsp_fdl_bwd(const float* ring_re, const float* ring_im, const float* h_re,
                const float* h_im, const float* ga_re, const float* ga_im,
                const float* go_re, const float* go_im, float* gi_re,
                float* gi_im, float* gh_re, float* gh_im, float* gs_re,
                float* gs_im, int log_m, int p_n, int w, int c_n,
                void* stream) {
  if (bad_size(log_m) || p_n < 1 || p_n > 65535 || c_n < 1 || w < 0 ||
      w >= p_n)
    return (int)cudaErrorInvalidValue;
  const int groups = groups_of(c_n);
  return (int)cluster_launch(
      fdl_bwd, dim3(tiles_of(1 << log_m, kFdlTile), p_n, groups),
      kBwdThreads, 0, groups, (cudaStream_t)stream, ring_re, ring_im,
      h_re, h_im, ga_re, ga_im, go_re, go_im, gi_re, gi_im, gh_re, gh_im,
      gs_re, gs_im, log_m, p_n, w, c_n, groups);
}

int lsp_eqfdl_bwd(const float* gp_re, const float* gp_im, const float* gu,
                  const float* heq_re, const float* heq_im,
                  const float* xs_re, const float* xs_im, const float* x,
                  const float* sv, const float* g_t, const float* m_mat,
                  const float* w_mat, const float* gsv2, float* gxs_re,
                  float* gxs_im, float* gheq_re, float* gheq_im, float* g_gt,
                  float* g_m, float* g_w, float* g_sv, float* g_x,
                  float* part_sv, int log_m, int c_n, int k2, void* stream) {
  if (bad_size(log_m) || c_n < 1 || k2 < 2 || k2 > kMaxK2 || k2 % 2)
    return (int)cudaErrorInvalidValue;
  const int groups = groups_of(c_n);
  const int tiles = lsp_eqfdl_bwd_tiles(log_m);
  const dim3 grid(tiles, 1, groups);
  cudaStream_t st = (cudaStream_t)stream;
  // the chain's 2K = 18 (and less) in its own build: the one with room
  // for kMaxK2 holds 2 x 64 row sums a thread, and took 2.6x its time at
  // 2K = 18 on the H100 (0.0535 against 0.0206 ms)
  cudaError_t err =
      (k2 <= 18 ? launch_eqfdl_bwd<18> : launch_eqfdl_bwd<kMaxK2>)(
          grid, groups, st, gp_re, gp_im, gu, heq_re, heq_im, xs_re, xs_im,
          x, sv, g_t, w_mat, gsv2, gxs_re, gxs_im, gheq_re, gheq_im, g_gt,
          g_w, g_x, part_sv, log_m, c_n, k2);
  if (err != cudaSuccess) return (int)err;
  const int n = c_n * k2 + k2 * k2;      // outputs, a warp each
  eqfdl_bwd_sums<<<tiles_of(32 * n, kBwdThreads), kBwdThreads, 0, st>>>(
      part_sv, gsv2, m_mat, sv, g_sv, g_m, tiles, c_n, k2);
  return (int)cudaGetLastError();
}

// The frame's transforms of the backward over c_n channels (gs [C, M]
// -> g_hist, g_last [C, M]): fdl_fused_bwd's (gu, gp_re, gp_im null) or,
// with gu, eqfdl_fused_bwd's (g_last = g_ut; gp [C, M]).
int lsp_frame_bwd(const float* gs_re, const float* gs_im, const float* gu,
                  float* g_hist, float* g_last, float* gp_re, float* gp_im,
                  const float2* wst, const float2* wnb, int log_m, int c_n,
                  void* stream) {
  if (bad_size(log_m) || c_n < 1) return (int)cudaErrorInvalidValue;
  const bool eq = gu != nullptr;
  if (eq && (gp_re == nullptr || gp_im == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = half_smem(log_m);
  const int threads = (1 << (log_m - 1)) / kPts;
  auto kernel = eq ? frame_bwd_kernel<true> : frame_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<2 * c_n, threads, smem, (cudaStream_t)stream>>>(
      gs_re, gs_im, gu, g_hist, g_last, gp_re, gp_im, wst, wnb, log_m);
  return (int)cudaGetLastError();
}

int lsp_eqfdl_fused(float* ring_re, float* ring_im, const float* h_re,
                    const float* h_im, const float* heq_re,
                    const float* heq_im, const float* xs_re,
                    const float* xs_im, const float* x, const float* sv,
                    const float* g_t, const float* m_mat, const float* w_mat,
                    const float* hist, float* y, float* u, float* sv_out,
                    const float2* wst, const float2* wnb, int log_m, int p_n,
                    int w, int c_n, int k2, void* stream) {
  if (k2 > kMaxK2 || bad_size(log_m)) return (int)cudaErrorInvalidValue;
  const int smem = half_smem(log_m);
  cudaError_t err = cudaFuncSetAttribute(
      eqfdl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  eqfdl_kernel<<<2 * c_n, kThreads, smem, (cudaStream_t)stream>>>(
      ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re, xs_im, x, sv, g_t,
      m_mat, w_mat, hist, y, u, sv_out, wst, wnb, log_m, p_n, w, c_n, k2);
  return (int)cudaGetLastError();
}

// launch_shape of each kernel
int lsp_eqfdl_shape(int log_m, int c_n, int* out) {
  return launch_shape(eqfdl_kernel, log_m, c_n, out);
}

int lsp_fdl_shape(int log_m, int c_n, int* out) {
  return launch_shape(fdl_kernel, log_m, c_n, out);
}

int lsp_fdl_fused(float* ring_re, float* ring_im, const float* h_re,
                  const float* h_im, const float* hist, const float* x,
                  float* y, const float2* wst, const float2* wnb, int log_m,
                  int p_n, int w, int c_n, void* stream) {
  if (bad_size(log_m)) return (int)cudaErrorInvalidValue;
  const int smem = half_smem(log_m);
  cudaError_t err = cudaFuncSetAttribute(
      fdl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fdl_kernel<<<2 * c_n, kThreads, smem, (cudaStream_t)stream>>>(
      ring_re, ring_im, h_re, h_im, hist, x, y, wst, wnb, log_m, p_n, w, c_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
