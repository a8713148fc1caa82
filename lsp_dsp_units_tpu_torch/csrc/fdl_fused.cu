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

#include <cooperative_groups.h>

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

}  // namespace

extern "C" {

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
