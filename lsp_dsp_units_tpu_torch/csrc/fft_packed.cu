// Packed real FFT for Hopper: forward (full or zero-padded input) and
// inverse (all, first or last half of the output), two thread blocks per
// row.
//
// Replaces the TPU kernel ops/pallas_fft.py::_call of the JAX package
// (_fwd_kernel/_inv_kernel -> _fwd_tile/_inv_tile), which ran the
// transform as a four-step of bf16x3 matmuls on the MXU.  Here it is the
// radix-2 FP32 FMA transform of fft_packed.cuh (in-place DIF forward,
// DIT inverse, packed bit-reversed spectra), with the same butterflies on
// the same operands in the same order as one block per row running one
// stage per pass would, so its output is bitwise that schedule's; the
// fused kernels (fdl_fused.cu) run the same split.
//
// What bounds it: each row reads and writes N floats once (at the main
// path's 64 x 16384, 4 MB each way: ~2.5 us of HBM at 3.35 TB/s).  One
// block per row with one shared-memory pass per radix-2 stage would be
// bound instead by 13 barriers and 13 passes of shared-memory and
// twiddle traffic on only 64 of the card's 132 SMs.  The schedule here:
//
// * Two blocks per row.  After the first DIF stage (span M/2) the two
//   halves of the M complex points are independent transforms, and the
//   untangle never pairs positions across halves (pair_of maps each
//   octave [2^a, 2^(a+1)) onto itself; positions 0 and 1 lie in the
//   first half).  So block b of a row loads exactly the first-stage
//   outputs of its half (a + c, or (a - c) w), transforms M/2 points in
//   its own shared memory, untangles and writes its half: 64 rows are 128
//   blocks.  The inverse is the mirror image: each block retangles its
//   half and runs every DIT stage but the last locally; the last stage
//   (span M/2) pairs the halves, so the two blocks of a row form a
//   cluster and read the partner's shared memory (DSMEM).
// * Several stages per shared-memory pass.  Each thread holds kPts = 16
//   points in registers and runs up to four consecutive radix-2 stages on
//   them before the next exchange, loading each distinct twiddle once per
//   pass: at M = 8192, 12 local stages in 3 passes and 3 barriers.  The
//   exchange is padded (one float2 per 16) so that neither the strided
//   nor the contiguous groups conflict on banks.
//
// What bounds it now: each block's passes, their shared-memory latency
// and barriers (3 at M = 8192), in one wave of 2 x rows blocks; the card
// could move the bytes ~5x faster.  Threads per block: (M/2) / 16, from
// 2 (N = 128) to 512 (N = 32768).
//
// The adjoints of the two transforms (ops/fft_packed.py's backwards) are
// the other direction's transform with weights that are powers of two:
// rfft_packed_bwd_kernel is the inverse on the packed cotangent, each
// value multiplied as it is loaded; irfft_packed_bwd_kernel the forward
// transform of the output's cotangent, each value multiplied (and in the
// upper half negated, for the last half) as it is stored.  They share
// their bodies (rfft_row, irfft_row) with the inference kernels, whose
// code the template leaves as it was, and their products are exact, so
// their outputs are those of the weights and the transform launched
// apart, bit for bit, in one launch and no pass over the spectra.

#include <cooperative_groups.h>

#include "fft_packed.cuh"

namespace cg = cooperative_groups;
using namespace lspfft;

namespace {

constexpr int kMaxThreads = 8192 / kPts;       // M/2 = 8192 at N = 32768

// blockIdx.x = 2 * row + b: block b owns packed positions [b L, (b+1) L),
// L = M/2.  kAdj: irfft_packed's adjoint (ops/fft_packed.py::
// irfft_packed_bwd), each output stored times 2/N, position 0's times 1/N,
// and negated in block 1 (packed positions >= M/2, the odd natural bins)
// where flip: powers of two, so each product (__fmul_rn, never contracted
// into a neighbour's FMA) is the one the weights gave after the transform.
template <bool kAdj>
__device__ __forceinline__ void rfft_row(const float* __restrict__ x,
                                         float* __restrict__ out_re,
                                         float* __restrict__ out_im,
                                         const float2* __restrict__ wst,
                                         const float2* __restrict__ wnb,
                                         int log_m, int half_input, int flip) {
  extern __shared__ __align__(16) float2 buf[];
  const int log_l = log_m - 1;
  const int l = 1 << log_l;
  const int row = blockIdx.x >> 1;
  const int b = blockIdx.x & 1;
  const float2* xz = reinterpret_cast<const float2*>(x) +
                     (size_t)row * (half_input ? l : 2 * l);
  // the first DIF stage (span L, across the halves) fused into the load;
  // with z[n] = 0 for n >= L it is a copy and a twiddle
  auto ld_first = [&](int i) {
    const float2 a = xz[i];
    if (half_input) return b ? cmul(a, __ldg(&wst[l + i])) : a;
    const float2 c = xz[i + l];
    return b ? cmul(csub(a, c), __ldg(&wst[l + i])) : cadd(a, c);
  };
  auto ld = [&](int i) { return buf[pad(i)]; };
  auto st = [&](int i, float2 v) { buf[pad(i)] = v; };
  int rem = log_l;
  for (bool first = true; rem > 0; first = false) {
    const int kk = min(kRadixBits, rem);
    rem -= kk;
    if (first) pass<false>(kk, wst, rem, blockDim.x, ld_first, st);
    else pass<false>(kk, wst, rem, blockDim.x, ld, st);
    __syncthreads();
  }

  float* ore = out_re + (size_t)row * 2 * l;
  float* oim = out_im + (size_t)row * 2 * l;
  const int off = b * l;
  // the adjoint's weights: 2/N = 2^-log_m, exact in float
  const float w = kAdj ? 1.0f / (float)(1 << log_m) : 1.0f;
  const float wb = kAdj && flip && b ? -w : w;
  auto put = [&](int j, float2 v, float s) {
    if constexpr (kAdj) {
      ore[j] = __fmul_rn(v.x, s);
      oim[j] = __fmul_rn(v.y, s);
    } else {
      ore[j] = v.x;
      oim[j] = v.y;
    }
  };
  int t0, count;
  half_pairs(b, l, t0, count);
  for (int u = threadIdx.x; u < count; u += blockDim.x) {
    int j, jp;
    pair_of(t0 + u, j, jp);
    float2 xk, xmk;
    untangle(buf[pad(j - off)], buf[pad(jp - off)], __ldg(&wnb[j]), xk, xmk);
    put(j, xk, wb);
    put(jp, xmk, wb);
  }
  if (b == 0 && threadIdx.x == 0) {
    put(0, untangle0(buf[0]), 0.5f * w);
    put(1, cconj(buf[1]), w);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
rfft_packed_kernel(const float* __restrict__ x, float* __restrict__ out_re,
                   float* __restrict__ out_im, const float2* __restrict__ wst,
                   const float2* __restrict__ wnb, int log_m, int half_input) {
  rfft_row<false>(x, out_re, out_im, wst, wnb, log_m, half_input, 0);
}

// irfft_packed's adjoint: the forward transform of the output's cotangent
// (the whole frame, or a half through the zero-pad form), weighted
__global__ void __launch_bounds__(kMaxThreads)
irfft_packed_bwd_kernel(const float* __restrict__ g,
                        float* __restrict__ out_re, float* __restrict__ out_im,
                        const float2* __restrict__ wst,
                        const float2* __restrict__ wnb, int log_m,
                        int half_input, int flip) {
  rfft_row<true>(g, out_re, out_im, wst, wnb, log_m, half_input, flip);
}

// half: 0 = all N samples, 1 = first N/2, 2 = last N/2.  A cluster of the
// two blocks of a row; block b retangles half b and runs the local DIT
// stages, then the last stage (span L) pairs point i of half 0 with
// point i of half 1, and block b computes it for i in [b L/2, (b+1) L/2).
// kAdj: rfft_packed's adjoint (ops/fft_packed.py::rfft_packed_bwd), the
// packed cotangent loaded times N/2, position 0's times N (__fmul_rn,
// exact: powers of two).
template <bool kAdj>
__device__ __forceinline__ void irfft_row(const float* __restrict__ in_re,
                                          const float* __restrict__ in_im,
                                          float* __restrict__ y,
                                          const float2* __restrict__ wst,
                                          const float2* __restrict__ wnb,
                                          int log_m, int half) {
  extern __shared__ __align__(16) float2 buf[];
  cg::cluster_group cluster = cg::this_cluster();
  const int log_l = log_m - 1;
  const int l = 1 << log_l;
  const int row = blockIdx.x >> 1;
  const int b = (int)cluster.block_rank();
  const float* ire = in_re + (size_t)row * 2 * l;
  const float* iim = in_im + (size_t)row * 2 * l;
  const int off = b * l;
  // the adjoint's weights: N/2 = M = 2^log_m, exact in float
  const float w = kAdj ? (float)(1 << log_m) : 1.0f;
  auto get = [&](int j, float s) {
    if constexpr (kAdj)
      return make_float2(__fmul_rn(ire[j], s), __fmul_rn(iim[j], s));
    else
      return make_float2(ire[j], iim[j]);
  };
  int t0, count;
  half_pairs(b, l, t0, count);
  for (int u = threadIdx.x; u < count; u += blockDim.x) {
    int j, jp;
    pair_of(t0 + u, j, jp);
    float2 zk, zmk;
    retangle(get(j, w), get(jp, w), __ldg(&wnb[j]), zk, zmk);
    buf[pad(j - off)] = zk;
    buf[pad(jp - off)] = zmk;
  }
  if (b == 0 && threadIdx.x == 0) {
    buf[0] = retangle0(get(0, 2.0f * w));
    buf[1] = cconj(get(1, w));
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

  const float2* lower = b ? cluster.map_shared_rank(buf, 0) : buf;
  const float2* upper = b ? buf : cluster.map_shared_rank(buf, 1);
  const int cnt = half == 0 ? 2 * l : l;
  float2* yz = reinterpret_cast<float2*>(y) + (size_t)row * cnt;
  const float inv_m = 1.0f / (float)(2 * l);
  const int i0 = b * (l >> 1);
  for (int i = i0 + threadIdx.x; i < i0 + (l >> 1); i += blockDim.x) {
    const float2 a = lower[pad(i)];
    const float2 c = cmulc(upper[pad(i)], __ldg(&wst[l + i]));
    if (half != 2) yz[i] = cscale(cadd(a, c), inv_m);
    if (half != 1) yz[(half == 0 ? l : 0) + i] = cscale(csub(a, c), inv_m);
  }
  // the partner reads this block's shared memory until it passes here
  cluster.sync();
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kMaxThreads)
irfft_packed_kernel(const float* __restrict__ in_re,
                    const float* __restrict__ in_im, float* __restrict__ y,
                    const float2* __restrict__ wst,
                    const float2* __restrict__ wnb, int log_m, int half) {
  irfft_row<false>(in_re, in_im, y, wst, wnb, log_m, half);
}

// rfft_packed's adjoint: the inverse of the weighted packed cotangent (the
// whole frame, or its first half for the zero-pad form)
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kMaxThreads)
rfft_packed_bwd_kernel(const float* __restrict__ g_re,
                       const float* __restrict__ g_im, float* __restrict__ gx,
                       const float2* __restrict__ wst,
                       const float2* __restrict__ wnb, int log_m, int half) {
  irfft_row<true>(g_re, g_im, gx, wst, wnb, log_m, half);
}

// threads and dynamic shared memory of one block of any of the kernels
void block_shape(int log_m, int& threads, int& smem) {
  const int l = 1 << (log_m - 1);
  threads = l / kPts;
  smem = padded(l) * (int)sizeof(float2);
}

}  // namespace

extern "C" {

int lsp_rfft_packed(const float* x, float* out_re, float* out_im,
                    const float2* wst, const float2* wnb, int rows, int log_m,
                    int half_input, void* stream) {
  if (bad_size(log_m)) return (int)cudaErrorInvalidValue;
  int threads, smem;
  block_shape(log_m, threads, smem);
  cudaError_t err = cudaFuncSetAttribute(
      rfft_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rfft_packed_kernel<<<2 * rows, threads, smem, (cudaStream_t)stream>>>(
      x, out_re, out_im, wst, wnb, log_m, half_input);
  return (int)cudaGetLastError();
}

int lsp_irfft_packed(const float* in_re, const float* in_im, float* y,
                     const float2* wst, const float2* wnb, int rows, int log_m,
                     int half, void* stream) {
  if (bad_size(log_m)) return (int)cudaErrorInvalidValue;
  int threads, smem;
  block_shape(log_m, threads, smem);
  cudaError_t err = cudaFuncSetAttribute(
      irfft_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  irfft_packed_kernel<<<2 * rows, threads, smem, (cudaStream_t)stream>>>(
      in_re, in_im, y, wst, wnb, log_m, half);
  return (int)cudaGetLastError();
}

// rfft_packed's adjoint (half_input 0) and rfft_packed_zeropad's (1): the
// packed cotangent [rows, M] -> gx [rows, N] or [rows, N/2]
int lsp_rfft_packed_bwd(const float* g_re, const float* g_im, float* gx,
                        const float2* wst, const float2* wnb, int rows,
                        int log_m, int half_input, void* stream) {
  if (bad_size(log_m)) return (int)cudaErrorInvalidValue;
  int threads, smem;
  block_shape(log_m, threads, smem);
  cudaError_t err = cudaFuncSetAttribute(
      rfft_packed_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  rfft_packed_bwd_kernel<<<2 * rows, threads, smem, (cudaStream_t)stream>>>(
      g_re, g_im, gx, wst, wnb, log_m, half_input ? 1 : 0);
  return (int)cudaGetLastError();
}

// irfft_packed's adjoint: mode 0 (the whole frame's cotangent [rows, N]),
// 1 and 2 (the first or last half's, [rows, N/2]) -> the packed
// cotangent [rows, M]
int lsp_irfft_packed_bwd(const float* g, float* g_re, float* g_im,
                         const float2* wst, const float2* wnb, int rows,
                         int log_m, int mode, void* stream) {
  if (bad_size(log_m) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  int threads, smem;
  block_shape(log_m, threads, smem);
  cudaError_t err = cudaFuncSetAttribute(
      irfft_packed_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  irfft_packed_bwd_kernel<<<2 * rows, threads, smem, (cudaStream_t)stream>>>(
      g, g_re, g_im, wst, wnb, log_m, mode != 0, mode == 2);
  return (int)cudaGetLastError();
}

// The launch shape at log2(M) = log_m: out[0] blocks per row, out[1]
// threads per block, out[2] dynamic shared memory per block (bytes),
// out[3] forward blocks resident per SM (the occupancy calculator).
int lsp_fft_packed_shape(int log_m, int* out) {
  if (bad_size(log_m)) return (int)cudaErrorInvalidValue;
  int threads, smem;
  block_shape(log_m, threads, smem);
  cudaError_t err = cudaFuncSetAttribute(
      rfft_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rfft_packed_kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = 2;
  out[1] = threads;
  out[2] = smem;
  out[3] = per_sm;
  return 0;
}

}  // extern "C"
