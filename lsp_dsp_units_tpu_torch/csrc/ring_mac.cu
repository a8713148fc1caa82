// The ring-FDL spectra MAC with the in-place slot write, alone: the
// convolver's per-block work between its forward and inverse FFTs when
// they run as separate kernels (rfft -> ring_mac -> irfft).
//
//   acc[c, f] = sum_p ring'[p, c, f] * H[(w - p) % P, f]   (p ascending)
//   ring[w, c, f] := S[c, f]
//
// where ring' is the ring with slot w read as the new spectrum S.  With
// packed_dc, position 0 of each row holds the two real bins (DC, Nyquist)
// and multiplies slot-wise (ops/fft_packed.py's layout).  Works on natural
// rows (F = B + 1, odd: scalar loads) and packed rows (F = B).
//
// Replaces the TPU kernel ops/pallas_fdl.py::ring_mac_pallas of the JAX
// package (_kernel), which runs the partitions as a sequential grid axis
// with the accumulator resident in VMEM.  Here one thread owns one bin of
// one channel and loops over the partitions in registers, in the
// reference's ascending order.
//
// What bounds it: HBM.  At 64 channels, B = 8192, P = 6 it reads P-1 ring
// slots, the IR spectra and S, and writes acc and one slot: ~34 MB, ~10
// us at 3.35 TB/s.  Consecutive threads take consecutive bins, so every
// ring, IR, S and acc access of a warp is one coalesced row segment.
// Slot w is never read, only written, so the in-place write races with no
// read.  The products and sums round each operation (__fmul_rn,
// __fadd_rn, no FMA contraction), as the plain PyTorch version's separate
// element-wise ops do, so the two agree bit for bit on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ring_mac_kernel(float* __restrict__ ring_re, float* __restrict__ ring_im,
                const float* __restrict__ h_re,
                const float* __restrict__ h_im,
                const float* __restrict__ s_re,
                const float* __restrict__ s_im, float* __restrict__ acc_re,
                float* __restrict__ acc_im, int p_n, int w, int c_n,
                int f_n, int packed_dc) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= f_n) return;
  const size_t plane = (size_t)c_n * f_n;
  const size_t row = (size_t)blockIdx.y * f_n + f;
  const float sr = s_re[row];
  const float si = s_im[row];
  const bool slotwise = packed_dc && f == 0;
  float ar = 0.0f, ai = 0.0f;
  for (int p = 0; p < p_n; ++p) {
    const int q = (w - p + p_n) % p_n;
    float vr = sr, vi = si;
    if (p != w) {
      vr = ring_re[p * plane + row];
      vi = ring_im[p * plane + row];
    }
    const float hr = __ldg(&h_re[(size_t)q * f_n + f]);
    const float hi = __ldg(&h_im[(size_t)q * f_n + f]);
    float pr, pi;
    if (slotwise) {
      pr = __fmul_rn(vr, hr);
      pi = __fmul_rn(vi, hi);
    } else {
      pr = __fsub_rn(__fmul_rn(vr, hr), __fmul_rn(vi, hi));
      pi = __fadd_rn(__fmul_rn(vr, hi), __fmul_rn(vi, hr));
    }
    ar = __fadd_rn(ar, pr);
    ai = __fadd_rn(ai, pi);
  }
  ring_re[w * plane + row] = sr;
  ring_im[w * plane + row] = si;
  acc_re[row] = ar;
  acc_im[row] = ai;
}

}  // namespace

extern "C" {

int lsp_ring_mac(float* ring_re, float* ring_im, const float* h_re,
                 const float* h_im, const float* s_re, const float* s_im,
                 float* acc_re, float* acc_im, int p_n, int w, int c_n,
                 int f_n, int packed_dc, void* stream) {
  if (c_n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((f_n + kThreads - 1) / kThreads, c_n);
  ring_mac_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ring_re, ring_im, h_re, h_im, s_re, s_im, acc_re, acc_im, p_n, w, c_n,
      f_n, packed_dc);
  return (int)cudaGetLastError();
}

}  // extern "C"
