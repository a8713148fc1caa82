"""Packed real FFT: the port of ops/pallas_fft.py.

Spectrum format ("packed"): a real N-point frame has N/2 + 1 complex
bins; the packed form stores them as exactly M = N/2 split-complex values
``(re, im)``, with the two real bins (DC and Nyquist) sharing position 0
(``re = DC``, ``im = Nyquist``) and bin ``k`` (0 < k < M) at position
``rev(k)``, the log2(M)-bit reversal of ``k``.  Bit-reversed order is
what the CUDA transform produces without a permutation pass
(``csrc/fft_packed.cuh``); like the JAX package's scrambled order, no
consumer on the chain looks at bin order: the ring MAC is elementwise,
and the IR and EQ spectra are packed once at build time by
:func:`pack_spectra`.

Each transform has a plain PyTorch version (``*_plain``, over
``torch.fft``) and a wrapper that runs the plain version for CPU tensors
and launches the CUDA kernel (``csrc/fft_packed.cu``: two blocks per
row, several radix-2 stages per shared-memory pass) for CUDA tensors.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

Gradients: under autograd (grad mode on, an input that requires grad)
each wrapper runs as a ``torch.autograd.Function`` whose backward is the
adjoint transform, worked out from the packed layout; it is the other
direction's packed transform with weights that are powers of two, so on
the card each backward is one launch of that transform's code with the
weights applied as it loads (``rfft_packed_bwd_kernel``) or stores
(``irfft_packed_bwd_kernel``) the spectrum, exactly, counted in
``<wrapper>.bwd_launches``; the plain versions weight apart
(``_weighted``) around ``torch.fft``:

* ``rfft_packed``: the forward's outputs are Re X[k] and Im X[k] for the
  interior bins and the real DC and Nyquist bins at position 0.  Their
  cotangent, weighted N at position 0 (each real bin appears once in
  the inverse's sum) and N / 2 elsewhere (the inverse counts an interior
  bin twice and divides by N), is a packed spectrum whose inverse
  (``irfft_packed``) is the gradient; ``rfft_packed_zeropad``'s is its
  first half (``half="first"``).
* ``irfft_packed``: the gradient of position p is the forward transform
  of the output's cotangent (zero where ``half=`` dropped samples),
  weighted 1 / N at position 0 and 2 / N elsewhere.  With ``half=`` the
  cotangent fills one half of the frame: the first half is
  ``rfft_packed_zeropad``'s input; the last half is too, shifted by N /
  2, which multiplies natural bin k by (-1)^k, and bin k is odd exactly
  at packed positions p >= N / 4.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from lsp_dsp_units_tpu_torch.ops import _build

Half = Union[bool, str]

_SIGS = {
    "lsp_rfft_packed": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "lsp_irfft_packed": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "lsp_rfft_packed_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "lsp_irfft_packed_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "lsp_fft_packed_shape": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}

MIN_M = 64            # smallest transform with the pair mapping's octaves
MAX_M = 16384         # 128 KB of shared memory per row


def supported(n: int) -> bool:
    """True for the frame sizes the kernels take: N a power of two with
    2 * MIN_M <= N <= 2 * MAX_M."""
    return n > 0 and not n & (n - 1) and MIN_M <= n // 2 <= MAX_M


def log2_m(n: int) -> int:
    """log2(N/2) for a supported frame size N (power of two)."""
    if not supported(n):
        raise ValueError(f"packed FFT needs N a power of two with "
                         f"{2 * MIN_M} <= N <= {2 * MAX_M}, got {n}")
    return (n // 2).bit_length() - 1


@functools.lru_cache(maxsize=8)
def bitrev(m: int) -> np.ndarray:
    """Packed position -> natural bin index (an involution)."""
    bits = m.bit_length() - 1
    j = np.arange(m)
    r = np.zeros(m, np.int64)
    for b in range(bits):
        r |= ((j >> b) & 1) << (bits - 1 - b)
    return r


@functools.lru_cache(maxsize=16)
def _bitrev_index(m: int, device: torch.device) -> torch.Tensor:
    """:func:`bitrev` as an index tensor on ``device``, made once: the
    packing sits on the step's path, where a host-to-device copy per call
    would wait for the card."""
    return torch.as_tensor(bitrev(m), device=device)


@functools.lru_cache(maxsize=8)
def tables(n: int, device: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twiddles computed in float64 and rounded once, each [M, 2]
    float32 (interleaved re, im): the per-stage table ``wst[h + j] =
    exp(-2 pi i j / 2h)`` (h = 1, 2, ..., M/2; j < h) and the untangle
    table ``wnb[j] = exp(-2 pi i rev(j) / N)`` in packed order."""
    m = n // 2
    wst = np.ones(m, np.complex128)
    h = 1
    while h < m:
        wst[h:2 * h] = np.exp(-1j * np.pi * np.arange(h) / h)
        h *= 2
    wnb = np.exp(-2j * np.pi * bitrev(m) / n)

    def f32(z):
        return torch.from_numpy(np.ascontiguousarray(
            np.stack([z.real, z.imag], axis=-1), np.float32)).to(device)

    return f32(wst), f32(wnb)


# ---------------------------------------------------------------------------
# layout helpers (device-agnostic tensor code)
# ---------------------------------------------------------------------------


def pack_spectra(re: torch.Tensor, im: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Natural-order rfft spectrum [..., N/2 + 1] -> packed [..., N/2]."""
    m = n // 2
    idx = _bitrev_index(m, re.device)
    pre = re[..., :m].index_select(-1, idx)
    pim = im[..., :m].index_select(-1, idx)
    pim[..., 0] = re[..., m]
    return pre.contiguous(), pim.contiguous()


def unpack_spectra(pre: torch.Tensor, pim: torch.Tensor, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_spectra`."""
    m = n // 2
    idx = _bitrev_index(m, pre.device)
    re_nat = pre.index_select(-1, idx)
    im_nat = pim.index_select(-1, idx)
    im_nat[..., 0] = 0.0
    re = torch.cat([re_nat, pim[..., :1]], dim=-1)
    im = torch.cat([im_nat, torch.zeros_like(pim[..., :1])], dim=-1)
    return re, im


def mul_packed(ar, ai, br, bi):
    """Elementwise product of two packed spectra: complex everywhere
    except position 0, whose (DC, Nyquist) slots multiply slot-wise."""
    pr = ar * br - ai * bi
    pi = ar * bi + ai * br
    pr[..., 0] = ar[..., 0] * br[..., 0]
    pi[..., 0] = ai[..., 0] * bi[..., 0]
    return pr, pi


def mul_conj_packed(ar, ai, br, bi):
    """``a * conj(b)`` of two packed spectra, position 0 slot-wise: the
    adjoint of :func:`mul_packed` (the cotangent of one factor is that of
    the product times the other's conjugate)."""
    pr = ar * br + ai * bi
    pi = ai * br - ar * bi
    pr[..., 0] = ar[..., 0] * br[..., 0]
    pi[..., 0] = ai[..., 0] * bi[..., 0]
    return pr, pi


# ---------------------------------------------------------------------------
# plain versions (torch.fft on any device)
# ---------------------------------------------------------------------------


def _rfft_torch(x: torch.Tensor, n: int):
    s = torch.fft.rfft(x, n=n)
    return s.real.contiguous(), s.imag.contiguous()


def rfft_packed_plain(x: torch.Tensor):
    n = x.shape[-1]
    return pack_spectra(*_rfft_torch(x, n), n)


def rfft_packed_zeropad_plain(x: torch.Tensor):
    n = 2 * x.shape[-1]
    return pack_spectra(*_rfft_torch(x, n), n)


def half_mode(half: Half) -> int:
    if half is True:
        half = "last"
    return {False: 0, None: 0, "first": 1, "last": 2}[half]


def irfft_packed_plain(re: torch.Tensor, im: torch.Tensor, n: int,
                       half: Half = False) -> torch.Tensor:
    nre, nim = unpack_spectra(re, im, n)
    y = torch.fft.irfft(torch.complex(nre, nim), n=n)
    mode = half_mode(half)
    if mode == 1:
        return y[..., :n // 2].contiguous()
    if mode == 2:
        return y[..., n // 2:].contiguous()
    return y


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    return _build.load("fft_packed", _SIGS)


def launch_shape(n: int) -> dict:
    """How the kernels launch at frame size N (needs the card): blocks
    per row, threads and dynamic shared memory (bytes) per block, and
    forward blocks resident per SM by the occupancy calculator."""
    out = (ctypes.c_int * 4)()
    _build.check(_lib().lsp_fft_packed_shape(log2_m(n), out),
                 "fft_packed launch shape")
    return dict(blocks_per_row=out[0], threads=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3])


def _rfft_launch(x: torch.Tensor, n: int, half_input: int):
    _build.check_cuda_f32(x=x)
    rows = x.numel() // x.shape[-1]
    lm = log2_m(n)
    out_re = torch.empty(x.shape[:-1] + (n // 2,), dtype=torch.float32,
                         device=x.device)
    out_im = torch.empty_like(out_re)
    wst, wnb = tables(n, x.device)
    _build.check(_lib().lsp_rfft_packed(
        _build.ptr(x), _build.ptr(out_re), _build.ptr(out_im),
        _build.ptr(wst), _build.ptr(wnb), rows, lm, half_input,
        _build.stream_of(x)), "rfft_packed kernel")
    return out_re, out_im


def _rfft(x: torch.Tensor, half_input: int):
    """Forward transform outside autograd: the plain version for CPU
    tensors, the kernel for CUDA tensors (counted on its wrapper)."""
    if half_input:
        if _build.is_cpu(x):
            return rfft_packed_zeropad_plain(x)
        out = _rfft_launch(x, 2 * x.shape[-1], 1)
        rfft_packed_zeropad.launches += 1
        return out
    if _build.is_cpu(x):
        return rfft_packed_plain(x)
    out = _rfft_launch(x, x.shape[-1], 0)
    rfft_packed.launches += 1
    return out


def rfft_packed(x: torch.Tensor):
    """Real N-point FFT of x [..., N] -> packed (re, im) [..., N/2]."""
    if _build.needs_grad(x):
        return _Rfft.apply(x, 0)
    return _rfft(x, 0)


def rfft_packed_zeropad(x: torch.Tensor):
    """rfft_packed of ``x || zeros`` (N = 2 * x.shape[-1]) without
    materializing the zero half."""
    if _build.needs_grad(x):
        return _Rfft.apply(x, 1)
    return _rfft(x, 1)


def _irfft_launch(re, im, n: int, mode: int) -> torch.Tensor:
    _build.check_cuda_f32(re=re, im=im)
    lm = log2_m(n)
    if re.shape[-1] != n // 2 or im.shape != re.shape:
        raise ValueError(f"packed spectra must be [..., {n // 2}], got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    rows = re.numel() // re.shape[-1]
    y = torch.empty(re.shape[:-1] + (n if mode == 0 else n // 2,),
                    dtype=torch.float32, device=re.device)
    wst, wnb = tables(n, re.device)
    _build.check(_lib().lsp_irfft_packed(
        _build.ptr(re), _build.ptr(im), _build.ptr(y), _build.ptr(wst),
        _build.ptr(wnb), rows, lm, mode, _build.stream_of(re)),
        "irfft_packed kernel")
    return y


def _irfft(re, im, n: int, half: Half) -> torch.Tensor:
    """Inverse transform outside autograd (counted on its wrapper)."""
    if _build.is_cpu(re, im):
        return irfft_packed_plain(re, im, n, half)
    y = _irfft_launch(re, im, n, half_mode(half))
    irfft_packed.launches += 1
    return y


def irfft_packed(re: torch.Tensor, im: torch.Tensor, n: int,
                 half: Half = False) -> torch.Tensor:
    """Inverse of :func:`rfft_packed`: packed [..., N/2] -> real
    [..., N], or only its first (``half="first"``) or last
    (``"last"`` / True) N/2 samples."""
    if _build.needs_grad(re, im):
        return _Irfft.apply(re, im, n, half)
    return _irfft(re, im, n, half)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous, 16-byte aligned tensor (the kernels read rows as
    float4)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _weighted(re, im, w0: float, w: float, flip_upper: bool = False):
    """A packed spectrum times w, position 0 times w0; with
    ``flip_upper``, positions p >= M / 2 negated (the odd natural
    bins).  The weights are powers of two, so exact."""
    m = re.shape[-1]
    scale = torch.full((m,), w, dtype=re.dtype, device=re.device)
    if flip_upper:
        scale[m // 2:] = -w
    scale[0] = w0
    return _aligned(re * scale), _aligned(im * scale)


def _rfft_adjoint_in(g_re, g_im, n: int):
    return _weighted(g_re, g_im, float(n), n / 2)


def rfft_packed_bwd_plain(g_re, g_im, n: int, half_input: int = 0):
    """Plain PyTorch version of :func:`rfft_packed_bwd`."""
    sr, si = _rfft_adjoint_in(g_re, g_im, n)
    return irfft_packed_plain(sr, si, n, "first" if half_input else False)


def rfft_packed_bwd(g_re, g_im, n: int, half_input: int = 0):
    """Backward of :func:`rfft_packed` (``half_input`` 0) and
    :func:`rfft_packed_zeropad` (1) at frame size N: the packed
    cotangent [..., N/2] weighted N at position 0 and N / 2 elsewhere,
    through the inverse (its whole frame, or its first half).  On the
    card one launch of ``rfft_packed_bwd_kernel``, the weights applied as
    it loads the cotangent, counted in the forward wrapper's
    ``bwd_launches``."""
    if _build.is_cpu(g_re, g_im):
        return rfft_packed_bwd_plain(g_re, g_im, n, half_input)
    g_re, g_im = _aligned(g_re), _aligned(g_im)
    _build.check_cuda_f32(g_re=g_re, g_im=g_im)
    lm = log2_m(n)
    if g_re.shape[-1] != n // 2 or g_im.shape != g_re.shape:
        raise ValueError(f"packed cotangents must be [..., {n // 2}], got "
                         f"{tuple(g_re.shape)} and {tuple(g_im.shape)}")
    rows = g_re.numel() // g_re.shape[-1]
    gx = torch.empty(g_re.shape[:-1] + (n // 2 if half_input else n,),
                     dtype=torch.float32, device=g_re.device)
    wst, wnb = tables(n, g_re.device)
    _build.check(_lib().lsp_rfft_packed_bwd(
        _build.ptr(g_re), _build.ptr(g_im), _build.ptr(gx), _build.ptr(wst),
        _build.ptr(wnb), rows, lm, 1 if half_input else 0,
        _build.stream_of(g_re)), "rfft_packed_bwd kernel")
    (rfft_packed_zeropad if half_input else rfft_packed).bwd_launches += 1
    return gx


def _irfft_adjoint_out(g_re, g_im, n: int, mode: int):
    return _weighted(g_re, g_im, 1.0 / n, 2.0 / n, mode == 2)


def irfft_packed_bwd_plain(g_y, n: int, half: Half = False):
    """Plain PyTorch version of :func:`irfft_packed_bwd`."""
    mode = half_mode(half)
    g_re, g_im = (rfft_packed_plain(g_y) if mode == 0
                  else rfft_packed_zeropad_plain(g_y))
    return _irfft_adjoint_out(g_re, g_im, n, mode)


def irfft_packed_bwd(g_y, n: int, half: Half = False):
    """Backward of :func:`irfft_packed`: the forward transform of the
    output's cotangent (the whole frame, or the half given, through the
    zero-pad form), weighted 1 / N at position 0 and 2 / N elsewhere,
    the odd bins negated for the last half.  On the card one launch of
    ``irfft_packed_bwd_kernel``, the weights applied as it stores the
    spectrum, counted in ``irfft_packed.bwd_launches``."""
    mode = half_mode(half)
    g_y = _aligned(g_y)
    if _build.is_cpu(g_y):
        return irfft_packed_bwd_plain(g_y, n, half)
    _build.check_cuda_f32(g_y=g_y)
    lm = log2_m(n)
    if g_y.shape[-1] != (n if mode == 0 else n // 2):
        raise ValueError(f"the cotangent of irfft_packed(n={n}, half="
                         f"{half!r}) must be [..., "
                         f"{n if mode == 0 else n // 2}], got "
                         f"{tuple(g_y.shape)}")
    rows = g_y.numel() // g_y.shape[-1]
    g_re = torch.empty(g_y.shape[:-1] + (n // 2,), dtype=torch.float32,
                       device=g_y.device)
    g_im = torch.empty_like(g_re)
    wst, wnb = tables(n, g_y.device)
    _build.check(_lib().lsp_irfft_packed_bwd(
        _build.ptr(g_y), _build.ptr(g_re), _build.ptr(g_im), _build.ptr(wst),
        _build.ptr(wnb), rows, lm, mode, _build.stream_of(g_y)),
        "irfft_packed_bwd kernel")
    irfft_packed.bwd_launches += 1
    return g_re, g_im


class _Rfft(torch.autograd.Function):
    """:func:`rfft_packed` (``half_input`` 0) and
    :func:`rfft_packed_zeropad` (1) under autograd."""

    @staticmethod
    def forward(ctx, x, half_input):
        ctx.half_input = half_input
        ctx.n = x.shape[-1] * (2 if half_input else 1)
        return _rfft(x, half_input)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_re, g_im):
        return rfft_packed_bwd(g_re, g_im, ctx.n, ctx.half_input), None


class _Irfft(torch.autograd.Function):
    """:func:`irfft_packed` under autograd."""

    @staticmethod
    def forward(ctx, re, im, n, half):
        ctx.n, ctx.half = n, half
        return _irfft(re, im, n, half)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_y):
        g_re, g_im = irfft_packed_bwd(g_y, ctx.n, ctx.half)
        return g_re, g_im, None, None


rfft_packed.launches = 0
rfft_packed_zeropad.launches = 0
irfft_packed.launches = 0
rfft_packed.bwd_launches = 0
rfft_packed_zeropad.bwd_launches = 0
irfft_packed.bwd_launches = 0
