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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import _build

Half = Union[bool, str]

_SIGS = {
    "lsp_rfft_packed": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "lsp_irfft_packed": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
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


def rfft_packed(x: torch.Tensor):
    """Real N-point FFT of x [..., N] -> packed (re, im) [..., N/2]."""
    if _build.is_cpu(x):
        return rfft_packed_plain(x)
    out = _rfft_launch(x, x.shape[-1], 0)
    rfft_packed.launches += 1
    return out


def rfft_packed_zeropad(x: torch.Tensor):
    """rfft_packed of ``x || zeros`` (N = 2 * x.shape[-1]) without
    materializing the zero half."""
    if _build.is_cpu(x):
        return rfft_packed_zeropad_plain(x)
    out = _rfft_launch(x, 2 * x.shape[-1], 1)
    rfft_packed_zeropad.launches += 1
    return out


def irfft_packed(re: torch.Tensor, im: torch.Tensor, n: int,
                 half: Half = False) -> torch.Tensor:
    """Inverse of :func:`rfft_packed`: packed [..., N/2] -> real
    [..., N], or only its first (``half="first"``) or last
    (``"last"`` / True) N/2 samples."""
    if _build.is_cpu(re, im):
        return irfft_packed_plain(re, im, n, half)
    _build.check_cuda_f32(re=re, im=im)
    mode = half_mode(half)
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
    irfft_packed.launches += 1
    return y


rfft_packed.launches = 0
rfft_packed_zeropad.launches = 0
irfft_packed.launches = 0
