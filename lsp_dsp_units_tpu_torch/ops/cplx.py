"""Split-complex arithmetic: spectra as (real, imag) float32 pairs.

The JAX package keeps every spectrum split-complex because its TPU
backend handled complex dtypes only at the FFT boundary; the port keeps
the same convention so that spectra cross between the two packages (and
into the CUDA kernels) as plain float32 planes.

``rfft_sc``/``irfft_sc`` take natural-order spectra [..., N/2 + 1] and
pick their route from the tensor's device, as the JAX module does from
its backend:

* CUDA tensors along the last axis at a frame size the packed FFT kernel
  takes (ops/fft_packed.supported: N a power of two, 128 <= N <= 32768)
  go through it: ``rfft_packed_zeropad`` when the input is half of N,
  ``rfft_packed`` otherwise (padded or cut to N), ``irfft_packed`` for
  the inverse, whose ``half=`` returns only the first or the last N/2
  samples.  The packed spectra are reordered to natural order and back
  (``unpack_spectra``/``pack_spectra``).
* Everything else (CPU tensors, larger N) runs ``torch.fft``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lsp_dsp_units_tpu_torch.ops import fft_packed as fp

SC = Tuple[torch.Tensor, torch.Tensor]   # (real, imag)


def _packed_route(t: torch.Tensor, n: int, dim: int) -> bool:
    return (t.device.type == "cuda" and dim in (-1, t.ndim - 1)
            and fp.supported(n))


def rfft_sc(x: torch.Tensor, n: Optional[int] = None, dim: int = -1) -> SC:
    m = x.shape[dim] if n is None else int(n)
    if _packed_route(x, m, dim):
        lead = x.shape[:-1]
        if x.shape[-1] * 2 == m:
            rows = x.reshape(-1, m // 2).to(torch.float32).contiguous()
            pre, pim = fp.rfft_packed_zeropad(rows)
        else:
            x = torch.nn.functional.pad(x, (0, m - x.shape[-1])) \
                if x.shape[-1] < m else x[..., :m]
            rows = x.reshape(-1, m).to(torch.float32).contiguous()
            pre, pim = fp.rfft_packed(rows)
        re, im = fp.unpack_spectra(pre, pim, m)
        shape = lead + (m // 2 + 1,)
        return re.reshape(shape), im.reshape(shape)
    s = torch.fft.rfft(x, n=n, dim=dim)
    return s.real.contiguous(), s.imag.contiguous()


def irfft_sc(sc: SC, n: Optional[int] = None, dim: int = -1,
             half: fp.Half = False) -> torch.Tensor:
    """Inverse of :func:`rfft_sc`.  ``half="first"``/``"last"`` returns
    only that half of the N output samples (last axis only)."""
    m = 2 * (sc[0].shape[dim] - 1) if n is None else int(n)
    mode = fp.half_mode(half)
    if _packed_route(sc[0], m, dim) and sc[0].shape[-1] == m // 2 + 1:
        lead = sc[0].shape[:-1]
        re = sc[0].reshape(-1, m // 2 + 1).to(torch.float32)
        im = sc[1].reshape(-1, m // 2 + 1).to(torch.float32)
        y = fp.irfft_packed(*fp.pack_spectra(re, im, m), m, half)
        return y.reshape(lead + y.shape[-1:])
    y = torch.fft.irfft(torch.complex(sc[0], sc[1]), n=n, dim=dim)
    if mode == 1:
        return y[..., :m // 2].contiguous()
    if mode == 2:
        return y[..., m // 2:].contiguous()
    return y


def sc_mul(a: SC, b: SC) -> SC:
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def sc_sum(a: SC, dim: int) -> SC:
    return torch.sum(a[0], dim=dim), torch.sum(a[1], dim=dim)


def sc_from(z: torch.Tensor) -> SC:
    return z.real.contiguous(), z.imag.contiguous()


def sc_to(sc: SC) -> torch.Tensor:
    return torch.complex(sc[0], sc[1])


def sc_rmul(a: SC, g: torch.Tensor) -> SC:
    return a[0] * g, a[1] * g


def sc_add(a: SC, b: SC) -> SC:
    return a[0] + b[0], a[1] + b[1]


def sc_concat(parts, dim: int) -> SC:
    return (torch.cat([p[0] for p in parts], dim=dim),
            torch.cat([p[1] for p in parts], dim=dim))


def sc_zeros(shape, dtype=torch.float32, device="cuda") -> SC:
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def sc_conj(a: SC) -> SC:
    return a[0], -a[1]


def sc_abs(a: SC) -> torch.Tensor:
    """|a|: the root taken in float64 and rounded once, as XLA's and
    CUDA's float32 sqrt round (torch's vectorised CPU sqrt can miss by an
    ulp)."""
    sq = a[0] * a[0] + a[1] * a[1]
    return torch.sqrt(sq.double()).to(sq.dtype)


def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex multiply of complex tensors by real arithmetic."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


def crmul(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Complex tensor times a real one, part by part."""
    return torch.complex(a.real * g, a.imag * g)
