"""Split-complex arithmetic: spectra as (real, imag) float32 pairs.

The JAX package keeps every spectrum split-complex because its TPU
backend handled complex dtypes only at the FFT boundary; the port keeps
the same convention so that spectra cross between the two packages (and
into the CUDA kernels) as plain float32 planes.  ``rfft_sc``/``irfft_sc``
run ``torch.fft``: they serve the plain versions of the kernels and the
host-side design, never the CUDA path of the chain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SC = Tuple[torch.Tensor, torch.Tensor]   # (real, imag)


def rfft_sc(x: torch.Tensor, n: Optional[int] = None, dim: int = -1) -> SC:
    s = torch.fft.rfft(x, n=n, dim=dim)
    return s.real.contiguous(), s.imag.contiguous()


def irfft_sc(sc: SC, n: Optional[int] = None, dim: int = -1) -> torch.Tensor:
    return torch.fft.irfft(torch.complex(sc[0], sc[1]), n=n, dim=dim)


def sc_mul(a: SC, b: SC) -> SC:
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def sc_sum(a: SC, dim: int) -> SC:
    return torch.sum(a[0], dim=dim), torch.sum(a[1], dim=dim)
