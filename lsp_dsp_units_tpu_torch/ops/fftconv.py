"""Uniform partitioned overlap-save convolution over a ring
frequency-delay line (FDL): the port of the ring part of ops/fftconv.py.

The ring keeps the P newest frame spectra partition-major, [P, ..., F]:
each block writes only slot ``w = (pos + 1) % P`` and partition p
multiplies slot p by the IR spectrum ``H[(w - p) % P]``.  Natural order
(F = B + 1) is the layout of :func:`fdl_ring_step`, the plain staged
convolver; the chain keeps its ring packed (F = B, ops/fft_packed.py),
the layout of the CUDA kernel in ops/fdl_fused.py.  ``pos`` is a host
integer: PyTorch runs eagerly, so the slot index never needs to live on
the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lsp_dsp_units_tpu_torch.ops.cplx import irfft_sc, rfft_sc, sc_mul, sc_sum


class Spectra(NamedTuple):
    """Split-complex spectra container."""
    re: torch.Tensor
    im: torch.Tensor


def parse_ir(ir: torch.Tensor, block: int) -> Spectra:
    """Partition an impulse response ``ir [..., N]`` into FDL spectra
    [..., P, B + 1], P = ceil(N / B), each partition zero-padded to 2B
    before the rfft (overlap-save layout)."""
    n = ir.shape[-1]
    p = max(1, -(-n // block))
    ir_p = torch.nn.functional.pad(ir.to(torch.float32), (0, p * block - n))
    parts = ir_p.reshape(ir.shape[:-1] + (p, block))
    re, im = rfft_sc(parts, 2 * block)
    return Spectra(re, im)


class RingFDLState(NamedTuple):
    spec_re: torch.Tensor   # [P, ..., F] ring storage, partition-major
    spec_im: torch.Tensor
    history: torch.Tensor   # [..., B] previous input block (overlap-save)
    pos: int                # slot holding the newest block's spectrum


def init_ring_fdl(h_spectra: Spectra, batch_shape: Tuple[int, ...] = (),
                  packed: bool = True, device=None) -> RingFDLState:
    """Zero ring for IR spectra [P, B + 1]; ``packed`` stores F = B
    packed bins (ops/fft_packed.py) instead of B + 1 natural ones."""
    p, f = h_spectra.re.shape[-2], h_spectra.re.shape[-1]
    block = f - 1
    fdim = block if packed else f
    z = torch.zeros((p,) + tuple(batch_shape) + (fdim,), dtype=torch.float32,
                    device=device)
    return RingFDLState(spec_re=z, spec_im=z.clone(),
                        history=torch.zeros(tuple(batch_shape) + (block,),
                                            dtype=torch.float32,
                                            device=device),
                        pos=p - 1)


def fdl_ring_step(h_spectra: Spectra, state: RingFDLState,
                  x_block: torch.Tensor
                  ) -> Tuple[RingFDLState, torch.Tensor]:
    """One block over a natural-order ring, plain PyTorch: the new frame
    spectrum goes to slot w and the output is the last half of
    ``irfft(sum_p ring[p] * H[(w - p) % P])``."""
    p = h_spectra.re.shape[-2]
    if state.spec_re.shape[-1] != h_spectra.re.shape[-1]:
        raise ValueError("fdl_ring_step needs a natural-order ring "
                         "(init_ring_fdl(packed=False))")
    frame = torch.cat([state.history, x_block], dim=-1)
    w = (state.pos + 1) % p
    sr, si = rfft_sc(frame)
    buf_re = state.spec_re.clone()
    buf_im = state.spec_im.clone()
    buf_re[w] = sr
    buf_im[w] = si
    rot = [(w - q) % p for q in range(p)]
    nb = state.spec_re.ndim - 2
    hshape = (p,) + (1,) * nb + h_spectra.re.shape[-1:]
    hre = h_spectra.re[rot].reshape(hshape)
    him = h_spectra.im[rot].reshape(hshape)
    acc = sc_sum(sc_mul((buf_re, buf_im), (hre, him)), dim=0)
    y = irfft_sc(acc, frame.shape[-1])[..., x_block.shape[-1]:]
    return RingFDLState(spec_re=buf_re, spec_im=buf_im, history=x_block,
                        pos=w), y.to(x_block.dtype)
