"""Batched dynamic slice: the port of ops/slicedma.py.

``batched_slice(bank, starts, size)`` returns ``out[v] =
bank[starts[v] : starts[v] + size]`` for a batch of arbitrary sample
offsets into one flat bank: the polyphonic sampler reads one contiguous
window per voice per block (models/sampling/device_mix.py, reference
SamplePlayer.cpp:305-366).

The contract is the JAX function's: ``size`` and ``N`` multiples of 128,
``N >= size + 1024``, and every start clamped to ``[0, N - size - 1024]``
(so a bad start reads in-bank samples, never outside).  Any number of
voices.  :func:`batched_slice` runs :func:`batched_slice_plain` (a
gather) for CPU tensors and the CUDA kernel (``csrc/slicedma.cu``: one
warp per window, 16-byte loads and stores) for CUDA tensors, counting
launches in ``batched_slice.launches``; the kernel takes a 16-byte
aligned bank.
"""

from __future__ import annotations

import ctypes

import torch

from lsp_dsp_units_tpu_torch.ops import _build

_SIGS = {"lsp_batched_slice": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
         + [ctypes.c_void_p],
         "lsp_batched_slice_shape": [ctypes.c_int, ctypes.c_void_p]}

LANE = 128
SLACK = 1024           # tail slack the JAX kernel's aligned window needs


def _limit(bank: torch.Tensor, starts: torch.Tensor, size: int) -> int:
    """Checks the contract; returns the largest start."""
    n = bank.shape[0]
    if bank.ndim != 1 or starts.ndim != 1:
        raise ValueError(f"bank [N] and starts [V], got {tuple(bank.shape)} "
                         f"and {tuple(starts.shape)}")
    if size % LANE or n % LANE:
        raise ValueError(f"size ({size}) and N ({n}) must be multiples of "
                         f"{LANE}")
    if n < size + SLACK:
        raise ValueError(f"bank must carry at least size + {SLACK} samples "
                         f"(n={n}, size={size}); pad it "
                         f"(device_mix.build_bank_padded does)")
    return n - size - SLACK


def batched_slice_plain(bank: torch.Tensor, starts: torch.Tensor,
                        size: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`batched_slice` (same contract)."""
    lim = _limit(bank, starts, size)
    s = starts.to(torch.int64).clamp(0, lim)
    return bank[s[:, None] + torch.arange(size, device=bank.device)]


def batched_slice(bank: torch.Tensor, starts: torch.Tensor,
                  size: int) -> torch.Tensor:
    """out[v, :] = bank[starts[v] : starts[v] + size].

    ``bank`` [N] float32; ``starts`` [V] int32 (any alignment, clamped as
    the module says); returns [V, size] float32."""
    if _build.is_cpu(bank, starts):
        return batched_slice_plain(bank, starts, size)
    lim = _limit(bank, starts, size)
    _build.check_cuda_f32(bank=bank)
    _build.check_cuda(torch.int32, bank.device, starts=starts)
    out = torch.empty((starts.shape[0], size), dtype=torch.float32,
                      device=bank.device)
    lib = _build.load("slicedma", _SIGS)
    _build.check(lib.lsp_batched_slice(
        _build.ptr(bank), _build.ptr(starts), _build.ptr(out),
        starts.shape[0], int(size), lim, _build.stream_of(bank)),
        "batched_slice kernel")
    batched_slice.launches += 1
    return out


batched_slice.launches = 0


def launch_shape(voices: int) -> dict:
    """How the kernel launches for ``voices`` windows (needs the card):
    blocks, threads per block and blocks resident per SM by the
    occupancy calculator."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.load("slicedma", _SIGS).lsp_batched_slice_shape(
        int(voices), out), "batched_slice launch shape")
    return dict(blocks=out[0], threads=out[1], blocks_per_sm=out[2])
