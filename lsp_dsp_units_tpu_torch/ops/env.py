"""Fused dynamics tail: the port of ops/pallas_env.py::chain_dyn_pallas.

Sidechain sliding RMS over a carried window of squared detector samples
-> compressor peak-hold envelope (with release threshold) -> two-knee
gain -> ``y = x * gain``, on [C, T] blocks.  :func:`chain_dyn` runs
:func:`chain_dyn_plain` (the staged plain ops: sliding_sum ->
peak_envelope_plain -> compressor_x2_gain) for CPU tensors and the CUDA
kernel (``csrc/env.cu``) for CUDA tensors, counting launches in
``chain_dyn.launches``.

Tolerance between the two: the kernel forms the rolling sum in float64,
as the window's sum plus a scan of per-sample (new - old) squares carried
from chunk to chunk, the plain version as a difference of two-level
float32 prefix sums.  That is a rounding difference in the level; the
envelope step itself is the plain version's, bit for bit (both round
``e + tau * d`` once).  The output agrees to >= 110 dB and the carried
window, envelope and peak to ~1e-5 relative; hold counts are exact.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops.dynamics import (
    CompKnee, EnvState, compressor_x2_gain, peak_envelope_plain)
from lsp_dsp_units_tpu_torch.ops.sliding import sliding_sum


class _Knee(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float) for f in CompKnee._fields]


class _DynParams(ctypes.Structure):
    _fields_ = [("g", ctypes.c_float), ("ta", ctypes.c_float),
                ("tr", ctypes.c_float), ("rt", ctypes.c_float),
                ("inv_n", ctypes.c_float), ("nh", ctypes.c_int),
                ("k0", _Knee), ("k1", _Knee)]


_SIGS = {"lsp_chain_dyn": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
         + [_DynParams, ctypes.c_void_p]}


def chain_dyn_plain(window, env_state: EnvState, x, n_win: int, sc_gain,
                    tau_attack, tau_release, release_thresh, hold_samples,
                    knees: Tuple[CompKnee, CompKnee]):
    """Plain PyTorch version of :func:`chain_dyn` (same contract)."""
    v = torch.abs(x) * sc_gain
    frame = torch.cat([window, v * v], dim=-1)
    rsum = sliding_sum(frame, n_win, x.shape[-1])
    level = torch.sqrt(torch.clamp(rsum / n_win, min=0.0))
    env_st, env = peak_envelope_plain(env_state, level, tau_attack,
                                      tau_release, hold_samples,
                                      release_thresh)
    y = x * compressor_x2_gain(knees, env)
    return frame[..., -n_win:].contiguous(), env_st, y


def chain_dyn(window, env_state: EnvState, x, n_win: int, sc_gain,
              tau_attack, tau_release, release_thresh, hold_samples,
              knees: Tuple[CompKnee, CompKnee]):
    """Dynamics tail of one block.  ``window`` [C, N] carried squared
    detector samples, ``x`` [C, T] (T >= N), scalars as host numbers (or
    0-d tensors).
    Returns (window' [C, N], EnvState', y [C, T])."""
    tensors = (window, env_state.envelope, env_state.peak, x)
    _build.no_grad_route("chain_dyn", *tensors, tau_attack, tau_release,
                         release_thresh, knees)
    if _build.is_cpu(*tensors, env_state.hold):
        return chain_dyn_plain(window, env_state, x, n_win, sc_gain,
                               tau_attack, tau_release, release_thresh,
                               hold_samples, knees)
    c, t = x.shape
    n = int(n_win)
    if window.shape != (c, n) or t < n:
        raise ValueError(f"window must be [{c}, {n}] with T={t} >= {n}, "
                         f"got {tuple(window.shape)}")
    if env_state.envelope.shape != (c,) or env_state.peak.shape != (c,) \
            or env_state.hold.shape != (c,):
        raise ValueError("envelope state must be [C] per field")
    if env_state.hold.dtype != torch.int32:
        raise ValueError(f"hold must be int32, got {env_state.hold.dtype}")
    _build.check_cuda_f32(window=window, envelope=env_state.envelope,
                      peak=env_state.peak, x=x)
    if not env_state.hold.is_contiguous():
        raise ValueError("hold must be contiguous")
    y = torch.empty_like(x)
    win_out = torch.empty_like(window)
    e_out = torch.empty_like(env_state.envelope)
    p_out = torch.empty_like(env_state.peak)
    h_out = torch.empty_like(env_state.hold)
    prm = _DynParams(g=float(sc_gain), ta=float(tau_attack),
                     tr=float(tau_release), rt=float(release_thresh),
                     inv_n=1.0 / n, nh=int(hold_samples),
                     k0=_Knee(*map(float, knees[0])),
                     k1=_Knee(*map(float, knees[1])))
    lib = _build.load("env", _SIGS)
    _build.check(lib.lsp_chain_dyn(
        _build.ptr(x), _build.ptr(window), _build.ptr(env_state.envelope),
        _build.ptr(env_state.peak), _build.ptr(env_state.hold),
        _build.ptr(y), _build.ptr(win_out), _build.ptr(e_out),
        _build.ptr(p_out), _build.ptr(h_out), c, t, n, prm,
        _build.stream_of(x)), "chain_dyn kernel")
    chain_dyn.launches += 1
    return win_out, EnvState(e_out, p_out, h_out), y


chain_dyn.launches = 0
