"""Sidechain level and envelope followers: the port of the three
single-purpose kernels of ops/pallas_env.py.

* :func:`sliding_rms`   (``sliding_rms_pallas``): sliding-window RMS over
  a carried window of squared detector samples.
* :func:`peak_envelope` (``peak_envelope_pallas``): the peak-hold
  attack/release follower, with or without a release threshold.
* :func:`gate_envelope` (``gate_envelope_pallas``): the same follower
  without a release threshold, plus the gate's hysteresis curve track.

Each wrapper runs its plain PyTorch version (``*_plain``) for CPU tensors
and launches its CUDA kernel (``csrc/env_units.cu``) for CUDA tensors,
counting launches in ``<wrapper>.launches``.  Inputs may carry any
leading batch shape ``[..., T]``; the kernels see them as [C, T] rows.
The state comes in and goes out as the caller's NamedTuple type
(``state._make``), so this module needs none of the modules that define
it.

Agreement between kernel and plain version:

* envelopes: bit for bit.  Both round the update ``e + tau * d`` once,
  as the FMA that XLA contracts in the JAX package (the kernels with
  ``__fmaf_rn``, the plain versions in float64 rounded to odd); hold
  counts and the curve track are int32 in both.
* RMS: the window' is exact (the same two float32 multiplies per sample).
  The level is not: the plain version differences two-level float32
  prefix sums (the JAX cumsum form, whose error grows with T), the kernel
  sums each time tile's window of history and scans the tile in float64.
  At [64, 16384] they agree to >= 110 dB.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops.sliding import sliding_sum

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    "lsp_sliding_rms": [_P] * 4 + [_I] * 3 + [_F, _P],
    "lsp_sliding_rms_shape": [_I, _I, _P],
    "lsp_peak_envelope": [_P] * 8 + [_I] * 2 + [_F] * 3 + [_I] * 2 + [_P],
    "lsp_gate_envelope": [_P] * 11 + [_I] * 2 + [_F] * 2 + [_I]
    + [_F] * 2 + [_P],
}


def _lib():
    return _build.load("env_units", _SIGS)


# ---------------------------------------------------------------------------
# sliding RMS
# ---------------------------------------------------------------------------


def sliding_rms_plain(window: torch.Tensor, x: torch.Tensor, n_win: int,
                      gain):
    """Plain PyTorch version of :func:`sliding_rms` (the JAX package's
    cumsum-difference form, models/util/sidechain.py)."""
    v = torch.abs(x) * gain
    frame = torch.cat([window, v * v], dim=-1)
    rsum = sliding_sum(frame, n_win, x.shape[-1])
    level = torch.sqrt(torch.clamp(rsum / n_win, min=0.0))
    return frame[..., -n_win:].contiguous(), level


def sliding_rms(window: torch.Tensor, x: torch.Tensor, n_win: int, gain):
    """Sliding-window RMS level detector (reference Sidechain.cpp:520-556
    RMS mode): ``level[t] = sqrt(mean of the last N squares of
    |x| * gain)`` over ``frame = [window || squares]``.

    ``window`` [..., N] carried squared-detector history, ``x`` [..., T].
    Any T >= 1 and N >= 1.  Returns (window' [..., N], level [..., T])."""
    if _build.is_cpu(window, x):
        return sliding_rms_plain(window, x, n_win, gain)
    n = int(n_win)
    t = x.shape[-1]
    if window.shape != x.shape[:-1] + (n,) or t < 1 or n < 1:
        raise ValueError(f"window must be [..., {n}] beside x [..., T>=1], "
                         f"got {tuple(window.shape)} and {tuple(x.shape)}")
    _build.check_cuda(torch.float32, x.device, window=window, x=x)
    xr, wr = x.reshape(-1, t), window.reshape(-1, n)
    level = torch.empty_like(xr)
    w_out = torch.empty_like(wr)
    _build.check(_lib().lsp_sliding_rms(
        _build.ptr(xr), _build.ptr(wr), _build.ptr(level), _build.ptr(w_out),
        xr.shape[0], t, n, float(gain), _build.stream_of(x)),
        "sliding_rms kernel")
    sliding_rms.launches += 1
    return w_out.reshape(window.shape), level.reshape(x.shape)


def rms_launch_shape(channels: int, t: int) -> dict:
    """How :func:`sliding_rms`'s kernel launches on [channels, t] (needs
    the card): blocks (one per channel and time tile), threads per block
    and blocks resident per SM by the occupancy calculator."""
    out = (ctypes.c_int * 3)()
    _build.check(_lib().lsp_sliding_rms_shape(int(channels), int(t), out),
                 "sliding_rms launch shape")
    return dict(blocks=out[0], threads=out[1], blocks_per_sm=out[2])


# ---------------------------------------------------------------------------
# peak-hold envelope
# ---------------------------------------------------------------------------


def _mul_add(tau, d, e):
    """``fmaf(tau, d, e)``: ``e + tau * d`` rounded once to float32, the
    kernels' ``__fmaf_rn`` and XLA's contraction in the JAX package.
    The float32 product is exact in float64; the float64 sum is rounded
    to odd (its last bit set where TwoSum finds it inexact), which makes
    the final rounding to float32 the correct one, ties included."""
    p, e64 = tau.double() * d.double(), e.double()
    s = e64 + p
    bb = s - p
    inexact = (e64 - bb) + (p - (s - bb)) != 0
    bits = s.view(torch.int64)
    return torch.where(inexact, bits | 1, bits).view(torch.float64).float()


def _env_step_plain(xt, e, peak, hold, ta, tr, nh, rt):
    """One step of the reference Compressor.cpp:231-256 recurrence on
    [...] tensors; ``rt`` None releases with ``tr`` always."""
    d = xt - e
    falling = d < 0.0
    holding = hold > 0
    tau_dn = tr if rt is None else torch.where(e > rt, tr, ta)
    e_fall = _mul_add(tau_dn, d, e)
    e_rise = _mul_add(ta, d, e)
    new_e = torch.where(falling, torch.where(holding, e, e_fall), e_rise)
    rise_peaked = torch.logical_and(~falling, e_rise >= peak)
    peak = torch.where(falling, torch.where(holding, peak, e_fall),
                       torch.where(rise_peaked, e_rise, peak))
    hold = torch.where(falling, torch.where(holding, hold - 1, hold),
                       torch.where(rise_peaked, nh, hold))
    return new_e, peak, hold


def _coefs(x, tau_attack, tau_release, hold_samples, release_thresh):
    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=x.device)
    return (f32(tau_attack), f32(tau_release),
            torch.tensor(int(hold_samples), dtype=torch.int32,
                         device=x.device),
            None if release_thresh is None else f32(release_thresh))


def peak_envelope_plain(state, x: torch.Tensor, tau_attack, tau_release,
                        hold_samples, release_thresh: Optional[float] = None):
    """Plain PyTorch version of :func:`peak_envelope`: a Python loop over
    T, one step of ~15 tensor ops per sample."""
    e, peak, hold = state
    ta, tr, nh, rt = _coefs(x, tau_attack, tau_release, hold_samples,
                            release_thresh)
    out = torch.empty_like(x)
    for t in range(x.shape[-1]):
        e, peak, hold = _env_step_plain(x[..., t], e, peak, hold, ta, tr,
                                        nh, rt)
        out[..., t] = e
    return state._make((e, peak, hold)), out


def _check_env_state(x, *fields):
    """Shapes and types of an envelope kernel's inputs: x [..., T >= 1],
    envelope and peak float32 [...], hold (and the gate's curve) int32
    [...]."""
    named = dict(zip(("envelope", "peak", "hold", "curve"), fields))
    lead = x.shape[:-1]
    for name, f in named.items():
        if f.shape != lead:
            raise ValueError(f"{name} must be {tuple(lead)} beside x "
                             f"{tuple(x.shape)}, got {tuple(f.shape)}")
    if x.shape[-1] < 1:
        raise ValueError("x must hold at least one sample")
    _build.check_cuda(torch.float32, x.device, x=x,
                      envelope=named.pop("envelope"), peak=named.pop("peak"))
    _build.check_cuda(torch.int32, x.device, **named)


def peak_envelope(state, x: torch.Tensor, tau_attack, tau_release,
                  hold_samples, release_thresh: Optional[float] = None):
    """Branchy attack/release follower with peak-hold (reference
    Compressor.cpp:231-256) over the detector level x [..., T].
    ``state`` is an EnvState (envelope, peak float32; hold int32, each
    [...]); ``release_thresh=None`` releases with ``tau_release`` always
    (the gate's form).  Returns (state', envelope [..., T])."""
    e, peak, hold = state
    if _build.is_cpu(x, e, peak, hold):
        return peak_envelope_plain(state, x, tau_attack, tau_release,
                                   hold_samples, release_thresh)
    _check_env_state(x, e, peak, hold)
    t = x.shape[-1]
    xr = x.reshape(-1, t)
    c = xr.shape[0]
    env = torch.empty_like(xr)
    e2, p2 = torch.empty(c, device=x.device), torch.empty(c, device=x.device)
    h2 = torch.empty(c, dtype=torch.int32, device=x.device)
    use_rt = release_thresh is not None
    _build.check(_lib().lsp_peak_envelope(
        _build.ptr(xr), _build.ptr(e), _build.ptr(peak), _build.ptr(hold),
        _build.ptr(env), _build.ptr(e2), _build.ptr(p2), _build.ptr(h2), c, t,
        float(tau_attack), float(tau_release),
        float(release_thresh) if use_rt else 0.0, int(hold_samples),
        int(use_rt), _build.stream_of(x)), "peak_envelope kernel")
    peak_envelope.launches += 1
    lead = x.shape[:-1]
    return (state._make((e2.reshape(lead), p2.reshape(lead),
                         h2.reshape(lead))), env.reshape(x.shape))


# ---------------------------------------------------------------------------
# gate envelope
# ---------------------------------------------------------------------------


def gate_envelope_plain(env_state, curve: torch.Tensor, x: torch.Tensor,
                        tau_attack, tau_release, hold_samples, k0_end,
                        k1_start):
    """Plain PyTorch version of :func:`gate_envelope`."""
    e, peak, hold = env_state
    ta, tr, nh, _ = _coefs(x, tau_attack, tau_release, hold_samples, None)
    k0e = torch.tensor(float(k0_end), dtype=torch.float32, device=x.device)
    k1s = torch.tensor(float(k1_start), dtype=torch.float32,
                       device=x.device)
    env = torch.empty_like(x)
    curves = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    cur = curve
    for t in range(x.shape[-1]):
        e, peak, hold = _env_step_plain(x[..., t], e, peak, hold, ta, tr,
                                        nh, None)
        up = torch.logical_and(cur == 0, e > k0e)
        dn = torch.logical_and(cur == 1, e < k1s)
        cur = torch.where(up, 1, torch.where(dn, 0, cur)).to(torch.int32)
        env[..., t] = e
        curves[..., t] = cur
    return env_state._make((e, peak, hold)), cur, env, curves


def gate_envelope(env_state, curve: torch.Tensor, x: torch.Tensor,
                  tau_attack, tau_release, hold_samples, k0_end, k1_start):
    """Gate envelope (reference Gate.cpp:267-367): the peak-hold follower
    without release threshold, plus the active-curve track, which
    switches to 1 when the envelope exceeds ``k0_end`` and back to 0 when
    it falls below ``k1_start``.  ``curve`` [...] int32.  Returns
    (EnvState', curve' [...], env [..., T], curves [..., T] int32)."""
    e, peak, hold = env_state
    if _build.is_cpu(x, e, peak, hold, curve):
        return gate_envelope_plain(env_state, curve, x, tau_attack,
                                   tau_release, hold_samples, k0_end,
                                   k1_start)
    _check_env_state(x, e, peak, hold, curve)
    t = x.shape[-1]
    xr = x.reshape(-1, t)
    c = xr.shape[0]
    env = torch.empty_like(xr)
    curves = torch.empty(xr.shape, dtype=torch.int32, device=x.device)
    e2, p2 = torch.empty(c, device=x.device), torch.empty(c, device=x.device)
    h2 = torch.empty(c, dtype=torch.int32, device=x.device)
    cur2 = torch.empty_like(h2)
    _build.check(_lib().lsp_gate_envelope(
        _build.ptr(xr), _build.ptr(e), _build.ptr(peak), _build.ptr(hold),
        _build.ptr(curve), _build.ptr(env), _build.ptr(curves),
        _build.ptr(e2), _build.ptr(p2), _build.ptr(h2), _build.ptr(cur2), c,
        t, float(tau_attack), float(tau_release), int(hold_samples),
        float(k0_end), float(k1_start), _build.stream_of(x)),
        "gate_envelope kernel")
    gate_envelope.launches += 1
    lead = x.shape[:-1]
    return (env_state._make((e2.reshape(lead), p2.reshape(lead),
                             h2.reshape(lead))), cur2.reshape(lead),
            env.reshape(x.shape), curves.reshape(x.shape))


sliding_rms.launches = 0
peak_envelope.launches = 0
gate_envelope.launches = 0
