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

Gradients: :func:`sliding_rms` and :func:`peak_envelope` differentiate
through ``torch.autograd.Function``s, used only when grad mode is on and
an input requires grad (otherwise each wrapper runs what it ran before).
Their forwards are the routes above; their backwards are
:func:`sliding_rms_bwd` and :func:`peak_envelope_bwd`, each again a
plain version for CPU tensors and a kernel of ``csrc/env_units.cu`` for
CUDA tensors, counted in ``<wrapper>.launches``.  The plain backward of
the envelope and its kernel agree bit for bit (both round every product
and sum alone in one order, and sum the per-row tau partials row after
row); the RMS's sums its window adjoints in float64 like its forward, in
another order than its plain version (>= 120 dB).  :func:`gate_envelope`
differentiates through its own Function: its envelope is the follower's
without a release threshold, so its backward is
:func:`peak_envelope_bwd` with ``release_thresh=None``; the curve track
and the hold are decisions and take no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops.sliding import sliding_sum

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    "lsp_sliding_rms": [_P] * 4 + [_I] * 3 + [_F, _P],
    "lsp_sliding_rms_shape": [_I, _I, _P],
    "lsp_sliding_rms_bwd": [_P] * 6 + [_I] * 3 + [_F, _P],
    "lsp_peak_envelope": [_P] * 8 + [_I] * 2 + [_F] * 3 + [_I] * 2 + [_P],
    "lsp_peak_envelope_bwd": [_P] * 14 + [_I] * 2 + [_F] * 3 + [_I] * 2
    + [_P],
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


def _sliding_rms(window, x, n_win, gain):
    """:func:`sliding_rms` outside autograd: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
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


def sliding_rms(window: torch.Tensor, x: torch.Tensor, n_win: int, gain):
    """Sliding-window RMS level detector (reference Sidechain.cpp:520-556
    RMS mode): ``level[t] = sqrt(mean of the last N squares of
    |x| * gain)`` over ``frame = [window || squares]``.

    ``window`` [..., N] carried squared-detector history, ``x`` [..., T].
    Any T >= 1 and N >= 1.  Returns (window' [..., N], level [..., T]).
    Differentiable in ``window`` and ``x`` (``gain`` is a constant)."""
    if _build.needs_grad(window, x):
        _build.no_grad_route("sliding_rms's gain", gain)
        return _SlidingRms.apply(window, x, n_win, gain)
    return _sliding_rms(window, x, n_win, gain)


def _rms_adjoint(g, level, mask, n_win):
    """The level's cotangent carried back through ``sqrt(max(S / N,
    0))`` onto S: ``((g * (0.5 / level)) * mask) / N``, each operation
    rounded alone, as jax.grad forms it (mask: jnp.maximum's 1 above 0,
    the tie's 0.5 at 0, 0 below)."""
    half = torch.full_like(level, 0.5)
    n_t = torch.tensor(float(n_win), dtype=level.dtype, device=level.device)
    return (g * (half / level)) * mask / n_t


def sliding_rms_bwd_plain(window, x, level, g_level, g_window, n_win, gain):
    """Plain PyTorch version of :func:`sliding_rms_bwd`.  The frame's
    cotangent is a reversed sliding sum of the level's adjoint a:
    ``gf[j] = a[j - N] + ... + a[j - 1]`` over the frame index j, summed
    in float64 as differences of a prefix sum, plus the cotangent of
    window' (the frame's last N); the window takes ``gf[:N]``, and x
    ``2 (gf[N + t] v[t]) gain sign(x[t])`` with ``v = |x| gain``."""
    n = int(n_win)
    t = x.shape[-1]
    v = torch.abs(x) * gain
    frame = torch.cat([window, v * v], dim=-1)
    s = sliding_sum(frame, n, t) / n_win       # the forward's S / N
    mask = torch.where(s > 0, 1.0, torch.where(s == 0, 0.5, 0.0)).to(x.dtype)
    a = _rms_adjoint(g_level, level, mask, n).double()
    pre = torch.nn.functional.pad(torch.cumsum(a, dim=-1), (1, 0))
    j = torch.arange(n + t, device=x.device)
    gf = (pre[..., j.clamp(max=t)] - pre[..., (j - n).clamp(0, t)])
    gf = torch.cat([gf[..., :t], gf[..., t:] + g_window.double()], dim=-1)
    gf = gf.to(x.dtype)
    q = gf[..., n:] * v
    gx = (q + q) * gain
    return gf[..., :n].contiguous(), torch.where(x < 0, -gx, gx)


def sliding_rms_bwd(window, x, level, g_level, g_window, n_win, gain):
    """Backward of :func:`sliding_rms`: the cotangents of (window', level)
    -> those of (window, x).  ``level`` is the forward's output.  The
    plain version for CPU tensors; for CUDA tensors the kernel
    ``sliding_rms_bwd`` (independent time tiles over the frame index,
    each from a halo of N adjoints before it, as the forward's), which
    takes the mask at a zero level as the tie's 0.5 (the forward kernel's
    S is a float64 sum of squares, so a zero level is S = 0)."""
    if _build.is_cpu(window, x, level, g_level, g_window):
        return sliding_rms_bwd_plain(window, x, level, g_level, g_window,
                                     n_win, gain)
    n = int(n_win)
    t = x.shape[-1]
    if level.shape != x.shape or g_level.shape != x.shape \
            or g_window.shape != x.shape[:-1] + (n,):
        raise ValueError("sliding_rms_bwd: level and its cotangent must be "
                         "shaped as x, window' as the window")
    g_level, g_window = g_level.contiguous(), g_window.contiguous()
    _build.check_cuda(torch.float32, x.device, x=x, level=level,
                      g_level=g_level, g_window=g_window)
    xr = x.reshape(-1, t)
    gx = torch.empty_like(xr)
    gw = torch.empty((xr.shape[0], n), dtype=torch.float32, device=x.device)
    _build.check(_lib().lsp_sliding_rms_bwd(
        _build.ptr(xr), _build.ptr(level), _build.ptr(g_level),
        _build.ptr(g_window), _build.ptr(gx), _build.ptr(gw), xr.shape[0], t,
        n, float(gain), _build.stream_of(x)), "sliding_rms_bwd kernel")
    sliding_rms_bwd.launches += 1
    return gw.reshape(g_window.shape), gx.reshape(x.shape)


class _SlidingRms(torch.autograd.Function):
    """:func:`sliding_rms` under autograd: forward :func:`_sliding_rms`,
    backward :func:`sliding_rms_bwd`."""

    @staticmethod
    def forward(ctx, window, x, n_win, gain):
        w_out, level = _sliding_rms(window, x, n_win, gain)
        ctx.save_for_backward(window, x, level)
        ctx.n_win, ctx.gain = int(n_win), gain
        return w_out, level

    @staticmethod
    @once_differentiable
    def backward(ctx, g_window, g_level):
        window, x, level = ctx.saved_tensors
        gw, gx = sliding_rms_bwd(window, x, level, g_level, g_window,
                                 ctx.n_win, ctx.gain)
        return gw, gx, None, None


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
    the final rounding to float32 the correct one, ties included.  The
    bit trick is no differentiable operation: under grad it raises.
    float64 operands (the float64 gradient checks) take ``e + tau * d``
    as it is."""
    _build.no_grad_route("_mul_add (the float32 FMA of the plain loops)",
                         tau, d, e)
    if e.dtype == torch.float64:
        return e + tau * d
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
    """The envelope's coefficients as tensors on x's device: the taus and
    the release threshold in x's type, float32 on the main path (a tensor
    stays one, in the graph), the hold int32 (a tensor is cast, as
    jnp.asarray(hold, jnp.int32) casts it, so its gradient is zero)."""
    def f32(v):
        if torch.is_tensor(v):
            return v.to(dtype=x.dtype, device=x.device).reshape(())
        return torch.tensor(float(v), dtype=x.dtype, device=x.device)
    return (f32(tau_attack), f32(tau_release),
            torch.tensor(int(hold_samples), dtype=torch.int32,
                         device=x.device),
            None if release_thresh is None else f32(release_thresh))


def _envelope_plain(x, e, peak, hold, tau_attack, tau_release, hold_samples,
                    release_thresh):
    """The recurrence over T on rows [...]: (e', peak', hold', env)."""
    ta, tr, nh, rt = _coefs(x, tau_attack, tau_release, hold_samples,
                            release_thresh)
    out = torch.empty_like(x)
    for t in range(x.shape[-1]):
        e, peak, hold = _env_step_plain(x[..., t], e, peak, hold, ta, tr,
                                        nh, rt)
        out[..., t] = e
    return e, peak, hold, out


def peak_envelope_plain(state, x: torch.Tensor, tau_attack, tau_release,
                        hold_samples, release_thresh: Optional[float] = None):
    """Plain PyTorch version of :func:`peak_envelope`: a Python loop over
    T, one step of ~15 tensor ops per sample."""
    e, peak, hold, out = _envelope_plain(x, *state, tau_attack, tau_release,
                                         hold_samples, release_thresh)
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


def _peak_envelope(x, e, peak, hold, tau_attack, tau_release, hold_samples,
                   release_thresh):
    """:func:`peak_envelope` outside autograd, on the state's fields:
    the plain version for CPU tensors, the kernel for CUDA tensors.
    Returns (e', peak', hold', env)."""
    if _build.is_cpu(x, e, peak, hold):
        return _envelope_plain(x, e, peak, hold, tau_attack, tau_release,
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
    return (e2.reshape(lead), p2.reshape(lead), h2.reshape(lead),
            env.reshape(x.shape))


def peak_envelope(state, x: torch.Tensor, tau_attack, tau_release,
                  hold_samples, release_thresh: Optional[float] = None):
    """Branchy attack/release follower with peak-hold (reference
    Compressor.cpp:231-256) over the detector level x [..., T].
    ``state`` is an EnvState (envelope, peak float32; hold int32, each
    [...]); ``release_thresh=None`` releases with ``tau_release`` always
    (the gate's form).  Coefficients are host numbers or 0-d tensors.
    Returns (state', envelope [..., T]).  Differentiable in x, the
    envelope and peak, and the taus; the hold, the release threshold and
    the hold time only steer the branches (zero gradient)."""
    e, peak, hold = state
    if _build.needs_grad(x, e, peak, tau_attack, tau_release,
                         release_thresh):
        env, e2, p2, h2 = _PeakEnvelope.apply(
            x, e, peak, hold, tau_attack, tau_release, hold_samples,
            release_thresh)
    else:
        e2, p2, h2, env = _peak_envelope(x, e, peak, hold, tau_attack,
                                         tau_release, hold_samples,
                                         release_thresh)
    return state._make((e2, p2, h2)), env


# The branch each step took, as the backward reads it: bits 0-1 the tau
# of its update (0 none: falling and holding, the envelope passes; 1 the
# release tau; 2 the attack tau), bit 2 set where the step set the peak
# to the new envelope (every fall that does not hold, a rise that
# reaches the peak).  csrc/env_units.cu uses the same codes.
_HOLD, _RISE, _FALL_TR, _SET_TA = 0, 2, 5, 6


def peak_envelope_codes(x, env, e0, p0, h0, hold_samples,
                        release_thresh=None):
    """The branch each step of a forward run took (the codes above), from
    its level x, its envelope env [..., T] and its incoming state: the
    step's new envelope is ``env[t]``, so the peak and hold recurrences
    replay without the envelope's arithmetic.  int8 [..., T]."""
    _, _, nh, rt = _coefs(x, 0.0, 0.0, hold_samples, release_thresh)
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    e, peak, hold = e0, p0, h0
    for t in range(x.shape[-1]):
        en = env[..., t]
        falling = (x[..., t] - e) < 0.0
        holding = hold > 0
        peaked = torch.logical_and(~falling, en >= peak)
        fall = _FALL_TR if rt is None else torch.where(e > rt, _FALL_TR,
                                                       _SET_TA)
        codes[..., t] = torch.where(
            falling, torch.where(holding, _HOLD, fall),
            torch.where(peaked, _SET_TA, _RISE))
        sets = torch.logical_or(torch.logical_and(falling, ~holding), peaked)
        peak = torch.where(sets, en, peak)
        hold = torch.where(falling, torch.where(holding, hold - 1, hold),
                           torch.where(peaked, nh, hold))
        e = en
    return codes


def free_codes(x, env, e0, release_thresh=None):
    """The branch code of every step as if it started free: its peak equal
    to the envelope before it and no hold left (csrc/env_bwd.cuh's
    free_code, which the kernels' threads apply in parallel).  A fall then
    sets the peak with the release tau (the attack tau at or below the
    release threshold), a rise to at least the envelope before it sets the
    peak with the attack tau, and a rise below it (``_RISE``, a break)
    leaves the peak.  x, env [..., T], e0 [...]; int8 [..., T]."""
    rt = _coefs(x, 0.0, 0.0, 0, release_thresh)[3]
    e = torch.cat([e0[..., None], env[..., :-1]], dim=-1)
    fall = (torch.full(x.shape, _FALL_TR, device=x.device) if rt is None
            else torch.where(e > rt, _FALL_TR, _SET_TA))
    rise = torch.where(env >= e, _SET_TA, _RISE)
    return torch.where((x - e) < 0.0, fall, rise).to(torch.int8)


def peak_envelope_codes_free(x, env, e0, p0, h0, release_thresh=None,
                             batch: int = 32):
    """:func:`peak_envelope_codes` for a hold time of 0 samples, as the
    backward kernels derive them (csrc/env_bwd.cuh::segment_codes):
    :func:`free_codes` for every step; the recurrence from the incoming
    state up to the first multiple of ``batch`` (or the start of the last
    partial batch) at which the state is free; from there the free codes up
    to the first break, and the recurrence again from it until the state
    is free, and so on.  The codes are discrete, so the result is
    :func:`peak_envelope_codes`'s exactly.  int8 [..., T]."""
    t_n = x.shape[-1]
    codes = free_codes(x, env, e0, release_thresh).reshape(-1, t_n).clone()
    rt = _coefs(x, 0.0, 0.0, 0, release_thresh)[3]
    xs, es, e0s = x.reshape(-1, t_n), env.reshape(-1, t_n), e0.reshape(-1)
    p0s, h0s = p0.reshape(-1), h0.reshape(-1)
    for r in range(xs.shape[0]):
        xr, er, cr = xs[r], es[r], codes[r]

        def e_before(i):
            return er[i - 1] if i > 0 else e0s[r]

        def step(i, peak, hold):
            e, en = e_before(i), er[i]
            falling = bool(xr[i] - e < 0.0)
            holding = hold > 0
            peaked = not falling and bool(en >= peak)
            fall = _FALL_TR if rt is None or bool(e > rt) else _SET_TA
            cr[i] = (fall if not holding else _HOLD) if falling else (
                _SET_TA if peaked else _RISE)
            if (falling and not holding) or peaked:
                peak = en
            hold = (hold - 1 if holding else hold) if falling else (
                0 if peaked else hold)
            return peak, hold

        def free(i, peak, hold):
            return hold == 0 and bool(peak == e_before(i))

        def serial(i, peak, hold):
            while i < t_n and i % batch:
                peak, hold = step(i, peak, hold)
                i += 1
            while i + batch <= t_n:
                if free(i, peak, hold):
                    return i
                for _ in range(batch):
                    peak, hold = step(i, peak, hold)
                    i += 1
            if i < t_n and free(i, peak, hold):
                return i
            while i < t_n:
                peak, hold = step(i, peak, hold)
                i += 1
            return t_n

        i = serial(0, p0s[r], int(h0s[r]))
        while i < t_n:
            brk = torch.nonzero(cr[i:] == _RISE)
            if not len(brk):
                break
            tb = i + int(brk[0, 0])
            peak, hold = step(tb, e_before(tb), 0)
            i = serial(tb + 1, peak, hold)
    return codes.reshape(x.shape)


def _row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of v's entries in order, each sum rounded in v's type (the
    kernel's reduction of its per-row partials)."""
    acc = torch.zeros((), dtype=v.dtype, device=v.device)
    for r in v.reshape(-1):
        acc = acc + r
    return acc


def peak_envelope_bwd_plain(x, env, e0, p0, h0, g_env, g_e, g_p,
                            tau_attack, tau_release, hold_samples,
                            release_thresh=None):
    """Plain PyTorch version of :func:`peak_envelope_bwd`: the adjoint of
    the scan body (lsp_dsp_units_tpu/ops/dynamics.py:102-123) in reverse
    time.  With lam the envelope's cotangent and lp the peak's: a step
    that set the peak adds lp to lam and clears it; a step with tau
    ``update = e + tau (x - e)`` gives x ``lam tau``, tau ``lam (x -
    e)`` and leaves ``lam - lam tau``; a held step passes lam on.
    Returns (g_x, g_envelope, g_peak, g_tau [2]: attack, release)."""
    ta, tr, _, _ = _coefs(x, tau_attack, tau_release, hold_samples,
                          release_thresh)
    codes = peak_envelope_codes(x, env, e0, p0, h0, hold_samples,
                                release_thresh)
    d = x - torch.cat([e0[..., None], env[..., :-1]], dim=-1)
    zero = torch.zeros_like(e0)
    gx = torch.empty_like(x)
    lam, lp, acc_ta, acc_tr = g_e, g_p, zero, zero
    for t in reversed(range(x.shape[-1])):
        c = codes[..., t]
        lv = lam + g_env[..., t]
        sets = (c & 4) != 0
        lv = torch.where(sets, lv + lp, lv)
        lp = torch.where(sets, zero, lp)
        kind = c & 3
        on = kind != 0
        gxt = torch.where(on, lv * torch.where(kind == 1, tr, ta), zero)
        p = lv * d[..., t]
        acc_tr = acc_tr + torch.where(kind == 1, p, zero)
        acc_ta = acc_ta + torch.where(kind == 2, p, zero)
        lam = torch.where(on, lv - gxt, lv)
        gx[..., t] = gxt
    return gx, lam, lp, torch.stack([_row_sum(acc_ta), _row_sum(acc_tr)])


def peak_envelope_bwd(x, env, e0, p0, h0, g_env, g_e, g_p, tau_attack,
                      tau_release, hold_samples, release_thresh=None):
    """Backward of :func:`peak_envelope`: ``x``, ``env`` the forward's
    level and envelope [..., T], ``e0``, ``p0``, ``h0`` its incoming
    state [...], ``g_*`` the cotangents of env, envelope' and peak'.
    The plain version for CPU tensors; for CUDA tensors the kernel
    ``peak_envelope_bwd`` (csrc/env_units.cu, csrc/env_bwd.cuh): a block
    a row stages it in shared memory, derives the branch codes (by the
    whole block where the hold time is 0, :func:`peak_envelope_codes_free`;
    by one thread otherwise), one thread runs the adjoint backward, the
    block forms x's cotangent; the per-row tau partials are summed on the
    card.  Bit for bit the plain version.  Returns (g_x, g_envelope,
    g_peak, g_tau [2])."""
    if _build.is_cpu(x, env, e0, p0, h0, g_env, g_e, g_p):
        return peak_envelope_bwd_plain(x, env, e0, p0, h0, g_env, g_e, g_p,
                                       tau_attack, tau_release, hold_samples,
                                       release_thresh)
    g_env, g_e, g_p = g_env.contiguous(), g_e.contiguous(), g_p.contiguous()
    _check_env_state(x, e0, p0, h0)
    lead = x.shape[:-1]
    if env.shape != x.shape or g_env.shape != x.shape \
            or g_e.shape != lead or g_p.shape != lead:
        raise ValueError("peak_envelope_bwd: env and its cotangent must be "
                         "shaped as x, the state's cotangents as the state")
    _build.check_cuda(torch.float32, x.device, env=env, g_env=g_env, g_e=g_e,
                      g_p=g_p)
    t = x.shape[-1]
    xr = x.reshape(-1, t)
    c = xr.shape[0]
    gx = torch.empty_like(xr)
    ge, gp = torch.empty(c, device=x.device), torch.empty(c, device=x.device)
    partials = torch.empty(2 * c, device=x.device)
    g_tau = torch.empty(2, device=x.device)
    codes = torch.empty(xr.shape, dtype=torch.uint8, device=x.device)
    use_rt = release_thresh is not None
    _build.check(_lib().lsp_peak_envelope_bwd(
        _build.ptr(xr), _build.ptr(env), _build.ptr(e0), _build.ptr(p0),
        _build.ptr(h0), _build.ptr(g_env), _build.ptr(g_e), _build.ptr(g_p),
        _build.ptr(gx), _build.ptr(ge), _build.ptr(gp), _build.ptr(partials),
        _build.ptr(g_tau), _build.ptr(codes), c, t, float(tau_attack),
        float(tau_release), float(release_thresh) if use_rt else 0.0,
        int(hold_samples), int(use_rt), _build.stream_of(x)),
        "peak_envelope_bwd kernel")
    peak_envelope_bwd.launches += 1
    return gx.reshape(x.shape), ge.reshape(lead), gp.reshape(lead), g_tau


class _PeakEnvelope(torch.autograd.Function):
    """:func:`peak_envelope` under autograd: forward
    :func:`_peak_envelope`, backward :func:`peak_envelope_bwd`."""

    @staticmethod
    def forward(ctx, x, e, peak, hold, tau_attack, tau_release,
                hold_samples, release_thresh):
        e2, p2, h2, env = _peak_envelope(x, e, peak, hold, tau_attack,
                                         tau_release, hold_samples,
                                         release_thresh)
        ctx.mark_non_differentiable(h2)
        ctx.save_for_backward(x, env, e, peak, hold)
        ctx.coefs = (tau_attack, tau_release, hold_samples, release_thresh)
        return env, e2, p2, h2

    @staticmethod
    @once_differentiable
    def backward(ctx, g_env, g_e, g_p, _g_hold):
        x, env, e, peak, hold = ctx.saved_tensors
        ta, tr, nh, rt = ctx.coefs
        gx, ge, gp, g_tau = peak_envelope_bwd(x, env, e, peak, hold, g_env,
                                              g_e, g_p, ta, tr, nh, rt)

        def tau_grad(i, v):
            if not ctx.needs_input_grad[i]:
                return None
            return g_tau[i - 4].to(dtype=v.dtype,
                                   device=v.device).reshape(v.shape)
        g_rt = torch.zeros_like(rt) if ctx.needs_input_grad[7] else None
        return (gx, ge, gp, None, tau_grad(4, ta), tau_grad(5, tr), None,
                g_rt)


# ---------------------------------------------------------------------------
# gate envelope
# ---------------------------------------------------------------------------


def _gate_plain(x, e, peak, hold, curve, tau_attack, tau_release,
                hold_samples, k0_end, k1_start):
    """The gate's recurrence over T on the state's fields: (e', peak',
    hold', curve', env, curves)."""
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
    return e, peak, hold, cur, env, curves


def gate_envelope_plain(env_state, curve: torch.Tensor, x: torch.Tensor,
                        tau_attack, tau_release, hold_samples, k0_end,
                        k1_start):
    """Plain PyTorch version of :func:`gate_envelope`."""
    e, peak, hold, cur, env, curves = _gate_plain(
        x, *env_state, curve, tau_attack, tau_release, hold_samples, k0_end,
        k1_start)
    return env_state._make((e, peak, hold)), cur, env, curves


def _gate_envelope(x, e, peak, hold, curve, tau_attack, tau_release,
                   hold_samples, k0_end, k1_start):
    """:func:`gate_envelope` outside autograd, on the state's fields: the
    plain version for CPU tensors, the kernel for CUDA tensors.  Returns
    (e', peak', hold', curve', env, curves)."""
    if _build.is_cpu(x, e, peak, hold, curve):
        return _gate_plain(x, e, peak, hold, curve, tau_attack, tau_release,
                           hold_samples, k0_end, k1_start)
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
    return (e2.reshape(lead), p2.reshape(lead), h2.reshape(lead),
            cur2.reshape(lead), env.reshape(x.shape),
            curves.reshape(x.shape))


class _GateEnvelope(torch.autograd.Function):
    """:func:`gate_envelope` under autograd: forward
    :func:`_gate_envelope`, backward :func:`peak_envelope_bwd` without a
    release threshold; the hold, the curve and the curve track are
    marked non-differentiable."""

    @staticmethod
    def forward(ctx, x, e, peak, hold, curve, tau_attack, tau_release,
                hold_samples, k0_end, k1_start):
        e2, p2, h2, cur2, env, curves = _gate_envelope(
            x, e, peak, hold, curve, tau_attack, tau_release, hold_samples,
            k0_end, k1_start)
        ctx.mark_non_differentiable(h2, cur2, curves)
        ctx.save_for_backward(x, env, e, peak, hold)
        ctx.coefs = (tau_attack, tau_release, hold_samples)
        return env, e2, p2, h2, cur2, curves

    @staticmethod
    @once_differentiable
    def backward(ctx, g_env, g_e, g_p, _g_hold, _g_cur, _g_curves):
        x, env, e, peak, hold = ctx.saved_tensors
        ta, tr, nh = ctx.coefs
        gx, ge, gp, g_tau = peak_envelope_bwd(x, env, e, peak, hold, g_env,
                                              g_e, g_p, ta, tr, nh, None)

        def tau_grad(i, v):
            if not ctx.needs_input_grad[i]:
                return None
            return g_tau[i - 5].to(dtype=v.dtype,
                                   device=v.device).reshape(v.shape)
        return (gx, ge, gp, None, None, tau_grad(5, ta), tau_grad(6, tr),
                None, None, None)


def gate_envelope(env_state, curve: torch.Tensor, x: torch.Tensor,
                  tau_attack, tau_release, hold_samples, k0_end, k1_start):
    """Gate envelope (reference Gate.cpp:267-367): the peak-hold follower
    without release threshold, plus the active-curve track, which
    switches to 1 when the envelope exceeds ``k0_end`` and back to 0 when
    it falls below ``k1_start``.  ``curve`` [...] int32.  Returns
    (EnvState', curve' [...], env [..., T], curves [..., T] int32).
    Differentiable in x, the envelope and peak, and the taus (host
    numbers or 0-d tensors); the hold, the curve and the knee points
    only steer decisions (zero gradient)."""
    e, peak, hold = env_state
    if _build.needs_grad(x, e, peak, tau_attack, tau_release):
        env, e2, p2, h2, cur2, curves = _GateEnvelope.apply(
            x, e, peak, hold, curve, tau_attack, tau_release, hold_samples,
            k0_end, k1_start)
    else:
        e2, p2, h2, cur2, env, curves = _gate_envelope(
            x, e, peak, hold, curve, tau_attack, tau_release, hold_samples,
            k0_end, k1_start)
    return env_state._make((e2, p2, h2)), cur2, env, curves


sliding_rms.launches = 0
sliding_rms_bwd.launches = 0
peak_envelope.launches = 0
peak_envelope_bwd.launches = 0
gate_envelope.launches = 0
