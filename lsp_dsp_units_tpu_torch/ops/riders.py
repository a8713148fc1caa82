"""Serial gain riders and followers: one state-dependent chain per row
over time, for AutoGain, SimpleAutoGain, SurgeProtector, PeakMeter and
DynamicProcessor's envelope (the ``lax.scan`` steps of the JAX package's
models/dynamics/autogain.py :97-147 and :178-191, surge_protector.py
:48-71, models/meters/peak.py :43-59 and dynamic_processor.py :155-175).

Each wrapper runs its plain PyTorch version (``*_plain``: a Python loop
over T, each step vectorised over the rows) for CPU tensors and launches
``csrc/riders.cu`` (``rider_kernel<Step>``, one thread per row, the step a
functor) for CUDA tensors, counting launches in ``<wrapper>.launches``.
Inputs are [..., T] (T >= 1), copied where they are not contiguous;
the kernel sees them as [rows, T].

The unit comes in as the model object (its float attributes, rounded to
float32 here once by each unit's ``_*_consts``); the state as the caller's
NamedTuple, returned with ``state._make``.  Flags in the states are
torch.bool, which the kernel reads and writes as bytes.

Agreement: every product, sum and quotient rounds once, as the JAX
package's separate float32 operations do, except where XLA on the CPU
contracts ``a * b + c`` into one FMA: DynamicProcessor's envelope update
``e + tau * d`` (as the compressor's, ops/env_units.py) and AutoGain's
curve (:func:`_curve_mid`).  There both versions round once
(``_mul_add``, ``__fmaf_rn``).  And XLA divides SurgeProtector's ramp
by its constant as a product with the reciprocal (:func:`_surge_consts`).
So kernel and plain version agree bit for bit, and the plain versions
agree with the JAX package bit for bit (found by holding each rounding
against it: tests/test_torch_dynamics2.py, tests/test_torch_meters.py).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops.env_units import _mul_add

N_FLOATS, N_INTS, N_STATE = 24, 4, 4      # csrc/riders.cu Args
KIND = {"autogain": 0, "simple_autogain": 1, "surge": 2, "peak_meter": 3,
        "dynproc": 4}
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
STATE_DTYPES = {"autogain": (_F32, _F32, _BOOL, _BOOL),
                "simple_autogain": (_F32,), "surge": (_BOOL, _I32, _I32),
                "peak_meter": (_F32, _I32), "dynproc": (_F32, _F32, _I32)}
MAX_LEVELS = 5                            # DynamicProcessor: 1 + 4 dots
TINY_LEVEL = 1e-18

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"lsp_rider": [_I] + [_P] * 4 + [_P] * 2 + [_P] * 2 + [_I] * 2
         + [_P], "lsp_rider_chain_ops": [_I]}


def _lib():
    return _build.load("riders", _SIGS)


def chain_ops(name: str) -> int:
    """The dependent operations a step of ``name``'s functor puts on its
    state chain (its ``kChainOps`` in csrc/riders.cu; builds the kernel)."""
    return int(_lib().lsp_rider_chain_ops(KIND[name]))


def _f32(v) -> float:
    return float(np.float32(v))


def _t(v, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=like.device)


def _launch(name: str, inputs: Sequence[torch.Tensor], state,
            floats: Sequence[float], ints: Sequence[int]):
    """Run ``rider_kernel<Step>`` of ``name`` over inputs [..., T] (the
    same shape) and the state's fields [...]; returns (fields', out)."""
    x = inputs[0]
    t = x.shape[-1]
    lead = x.shape[:-1]
    if t < 1 or any(i.shape != x.shape for i in inputs):
        raise ValueError(f"inputs must share one shape [..., T>=1], got "
                         f"{[tuple(i.shape) for i in inputs]}")
    if tuple(f.dtype for f in state) != STATE_DTYPES[name]:
        raise ValueError(f"{name} state fields must be {STATE_DTYPES[name]}, "
                         f"got {tuple(f.dtype for f in state)}")
    for f in state:
        if f.shape != lead:
            raise ValueError(f"state fields must be {tuple(lead)} beside "
                             f"inputs {tuple(x.shape)}, got {tuple(f.shape)}")
        if f.device != x.device or not f.is_contiguous():
            raise ValueError("state fields must be contiguous, on the "
                             "inputs' device")
    rows = int(np.prod(lead, dtype=np.int64))
    xs = [i.contiguous().reshape(rows, t) for i in inputs]
    _build.check_cuda(torch.float32, x.device,
                      **{f"in{i}": v for i, v in enumerate(xs)})
    out = torch.empty_like(xs[0])
    fields = [torch.empty_like(f) for f in state]
    ptrs = [_build.ptr(v) for v in xs] + [None] * (3 - len(xs))
    st_in = (ctypes.c_void_p * N_STATE)(
        *[f.data_ptr() for f in state], *[0] * (N_STATE - len(state)))
    st_out = (ctypes.c_void_p * N_STATE)(
        *[f.data_ptr() for f in fields], *[0] * (N_STATE - len(fields)))
    fl = (ctypes.c_float * N_FLOATS)(*floats)
    it = (ctypes.c_int * N_INTS)(*ints)
    _build.check(_lib().lsp_rider(
        KIND[name], *ptrs, _build.ptr(out),
        *(ctypes.cast(v, ctypes.c_void_p) for v in (st_in, st_out, fl, it)),
        rows, t, _build.stream_of(x)), f"{name} rider kernel")
    return fields, out.reshape(x.shape)


# ---------------------------------------------------------------------------
# AutoGain
# ---------------------------------------------------------------------------

_COMP_KEYS = ("x1", "x2", "t", "d", "c", "b", "a")


def _autogain_consts(unit):
    """(floats, ints) of the kernel's AutoGainStep: deviation, the four
    timing factors, silence, max_gain, then short_comp and out_comp by
    ``_COMP_KEYS``; quick_amp, use_max_gain."""
    floats = [_f32(v) for v in (
        unit.deviation, unit.short_kfall, unit.short_kgrow,
        unit.long_kfall, unit.long_kgrow, unit.silence, unit.max_gain)]
    for comp in (unit.short_comp, unit.out_comp):
        floats += [_f32(comp[k]) for k in _COMP_KEYS]
    return floats, [int(unit.quick_amp), int(unit.use_max_gain)]


def _curve_mid(c, v):
    """AutoGain's curve ``((a v + b) v + c v) + d`` (reference
    AutoGain.cpp:205) as XLA contracts it on the CPU: ``fma(fma(a, v, b),
    v, c v) + d``."""
    av_b = _mul_add(c["a"].expand_as(v), v, c["b"].expand_as(v))
    return _mul_add(av_b, v, c["c"] * v) + c["d"]


def eval_curve(c, x):
    """AutoGain's compressor curve (reference eval_curve) on float32 x,
    ``c`` its coefficients as float32 tensors by ``_COMP_KEYS``."""
    return torch.where(x >= c["x2"], c["t"],
                       torch.where(x <= c["x1"], x,
                                   _curve_mid(c, x - c["x1"])))


def _eval_gain(c, x):
    """Curve gain ``curve(x) / max(x, 1e-18)`` (reference eval_gain)."""
    return eval_curve(c, x) / torch.clamp(x, min=TINY_LEVEL)


def autogain_plain(unit, state, l_long, l_short, l_exp):
    """Plain PyTorch version of :func:`autogain`."""
    floats, (quick, use_max) = _autogain_consts(unit)
    dev, skfall, skgrow, lkfall, lkgrow, silence, max_gain = (
        _t(v, l_long) for v in floats[:7])
    sc = dict(zip(_COMP_KEYS, (_t(v, l_long) for v in floats[7:14])))
    oc = dict(zip(_COMP_KEYS, (_t(v, l_long) for v in floats[14:21])))
    one = _t(1.0, l_long)
    l_exp = l_exp.expand(l_long.shape)
    g, og, su, sd = state
    vca = torch.empty_like(l_long)
    for i in range(l_long.shape[-1]):
        sl, ss, le = l_long[..., i], l_short[..., i], l_exp[..., i]
        nl, ns = sl * g, ss * g
        up = torch.logical_and(torch.logical_and(su, ~sd), ns > le * dev)
        if quick:
            down = torch.logical_and(torch.logical_and(sd, ~su),
                                     ns * dev <= le)
        else:
            down = torch.zeros_like(sd)
        lim = torch.clamp(le, min=TINY_LEVEL)
        red = _eval_gain(sc, ns / lim)
        up = torch.logical_or(up, red * dev < 1.0)
        if quick:
            down = torch.logical_or(down, torch.logical_and(
                ~up, ns * dev <= le))
        gain = torch.where(up, g * skfall, torch.where(
            down, g * skgrow, torch.where(nl > le, g * lkfall, torch.where(
                nl < le, g * lkgrow, g))))
        gain = gain * _eval_gain(oc, (ss * gain) / lim)
        silent = ss <= silence
        gain = torch.where(silent, g, gain)
        up = torch.where(silent, su, up)
        down = torch.where(silent, sd, down)
        if use_max:
            og = torch.where(gain >= max_gain, max_gain / gain, one)
        else:
            og = torch.clamp(og * lkgrow, max=1.0)
        vca[..., i] = gain * og
        g, su, sd = gain, up, down
    return state._make((g, og, su, sd)), vca


def autogain(unit, state, l_long, l_short, l_exp):
    """AutoGain's rider (reference AutoGain::process) over the long,
    short and expected loudness [..., T] (``l_exp`` broadcast to
    ``l_long``'s shape); ``state`` an AutoGainState (gain, out_gain
    float32; surge_up, surge_down bool).  Returns (state', vca gain)."""
    if _build.is_cpu(l_long, l_short, l_exp, *state):
        return autogain_plain(unit, state, l_long, l_short, l_exp)
    floats, ints = _autogain_consts(unit)
    fields, vca = _launch("autogain", (
        l_long, l_short, l_exp.expand(l_long.shape).contiguous()), state,
        floats, ints)
    autogain.launches += 1
    return state._make(fields), vca


# ---------------------------------------------------------------------------
# SimpleAutoGain
# ---------------------------------------------------------------------------


def _simple_consts(unit):
    return [_f32(v) for v in (unit.deviation, unit.kgrow, unit.kfall,
                              unit.silence, unit.min_gain, unit.max_gain)]


def simple_autogain_plain(unit, state, level, target):
    """Plain PyTorch version of :func:`simple_autogain`."""
    dev, kgrow, kfall, silence, lo, hi = (_t(v, level)
                                          for v in _simple_consts(unit))
    target = target.expand(level.shape)
    (g,) = state
    out = torch.empty_like(level)
    for i in range(level.shape[-1]):
        lv, tg = level[..., i], target[..., i]
        nl = lv * g
        ng = torch.where(lv <= silence, g, torch.where(
            nl * dev < tg, g * kgrow, torch.where(nl > tg * dev, g * kfall,
                                                  g)))
        g = torch.minimum(torch.maximum(ng, lo), hi)
        out[..., i] = g
    return state._make((g,)), out


def simple_autogain(unit, state, level, target):
    """SimpleAutoGain's rider (reference SimpleAutoGain.cpp) toward
    ``target`` (broadcast to ``level``'s shape).  Returns (state', gain
    [..., T])."""
    if _build.is_cpu(level, target, *state):
        return simple_autogain_plain(unit, state, level, target)
    fields, out = _launch("simple_autogain", (
        level, target.expand(level.shape).contiguous()), state,
        _simple_consts(unit), [])
    simple_autogain.launches += 1
    return state._make(fields), out


# ---------------------------------------------------------------------------
# SurgeProtector
# ---------------------------------------------------------------------------


def _surge_consts(unit):
    """The ramp ``sqrt(tt / tmax)`` is ``sqrt(tt * (1 / tmax))``: XLA
    turns the JAX package's division by the constant into a product with
    its float32 reciprocal (then a correctly rounded sqrt)."""
    return ([_f32(unit.on_threshold), _f32(unit.off_threshold),
             _f32(1.0 / max(int(unit.transition_max), 1))],
            [int(unit.transition_max), int(unit.shutdown_max)])


def surge_protector_plain(unit, state, x):
    """Plain PyTorch version of :func:`surge_protector`."""
    (on_thr, off_thr, recip), (tmax, sd_max) = _surge_consts(unit)
    on_thr, off_thr, recip = (_t(v, x) for v in (on_thr, off_thr, recip))
    on, sd, tt = state
    ax = torch.abs(x)
    out = torch.empty_like(x)
    for i in range(x.shape[-1]):
        xt = ax[..., i]
        sd = torch.where(on, torch.where(xt >= off_thr, 0, sd + 1), sd)
        turn_off = torch.logical_and(on, sd >= sd_max)
        turn_on = torch.logical_and(~on, xt >= on_thr)
        on = torch.where(turn_off, False, torch.where(turn_on, True, on))
        sd = torch.where(turn_on, 0, sd).to(torch.int32)
        ramp = torch.sqrt(tt.to(torch.float32) * recip)
        gain_on = torch.where(tt < tmax, ramp, 1.0)
        gain_off = torch.where(tt > 0, ramp, 0.0)
        out[..., i] = torch.where(on, gain_on, gain_off)
        tt = torch.where(on, torch.clamp(tt + 1, max=tmax),
                         torch.clamp(tt - 1, min=0)).to(torch.int32)
    return state._make((on, sd, tt)), out


def surge_protector(unit, state, x):
    """SurgeProtector's on/off machine (reference SurgeProtector.cpp) on
    the detector x [..., T]; ``state`` (on bool, shutdown_time,
    transition_time int32).  Returns (state', gain [..., T])."""
    if _build.is_cpu(x, *state):
        return surge_protector_plain(unit, state, x)
    floats, ints = _surge_consts(unit)
    fields, out = _launch("surge", (x,), state, floats, ints)
    surge_protector.launches += 1
    return state._make(fields), out


# ---------------------------------------------------------------------------
# PeakMeter
# ---------------------------------------------------------------------------


def peak_meter_plain(unit, state, x):
    """Plain PyTorch version of :func:`peak_meter`."""
    tau = _t(_f32(unit.tau), x)
    peak, cnt = state
    ax = torch.abs(x)
    out = torch.empty_like(x)
    for i in range(x.shape[-1]):
        a = ax[..., i]
        rising = a >= peak
        peak = torch.where(rising, a, torch.where(cnt > 0, peak, peak * tau))
        cnt = torch.where(rising, unit.hold,
                          torch.clamp(cnt - 1, min=0)).to(torch.int32)
        out[..., i] = peak
    return state._make((peak, cnt)), out


def peak_meter(unit, state, x):
    """PeakMeter's held peak with release decay (reference
    PeakMeter.cpp:130-149) over x [..., T]; ``state`` (peak float32,
    counter int32).  Returns (state', peak [..., T])."""
    if _build.is_cpu(x, *state):
        return peak_meter_plain(unit, state, x)
    fields, out = _launch("peak_meter", (x,), state, [_f32(unit.tau)],
                          [int(unit.hold)])
    peak_meter.launches += 1
    return state._make(fields), out


# ---------------------------------------------------------------------------
# DynamicProcessor's envelope
# ---------------------------------------------------------------------------


def _dynproc_consts(params):
    levels = (params.att_level, params.att_tau, params.rel_level,
              params.rel_tau)
    if not 1 <= len(params.att_level) <= MAX_LEVELS or not (
            1 <= len(params.rel_level) <= MAX_LEVELS):
        raise ValueError(f"1 to {MAX_LEVELS} attack and release levels")
    floats = []
    for v in levels:
        floats += [_f32(f) for f in v] + [0.0] * (MAX_LEVELS - len(v))
    return floats, [len(params.att_level), len(params.rel_level),
                    int(params.hold)]


def _solve_tau(levels, taus, e):
    """Level-dependent tau (reference solve_reaction): the tau of the
    highest level <= e (the first where none is)."""
    idx = torch.clamp(torch.sum((e[..., None] >= levels).to(torch.int32),
                                dim=-1) - 1, min=0)
    return taus[idx]


def dynproc_envelope_plain(params, state, x):
    """Plain PyTorch version of :func:`dynproc_envelope`."""
    al, at, rl, rt = (_t([_f32(v) for v in f], x) for f in (
        params.att_level, params.att_tau, params.rel_level, params.rel_tau))
    nh = int(params.hold)
    e, peak, hold = state
    out = torch.empty_like(x)
    for i in range(x.shape[-1]):
        d = x[..., i] - e
        falling = d < 0.0
        holding = hold > 0
        e_fall = _mul_add(_solve_tau(rl, rt, e), d, e)
        e_rise = _mul_add(_solve_tau(al, at, e), d, e)
        new_e = torch.where(falling, torch.where(holding, e, e_fall), e_rise)
        rise_peaked = torch.logical_and(~falling, e_rise >= peak)
        peak = torch.where(falling, torch.where(holding, peak, e_fall),
                           torch.where(rise_peaked, e_rise, peak))
        hold = torch.where(falling, torch.where(holding, hold - 1, hold),
                           torch.where(rise_peaked, nh, hold)).to(torch.int32)
        e = new_e
        out[..., i] = e
    return state._make((e, peak, hold)), out


def dynproc_envelope(params, state, x):
    """DynamicProcessor's peak-hold envelope with level-dependent attack
    and release taus (reference DynamicProcessor.cpp:195-201 and the
    shared follower) over the detector x [..., T]; ``params`` a
    DynProcParams (its levels and taus float tuples, ``hold`` an int),
    ``state`` an EnvState.  Returns (state', envelope [..., T])."""
    if _build.is_cpu(x, *state):
        return dynproc_envelope_plain(params, state, x)
    floats, ints = _dynproc_consts(params)
    fields, out = _launch("dynproc", (x,), state, floats, ints)
    dynproc_envelope.launches += 1
    return state._make(fields), out


RIDERS = (autogain, simple_autogain, surge_protector, peak_meter,
          dynproc_envelope)
for _fn in RIDERS:
    _fn.launches = 0
