"""Serial gain riders, followers and state machines: one state-dependent
chain per row over time, for AutoGain, SimpleAutoGain, SurgeProtector,
PeakMeter, DynamicProcessor's envelope, the Trigger and the Depopper's
forward machine (the ``lax.scan`` steps of the JAX package's
models/dynamics/autogain.py :97-147 and :178-191, surge_protector.py
:48-71, models/meters/peak.py :43-59, dynamic_processor.py :155-175,
models/util/trigger.py :114-164 and models/util/depopper.py :137-186).

Each wrapper runs its plain PyTorch version (``*_plain``: a Python loop
over T, each step vectorised over the rows) for CPU tensors and launches
``csrc/riders.cu`` (``rider_kernel<Step>``, one block per row: producer
warps compute each step's input terms, one thread runs the state
transition, consumer warps form the outputs; the step a functor split in
those three parts) for CUDA tensors, counting launches in
``<wrapper>.launches``.
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
against it: tests/test_torch_dynamics2.py, tests/test_torch_meters.py,
tests/test_torch_utility_units.py).  The Depopper's fade-in curve
(:func:`_fade_in`) is rounded as XLA compiles it inside the JAX scan,
which contracts and reassociates it; its sine and gaussian forms take
sin and exp in float64 rounded once (as the kernel does), within an ulp
of XLA's float32 functions.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops.env_units import _mul_add

N_FLOATS, N_INTS, N_STATE, N_OUT = 24, 8, 5, 3   # csrc/riders.cu Args
# kind of each step functor; the Trigger's is 5 + its type (0-4)
KIND = {"autogain": 0, "simple_autogain": 1, "surge": 2, "peak_meter": 3,
        "dynproc": 4, "trigger": 5, "depopper": 10}
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
STATE_DTYPES = {"autogain": (_F32, _F32, _BOOL, _BOOL),
                "simple_autogain": (_F32,), "surge": (_BOOL, _I32, _I32),
                "peak_meter": (_F32, _I32), "dynproc": (_F32, _F32, _I32),
                "trigger": (_F32, _I32, _I32, _BOOL, _BOOL),
                "depopper": (_I32, _I32, _I32)}
OUT_DTYPES = {"trigger": (_I32,), "depopper": (_F32, _BOOL, _I32)}
MAX_LEVELS = 5                            # DynamicProcessor: 1 + 4 dots
TINY_LEVEL = 1e-18

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"lsp_rider": [_I] + [_P] * 4 + [_P] * 2 + [_P] * 2 + [_I] * 2
         + [_P], "lsp_rider_chain_ops": [_I]}


def _lib():
    return _build.load("riders", _SIGS)


def chain_ops(name: str, kind=None) -> int:
    """The dependent operations a step of ``name``'s functor (``kind``,
    by default ``KIND[name]``: the Trigger's is 5 + its type) puts on its
    state chain (its ``kChainOps`` in csrc/riders.cu; builds the
    kernel)."""
    return int(_lib().lsp_rider_chain_ops(KIND[name] if kind is None
                                          else kind))


def _f32(v) -> float:
    return float(np.float32(v))


def _t(v, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=like.device)


def _launch(name: str, inputs: Sequence[torch.Tensor], state,
            floats: Sequence[float], ints: Sequence[int], kind=None):
    """Run ``rider_kernel<Step>`` of ``name`` (functor ``kind``, by default
    ``KIND[name]``) over inputs [..., T] (the same shape) and the state's
    fields [...]; returns (fields', out), out one tensor [..., T] or, for
    a step with several outputs, a tuple of them."""
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
    outs = [torch.empty(rows, t, dtype=d, device=x.device)
            for d in OUT_DTYPES.get(name, (_F32,))]
    fields = [torch.empty_like(f) for f in state]
    ptrs = [_build.ptr(v) for v in xs] + [None] * (3 - len(xs))
    st_in = (ctypes.c_void_p * N_STATE)(
        *[f.data_ptr() for f in state], *[0] * (N_STATE - len(state)))
    st_out = (ctypes.c_void_p * N_STATE)(
        *[f.data_ptr() for f in fields], *[0] * (N_STATE - len(fields)))
    out = (ctypes.c_void_p * N_OUT)(
        *[o.data_ptr() for o in outs], *[0] * (N_OUT - len(outs)))
    fl = (ctypes.c_float * N_FLOATS)(*floats, *[0.0] * (N_FLOATS
                                                       - len(floats)))
    it = (ctypes.c_int * N_INTS)(*ints, *[0] * (N_INTS - len(ints)))
    _build.check(_lib().lsp_rider(
        KIND[name] if kind is None else kind, *ptrs,
        *(ctypes.cast(v, ctypes.c_void_p)
          for v in (out, st_in, st_out, fl, it)),
        rows, t, _build.stream_of(x)), f"{name} rider kernel")
    outs = tuple(o.reshape(x.shape) for o in outs)
    return fields, outs if len(outs) > 1 else outs[0]


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
    _build.no_grad_route("autogain", l_long, l_short, l_exp, *state)
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
    _build.no_grad_route("simple_autogain", level, target, *state)
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
    _build.no_grad_route("surge_protector", x, *state)
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
    _build.no_grad_route("peak_meter", x, *state)
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
    """(floats, ints) of the kernel's DynProcStep: each level list
    ascending beside its taus in the caller's order (the tau of c levels
    <= e is tau[c - 1] whatever the levels' order, and the kernel finds c
    by a ladder over ascending levels), padded to MAX_LEVELS; the
    counts, the hold."""
    levels = (sorted(params.att_level), params.att_tau,
              sorted(params.rel_level), params.rel_tau)
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
    _build.no_grad_route("dynproc_envelope", x, *state)
    if _build.is_cpu(x, *state):
        return dynproc_envelope_plain(params, state, x)
    floats, ints = _dynproc_consts(params)
    fields, out = _launch("dynproc", (x,), state, floats, ints)
    dynproc_envelope.launches += 1
    return state._make(fields), out


# ---------------------------------------------------------------------------
# Trigger
# ---------------------------------------------------------------------------


def _trigger_consts(unit):
    """(floats, ints, kind): the threshold and its hysteresis window's
    bounds (float64 sums rounded to float32, as the JAX step compares
    against them); one-shot (SINGLE or MANUAL), hold; the functor of the
    trigger's type."""
    th, hy = unit.threshold, unit.hysteresis
    one_shot = unit.mode.name in ("SINGLE", "MANUAL")
    return ([_f32(th), _f32(th - hy), _f32(th + hy)],
            [int(one_shot), int(unit.hold)], KIND["trigger"]
            + int(unit.ttype.value))


def _trigger_edges(ttype: int, x, prev0, th, lo, hi):
    """The step's compares that read the samples alone, for all T at once
    (the step's own float32 subtraction and compares).  While a row is
    unlocked its previous sample is the one before (``prev0`` at the
    first); a locked row's compares are masked, so these serve it too."""
    prev = torch.cat([prev0[..., None], x[..., :-1]], dim=-1)
    diff = x - prev
    if ttype == 1:
        return ((diff > 0.0) & (x >= th),)
    if ttype == 2:
        return ((diff < 0.0) & (x <= th),)
    if ttype == 3:
        return ((diff > 0.0) & (x >= lo) & (prev < lo) & (x < th),
                (diff > 0.0) & (x >= hi) & (prev < hi), x < lo)
    return ((diff < 0.0) & (x <= hi) & (prev > hi) & (x > th),
            (diff < 0.0) & (x <= lo) & (prev > lo), x > hi)


def trigger_plain(unit, state, x):
    """Plain PyTorch version of :func:`trigger`."""
    (th, lo, hi), (one_shot, hold), kind = _trigger_consts(unit)
    ttype = kind - KIND["trigger"]
    prev, st, cnt, disarm, locked = state
    edges = _trigger_edges(ttype, x, prev, th, lo, hi) if ttype else ()
    # no lock now and none can come: the lock's masks drop out
    lockable = bool(one_shot) or bool(locked.any())
    out = torch.empty(x.shape, dtype=_I32, device=x.device)
    for i in range(x.shape[-1]):
        hold_ok = cnt >= hold
        if ttype == 0:
            fire = hold_ok
            new_st = torch.where(fire, 2, 0).to(_I32)
            new_dis = disarm
        elif ttype in (1, 2):
            fire = edges[0][..., i] & hold_ok
            new_st = torch.where(fire, 2, 0).to(_I32)
            new_dis = disarm
        else:
            arm, firec, oob = (e[..., i] for e in edges)
            st2 = torch.where(arm & hold_ok, 1, torch.where(disarm, 0, st))
            fire = (st2 == 1) & firec
            new_st = torch.where(fire, 2, st2)
            new_dis = fire | oob
        if lockable:
            fire = fire & ~locked
            st = torch.where(locked, 0, new_st)
            cnt = torch.where(locked, cnt, torch.where(fire, 0, cnt) + 1)
            disarm = torch.where(locked, disarm, new_dis)
            prev = torch.where(locked, prev, x[..., i])
            if one_shot:
                locked = locked | fire
        else:
            st = new_st
            cnt = torch.where(fire, 0, cnt) + 1
            disarm = new_dis
        out[..., i] = st
    if not lockable and x.shape[-1]:
        prev = x[..., -1].clone()
    return state._make((prev, st, cnt, disarm, locked)), out


def trigger(unit, state, x):
    """The Trigger's machine (reference Trigger.cpp:80-215) over x [..., T]
    for ``unit`` (a models.util.trigger.Trigger: type, mode, threshold,
    hysteresis, hold); ``state`` a TriggerState (prev float32, state and
    hold counter int32, disarm and locked bool, each [...]).  Returns
    (state', int32 state a sample: 0 waiting, 1 armed, 2 fired)."""
    _build.no_grad_route("trigger", x, *state)
    if _build.is_cpu(x, *state):
        return trigger_plain(unit, state, x)
    floats, ints, kind = _trigger_consts(unit)
    fields, out = _launch("trigger", (x,), state, floats, ints, kind)
    trigger.launches += 1
    return state._make(fields), out


# ---------------------------------------------------------------------------
# Depopper's forward machine
# ---------------------------------------------------------------------------

DEPOP_CLOSED, DEPOP_FADE, DEPOP_OPENED, DEPOP_WAIT = 0, 1, 2, 3


def _depopper_consts(unit):
    """(floats, ints): the thresholds, the fade-in curve's constants (the
    JAX step's float64 expressions of k = 1 / n_in, each rounded to
    float32; the parabola's k^2 as XLA folds it, the product of float32
    k with itself); n_in, n_out, the two delays, the fade-in mode."""
    n_in = int(unit.fade_in_n)
    k = 1.0 / n_in if n_in > 0 else 0.0
    f0 = float(np.exp(-16.0))
    kf = np.float32(k)
    floats = [_f32(unit.fade_in_thresh), _f32(unit.fade_out_thresh),
              _f32(k), _f32(3.0 * k * k), _f32(-2.0 * k ** 3),
              _f32(np.pi * 0.5 * k), _f32(4.0 * k), _f32(1.0 / (1.0 - f0)),
              _f32(f0), float(kf * kf)]
    return floats, [n_in, int(unit.fade_out_n), int(unit.in_delay_n),
                    int(unit.out_delay_n), int(unit.fade_in_mode.value)]


def _fade_in(floats, mode: int, n: int, x):
    """The fade-in gain at x samples (int32, >= 0), rounded as XLA
    compiles the JAX package's crossfade inside its scan
    (models/util/depopper.py:54-81): the cubic as ``fma(c3 x, x,
    ((c2 x) x) x)``, the gaussian as ``fma(exp(-u u), c1, -f0)`` with
    ``u = fma(4 k, x, -4)``, the parabola as ``k^2 (x x)``.  sin and exp
    in float64, rounded once to float32: the kernel takes the same, so
    the two agree bit for bit (float32 sin and exp differ in their last
    bits between torch, CUDA and XLA)."""
    c = [_t(v, x) for v in floats]
    xf = x.to(_F32)
    if mode == 0:
        g = c[2] * xf
    elif mode == 1:
        g = _mul_add(c[3] * xf, xf, ((c[4] * xf) * xf) * xf)
    elif mode == 2:
        s = torch.sin((c[5] * xf).double()).to(_F32)
        g = s * s
    elif mode == 3:
        u = _mul_add(c[6].expand_as(xf), xf, _t(-4.0, x).expand_as(xf))
        g = _mul_add(torch.exp((-u * u).double()).to(_F32),
                     c[7].expand_as(xf), (-c[8]).expand_as(xf))
    else:
        g = c[9] * (xf * xf)
    return torch.where(x >= n, 1.0, g)


def depopper_forward_plain(unit, state, env):
    """Plain PyTorch version of :func:`depopper_forward`."""
    floats, (n_in, n_out, in_dly, out_dly, mode) = _depopper_consts(unit)
    st, cnt, dly = state
    # the thresholds' compares read env alone; the fade-in gain at each
    # count 0..n_in, rounded as the step rounds it, looked up
    above_in = env >= floats[0]
    below_out = env < floats[1]
    table = _fade_in(floats, mode, n_in, torch.arange(
        n_in + 1, dtype=_I32, device=env.device))
    raw = torch.empty_like(env)
    fall = torch.empty(env.shape, dtype=_BOOL, device=env.device)
    patch = torch.empty(env.shape, dtype=_I32, device=env.device)
    for i in range(env.shape[-1]):
        closed, fade = st == DEPOP_CLOSED, st == DEPOP_FADE
        opened, wait = st == DEPOP_OPENED, st == DEPOP_WAIT
        bo = below_out[..., i]
        open_now = closed & above_in[..., i]
        cp1, dm1 = cnt + 1, dly - 1
        cnt1 = torch.where(fade | (opened & (cnt < n_out)), cp1, cnt)
        cnt1 = torch.where(open_now, 1, cnt1)
        dly_f = torch.where(bo, dm1, in_dly)
        fade_fall = fade & bo & (dly_f <= 0)
        fade_done = fade & ~bo & (cnt1 >= n_in)
        open_fall = opened & bo
        fl = fade_fall | open_fall
        pos = torch.clamp(torch.where(open_now, 0, cnt), max=n_in)
        raw[..., i] = torch.where(fade | open_now, table[pos],
                                  opened.to(env.dtype))
        fall[..., i] = fl
        patch[..., i] = torch.where(fl, torch.clamp(cnt1, max=n_out), 0)
        st = torch.where(open_now, DEPOP_FADE, torch.where(
            fl, DEPOP_WAIT, torch.where(fade_done, DEPOP_OPENED, torch.where(
                wait & (dm1 <= 0), DEPOP_CLOSED, st))))
        dly = torch.where(open_fall, out_dly, torch.where(
            fade, dly_f, torch.where(open_now, in_dly, torch.where(
                wait, dm1, dly))))
        cnt = cnt1
    return (st, cnt, dly), (raw, fall, patch)


def depopper_forward(unit, state, env):
    """The Depopper's forward machine (reference Depopper.cpp:550-640)
    over the RMS envelope env [..., T] for ``unit`` (a
    models.util.depopper.Depopper); ``state`` (st, counter, delay), int32
    [...] each.  Returns ((st, counter, delay)', (raw fade-in gain
    float32, fall bool, the fall's patch length int32), each [..., T])."""
    _build.no_grad_route("depopper_forward", env, *state)
    if _build.is_cpu(env, *state):
        return depopper_forward_plain(unit, state, env)
    floats, ints = _depopper_consts(unit)
    fields, outs = _launch("depopper", (env,), tuple(state), floats, ints)
    depopper_forward.launches += 1
    return tuple(fields), outs


RIDERS = (autogain, simple_autogain, surge_protector, peak_meter,
          dynproc_envelope)
for _fn in RIDERS + (trigger, depopper_forward):
    _fn.launches = 0
