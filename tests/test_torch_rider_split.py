"""The split of ``csrc/riders.cu``'s step functors, modelled on the CPU.

``rider_kernel`` runs each step functor in three parts: ``pre`` (what a
step computes from its inputs alone) on producer warps, ``next`` (the
state transition alone, writing each step's record) on one chain thread,
and ``out`` (each step's outputs from the record) on consumer warps.
Here each functor's three parts are written in torch as the kernel
writes them, through the real ``_*_consts`` of ``ops/riders.py``:
``pre`` and ``out`` vectorised over T, ``next`` a loop over T.  Each
model must equal its plain loop bit for bit, outputs and state, at T on
both sides of the kernel's chunk (``kChunk``, read from the source), over
two calls with the state carried, on seeded inputs that reach every
branch: silence, lock, hold, fall and wait.  That holds the split's
algebra (the folded silence and timing factors, the records, the
Trigger's edge terms and its last unlocked step in place of prev, the
Depopper's packed record) that only the card could otherwise show.
"""

import os
import re

import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu_torch.models.dynamics import (
    AutoGain, DynamicProcessor, SimpleAutoGain, SurgeProtector)
from lsp_dsp_units_tpu_torch.models.meters import PeakMeter
from lsp_dsp_units_tpu_torch.models.util import (
    Depopper, DepopperMode, Trigger, TriggerMode, TriggerType)
from lsp_dsp_units_tpu_torch.ops import riders as rd

RIDERS_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lsp_dsp_units_tpu_torch", "csrc", "riders.cu")
with open(RIDERS_CU) as _f:
    CHUNK = int(re.search(r"constexpr int kChunk = (\d+);",
                          _f.read()).group(1))
TS = (1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 17)
ROWS = 3
F32, I32 = torch.float32, torch.int32


def _t(v, dtype=F32):
    return torch.tensor(v, dtype=dtype)


def _w(cond, a, b):
    """torch.where with Python or 0-d operands, float32."""
    return torch.where(cond, torch.as_tensor(a, dtype=F32),
                       torch.as_tensor(b, dtype=F32))


# --- the riders ------------------------------------------------------------


def autogain_split(unit, state, l_long, l_short, l_exp):
    floats, (quick, use_max) = rd._autogain_consts(unit)
    dev, skfall, skgrow, lkfall, lkgrow, silence, max_gain = (
        _t(v) for v in floats[:7])
    sc = dict(zip(rd._COMP_KEYS, (_t(v) for v in floats[7:14])))
    oc = dict(zip(rd._COMP_KEYS, (_t(v) for v in floats[14:21])))
    le_all = l_exp.expand(l_long.shape)
    # pre
    ledev = le_all * dev
    lim_all = torch.clamp(le_all, min=rd.TINY_LEVEL)
    silent_all = l_short <= silence
    # next: the gain (and, without max_gain, out_gain) after each step
    g, og, up, down = state
    rec_g = torch.empty_like(l_long)
    rec_og = torch.empty_like(l_long)
    for i in range(l_long.shape[-1]):
        sl, ss, le = l_long[..., i], l_short[..., i], le_all[..., i]
        lim, silent = lim_all[..., i], silent_all[..., i]
        nl, ns = sl * g, ss * g
        u = up & ~down & (ns > ledev[..., i])
        ns_low = ns * dev <= le
        d = down & ~up & ns_low if quick else torch.zeros_like(down)
        red = rd._eval_gain(sc, ns / lim)
        u = u | (red * dev < 1.0)
        if quick:
            d = d | (~u & ns_low)
        k = _w(u, skfall, _w(d, skgrow, _w(nl > le, lkfall,
                                           _w(nl < le, lkgrow, 1.0))))
        gain = g * k
        gain = gain * rd._eval_gain(oc, (ss * gain) / lim)
        gain = torch.where(silent, g, gain)
        up, down = torch.where(silent, up, u), torch.where(silent, down, d)
        if not use_max:
            og = torch.clamp(og * lkgrow, max=1.0)
            rec_og[..., i] = og
        g = gain
        rec_g[..., i] = g
    # out
    if use_max:
        rec_og = _w(rec_g >= max_gain, max_gain / rec_g, 1.0)
        og = rec_og[..., -1].clone()
    return state._make((g, og, up, down)), rec_g * rec_og


def simple_split(unit, state, level, target):
    dev, kgrow, kfall, silence, lo, hi = (_t(v) for v in
                                          rd._simple_consts(unit))
    target = target.expand(level.shape)
    # pre: a silent level meets neither compare
    silent = level <= silence
    tg = _w(silent, -np.inf, target)
    tgdev = _w(silent, np.inf, target * dev)
    # next
    (g,) = state
    rec = torch.empty_like(level)
    for i in range(level.shape[-1]):
        nl = level[..., i] * g
        k = _w(nl * dev < tg[..., i], kgrow, _w(nl > tgdev[..., i], kfall,
                                                1.0))
        g = torch.minimum(torch.maximum(g * k, lo), hi)
        rec[..., i] = g
    # out: the gain
    return state._make((g,)), rec


def surge_split(unit, state, x):
    (on_thr, off_thr, recip), (tmax, sd_max) = rd._surge_consts(unit)
    # pre: the two threshold compares as masks
    ax = torch.abs(x)
    m_off, m_on = (-(ax >= thr).to(I32) for thr in (off_thr, on_thr))
    # next, on masks: the counter before each step, the flag after it
    on, sd, tt = state
    on = -on.to(I32)
    rec_tt = torch.empty(x.shape, dtype=I32)
    rec_on = torch.empty(x.shape, dtype=I32)
    for i in range(x.shape[-1]):
        f_off, f_on = m_off[..., i], m_on[..., i]
        below = (sd + 1 - sd_max) >> 31
        keep = (f_off & (-1 if sd_max > 0 else 0)) | (~f_off & below)
        sd = (on & ((sd + 1) & ~f_off)) | (~on & (sd & ~f_on))
        on = (on & keep) | (~on & f_on)
        rec_tt[..., i], rec_on[..., i] = tt, on
        tt = ((on & torch.clamp(tt + 1, max=tmax))
              | (~on & torch.clamp(tt - 1, min=0))).to(I32)
    # out: the ramp from the counter before the step
    ramp = torch.sqrt(rec_tt.to(F32) * _t(recip))
    gain = torch.where(rec_on != 0, _w(rec_tt < tmax, ramp, 1.0),
                       _w(rec_tt > 0, ramp, 0.0))
    return state._make((on != 0, sd.to(I32), tt)), gain


def peak_split(unit, state, x):
    tau = _t(rd._f32(unit.tau))
    ax = torch.abs(x)                                   # pre
    peak, cnt = state
    rec = torch.empty_like(x)
    for i in range(x.shape[-1]):                        # next
        rising = ax[..., i] >= peak
        decayed = torch.where(cnt <= 0, peak * tau, peak)
        peak = torch.where(rising, ax[..., i], decayed)
        cnt = torch.where(rising, unit.hold,
                          torch.clamp(cnt - 1, min=0)).to(I32)
        rec[..., i] = peak
    return state._make((peak, cnt)), rec                # out: the peak


def dynproc_split(params, state, x):
    floats, (n_att, n_rel, nh) = rd._dynproc_consts(params)
    m = rd.MAX_LEVELS
    # the levels, NaN past each count: no envelope counts them
    la, at, lr, rt = (_t(floats[j * m:(j + 1) * m]) for j in range(4))
    la[n_att:] = float("nan")
    lr[n_rel:] = float("nan")

    def solve(levels, taus, e):
        # the ladder over ascending levels (_dynproc_consts sorts them)
        t = taus[0].expand_as(e)
        for i in range(1, m):
            t = torch.where(e >= levels[i], taus[i], t)
        return t

    e, peak, hold = state
    rec = torch.empty_like(x)
    for i in range(x.shape[-1]):                        # next; pre is x
        d = x[..., i] - e
        falling, holding = d < 0.0, hold > 0
        e_fall = rd._mul_add(solve(lr, rt, e), d, e)
        e_rise = rd._mul_add(solve(la, at, e), d, e)
        rise_peaked = ~falling & (e_rise >= peak)
        fall_free = falling & ~holding
        hold = torch.where(falling, torch.where(holding, hold - 1, hold),
                           torch.where(rise_peaked, nh, hold)).to(I32)
        peak = torch.where(fall_free, e_fall,
                           torch.where(rise_peaked, e_rise, peak))
        e = torch.where(falling, torch.where(holding, e, e_fall), e_rise)
        rec[..., i] = e
    return state._make((e, peak, hold)), rec            # out: the envelope


# --- the Trigger -----------------------------------------------------------


def trigger_split(unit, state, x):
    (th, lo, hi), (one_shot, hold), kind = rd._trigger_consts(unit)
    ttype = kind - rd.KIND["trigger"]
    prev0, st, cnt, disarm, locked = state
    # pre: the edge terms from each sample and the one before, as bits
    prev = torch.cat([prev0[..., None], x[..., :-1]], dim=-1)
    diff = x - prev
    z = torch.zeros(x.shape, dtype=torch.bool)
    if ttype == 0:
        e0 = e1 = e2 = z
    elif ttype == 1:
        e0, e1, e2 = (diff > 0.0) & (x >= th), z, z
    elif ttype == 2:
        e0, e1, e2 = (diff < 0.0) & (x <= th), z, z
    elif ttype == 3:
        e0 = (diff > 0.0) & (x >= lo) & (prev < lo) & (x < th)
        e1 = (diff > 0.0) & (x >= hi) & (prev < hi)
        e2 = x < lo
    else:
        e0 = (diff < 0.0) & (x <= hi) & (prev > hi) & (x > th)
        e1 = (diff < 0.0) & (x <= lo) & (prev > lo)
        e2 = x > hi
    bits = e0.to(I32) | (e1.to(I32) << 1) | (e2.to(I32) << 2)
    # next: the state after each step; the last unlocked step for prev
    last = torch.full(prev0.shape, -1, dtype=torch.int64)
    rec = torch.empty(x.shape, dtype=I32)
    for i in range(x.shape[-1]):
        b = bits[..., i]
        hold_ok = cnt >= hold
        dis = disarm
        if ttype == 0:
            fire = hold_ok
            nst = torch.where(fire, 2, 0)
        elif ttype in (1, 2):
            fire = ((b & 1) != 0) & hold_ok
            nst = torch.where(fire, 2, 0)
        else:
            st1 = torch.where(disarm, 0, st)
            st2 = torch.where(((b & 1) != 0) & hold_ok, 1, st1)
            fire = (st2 == 1) & ((b & 2) != 0)
            nst = torch.where(fire, 2, st2)
            dis = fire | ((b & 4) != 0)
        fire = fire & ~locked
        o = torch.where(locked, 0, nst).to(I32)
        last = torch.where(locked, last, i)
        cnt = torch.where(locked, cnt, torch.where(fire, 0, cnt) + 1
                          ).to(I32)
        disarm = torch.where(locked, disarm, dis)
        locked = locked | (bool(one_shot) & fire)
        st = o
        rec[..., i] = o
    prev_out = torch.where(last >= 0, torch.gather(
        x, -1, torch.clamp(last, min=0)[..., None])[..., 0], prev0)
    return state._make((prev_out, st, cnt, disarm, locked)), rec


# --- the Depopper ----------------------------------------------------------


def _depop_move(st, cnt, dly, bits, n_out, in_dly):
    """What a step's outputs read of the reference step (csrc/riders.cu
    DepopperStep::move, which the consumers run) from the state before
    it: the counter after it, whether it opens, whether it falls."""
    above_in, below_out = (bits & 1) != 0, (bits & 2) != 0
    fade, opened = st == rd.DEPOP_FADE, st == rd.DEPOP_OPENED
    open_now = (st == rd.DEPOP_CLOSED) & above_in
    cnt1 = torch.where(opened & (cnt < n_out), cnt + 1, cnt)
    cnt1 = torch.where(open_now, 1, cnt1)
    cnt1 = torch.where(fade, cnt + 1, cnt1)
    dly_f = torch.where(below_out, dly - 1, in_dly)
    fall = (fade & below_out & (dly_f <= 0)) | (opened & below_out)
    return cnt1, open_now, fall


def depopper_split(unit, state, env):
    floats, (n_in, n_out, in_dly, out_dly, mode) = rd._depopper_consts(unit)
    # pre: the two threshold compares as masks
    above_in = -(env >= floats[0]).to(I32)
    below_out = -(env < floats[1]).to(I32)
    # next, on masks (the state one-hot, compares the signs of
    # differences): the state before each step, packed (counter; delay x
    # 4 + state)
    st, cnt, dly = state
    closed, fade, opened, wait = (-(st == v).to(I32) for v in range(4))
    rec_cnt = torch.empty(env.shape, dtype=I32)
    rec_sd = torch.empty(env.shape, dtype=I32)
    for i in range(env.shape[-1]):
        a_in, b_out = above_in[..., i], below_out[..., i]
        st = (fade & 1) | (opened & 2) | (wait & 3)
        rec_cnt[..., i], rec_sd[..., i] = cnt, (dly << 2) | st
        open_now = closed & a_in
        inc = fade | (opened & ((cnt - n_out) >> 31))
        cnt1 = (open_now & 1) | (~open_now & (cnt - inc))
        low = (dly - 2) >> 31
        fade_fall = fade & b_out & low
        open_fall = opened & b_out
        fall = fade_fall | open_fall
        fade_done = fade & ~b_out & ~((cnt + 1 - n_in) >> 31)
        wait_done = wait & low
        dly_f = (b_out & (dly - 1)) | (~b_out & in_dly)
        moved = open_fall | fade | open_now | wait
        dly = ((open_fall & out_dly) | (fade & dly_f) | (open_now & in_dly)
               | (wait & (dly - 1)) | (~moved & dly))
        closed, fade, opened, wait = (
            wait_done | (closed & ~open_now),
            open_now | (fade & ~(fall | fade_done)),
            fade_done | (opened & ~open_fall), fall | (wait & ~wait_done))
        cnt = cnt1
    st = ((fade & 1) | (opened & 2) | (wait & 3)).to(I32)
    # out: unpack, the reference step, the fade-in gain, the fall, its
    # patch length
    bits = (above_in & 1) | (below_out & 2)
    s0, d0 = rec_sd & 3, rec_sd >> 2
    cnt1, open_now, fall = _depop_move(s0, rec_cnt, d0, bits, n_out, in_dly)
    gain = rd._fade_in(floats, mode, n_in, torch.where(open_now, 0,
                                                       rec_cnt))
    raw = torch.where((s0 == rd.DEPOP_FADE) | open_now, gain,
                      (s0 == rd.DEPOP_OPENED).to(F32))
    patch = torch.where(fall, torch.clamp(cnt1, max=n_out), 0).to(I32)
    return (st, cnt.to(I32), dly.to(I32)), (raw, fall, patch)


# --- the cases -------------------------------------------------------------


def _levels(rng, t):
    """Levels over 100 dB, rising: AutoGain's silence below -72 dB at the
    start, loud at the end."""
    lvl = np.abs(rng.standard_normal((ROWS, t)) * np.geomspace(1e-5, 2.0, t))
    return torch.from_numpy(lvl.astype(np.float32))


def _bursts(rng, t, period=(60, 180)):
    """Noise bursts (0.5 on, 1e-3 off) with per-row gate lengths."""
    per = rng.integers(*period, (ROWS, 1))
    on = (np.arange(t)[None, :] + rng.integers(0, 180, (ROWS, 1))) % per \
        < per // 2
    return torch.from_numpy((rng.standard_normal((ROWS, t))
                             * np.where(on, 0.5, 1e-3)).astype(np.float32))


def _rider(kind, rng, t):
    """(unit state, call inputs, split model, plain loop)."""
    lvl = _levels(rng, t)
    if kind.startswith("autogain"):
        quick, use_max = kind[-2] == "1", kind[-1] == "1"
        u = AutoGain(48000, quick_amplifier=quick, use_max_gain=use_max,
                     max_gain=3.0, long_grow_db_s=60.0)
        short = (lvl * torch.from_numpy(np.clip(
            1.0 + 0.4 * rng.standard_normal((ROWS, t)), 0.1, None).astype(
            np.float32))).contiguous()
        return (u.init_state((ROWS,), device="cpu"),
                (lvl, short, torch.full((ROWS, 1), 0.2)),
                lambda s, *a: autogain_split(u, s, *a),
                lambda s, *a: rd.autogain_plain(u, s, *a))
    if kind == "simple":
        u = SimpleAutoGain(48000, grow_db_s=120.0, deviation=1.5)
        return (u.init_state((ROWS,), device="cpu"),
                (lvl, torch.full((ROWS, t), 0.25)),
                lambda s, *a: simple_split(u, s, *a),
                lambda s, *a: rd.simple_autogain_plain(u, s, *a))
    x = _bursts(rng, t)
    if kind == "surge":
        u = SurgeProtector(0.1, 0.01, 30, 40)
        return (u.init_state((ROWS,), device="cpu"), (x,),
                lambda s, *a: surge_split(u, s, *a),
                lambda s, *a: rd.surge_protector_plain(u, s, *a))
    if kind == "peak":
        u = PeakMeter(48000, hold_ms=0.5, release_ms=2.0)
        return (u.init_state((ROWS,), device="cpu"), (x,),
                lambda s, *a: peak_split(u, s, *a),
                lambda s, *a: rd.peak_meter_plain(u, s, *a))
    u = DynamicProcessor(48000, hold_ms=0.5,
                         attack_time_ms=[5, 1, 2, 3, 4],
                         release_time_ms=[50, 20, 30, 40, 60])
    for i, dot in enumerate([(0.01, 0.02, 0.5), (0.1, 0.08, 0.7)]):
        u.set_dot(i, *dot)
    for i, lv in enumerate((0.05, 0.1, 0.2)):
        u.set_attack_level(i, lv)
        u.set_release_level(i, lv * 2)
    p = u.build(device="cpu")
    if kind == "dynproc_unordered":
        # levels out of order beside their taus (a caller's own params):
        # the tau of c levels <= e is still tau[c - 1]
        p = p._replace(att_level=p.att_level[::-1], att_tau=p.att_tau[1:]
                       + p.att_tau[:1], rel_level=p.rel_level[::-1])
    return (u.init_state((ROWS,), device="cpu"), (x.abs(),),
            lambda s, *a: dynproc_split(p, s, *a),
            lambda s, *a: rd.dynproc_envelope_plain(p, s, *a))


def _same(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _call_in(args, k, t):
    return tuple(a if a.shape[-1] != 2 * t else a[..., k * t:(k + 1) * t]
                 .contiguous() for a in args)


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("kind", ["autogain_00", "autogain_01",
                                  "autogain_10", "autogain_11", "simple",
                                  "surge", "peak", "dynproc",
                                  "dynproc_unordered"])
def test_rider_split_matches_plain(kind, t):
    """Each rider's pre / next / out equals its plain loop bit for bit,
    two calls with the state carried (AutoGain in each quick_amp and
    max_gain setting)."""
    rng = np.random.default_rng(t * 7 + len(kind))
    st, args, split, plain = _rider(kind, rng, 2 * t)
    s_m = s_p = st
    for k in range(2):
        a = _call_in(args, k, t)
        s_m, y_m = split(s_m, *a)
        s_p, y_p = plain(s_p, *a)
        assert torch.equal(y_m, y_p), k
        assert _same(s_m, s_p), k


def test_rider_split_inputs_reach_the_branches():
    """The seeded inputs above reach silence and sound (AutoGain), the
    surge protector's on and off, the peak meter's hold and decay, the
    processor's held and falling envelope."""
    t = 3 * CHUNK + 17
    rng = np.random.default_rng(5)
    u = AutoGain(48000)
    lvl = _levels(rng, t)
    silent = lvl <= rd._autogain_consts(u)[0][5]
    assert silent.any() and (~silent).any()
    st, (x,), _, plain = _rider("surge", np.random.default_rng(1), t)
    ons = []
    for i in range(0, t, 50):
        st, _ = plain(st, x[..., i:i + 50].contiguous())
        ons.append(st[0].clone())
    ons = torch.stack(ons)
    assert ons.any() and (~ons).any()
    st, (x,), _, plain = _rider("peak", np.random.default_rng(2), t)
    _, y = plain(st, x)
    assert (y[..., 1:] < y[..., :-1]).any() and (y[..., 1:] == y[..., :-1]
                                                 ).any()


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("mode", [TriggerMode.SINGLE, TriggerMode.REPEAT],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("ttype", list(TriggerType), ids=lambda v: v.name)
def test_trigger_split_matches_plain(ttype, mode, t):
    """The Trigger's pre (edge bits from each sample and the one before)
    / next / out equals its plain loop bit for bit, two calls with the
    state carried, a hold of 3 samples, one row locked at the start and
    one-shot rows locking on their first fire (one at least)."""
    u = Trigger(ttype, mode, threshold=0.3, hysteresis=0.1, hold_samples=3)
    rng = np.random.default_rng(t + 11 * ttype.value + mode.value)
    st = u.init_state(device="cpu")
    st = st._make(torch.stack([f] * ROWS) for f in st)
    st = st._replace(locked=torch.tensor([False, True, False]))
    s_m = s_p = st
    fired = 0
    for k in range(2):
        x = torch.from_numpy((rng.standard_normal((ROWS, t))
                              * np.linspace(0.05, 1.0, t)).astype(
            np.float32))
        s_m, y_m = trigger_split(u, s_m, x)
        s_p, y_p = rd.trigger_plain(u, s_p, x)
        assert torch.equal(y_m, y_p), k
        assert _same(s_m, s_p), k
        fired += int((y_p == 2).sum())
    if t >= CHUNK:
        assert fired > 0
        # a one-shot row that started unlocked reached its lock
        assert mode != TriggerMode.SINGLE or bool(s_p.locked[[0, 2]].any())


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("mode", list(DepopperMode), ids=lambda m: m.name)
def test_depopper_split_matches_plain(mode, t):
    """The Depopper's pre (threshold bits) / next (the packed record of
    the state before each step) / out (the fade-in gain, the fall and its
    patch length) equals its plain loop bit for bit in every mode, two
    calls with the state carried, on bursts that open, fade in, fall
    (inside the fade-in too) and wait."""
    u = Depopper(48000, fade_in_mode=mode, fade_out_mode=mode,
                 fade_in_ms=1.0, fade_out_ms=0.5, fade_in_delay_ms=0.1,
                 fade_out_delay_ms=0.2, rms_ms=0.2)
    rng = np.random.default_rng(t + mode.value)
    env = _bursts(rng, 2 * t, period=(40, 200)).abs()
    st = tuple(torch.zeros(ROWS, dtype=I32) for _ in range(3))
    s_m = s_p = st
    falls = 0
    for k in range(2):
        e = env[:, k * t:(k + 1) * t].contiguous()
        s_m, o_m = depopper_split(u, s_m, e)
        s_p, o_p = rd.depopper_forward_plain(u, s_p, e)
        assert _same(o_m, o_p), k
        assert _same(s_m, s_p), k
        falls += int(o_p[1].sum())
    if t >= 3 * CHUNK:
        assert falls > 0
