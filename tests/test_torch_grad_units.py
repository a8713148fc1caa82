"""Gradients through the sequential cascade, the Gate and the DynamicDelay
against jax.grad on the CPU.

The routes: ``biquad_cascade_seq`` and ``dyn_biquad_cascade_seq`` (shared,
per-row and per-sample coefficients), ``gate_envelope`` (through
``Gate.process``) and ``dynamic_delay`` (through ``DynamicDelay.process``),
and the units on the cascade: ``Filter`` seq, the IIR ``Equalizer``,
``SpectralTilt``, ``DynamicFilters`` seq (its gain through the per-sample
design), ``LoudnessMeter`` and ``ILUFSMeter``.  Inputs are float32 from
``numpy.random.default_rng`` seeds at small sizes ([2-4, 256-1024], K <=
9); the losses put random weights on every output and on the outgoing
state, over two calls where the unit carries a state.

Bars:

* >= 100 dB against ``jax.grad`` (``BAR_DB``): float32 gradients formed in
  another order (XLA contracts the scan bodies into FMAs; the port rounds
  every product and sum, and sums the coefficients' terms in float64).
* Near-unit poles (``F64_RULE``): where a pole near z = 1 carries every
  rounding on and keeps JAX or the port from 100 dB (the K-weighting's
  38 Hz high-pass, the chain's EQ with its 100 Hz shelf, the tilt's 16
  low sections, a 30 Hz shelf), both are held to a float64 run of the
  port's plain adjoint instead, and the port must be within 1 dB of JAX's
  own distance from it.  The figures each such test measured are in its
  docstring.
* The Gate: ``jax.grad`` of the JAX Gate is NaN where the Hermite branch
  of ``gate_x1_gain`` overflows outside its range (0 x inf in the
  adjoint of ``where``).  The port keeps the form, so its NaNs fall at the
  same entries: the NaN masks are equal and the finite entries meet the
  bar.
* float64 ``torch.autograd.gradcheck`` of each plain adjoint on tiny
  shapes, at its default tolerances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsp_dsp_units_tpu.models.dynamics.gate import Gate as JGate
from lsp_dsp_units_tpu.models.filters import design as jdesign
from lsp_dsp_units_tpu.models.filters import dynamic_filters as jdf
from lsp_dsp_units_tpu.models.filters.equalizer import (
    EqMode as JEqMode, Equalizer as JEqualizer)
from lsp_dsp_units_tpu.models.filters.filter import Filter as JFilter
from lsp_dsp_units_tpu.models.filters.spectral_tilt import (
    SlopeUnit as JSlope, SpectralTilt as JTilt, TiltNorm as JNorm)
from lsp_dsp_units_tpu.models.meters.loudness import (
    ILUFSMeter as JILUFS, LoudnessMeter as JLoud)
from lsp_dsp_units_tpu.models.util.delay import (
    DynamicDelay as JDelay, DynamicDelayState as JDelayState)
from lsp_dsp_units_tpu.ops import biquad as jbq
from lsp_dsp_units_tpu.pipeline import default_eq_params as jdefault_eq

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch.models import filters as tf
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate as TGate
from lsp_dsp_units_tpu_torch.models.meters.loudness import (
    ILUFSMeter as TILUFS, LoudnessMeter as TLoud)
from lsp_dsp_units_tpu_torch.models.util.delay import (
    DynamicDelay as TDelay, DynamicDelayState as TDelayState)
from lsp_dsp_units_tpu_torch.ops import biquad as tbq
from lsp_dsp_units_tpu_torch.ops import delay as tdelay
from lsp_dsp_units_tpu_torch.ops import dynamics as tdyn
from lsp_dsp_units_tpu_torch.ops import env_units as eu

SR = 48000
BAR_DB = 100.0
F64_RULE_DB = 1.0     # the port within this of JAX's distance from float64


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _grad(t):
    return np.zeros(t.shape) if t.grad is None else t.grad.numpy()


def _tparams(jp):
    return tf.FilterParams(ftype=tf.FilterType[jp.ftype.name], freq=jp.freq,
                           freq2=jp.freq2, gain=jp.gain, slope=jp.slope,
                           quality=jp.quality)


def _stable(rng, k, radius=(0.3, 0.9)):
    """K stable stages (poles inside ``radius``), JAX's sign convention."""
    r = rng.uniform(*radius, k)
    th = rng.uniform(0.2, np.pi - 0.2, k)
    b = rng.normal(size=(k, 3)) * 0.5
    return np.concatenate([b, np.stack([2 * r * np.cos(th), -r * r], 1)],
                          1).astype(np.float32)


def _two_calls(jstep, tstep, s0, xs, rng, dtype=torch.float32):
    """jax.grad and the port's autograd of ``sum_k sum(y_k w_k) + sum_i
    sum(s'_i v_i)`` over len(xs) calls with the state carried, w.r.t. the
    incoming state's leaves ``s0`` (a tuple of arrays) and each call's x.
    ``dtype`` float64 runs the port alone (the float64 reference), in
    which case the JAX grads are None.  Returns (jax, port) lists of
    numpy gradients: the state's leaves, then each x."""
    wy = [_f32(rng, *x.shape) for x in xs]
    ws = [_f32(rng, *np.shape(a)) for a in s0]

    def jloss(s, xa):
        tot = 0.0
        for x, w in zip(xa, wy):
            s, y = jstep(s, x)
            tot = tot + jnp.sum(y * w)
        return tot + sum(jnp.sum(a * b) for a, b in zip(s, ws))

    jg = None
    if dtype == torch.float32:
        g = jax.grad(jloss, argnums=(0, 1))(
            tuple(jnp.asarray(a) for a in s0), [jnp.asarray(x) for x in xs])
        jg = [np.asarray(v) for v in (*g[0], *g[1])]
    ts = [torch.tensor(np.asarray(a), dtype=dtype, requires_grad=True)
          for a in s0]
    tx = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in xs]
    s, tot = tuple(ts), 0.0
    for x, w in zip(tx, wy):
        s, y = tstep(s, x)
        tot = tot + torch.sum(y * torch.tensor(w, dtype=dtype))
    tot = tot + sum(torch.sum(a * torch.tensor(b, dtype=dtype))
                    for a, b in zip(s, ws))
    tot.backward()
    return jg, [_grad(v) for v in ts + tx]


def _bar(jg, tg, names):
    for name, a, b in zip(names, jg, tg):
        assert _snr(a, b) >= BAR_DB, (name, _snr(a, b))


def _f64_rule(jg, tg, fg, names, floors=None):
    """Each gradient of the port within F64_RULE_DB of JAX's distance from
    the float64 run, or of ``floors[i]`` where that is lower (the port's
    own forward's distance from float64, for a gradient formed on the
    forward's output); returns {name: (jax dB, port dB)}."""
    out = {}
    for i, (name, a, b, ref) in enumerate(zip(names, jg, tg, fg)):
        dj, dt = _snr(ref, a), _snr(ref, b)
        out[name] = (dj, dt)
        bar = dj if floors is None else min(dj, floors[i])
        assert dt >= bar - F64_RULE_DB, (name, dj, dt, bar)
    return out


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


def _route_inputs(kind, rng, k=5, t=300, rows=3):
    if kind == "shared":
        c = _stable(rng, k)
    elif kind == "per_row":
        c = np.stack([_stable(rng, k) for _ in range(rows)])
    else:
        mod = 1.0 + 0.02 * rng.standard_normal(
            ((rows,) if kind == "per_sample" else ()) + (t, k, 5))
        c = (_stable(rng, k) * mod).astype(np.float32)
    return c, _f32(rng, rows, k, 2, scale=0.2), _f32(rng, rows, t)


@pytest.mark.parametrize("kind", ["shared", "per_row", "per_sample",
                                  "sample_shared"])
def test_seq_route_gradient_matches_jax(kind):
    """The route alone: d/d coefficients, state and x of a random loss on
    y and the outgoing state, against jax.grad of the JAX lax.scan
    (per-sample coefficients [rows, T, K, 5], or [T, K, 5] shared by the
    rows and summed over them)."""
    rng = np.random.default_rng(len(kind) + 11)
    c, st, x = _route_inputs(kind, rng)
    dyn = kind in ("per_sample", "sample_shared")
    jfn = jbq.dyn_biquad_cascade_seq if dyn else jbq.biquad_cascade_seq
    tfn = tbq.dyn_biquad_cascade_seq if dyn else tbq.biquad_cascade_seq
    wy, ws = _f32(rng, *x.shape), _f32(rng, *st.shape)

    def loss(cc, s, xx):
        y, s2 = jfn(cc, s, xx)
        return jnp.sum(y * wy) + jnp.sum(s2 * ws)

    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (c, st, x)))
    ins = [torch.tensor(v, requires_grad=True) for v in (c, st, x)]
    y, s2 = tfn(*ins)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(s2 * torch.from_numpy(ws))).backward()
    _bar(jg, [_grad(v) for v in ins], ("coeffs", "state", "x"))


def _kweight():
    from lsp_dsp_units_tpu_torch.models.meters.loudness import (
        Weighting, weighting_coeffs)
    return weighting_coeffs(Weighting.K, SR).astype(np.float32)


def _loshelf():
    return np.array(JFilter(SR, jdesign.FilterParams(
        ftype=jdesign.FilterType.BT_RLC_LOSHELF, freq=30.0, gain=4.0,
        slope=2, quality=0.5)).coefficients(), np.float32)


@pytest.mark.parametrize("case", ["k_weighting", "loshelf_30hz"])
def test_seq_route_near_unit_poles_float64_rule(case):
    """Near-unit poles: both packages' float32 gradients against the
    port's route run in float64 on the same float32 values, the port
    within 1 dB of JAX's distance: the state's and x's, which the adjoint
    forms from the cotangents alone, and the coefficients' terms formed
    on the forward's signals.  Those signals are the forward's own: the
    port's scan rounds every product and sum where XLA contracts FMAs,
    and at the 30 Hz shelf its float32 signals sit further from float64
    than JAX's, so the coefficients are held to the rule with the port's
    adjoint on the float64 forward's signals (rounded to float32).
    Measured (JAX, port) dB at [2, 1024]: the K-weighting, coeffs (61.08,
    74.21), state (91.16, 91.16), x (92.74, 92.74); the 30 Hz shelf,
    coeffs (84.19, 84.26; on the port's own signals 82.42), state (71.95,
    74.44), x (76.00, 78.25)."""
    c = _kweight() if case == "k_weighting" else _loshelf()
    rng = np.random.default_rng(7)
    st, x = _f32(rng, 2, c.shape[0], 2, scale=0.1), _f32(rng, 2, 1024)
    wy, ws = _f32(rng, *x.shape), _f32(rng, *st.shape)

    def loss(cc, s, xx):
        y, s2 = jbq.biquad_cascade_seq(cc, s, xx)
        return jnp.sum(y * wy) + jnp.sum(s2 * ws)

    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (c, st, x)))

    def port(dtype):
        ins = [torch.tensor(v, dtype=dtype, requires_grad=True)
               for v in (c, st, x)]
        y, s2 = tbq.biquad_cascade_seq(*ins)
        (torch.sum(y * torch.tensor(wy, dtype=dtype))
         + torch.sum(s2 * torch.tensor(ws, dtype=dtype))).backward()
        return [_grad(v) for v in ins]

    tg, fg = port(torch.float32), port(torch.float64)
    _f64_rule(jg[1:], tg[1:], fg[1:], ("state", "x"))
    ins = [torch.from_numpy(v) for v in (c, st, x)]
    sig64 = tbq._seq_plain_run(*(v.double() for v in ins), False,
                               save=True)[2]
    g_c = tbq.biquad_cascade_seq_bwd_plain(
        *ins, sig64.float(), torch.from_numpy(wy), torch.from_numpy(ws))[0]
    _f64_rule(jg[:1], [g_c.numpy()], fg[:1], ("coeffs",))


# ---------------------------------------------------------------------------
# the units on the cascade
# ---------------------------------------------------------------------------


def test_filter_seq_gradient_matches_jax():
    """Filter ``seq`` (a 3 kHz bell and a 2 kHz high-shelf, through the
    ``coeffs`` argument so the coefficients take a gradient), two calls:
    d/d coefficients, state and each x."""
    rng = np.random.default_rng(3)
    jp = jdesign.FilterParams(ftype=jdesign.FilterType.BT_RLC_BELL,
                              freq=3000.0, gain=0.5, slope=2, quality=2.0)
    jflt, tflt = JFilter(SR, jp), tf.Filter(SR, _tparams(jp))
    c0 = np.asarray(jflt.coefficients())
    xs = [_f32(rng, 2, 512, scale=0.3), _f32(rng, 2, 301, scale=0.3)]
    s0 = (c0, _f32(rng, 2, c0.shape[0], 2, scale=0.1))

    def jstep(s, x):
        c, st = s
        st, y = jflt.process(st, x, coeffs=c, method="seq")
        return (c, st), y

    def tstep(s, x):
        c, st = s
        st, y = tflt.process(st, x, coeffs=c, method="seq")
        return (c, st), y

    jg, tg = _two_calls(jstep, tstep, s0, xs, rng)
    _bar(jg, tg, ("coeffs", "state", "x0", "x1"))


def test_equalizer_iir_gradient_float64_rule():
    """The IIR Equalizer without a fused block (the chain's 8 bands,
    their 100 Hz shelf among them), two calls: d/d state and each x,
    under the float64 rule.  Measured (JAX, port) dB: state (85.94,
    100.96), x0 (79.11, 82.00), x1 (84.13, 86.76)."""
    jeq = JEqualizer(SR, filters=8, mode=JEqMode.IIR, iir_block=None)
    teq = tf.Equalizer(SR, filters=8, mode=tf.EqMode.IIR, iir_block=None)
    for i, jp in enumerate(jdefault_eq(SR)):
        jeq.set_params(i, jp)
        teq.set_params(i, _tparams(jp))
    jp, tp = jeq.build(), teq.build(device="cpu")
    rng = np.random.default_rng(4)
    xs = [_f32(rng, 2, 512, scale=0.3), _f32(rng, 2, 300, scale=0.3)]
    s0 = (_f32(rng, 2, np.asarray(jp.coeffs).shape[0], 2, scale=0.1),)
    jst0, tst0 = jeq.init_state(jp, (2,)), teq.init_state(tp, (2,), "cpu")

    def jstep(s, x):
        st, y = jeq.process(jp, jst0._replace(iir=s[0]), x)
        return (st.iir,), y

    def tstep_of(params):
        def tstep(s, x):
            st, y = teq.process(params, tst0._replace(iir=s[0]), x)
            return (st.iir,), y
        return tstep

    jg, tg = _two_calls(jstep, tstep_of(tp), s0, xs,
                        np.random.default_rng(40))
    _, fg = _two_calls(None, tstep_of(tp._replace(coeffs=tp.coeffs.double())),
                       s0, xs, np.random.default_rng(40), torch.float64)
    _f64_rule(jg, tg, fg, ("state", "x0", "x1"))


def test_spectral_tilt_gradient_float64_rule():
    """SpectralTilt (16 sections, -3 dB/octave from 100 Hz), two calls:
    d/d state and each x, under the float64 rule.  Measured (JAX, port)
    dB: state (98.07, 104.40), x0 (79.76, 81.53), x1 (81.64, 84.74)."""
    kw = dict(order=16, slope=-3.0, lower_freq=100.0, upper_freq=10000.0)
    jt = JTilt(SR, slope_unit=JSlope.DB_PER_OCTAVE, norm=JNorm.AT_1_KHZ,
               **kw)
    tt = tf.SpectralTilt(SR, slope_unit=tf.SlopeUnit.DB_PER_OCTAVE,
                         norm=tf.TiltNorm.AT_1_KHZ, **kw)
    rng = np.random.default_rng(5)
    k = np.asarray(jt.coefficients()).shape[0]
    xs = [_f32(rng, 2, 512, scale=0.3), _f32(rng, 2, 300, scale=0.3)]
    s0 = (_f32(rng, 2, k, 2, scale=0.1),)

    def jstep(s, x):
        st, y = jt.process(s[0], x)
        return (st,), y

    def tstep(s, x):
        st, y = tt.process(s[0], x)
        return (st,), y

    c64 = tt.coefficients(device="cpu").double()

    def tstep64(s, x):
        y, st = tbq.biquad_cascade_seq(c64, s[0], x)
        return (st,), y

    jg, tg = _two_calls(jstep, tstep, s0, xs, np.random.default_rng(50))
    _, fg = _two_calls(None, tstep64, s0, xs, np.random.default_rng(50),
                       torch.float64)
    _f64_rule(jg, tg, fg, ("state", "x0", "x1"))


@pytest.mark.parametrize("ftype", ["BT_BWC_BELL", "BT_RLC_HISHELF"])
def test_dynamic_filters_seq_gradient_matches_jax(ftype):
    """DynamicFilters ``seq``: the gain signal through the per-sample
    design, then the per-sample cascade; d/d state, x and the gain (the
    design's float32 transcendentals differ by an ulp between torch and
    XLA: the same designed coefficients would be needed for more)."""
    jp = jdesign.FilterParams(ftype=jdesign.FilterType[ftype], freq=1000.0,
                              slope=2, quality=0.7)
    jd, td = jdf.DynamicFilters(SR, 1), tf.DynamicFilters(SR, 1)
    jd.set_params(0, jp)
    td.set_params(0, _tparams(jp))
    rng = np.random.default_rng(len(ftype))
    t = 400
    gain = (0.5 + 1.5 * np.abs(np.sin(np.linspace(0.0, 3.0, t))))[None] \
        .repeat(2, 0).astype(np.float32)
    x = _f32(rng, 2, t, scale=0.3)
    st = _f32(rng, 2, td.num_stages(0), 2, scale=0.1)
    wy, ws = _f32(rng, 2, t), _f32(rng, *st.shape)

    def loss(s, xx, g):
        s2, y = jd.process(0, s, xx, g, method="seq")
        return jnp.sum(y * wy) + jnp.sum(s2 * ws)

    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (st, x, gain)))
    ins = [torch.tensor(v, requires_grad=True) for v in (st, x, gain)]
    s2, y = td.process(0, *ins, method="seq")
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(s2 * torch.from_numpy(ws))).backward()
    tg = [_grad(v) for v in ins]
    _bar(jg[:2], tg[:2], ("state", "x"))
    assert _snr(jg[2], tg[2]) >= 90.0, _snr(jg[2], tg[2])


def test_loudness_meter_gradient_float64_rule():
    """LoudnessMeter (K-weighting, 400 ms window at 48 kHz), two calls of
    [2, 1024]: d/d the weighting's state, the window and each x, under the
    float64 rule.  x's gradient is formed on the weighted signal y (the
    square's adjoint, 2 y), and the port's float32 weighting (its forward,
    which rounds every product and sum where XLA contracts FMAs) sits
    further from float64 than JAX's on this input: y of the two calls
    (83.15, 84.13) dB from float64 for JAX, (80.23, 74.78) for the port.
    So each gradient is held within 1 dB of the lower of JAX's distance
    and the port's forward's.  Measured (JAX, port) dB: flt (69.27,
    70.43), window (142.86, 145.43), x0 (82.30, 79.43), x1 (81.84,
    74.83)."""
    jm, tm = JLoud(SR, 2), TLoud(SR, 2, device="cpu")
    rng = np.random.default_rng(8)
    jst = jm.init_state()
    s0 = (_f32(rng, *np.shape(jst.flt), scale=0.05),
          np.abs(_f32(rng, *np.shape(jst.window), scale=0.05)))
    xs = [_f32(rng, 2, 1024, scale=0.3), _f32(rng, 2, 1024, scale=0.3)]

    def jstep(s, x):
        st, y = jm.process(type(jst)(*s), x)
        return tuple(st), y

    def tstep_of(meter):
        def tstep(s, x):
            st, y = meter.process(type(meter.init_state())(*s), x)
            return tuple(st), y
        return tstep

    jg, tg = _two_calls(jstep, tstep_of(tm), s0, xs,
                        np.random.default_rng(80))
    t64 = TLoud(SR, 2, device="cpu")
    t64._coeffs, t64.weights = t64._coeffs.double(), t64.weights.double()
    _, fg = _two_calls(None, tstep_of(t64), s0, xs,
                       np.random.default_rng(80), torch.float64)
    ins = [torch.from_numpy(v) for v in (s0[0], np.concatenate(xs, -1))]
    y32, _ = tbq.biquad_cascade_seq(tm._coeffs, *ins)
    y64, _ = tbq.biquad_cascade_seq(tm._coeffs.double(),
                                    *(v.double() for v in ins))
    fwd = [_snr(y64[:, sl], y32[:, sl]) for sl in (slice(0, 1024),
                                                   slice(1024, 2048))]
    _f64_rule(jg, tg, fg, ("flt", "window", "x0", "x1"),
              floors=(np.inf, np.inf, *fwd))


def test_ilufs_meter_gradient_matches_jax():
    """ILUFSMeter differentiates in the JAX package (jax.grad through its
    lax.scan and lax.cond runs), so the port does: at 8 kHz (quarter
    blocks of 800 samples, as short as the meter allows), two calls of
    [2, 6400] (8 quarters each), d/d the weighting's state and each x of
    the per-sample output plus the integrated loudness, under the float64
    rule.  Measured (JAX, port) dB: flt (105.28, 109.48), x0 (112.51,
    112.52), x1 (99.29, 98.90)."""
    sr = 8000
    jm, tm = JILUFS(sr, 2), TILUFS(sr, 2, device="cpu")
    rng = np.random.default_rng(9)
    s0 = (_f32(rng, *np.shape(jm.init_state().flt), scale=0.05),)
    xs = [_f32(rng, 2, 8 * jm.block, scale=0.3),
          _f32(rng, 2, 8 * jm.block, scale=0.3)]
    jst = jm.init_state()

    def jstep(s, x):
        st, y = jm.process(jst._replace(flt=s[0]), x)
        return (st.flt,), y + st.loudness

    def tstep_of(meter):
        st0 = meter.init_state()

        def tstep(s, x):
            st, y = meter.process(st0._replace(flt=s[0]), x)
            return (st.flt,), y + st.loudness
        return tstep

    # the integrated loudness restarts from the meter's initial state in
    # each call, so the two calls are joined by the filter's state alone
    jg, tg = _two_calls(jstep, tstep_of(tm), s0, xs,
                        np.random.default_rng(90))
    t64 = TILUFS(sr, 2, device="cpu")
    t64._coeffs, t64.weights = t64._coeffs.double(), t64.weights.double()
    _, fg = _two_calls(None, tstep_of(t64), s0, xs,
                       np.random.default_rng(90), torch.float64)
    _f64_rule(jg, tg, fg, ("flt", "x0", "x1"))


# ---------------------------------------------------------------------------
# the Gate
# ---------------------------------------------------------------------------


GATE_KW = {0: {}, 24: dict(threshold=0.2, zone=0.5, hyst_threshold=0.15,
                           attack_ms=2.0, release_ms=20.0, hold_ms=0.5)}


def _gate_grads(hold, x, warm):
    """jax.grad and the port's gradients of ``sum(gain^2)`` through the
    Gate w.r.t. the GateParams' 18 float leaves (the hold is an int and
    takes none) and x; ``warm`` starts the envelope at 0.05."""
    jg_, tg_ = JGate(SR, **GATE_KW[hold]), TGate(SR, **GATE_KW[hold])
    jp = jg_.build()
    leaves, treedef = jax.tree_util.tree_flatten(jp)
    fl = [i for i, v in enumerate(leaves)
          if np.asarray(v).dtype == np.float32]
    assert len(fl) == 18 and int(np.asarray(leaves[-1])) == hold
    jst = jg_.init_state((x.shape[0],))
    if warm:
        jst = jst._replace(env=jst.env._replace(
            envelope=jnp.full((x.shape[0],), 0.05, jnp.float32)))

    def loss(lv, xx):
        full = list(leaves)
        for i, v in zip(fl, lv):
            full[i] = v
        _, gain, _ = jg_.process(jax.tree_util.tree_unflatten(treedef, full),
                                 jst, xx)
        return jnp.sum(gain * gain)

    jl, jx = jax.grad(loss, argnums=(0, 1))(
        [jnp.asarray(leaves[i]) for i in fl], jnp.asarray(x))
    tp = convert.gate_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu",
        requires_grad=True)
    assert tp.hold == hold
    tst = tg_.init_state((x.shape[0],), "cpu")
    if warm:
        tst = tst._replace(env=tst.env._replace(
            envelope=torch.full((x.shape[0],), 0.05)))
    xt = torch.tensor(x, requires_grad=True)
    _, gain, _ = tg_.process(tp, tst, xt)
    torch.sum(gain * gain).backward()
    tl = [*tp.knees[0], *tp.knees[1], tp.tau_attack, tp.tau_release]
    return ([np.asarray(v) for v in jl] + [np.asarray(jx)],
            [_grad(v) for v in tl] + [_grad(xt)])


def _gate_input(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 1024)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("hold", [0, 24])
def test_gate_gradient_nan_where_jax_is(hold):
    """From the zero state (the Gate's defaults at a hold of 0: the input
    the JAX package's gradient is NaN on, at 129 of x's 2048 entries; at
    a hold of 24, 15): the NaN masks of every gradient equal JAX's, the
    finite entries >= 100 dB, and a leaf that is finite in both >= 100
    dB."""
    jg, tg = _gate_grads(hold, _gate_input(3), warm=False)
    nan_x = np.isnan(jg[-1])
    assert nan_x.any()
    for i, (a, b) in enumerate(zip(jg, tg)):
        assert np.array_equal(np.isnan(a), np.isnan(b)), i
        fin = ~np.isnan(a)
        if fin.any() and np.any(a[fin]):
            assert _snr(a[fin], b[fin]) >= BAR_DB, (i, _snr(a[fin], b[fin]))
        else:
            assert not np.any(b[fin]), i


@pytest.mark.parametrize("hold", [0, 24])
def test_gate_leaf_gradients_match_jax(hold):
    """From a warm state (the envelope at 0.05, so the Hermite branch
    never overflows): every gradient finite, the 18 float leaves' and x's
    >= 100 dB against jax.grad, exact zeros where JAX's are (the knee
    points only steer the branches), and the taus move the loss."""
    jg, tg = _gate_grads(hold, _gate_input(4), warm=True)
    for i, (a, b) in enumerate(zip(jg, tg)):
        assert np.isfinite(a).all() and np.isfinite(b).all(), i
        assert np.array_equal(a == 0, b == 0), (i, a, b)
        if np.any(a):
            assert _snr(a, b) >= BAR_DB, (i, _snr(a, b))
    assert tg[16] != 0.0 and tg[17] != 0.0


def _gate_forward_codes(x, e, peak, hold, nh, ta, tr):
    """The gate's forward recurrence (ops/env_units.py's _env_step_plain,
    no release threshold) recording the branch of every step as it takes
    it: a held fall, a fall with the release tau (setting the peak), a
    rise that reaches the peak (setting it), a rise below it."""
    codes = np.empty(x.shape, np.int8)
    env = torch.empty_like(x)
    for t in range(x.shape[-1]):
        falling = (x[..., t] - e) < 0.0
        holding = hold > 0
        e2, peak2, hold2 = eu._env_step_plain(x[..., t], e, peak, hold, ta,
                                              tr, nh, None)
        peaked = torch.logical_and(~falling, e2 >= peak)
        codes[..., t] = np.where(
            falling, np.where(holding, eu._HOLD, eu._FALL_TR),
            np.where(peaked, eu._SET_TA, eu._RISE))
        e, peak, hold = e2, peak2, hold2
        env[..., t] = e
    return env, codes


@pytest.mark.parametrize("hold", [0, 24])
def test_gate_forward_takes_the_replayed_branches(hold):
    """The gate's forward envelope takes exactly the branches that
    peak_envelope_codes(..., release_thresh=None) replays from its level,
    envelope and incoming state (the codes its backward,
    peak_envelope_bwd, reads), and equals gate_envelope's envelope."""
    p = TGate(SR, **GATE_KW[hold]).build()
    x = torch.from_numpy(np.abs(_gate_input(5)) * np.linspace(
        1.0, 0.0, 1024, dtype=np.float32))
    e0 = torch.tensor([0.0, 0.3])
    p0 = torch.tensor([0.0, 0.4])
    h0 = torch.tensor([0, 5], dtype=torch.int32)
    ta, tr, nh, _ = eu._coefs(x, p.tau_attack, p.tau_release, p.hold, None)
    env, codes = _gate_forward_codes(x, e0, p0, h0, nh, ta, tr)
    _, _, genv, _ = eu.gate_envelope(
        tdyn.EnvState(e0, p0, h0), torch.zeros(2, dtype=torch.int32), x,
        p.tau_attack, p.tau_release, p.hold, p.knees[0].end,
        p.knees[1].start)
    assert torch.equal(env, genv)
    replay = eu.peak_envelope_codes(x, genv, e0, p0, h0, p.hold, None)
    np.testing.assert_array_equal(replay.numpy(), codes)
    # every branch taken: the held falls from the incoming hold of 5
    # samples at a hold time of 0, from the hold time itself at 24
    assert set(np.unique(codes)) == {eu._HOLD, eu._RISE, eu._FALL_TR,
                                     eu._SET_TA}


# ---------------------------------------------------------------------------
# the DynamicDelay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gain", ["per_sample", "scalar"])
def test_dynamic_delay_gradient_matches_jax(gain):
    """DynamicDelay.process with delays and feedback delays inside and
    outside their ranges: d/d the buffer, x and fgain (per sample, or one
    scalar summed over its broadcast) against jax.grad, two calls with the
    ring carried; the delays are int32 and take none."""
    rng = np.random.default_rng(17 + len(gain))
    c, t, md = 3, 400, 40
    buf = _f32(rng, c, md + 1)
    d = [rng.integers(-2, md + 3, (c, t)).astype(np.int32) for _ in "ab"]
    f = [rng.integers(-1, 10, (c, t)).astype(np.int32) for _ in "ab"]
    g = (_f32(rng, c, t, scale=0.5) if gain == "per_sample"
         else np.float32(0.4))
    xs = [_f32(rng, c, t), _f32(rng, c, t)]
    jd, td = JDelay(md), TDelay(md)

    def jstep(s, x, i):
        st, y = jd.process(JDelayState(s[0]), x, jnp.asarray(d[i]), s[1],
                           jnp.asarray(f[i]))
        return (st.buffer, s[1]), y

    def tstep(s, x, i):
        st, y = td.process(TDelayState(s[0]), x, torch.from_numpy(d[i]), s[1],
                           torch.from_numpy(f[i]))
        return (st.buffer, s[1]), y

    calls = iter(range(2))
    tcalls = iter(range(2))
    jg, tg = _two_calls(lambda s, x: jstep(s, x, next(calls)),
                        lambda s, x: tstep(s, x, next(tcalls)),
                        (buf, g), xs, rng)
    _bar(jg, tg, ("buffer", "fgain", "x0", "x1"))


# ---------------------------------------------------------------------------
# float64 gradient checks of the plain adjoints
# ---------------------------------------------------------------------------


def _d(rng, *shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("kind", ["shared", "per_row", "per_sample",
                                  "broadcast"])
def test_seq_cascade_gradcheck(kind):
    """gradcheck of the sequential cascade's plain adjoint in float64 (the
    coefficients' terms summed over time and rows, or per sample; a state
    broadcast over the rows), 3 stages, [2, 7]."""
    rng = np.random.default_rng(len(kind))
    base = _stable(rng, 3).astype(np.float64)
    if kind == "per_row":
        c = np.stack([base, base[::-1]])
    elif kind == "per_sample":
        c = base * (1 + 0.05 * rng.standard_normal((2, 7, 3, 5)))
    else:
        c = base
    ct = torch.tensor(c, requires_grad=True)
    st = _d(rng, *((3, 2) if kind == "broadcast" else (2, 3, 2)), scale=0.2)
    x = _d(rng, 2, 7)
    fn = tbq.dyn_biquad_cascade_seq if kind == "per_sample" \
        else tbq.biquad_cascade_seq
    assert torch.autograd.gradcheck(fn, (ct, st, x))


def test_dynamic_delay_gradcheck():
    """gradcheck of the DynamicDelay's plain adjoint in float64: the
    buffer, x and a per-sample gain, feedback at and after the tail."""
    rng = np.random.default_rng(2)
    md = 6
    d = torch.from_numpy(rng.integers(0, md + 1, (2, 11)).astype(np.int32))
    f = torch.from_numpy(rng.integers(0, 4, (2, 11)).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda b, x, g: tdelay.dynamic_delay(b, x, d, g, f, md),
        (_d(rng, 2, md + 1), _d(rng, 2, 11), _d(rng, 2, 11, scale=0.5)))


@pytest.mark.parametrize("hold", [0, 3])
def test_gate_envelope_gradcheck(hold):
    """gradcheck of the gate envelope's adjoint (peak_envelope_bwd without
    a release threshold) in float64 w.r.t. x, the incoming envelope and
    peak and both taus, from a state with a hold left."""
    rng = np.random.default_rng(hold + 1)
    x = torch.tensor(np.abs(rng.standard_normal((2, 9))) * 0.5,
                     dtype=torch.float64, requires_grad=True)
    e = torch.tensor([0.2, 0.6], dtype=torch.float64, requires_grad=True)
    p = torch.tensor([0.3, 0.7], dtype=torch.float64, requires_grad=True)
    ta = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    tr = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    h = torch.tensor([0, 2], dtype=torch.int32)
    cur = torch.zeros(2, dtype=torch.int32)

    def fn(xx, ee, pp, a, r):
        st, _, env, _ = eu.gate_envelope(tdyn.EnvState(ee, pp, h), cur, xx,
                                         a, r, hold, 0.5, 0.4)
        return env, st.envelope, st.peak

    assert torch.autograd.gradcheck(fn, (x, e, p, ta, tr))


# ---------------------------------------------------------------------------
# forwards under grad
# ---------------------------------------------------------------------------


def test_forwards_under_grad_are_the_plain_ones():
    """With an input requiring grad each of the four routes runs its
    Function, whose forward gives the no-grad route's outputs bit for bit
    (the cascade's saving loop, the delay's, the gate's), with a graph."""
    rng = np.random.default_rng(21)
    c, st, x = _route_inputs("shared", rng)
    cd, _, _ = _route_inputs("per_sample", rng)
    env = tdyn.EnvState(torch.full((3,), 0.1), torch.full((3,), 0.2),
                        torch.tensor([0, 3, 0], dtype=torch.int32))
    cur = torch.zeros(3, dtype=torch.int32)
    d = torch.from_numpy(rng.integers(0, 30, (3, 300)).astype(np.int32))
    calls = {
        "seq": lambda a: tbq.biquad_cascade_seq(torch.from_numpy(c),
                                                torch.from_numpy(st), a),
        "dyn_seq": lambda a: tbq.dyn_biquad_cascade_seq(
            torch.from_numpy(cd), torch.from_numpy(st), a),
        "gate": lambda a: eu.gate_envelope(env, cur, a.abs(), 0.3, 0.05, 4,
                                           0.5, 0.4),
        "delay": lambda a: tdelay.dynamic_delay(
            torch.zeros(3, 31), a, d, torch.tensor(0.3), d // 3, 30),
    }
    xt = torch.from_numpy(x)
    for name, fn in calls.items():
        plain = [v for v in _flat(fn(xt))]
        graded = [v for v in _flat(fn(xt.clone().requires_grad_(True)))]
        assert any(v.grad_fn is not None for v in graded), name
        assert all(v.grad_fn is None for v in plain), name
        for a, b in zip(plain, graded):
            assert torch.equal(a, b.detach()), name


def _flat(t):
    if torch.is_tensor(t):
        return [t]
    return [v for u in t for v in _flat(u)]


# ---------------------------------------------------------------------------
# the backward kernel's schedule, modelled on the CPU
# ---------------------------------------------------------------------------


def _bwd_consts():
    import os
    import re
    src = os.path.join(os.path.dirname(__file__), "..",
                       "lsp_dsp_units_tpu_torch", "csrc", "biquad_bwd.cu")
    with open(src) as f:
        text = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
            for k in ("kLanes", "kChunk", "kWarps")}


def _view(addr, n, ctype):
    import ctypes
    return np.ctypeslib.as_array((ctype * n).from_address(addr))


def _model_bwd(save_p, g_in_p, c_p, gs_in_p, g_out_p, gs_out_p, part_p, gc_p,
               rows, t_n, k_n, k0, kg, row_stride, t_stride, dyn, coef,
               stream, chunk=None):
    """``lsp_biquad_seq_bwd`` slot by slot (chunk: kChunk unless given):
    chain lane k runs chunk s - 2k of its stage's recurrence at slot s
    from its g and, per sample, its (c3, c4) in shared memory, writing
    its record (the chunk's incoming l2, l1, then each gy); the map warps
    turn the chunk each lane ran in slot s - 1 into g_u (the next lane's
    g, or g_out for the group's first stage) and per-sample terms, and
    stage slot s + 1's inputs (g_in, each lane's two signals of the chunk
    it runs at slot s, per sample its (c3, c4) of its next chunk); the
    sum threads add their (stage, coefficient) terms in reverse time
    from the staged signals.  Each buffer holds two
    chunks by parity: every read must find the chunk it wants, and no
    slot may read a buffer that it writes (the writes land at the slot's
    barrier).  Every product and sum as the kernel rounds it (its FMAs
    as ops/env_units._mul_add)."""
    import ctypes
    kc = _bwd_consts()
    chunk = chunk or kc["kChunk"]
    assert 1 <= kg <= kc["kLanes"]
    if coef and not dyn:
        assert 1 + -(-kg * 5 // 32) < kc["kWarps"], "no map warp left"
    f32 = ctypes.c_float
    g_in = _view(g_in_p.value, rows * t_n, f32).reshape(rows, t_n)
    g_out = _view(g_out_p.value, rows * t_n, f32).reshape(rows, t_n)
    gs_in = _view(gs_in_p.value, rows * k_n * 2, f32).reshape(rows, k_n, 2)
    gs_out = _view(gs_out_p.value, rows * k_n * 2, f32).reshape(rows, k_n, 2)
    c_a = _view(c_p.value, (rows - 1) * row_stride + (t_n - 1) * t_stride
                + k_n * 5, f32)
    sig = (_view(save_p.value, (k_n + 1) * rows * t_n, f32)
           .reshape(k_n + 1, rows, t_n) if coef else None)
    part = (_view(part_p.value, rows * k_n * 5, ctypes.c_double)
            .reshape(rows, k_n, 5) if coef and not dyn else None)
    gc = (_view(gc_p.value, rows * t_n * k_n * 5, f32)
          .reshape(rows, t_n, k_n, 5) if coef and dyn else None)
    nch = -(-t_n // chunk)

    def fma(a, b, c):
        return eu._mul_add(torch.from_numpy(np.asarray(a, np.float32)),
                           torch.from_numpy(np.asarray(b, np.float32)),
                           torch.from_numpy(np.asarray(c, np.float32))
                           ).numpy()

    def steps(n):
        return np.arange(min(chunk, t_n - n * chunk))

    for r in range(rows):
        def coefs(k, t):
            """stage k0 + kg - 1 - k's coefficients at the times t: [5, len]"""
            at = r * row_stride + (k0 + kg - 1 - k) * 5 + (
                np.asarray(t) * t_stride if dyn else np.zeros_like(t))
            return np.stack([c_a[at + q] for q in range(5)])

        bufs = {}       # (kind, lane, parity) -> (chunk, values)
        l1 = [np.float32(gs_in[r, k0 + kg - 1 - k, 0]) for k in range(kg)]
        l2 = [np.float32(gs_in[r, k0 + kg - 1 - k, 1]) for k in range(kg)]
        acc = np.zeros((kg, 5))
        written = np.zeros(t_n, int)

        def read(key, n, reads):
            reads.add(key)
            got, v = bufs[key]
            assert got == n, (key, got, n)
            return v

        def map_slot(s, reads, writes):
            for k in range(kg):
                n = s - 1 - 2 * k
                if not 0 <= n < nch:
                    continue
                rc = read(("rec", k, n & 1), n, reads)
                i = steps(n)
                t = t_n - 1 - (n * chunk + i)
                l2v, l1v, gy = rc[i], rc[i + 1], rc[i + 2]
                c = coefs(k, t)
                gu = fma(c[0], gy, fma(c[1], l1v, c[2] * l2v))
                if k + 1 < kg:
                    writes[("g", k + 1, n & 1)] = (n, gu)
                else:
                    g_out[r, t] = gu
                    written[t] += 1
                if dyn and coef:
                    q = kg - 1 - k
                    u = read(("u", k, n & 1), n, reads)[i]
                    yo = read(("yo", k, n & 1), n, reads)[i]
                    gc[r, t, k0 + q] = np.stack(
                        [gy * u, l1v * u, l2v * u, l1v * yo, l2v * yo], -1)
            n0 = s + 1
            if n0 < nch:
                writes[("g", 0, n0 & 1)] = (
                    n0, g_in[r, t_n - 1 - (n0 * chunk + steps(n0))].copy())
            for k in range(kg) if coef else ():
                n = s - 2 * k
                if 0 <= n < nch:
                    t = t_n - 1 - (n * chunk + steps(n))
                    q = kg - 1 - k
                    writes[("u", k, n & 1)] = (n, sig[k0 + q, r, t].copy())
                    writes[("yo", k, n & 1)] = (n, sig[k0 + q + 1, r, t]
                                                .copy())
            if dyn:
                for k in range(kg):
                    n = s + 1 - 2 * k
                    if 0 <= n < nch:
                        c = coefs(k, t_n - 1 - (n * chunk + steps(n)))
                        writes[("c", k, n & 1)] = (n, c[3:5])

        def land(reads, writes):
            assert not reads & set(writes), reads & set(writes)
            bufs.update(writes)

        reads, writes = set(), {}
        map_slot(-1, reads, writes)
        land(reads, writes)
        for s in range(nch + 2 * (kg - 1) + 1):
            reads, writes = set(), {}
            for k in range(kg):     # the chain lanes
                n = s - 2 * k
                if not 0 <= n < nch:
                    continue
                g = read(("g", k, n & 1), n, reads)
                if dyn:
                    cc = read(("c", k, n & 1), n, reads)
                else:
                    cc = np.repeat(coefs(k, np.zeros(1, int))[3:5], chunk, axis=1)
                rec = [l2[k], l1[k]]
                for i in steps(n):
                    gy = fma(cc[0][i], l1[k], fma(cc[1][i], l2[k], g[i]))
                    rec.append(np.float32(gy))
                    l2[k], l1[k] = l1[k], np.float32(gy)
                writes[("rec", k, n & 1)] = (n, np.asarray(rec, np.float32))
            if coef and not dyn:    # the sum threads
                for k in range(kg):
                    n = s - 1 - 2 * k
                    if not 0 <= n < nch:
                        continue
                    rc = read(("rec", k, n & 1), n, reads)
                    us = read(("u", k, n & 1), n, reads)
                    yos = read(("yo", k, n & 1), n, reads)
                    for i in steps(n):
                        u, yo = us[i], yos[i]
                        terms = [rc[i + 2] * u, rc[i + 1] * u, rc[i] * u,
                                 rc[i + 1] * yo, rc[i] * yo]
                        for j in range(5):
                            acc[k, j] += np.float64(np.float32(terms[j]))
            map_slot(s, reads, writes)
            land(reads, writes)
        assert (written == 1).all()
        for k in range(kg):
            gs_out[r, k0 + kg - 1 - k] = (l1[k], l2[k])
            if part is not None:
                part[r, k0 + kg - 1 - k] = acc[k]
    return 0


def _model_sums(p_p, out_p, rows, n, f64, stream):
    import ctypes
    p = _view(p_p.value, rows * n, ctypes.c_double if f64
              else ctypes.c_float).reshape(rows, n)
    out = _view(out_p.value, n, ctypes.c_float)
    acc = p[0].astype(np.float64)
    for r in range(1, rows):
        acc = acc + p[r].astype(np.float64)
    out[:] = acc.astype(np.float32)
    return 0


def _bwd_model_lib(chunk=None):
    class Lib:
        @staticmethod
        def lsp_biquad_seq_bwd(*args):
            return _model_bwd(*args, chunk=chunk)
        lsp_biquad_seq_bwd_sums = staticmethod(_model_sums)
    return Lib


@pytest.mark.parametrize("case", [
    ("shared", 9, 100, True), ("shared", 1, 1, True),
    ("per_row", 33, 45, True), ("per_sample", 4, 70, True),
    ("per_sample", 34, 33, True), ("sample_shared", 3, 40, True),
    ("shared", 5, 95, False), ("per_sample", 2, 63, False),
    # chunk boundaries at the kernel's own chunk: T a chunk +- 1, ragged
    ("shared", 9, 129, True), ("per_sample", 4, 255, True),
    ("per_row", 3, 256, True), ("shared", 2, 127, False),
    # a deep pipeline at a small chunk: many chunks, two groups
    ("shared", 33, 61, "chunk8"), ("per_sample", 34, 45, "chunk8"),
    ("shared", 9, 50, "chunk8_x")])
def test_bwd_kernel_schedule_model_is_the_plain_adjoint(case, monkeypatch):
    """The wrapper's CUDA route of the adjoint (groups of 32 stages, the
    last first, the row sums, strides) with the kernel replaced by its
    numpy model (at the kernel's chunk, or at a chunk of 8 steps for a
    deep pipeline), on CPU tensors: identical to the plain adjoint, and
    one launch counted per group."""
    from lsp_dsp_units_tpu_torch.ops import _build
    import ctypes
    kind, k, t, want = case
    chunk = 8 if isinstance(want, str) else None
    if isinstance(want, str):
        want = not want.endswith("_x")
    rng = np.random.default_rng(k * 100 + t)
    c, st, x = _route_inputs(kind, rng, k=k, t=t, rows=2)
    dyn = kind in ("per_sample", "sample_shared")
    c, st, x = map(torch.from_numpy, (c, st, x))
    gy = torch.from_numpy(_f32(rng, 2, t))
    gs = torch.from_numpy(_f32(rng, 2, k, 2))
    sig = tbq._seq_plain_run(c, st, x, dyn, save=True)[2]
    plain = (tbq.dyn_biquad_cascade_seq_bwd_plain if dyn
             else tbq.biquad_cascade_seq_bwd_plain)
    ref = plain(c, st, x, sig if want else None, gy, gs, want)
    monkeypatch.setattr(_build, "load",
                        lambda name, sigs: _bwd_model_lib(chunk))
    monkeypatch.setattr(_build, "stream_of", lambda v: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "is_cpu", lambda *ts: False)
    bwd = tbq.dyn_biquad_cascade_seq_bwd if dyn else \
        tbq.biquad_cascade_seq_bwd
    before = bwd.launches
    out = bwd(c, st, x, sig if want else None, gy, gs, want)
    assert bwd.launches - before == -(-k // 32)
    for a, b in zip(ref, out):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
