"""The port's dynamics units against the JAX package: the plain versions
of the three single-purpose envelope kernels (ops/env_units.py) against
``sliding_rms_pallas``, ``peak_envelope_pallas`` and
``gate_envelope_pallas`` in interpret mode; the knees; the Sidechain in
all four modes with ``select_source``; Compressor, Expander and Gate
(``build`` exact, ``process`` against JAX).  Inputs are float32 numpy
arrays from fixed seeds.  (Each CUDA kernel against its plain version:
tests/test_torch_cuda.py.)

Bars: envelopes, hold counts and curve tracks exact (both packages round
``e + tau * d`` once); RMS level to atol 2e-6 and window to 1e-7 (the
JAX package's own kernel-vs-cumsum bars); element-wise exp/log curves
to rtol 1e-6 (torch's and XLA's transcendentals differ by an ulp), the
gate's cubic knee to rtol 1e-5 (XLA contracts its Horner steps into
FMAs, torch rounds each; exp turns the log-domain difference into a
relative one)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsp_dsp_units_tpu.models.dynamics.compressor import (
    Compressor as JCompressor, CompressorMode as JCMode)
from lsp_dsp_units_tpu.models.dynamics.expander import (
    Expander as JExpander, ExpanderMode as JEMode)
from lsp_dsp_units_tpu.models.dynamics.gate import Gate as JGate
from lsp_dsp_units_tpu.models.util import sidechain as jsc
from lsp_dsp_units_tpu.ops import dynamics as jdyn
from lsp_dsp_units_tpu.ops.pallas_env import (
    gate_envelope_pallas, peak_envelope_pallas, sliding_rms_pallas)

from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (
    Compressor as TCompressor, CompressorMode as TCMode)
from lsp_dsp_units_tpu_torch.models.dynamics.expander import (
    Expander as TExpander, ExpanderMode as TEMode)
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate as TGate
from lsp_dsp_units_tpu_torch.models.util import sidechain as tsc
from lsp_dsp_units_tpu_torch.ops import dynamics as tdyn
from lsp_dsp_units_tpu_torch.ops import env_units as eu

SR = 48000
GATE_KW = dict(threshold=0.2, zone=0.4, hyst_threshold=0.15, hyst_zone=0.5,
               reduction=0.1, attack_ms=2.0, release_ms=30.0, hold_ms=1.0)
EXP_KW = dict(attack_thresh=0.25, release_thresh=0.125, attack_ms=2.0,
              release_ms=10.0, knee=0.7071, ratio=2.0, hold_ms=0.5)
COMP_KW = dict(attack_thresh=0.25, release_thresh=0.125, attack_ms=2.0,
               release_ms=10.0, knee=0.7071, ratio=4.0, hold_ms=0.5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _env_state(c, rng):
    e = rng.random(c).astype(np.float32)
    p = rng.random(c).astype(np.float32)
    h = rng.integers(0, 6, c).astype(np.int32)
    return (jdyn.EnvState(jnp.asarray(e), jnp.asarray(p), jnp.asarray(h)),
            tdyn.EnvState(_t(e), _t(p), torch.from_numpy(h)))


def _assert_env_equal(js, ts):
    for f in ("envelope", "peak", "hold"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def _detector(rng, shape, peak=0.6):
    """|noise| under a half-sine swell: rises through every knee and
    falls back in one call."""
    swell = np.sin(np.linspace(0.0, np.pi, shape[-1]))
    return (np.abs(rng.standard_normal(shape)) * peak
            * swell).astype(np.float32)


@pytest.mark.parametrize("t_len", [64, 128])
def test_sliding_rms_plain_matches_jax_pallas(t_len):
    rng = np.random.default_rng(12 + t_len)
    c, n = 5, 16
    win = (rng.standard_normal((c, n)) ** 2).astype(np.float32)
    for k in range(2):
        x = np.abs(rng.standard_normal((c, t_len))).astype(np.float32)
        jw, jl = sliding_rms_pallas(jnp.asarray(win), jnp.asarray(x), n, 1.0,
                                    interpret=True)
        tw, tl = eu.sliding_rms(_t(win), _t(x), n, 1.0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=2e-6)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-7)
        win = tw.numpy()


def test_sliding_rms_short_block_matches_jax_cumsum():
    """T < N: the JAX Sidechain's cumsum branch (the TPU kernel needs
    T >= N); the window' is the last N of [window || squares]."""
    rng = np.random.default_rng(21)
    c, n = 3, 48
    win = (rng.standard_normal((c, n)) ** 2).astype(np.float32)
    js = jsc.SidechainState(jnp.asarray(win), jnp.zeros(c, jnp.float32))
    tw = _t(win)
    side = jsc.Sidechain(SR, jsc.SidechainMode.RMS, reactivity_ms=1.0)
    assert side.reactivity == n
    for t_len in (20, 7, 1, 30):
        x = np.abs(rng.standard_normal((c, t_len))).astype(np.float32)
        js, jl = side.process(js, jnp.asarray(x))
        tw, tl = eu.sliding_rms(tw, _t(x), n, 1.0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=2e-6)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(js.window))


@pytest.mark.parametrize("t_len", [512, 509])
@pytest.mark.parametrize("rt", [None, 0.2])
def test_peak_envelope_plain_matches_jax_pallas(t_len, rt):
    rng = np.random.default_rng(11)
    x = np.abs(rng.standard_normal((5, t_len))).astype(np.float32)
    jst, tst = _env_state(5, rng)
    jst, jenv = peak_envelope_pallas(jst, jnp.asarray(x), 0.05, 0.01, 8,
                                     release_thresh=rt, interpret=True)
    tst, tenv = tdyn.peak_envelope(tst, _t(x), 0.05, 0.01, 8, rt)
    assert isinstance(tst, tdyn.EnvState)
    np.testing.assert_array_equal(tenv.numpy(), np.asarray(jenv))
    _assert_env_equal(jst, tst)


@pytest.mark.parametrize("t_len", [512, 509])
def test_gate_envelope_plain_matches_jax_pallas(t_len):
    """Fast attack and release (0.05, 0.02 per sample, hold 8) against
    the knee points of GATE_KW: the curve track switches up in the
    swell and back down in the near silence after it."""
    rng = np.random.default_rng(5)
    p = JGate(SR, **GATE_KW).build()
    k0_end, k1_start = float(p.knees[0].end), float(p.knees[1].start)
    x = _detector(rng, (3, t_len))
    x[:, t_len // 2:] *= 0.02                  # near silence: release
    jst, tst = _env_state(3, rng)
    cur = np.array([0, 1, 0], np.int32)
    jst, jcur, jenv, jcurves = gate_envelope_pallas(
        jst, jnp.asarray(cur), jnp.asarray(x), 0.05, 0.02, 8, k0_end,
        k1_start, interpret=True)
    tst, tcur, tenv, tcurves = eu.gate_envelope(
        tst, torch.from_numpy(cur), _t(x), 0.05, 0.02, 8, k0_end, k1_start)
    np.testing.assert_array_equal(tenv.numpy(), np.asarray(jenv))
    np.testing.assert_array_equal(tcurves.numpy(), np.asarray(jcurves))
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
    assert tcurves.dtype == torch.int32
    assert np.abs(np.diff(np.asarray(jcurves), axis=-1)).sum() >= 4
    _assert_env_equal(jst, tst)


@pytest.mark.parametrize("hold_ms", [0.0, 0.5])
def test_gate_envelope_hold0_and_hold_match_jax_pallas(hold_ms):
    """The gate's default hold of 0 samples (where the CUDA kernel's
    chain runs the predicate-free step) and a hold of 24, with the
    gate's own coefficients, from env_init and from curve 0 and 1: T =
    2048 + 3 x 32 + 7 is no multiple of the kernel's chunk or batch.
    Envelope, curve track and state exact."""
    kw = dict(GATE_KW, attack_ms=0.5, release_ms=2.0, hold_ms=hold_ms)
    jp, tp = JGate(SR, **kw).build(), TGate(SR, **kw).build()
    assert tp.hold == jp.hold == (0 if hold_ms == 0.0 else 24)
    assert tp.tau_release <= tp.tau_attack
    k0_end, k1_start = float(jp.knees[0].end), float(jp.knees[1].start)
    assert float(tp.knees[0].end) == k0_end
    assert float(tp.knees[1].start) == k1_start
    t_len = 2048 + 3 * 32 + 7
    rng = np.random.default_rng(23)
    # two swells with near silence after each: up and down twice
    x = np.concatenate([_detector(rng, (3, 1024)),
                        _detector(rng, (3, t_len - 1024))], axis=-1)
    x[:, 700:1024] *= 0.02
    x[:, 1800:] *= 0.02
    cur = np.array([0, 1, 0], np.int32)
    jst, jcur, jenv, jcurves = gate_envelope_pallas(
        jdyn.env_init((3,)), jnp.asarray(cur), jnp.asarray(x),
        jp.tau_attack, jp.tau_release, jp.hold, k0_end, k1_start,
        interpret=True)
    tst, tcur, tenv, tcurves = eu.gate_envelope(
        tdyn.env_init((3,), "cpu"), torch.from_numpy(cur), _t(x),
        tp.tau_attack, tp.tau_release, tp.hold, k0_end, k1_start)
    np.testing.assert_array_equal(tenv.numpy(), np.asarray(jenv))
    np.testing.assert_array_equal(tcurves.numpy(), np.asarray(jcurves))
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
    assert np.abs(np.diff(np.asarray(jcurves), axis=-1)).sum() >= 9
    _assert_env_equal(jst, tst)


def test_wrappers_refuse_other_devices():
    m = torch.empty(2, 8, device="meta")
    w = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        eu.sliding_rms(w, m, 4, 1.0)
    st = tdyn.env_init((2,), "cpu")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        eu.peak_envelope(st, m, 0.1, 0.01, 0)


@pytest.mark.parametrize("source", [s.name for s in jsc.SidechainSource])
def test_select_source_exact(source):
    rng = np.random.default_rng(7)
    left = rng.standard_normal((2, 300)).astype(np.float32)
    right = rng.standard_normal((2, 300)).astype(np.float32)
    j = jsc.select_source(jnp.asarray(left), jnp.asarray(right),
                          jsc.SidechainSource[source])
    t = tsc.select_source(_t(left), _t(right), tsc.SidechainSource[source])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("mode", [m.name for m in jsc.SidechainMode])
def test_sidechain_modes_match_jax(mode):
    """PEAK exact; RMS shares the two-level float32 cumsum association,
    UNIFORM sums in float64 (each within a few ulps of the JAX prefix);
    LPF runs another scan order (rtol 1e-5)."""
    c, t = 3, 640
    js = jsc.Sidechain(SR, jsc.SidechainMode[mode], reactivity_ms=1.0,
                       gain=1.5)
    ts = tsc.Sidechain(SR, tsc.SidechainMode[mode], reactivity_ms=1.0,
                       gain=1.5)
    jst, tst = js.init_state((c,)), ts.init_state((c,), "cpu")
    for f in ("window", "rms"):
        assert tuple(getattr(tst, f).shape) == getattr(jst, f).shape, f
    rng = np.random.default_rng(8)
    for k in range(3):
        x = (rng.standard_normal((c, t)) * 0.5).astype(np.float32)
        jst, jl = js.process(jst, jnp.asarray(x))
        tst, tl = ts.process(tst, _t(x))
        if mode == "PEAK":
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        elif mode == "LPF":
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=2e-6)
        np.testing.assert_allclose(tst.window.numpy(),
                                   np.asarray(jst.window), rtol=0, atol=0)
        np.testing.assert_allclose(tst.rms.numpy(), np.asarray(jst.rms),
                                   rtol=1e-5, atol=1e-7)


def test_onepole_lowpass_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    s0 = rng.standard_normal(2).astype(np.float32)
    js, jy = jdyn.onepole_lowpass(jnp.asarray(s0), jnp.asarray(x), 0.01)
    ts, ty = tdyn.onepole_lowpass(_t(s0), _t(x), 0.01)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    e0, ey = tdyn.onepole_lowpass(_t(s0), torch.zeros(2, 0), 0.01)
    assert e0 is not None and ey.shape == (2, 0)


def _knee_tuple(k):
    return tuple(np.asarray(v).item() for v in k)


@pytest.mark.parametrize("mode", ["DOWNWARD", "UPWARD", "BOOSTING"])
def test_compressor_matches_jax(mode):
    c, t = 3, 600
    jc = JCompressor(SR, mode=JCMode[mode], **COMP_KW)
    tc = TCompressor(SR, mode=TCMode[mode], **COMP_KW)
    jp, tp = jc.build(), tc.build()
    rng = np.random.default_rng(30)
    x = _detector(rng, (c, t), 0.9)
    je, jg, jenv = jc.process(jp, jc.init_state((c,)), jnp.asarray(x))
    te, tg, tenv = tc.process(tp, tc.init_state((c,), "cpu"), _t(x))
    np.testing.assert_array_equal(tenv.numpy(), np.asarray(jenv))
    _assert_env_equal(je, te)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    lv = _t(np.linspace(1e-4, 2.0, 257))
    np.testing.assert_allclose(
        tc.curve(tp, lv).numpy(),
        np.asarray(jc.curve(jp, jnp.asarray(lv.numpy()))), rtol=1e-6)
    np.testing.assert_allclose(
        tc.amplification(tp, lv).numpy(),
        np.asarray(jc.amplification(jp, jnp.asarray(lv.numpy()))),
        rtol=1e-6)


@pytest.mark.parametrize("mode", ["DOWNWARD", "UPWARD"])
def test_expander_build_exact_and_process_matches_jax(mode):
    c, t = 3, 600
    je = JExpander(SR, mode=JEMode[mode], **EXP_KW)
    te = TExpander(SR, mode=TEMode[mode], **EXP_KW)
    jp, tp = je.build(), te.build()
    assert _knee_tuple(jp.knee) == tuple(tp.knee)
    for f in ("tau_attack", "tau_release", "release_thresh", "hold"):
        assert np.asarray(getattr(jp, f)).item() == getattr(tp, f), f
    rng = np.random.default_rng(31)
    x = _detector(rng, (c, t), 0.9)
    js, jg, jenv = je.process(jp, je.init_state((c,)), jnp.asarray(x))
    ts, tg, tenv = te.process(tp, te.init_state((c,), "cpu"), _t(x))
    np.testing.assert_array_equal(tenv.numpy(), np.asarray(jenv))
    _assert_env_equal(js, ts)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    lv = np.geomspace(1e-8, 10.0, 301).astype(np.float32)
    np.testing.assert_allclose(
        te.curve(tp, _t(lv)).numpy(), np.asarray(je.curve(jp,
                                                          jnp.asarray(lv))),
        rtol=1e-6)
    np.testing.assert_allclose(
        te.amplification(tp, _t(lv)).numpy(),
        np.asarray(je.amplification(jp, jnp.asarray(lv))), rtol=1e-6)


def test_gate_build_exact_and_process_matches_jax():
    c, t = 3, 700
    jg, tg = JGate(SR, **GATE_KW), TGate(SR, **GATE_KW)
    jp, tp = jg.build(), tg.build()
    for jk, tk in zip(jp.knees, tp.knees):
        assert _knee_tuple(jk) == tuple(tk)
    for f in ("tau_attack", "tau_release", "hold"):
        assert np.asarray(getattr(jp, f)).item() == getattr(tp, f), f
    rng = np.random.default_rng(32)
    jst, tst = jg.init_state((c,)), tg.init_state((c,), "cpu")
    for k in range(2):
        x = _detector(rng, (c, t), 0.6 - 0.4 * k)
        jst, jgain, jenv = jg.process(jp, jst, jnp.asarray(x))
        tst, tgain, tenv = tg.process(tp, tst, _t(x))
        np.testing.assert_array_equal(tenv.numpy(), np.asarray(jenv))
        np.testing.assert_array_equal(tst.curve.numpy(),
                                      np.asarray(jst.curve))
        _assert_env_equal(jst.env, tst.env)
        np.testing.assert_allclose(tgain.numpy(), np.asarray(jgain),
                                   rtol=1e-5)
    lv = np.geomspace(1e-4, 2.0, 301).astype(np.float32)
    for hyst in (False, True):
        np.testing.assert_allclose(
            tg.curve(tp, _t(lv), hyst).numpy(),
            np.asarray(jg.curve(jp, jnp.asarray(lv), hyst)), rtol=1e-5)
        np.testing.assert_allclose(
            tg.amplification(tp, _t(lv), hyst).numpy(),
            np.asarray(jg.amplification(jp, jnp.asarray(lv), hyst)),
            rtol=1e-5)
