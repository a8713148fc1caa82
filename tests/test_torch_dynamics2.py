"""The port's remaining dynamics units (Limiter, DynamicProcessor,
AutoGain, SimpleAutoGain, SurgeProtector) against the JAX package's, on
float32 inputs from numpy seeds, over calls with the state carried.

Bars:

* Host designs are numpy float64 on both sides: the Limiter's patch and
  ALR constants and DynamicProcessor's splines, levels and taus equal
  the JAX package's float32 arrays exactly, in all 12 limiter modes.
* Every per-sample chain (the limiter's ALR and patch loop, the riders,
  DynamicProcessor's envelope) equals the JAX package's output and state
  bit for bit.  XLA on the CPU contracts some ``a * b + c`` into FMAs and
  divides by a constant as a product with its reciprocal; the port's
  plain versions round the same (ops/limiter.py, ops/riders.py), and a
  change of any one of those roundings breaks these tests.
* DynamicProcessor's ``reduction``/``curve`` (exp and log of the spline
  sum, element-wise): rtol 2e-6.  torch's and XLA's float32 exp and log
  differ by an ulp or two (measured worst 4.8e-7 absolute on gains near
  1), which no rounding in the port can repeat.
* The limiter's rows are independent: rows needing few and many passes,
  batched, equal each row run alone, in both packages (the kernel runs
  each row's loop alone, csrc/limiter.cu).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu.models.dynamics import autogain as JA
from lsp_dsp_units_tpu.models.dynamics import dynamic_processor as JD
from lsp_dsp_units_tpu.models.dynamics import limiter as JL
from lsp_dsp_units_tpu.models.dynamics import surge_protector as JS
from lsp_dsp_units_tpu.ops import dynamics as jdyn

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch.models import dynamics as tdyn_models
from lsp_dsp_units_tpu_torch.models.dynamics import autogain as TA
from lsp_dsp_units_tpu_torch.models.dynamics import dynamic_processor as TD
from lsp_dsp_units_tpu_torch.models.dynamics import limiter as TL
from lsp_dsp_units_tpu_torch.models.dynamics import surge_protector as TS
from lsp_dsp_units_tpu_torch.ops import limiter as lim_ops

SR = 48000


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _eq(want, got):
    """Bit for bit: values and dtypes' kinds (bool stays bool)."""
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, want)
    assert got.dtype.kind == want.dtype.kind


def _state_eq(jstate, tstate):
    for name, jv in zip(jstate._fields, jstate):
        _eq(jv, getattr(tstate, name))


# ---------------------------------------------------------------------------
# Limiter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(JL.LimiterMode), ids=lambda m: m.value)
@pytest.mark.parametrize("la_ms, att_ms, rel_ms", [(2.0, 1.0, 3.0),
                                                   (5.0, 5.0, 8.0)])
def test_limiter_build_matches_jax_exactly(mode, la_ms, att_ms, rel_ms):
    kw = dict(threshold=0.7, lookahead_ms=la_ms, attack_ms=att_ms,
              release_ms=rel_ms, knee=0.9, alr_knee=0.6)
    jl = JL.Limiter(SR, mode=mode, **kw)
    tl = TL.Limiter(SR, mode=TL.LimiterMode(mode.value), **kw)
    assert tl.lookahead == jl.lookahead == tl.latency()
    jp = _np(jl.build())
    tp = tl.build(device="cpu")
    _eq(jp.patch, tp.patch)
    assert tp.middle == int(jp.middle)
    for f in ("threshold", "alr_ks", "alr_ke", "alr_gain", "alr_tau_att",
              "alr_tau_rel"):
        assert np.float32(getattr(tp, f)) == getattr(jp, f), f
    _eq(jp.alr_herm, np.asarray(tp.alr_herm, np.float32))
    # the params carried across equal the port's own build
    cp = convert.limiter_params_from_jax(jp, device="cpu")
    assert torch.equal(cp.patch, tp.patch) and cp[1:] == tp[1:]


def _sidechain(seed, rows, t, calls, peak):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(peak / 8.0, peak, t * calls)
    return (rng.standard_normal((rows, t * calls)) * ramp).astype(np.float32)


def _run_limiter(jl, tl, x, t, jstate=None, tstate=None):
    jp, tp = jl.build(), tl.build(device="cpu")
    rows = x.shape[0]
    js = jl.init_state((rows,)) if jstate is None else jstate
    ts = tl.init_state((rows,), device="cpu") if tstate is None else tstate
    jg, tg = [], []
    for k in range(x.shape[-1] // t):
        xk = x[:, k * t:(k + 1) * t]
        js, g = jl.process(jp, js, jnp.asarray(xk))
        jg.append(np.asarray(g))
        ts, g = tl.process(tp, ts, torch.from_numpy(xk))
        tg.append(g)
    return js, np.concatenate(jg, -1), ts, torch.cat(tg, -1)


@pytest.mark.parametrize("mode, alr, la_ms", [
    (JL.LimiterMode.HERM_THIN, False, 2.0),
    (JL.LimiterMode.EXP_WIDE, True, 5.0),
    (JL.LimiterMode.LINE_DUCK, True, 2.0),
    (JL.LimiterMode.HERM_TAIL, False, 5.0),
], ids=["herm_thin-2ms", "exp_wide-alr-5ms", "line_duck-alr-2ms",
        "herm_tail-5ms"])
def test_limiter_process_matches_jax_bitwise(mode, alr, la_ms):
    """Three calls of 700 samples, state carried; short patches and
    enough peaks that the knee is lowered (more than 32 passes in the
    first call without ALR) on every row."""
    kw = dict(threshold=0.3, lookahead_ms=la_ms, alr=alr, knee=0.8,
              attack_ms=0.5, release_ms=0.5)
    jl = JL.Limiter(SR, mode=mode, **kw)
    tl = TL.Limiter(SR, mode=TL.LimiterMode(mode.value), **kw)
    x = _sidechain(11, 3, 700, 3, 8.0) + np.float32(0.9) * np.sign(
        _sidechain(12, 3, 700, 3, 1.0))
    js, jg, ts, tg = _run_limiter(jl, tl, x, 700)
    _eq(jg, tg)
    _state_eq(_np(js), ts)
    # the ceiling holds on the delayed sidechain
    la = tl.lookahead
    lvl = np.abs(x[:, :-la]) * tg.numpy()[:, la:]
    assert lvl.max() <= 0.3 * (1 + 1e-6)
    _, _, _, passes = lim_ops.limiter_plain(
        tl.build(device="cpu"), *tl.init_state((3,), device="cpu"),
        torch.from_numpy(x[:, :700]), la, alr)
    assert passes.min() > 32 or alr


def test_limiter_rows_run_independently():
    """Rows needing 0, a few and many passes: batched, each equals the
    row run alone, in both packages, and the two packages agree; a row
    at the cap runs exactly 1024 passes beside rows that stop early."""
    t = 2400
    rng = np.random.default_rng(7)
    base = rng.standard_normal(t).astype(np.float32)
    x = np.stack([0.05 * base, 0.6 * base, 4.0 * base,
                  np.full(t, 300.0, np.float32) * np.sign(base)])
    kw = dict(threshold=0.2, lookahead_ms=2.0, release_ms=0.1,
              attack_ms=0.1)
    jl, tl = JL.Limiter(SR, **kw), TL.Limiter(SR, **kw)
    js, jg, ts, tg = _run_limiter(jl, tl, x, t)
    _eq(jg, tg)
    _state_eq(_np(js), ts)
    tp = tl.build(device="cpu")
    _, _, _, passes = lim_ops.limiter_plain(
        tp, *tl.init_state((4,), device="cpu"), torch.from_numpy(x),
        tl.lookahead, False)
    assert passes[0] == 0 and 0 < passes[1] < passes[2] < 1024
    assert passes[3] == lim_ops.MAX_PATCH_ITERS
    for r in range(4):
        jsr, jgr, tsr, tgr = _run_limiter(jl, tl, x[r:r + 1], t)
        _eq(jg[r:r + 1], jgr)
        _eq(jgr, tgr)
        _eq(np.asarray(js.gcarry)[r:r + 1], tsr.gcarry)
    # the clamp holds the ceiling on the row the cap cut short
    la = tl.lookahead
    assert (np.abs(x[:, :-la]) * tg.numpy()[:, la:]).max() <= 0.2 * (1 + 1e-6)


def test_limiter_state_from_jax_resumes_the_stream():
    kw = dict(threshold=0.4, lookahead_ms=2.0, alr=True,
              mode=JL.LimiterMode.LINE_WIDE)
    jl = JL.Limiter(SR, **kw)
    tl = TL.Limiter(SR, **{**kw, "mode": TL.LimiterMode.LINE_WIDE})
    x = _sidechain(3, 2, 512, 2, 2.0)
    js, _, _, _ = _run_limiter(jl, tl, x[:, :512], 512)
    ts = convert.limiter_state_from_jax(_np(js), device="cpu")
    js2, jg, ts2, tg = _run_limiter(jl, tl, x[:, 512:], 512, js, ts)
    _eq(jg, tg)
    _state_eq(_np(js2), ts2)


# ---------------------------------------------------------------------------
# the riders
# ---------------------------------------------------------------------------


def _levels(seed, rows, t):
    rng = np.random.default_rng(seed)
    ramp = np.geomspace(1e-5, 2.0, t)
    lvl = np.abs(rng.standard_normal((rows, t)) * ramp).astype(np.float32)
    short = np.clip(lvl * (1 + 0.3 * rng.standard_normal((rows, t))), 1e-6,
                    None).astype(np.float32)
    return lvl, short


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("use_max", [False, True])
def test_autogain_matches_jax_bitwise(quick, use_max):
    kw = dict(quick_amplifier=quick, use_max_gain=use_max, max_gain=3.0,
              long_grow_db_s=60.0, long_fall_db_s=60.0)
    ja, ta = JA.AutoGain(SR, **kw), TA.AutoGain(SR, **kw)
    lvl, short = _levels(5, 3, 1536)
    l_exp = np.float32(0.2)            # broadcast, as the JAX call allows
    js, ts = ja.init_state((3,)), ta.init_state((3,), device="cpu")
    for k in range(3):
        sl = slice(k * 512, (k + 1) * 512)
        js, jv = ja.process(js, jnp.asarray(lvl[:, sl]),
                            jnp.asarray(short[:, sl]), jnp.asarray(l_exp))
        ts, tv = ta.process(ts, torch.from_numpy(lvl[:, sl]),
                            torch.from_numpy(short[:, sl]),
                            torch.tensor(l_exp))
        _eq(jv, tv)
        _state_eq(_np(js), ts)
    assert bool(np.asarray(js.surge_up).any() or np.asarray(js.surge_down)
                .any()) or not quick
    ts2 = convert.autogain_state_from_jax(_np(js), device="cpu")
    for a, b in zip(ts2, ts):
        assert torch.equal(a, b)


def test_simple_autogain_and_surge_protector_match_jax_bitwise():
    lvl, _ = _levels(6, 3, 1024)
    target = np.full((3, 1), 0.25, np.float32)
    js_, ts_ = (m.SimpleAutoGain(SR, grow_db_s=120.0, deviation=1.5)
                for m in (JA, TA))
    jst, tst = js_.init_state((3,)), ts_.init_state((3,), device="cpu")
    rng = np.random.default_rng(8)
    sx = np.concatenate([np.zeros((3, 50)), rng.standard_normal((3, 300)),
                         np.zeros((3, 400)),
                         0.5 * rng.standard_normal((3, 274))],
                        1).astype(np.float32)
    jsp, tsp = (m.SurgeProtector(0.1, 0.01, 100, 200) for m in (JS, TS))
    jss, tss = jsp.init_state((3,)), tsp.init_state((3,), device="cpu")
    for k in range(2):
        sl = slice(k * 512, (k + 1) * 512)
        jst, jg = js_.process(jst, jnp.asarray(lvl[:, sl]),
                              jnp.asarray(target))
        tst, tg = ts_.process(tst, torch.from_numpy(lvl[:, sl]),
                              torch.from_numpy(target))
        _eq(jg, tg)
        _state_eq(_np(jst), tst)
        jss, jg = jsp.process(jss, jnp.asarray(sx[:, sl]))
        tss, tg = tsp.process(tss, torch.from_numpy(sx[:, sl]))
        _eq(jg, tg)
        _state_eq(_np(jss), tss)
    # the ramp ran both ways, and the carried states convert exactly
    g = tg.numpy()
    assert (g > 0).any() and (g < 1).any()
    for conv, js, ts in ((convert.simple_autogain_state_from_jax, jst, tst),
                         (convert.surge_state_from_jax, jss, tss)):
        for a, b in zip(conv(_np(js), device="cpu"), ts):
            assert torch.equal(a, b)


def _dynproc(m):
    d = m.DynamicProcessor(SR, in_ratio=1.2, out_ratio=2.0, hold_ms=1.0,
                           attack_time_ms=[5, 1, 2, 3, 4],
                           release_time_ms=[50, 20, 30, 40, 60])
    for i, dot in enumerate([(0.01, 0.02, 0.5), (0.1, 0.08, 0.7),
                             (0.5, 0.3, 0.8), (0.9, 0.5, 0.9)]):
        d.set_dot(i, *dot)
    d.set_attack_level(0, 0.05)
    d.set_attack_level(2, 0.3)
    d.set_release_level(1, 0.1)
    d.set_release_level(3, 0.6)
    return d


def test_dynamic_processor_build_matches_jax_exactly():
    jp = _np(_dynproc(JD).build())
    tp = _dynproc(TD).build(device="cpu")
    for f in jp._fields:
        _eq(getattr(jp, f), np.asarray(getattr(tp, f)) if isinstance(
            getattr(tp, f), (tuple, int)) else getattr(tp, f))
    assert len(tp.att_level) == 3 and len(tp.rel_level) == 3
    cp = convert.dynproc_params_from_jax(jp, device="cpu")
    for a, b in zip(cp, tp):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_dynamic_processor_envelope_and_curve_match_jax():
    jd, td = _dynproc(JD), _dynproc(TD)
    jp, tp = jd.build(), td.build(device="cpu")
    rng = np.random.default_rng(9)
    x = np.abs(rng.standard_normal((3, 1500))
               * np.geomspace(0.001, 1.5, 1500)).astype(np.float32)
    x[:, 700:760] = 0.0                  # falls inside the hold
    js, ts = jdyn.env_init((3,)), td.init_state((3,), device="cpu")
    for k in range(3):
        sl = slice(k * 500, (k + 1) * 500)
        js, jg, je = jd.process(jp, js, jnp.asarray(x[:, sl]))
        ts, tg, te = td.process(tp, ts, torch.from_numpy(x[:, sl]))
        _eq(je, te)
        _state_eq(_np(js), ts)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-6)
    assert int(np.asarray(jp.hold)) == 48
    xs = np.geomspace(1e-4, 3.0, 4001).astype(np.float32)
    np.testing.assert_allclose(
        td.reduction(tp, torch.from_numpy(xs)).numpy(),
        np.asarray(jd.reduction(jp, jnp.asarray(xs))), rtol=2e-6)
    np.testing.assert_allclose(
        td.curve(tp, torch.from_numpy(xs)).numpy(),
        np.asarray(jd.curve(jp, jnp.asarray(xs))), rtol=2e-6)
    te2 = convert.env_state_from_jax(_np(js), device="cpu")
    for a, b in zip(te2, ts):
        assert torch.equal(a, b)


def test_dynamics_exports_match_jax():
    from lsp_dsp_units_tpu.models import dynamics as jdyn_models
    names = {n for n in dir(jdyn_models) if n[0].isupper()}
    assert names <= {n for n in dir(tdyn_models) if n[0].isupper()}


@pytest.mark.parametrize("which", ["short_comp", "out_comp"])
def test_autogain_curve_matches_jax_bitwise(which):
    """The compressor curve and its gain (reference eval_curve /
    eval_gain) over both knees and the segments around them, within an
    ulp: called alone, JAX runs each operation on its own and rounds
    each, while inside AutoGain's scan XLA fuses the curve and contracts
    it into FMAs, which is how the port rounds it (the unit's bitwise
    test above holds that)."""
    ja, ta = JA.AutoGain(SR), TA.AutoGain(SR)
    jc, tc = getattr(ja, which), getattr(ta, which)
    assert jc == tc
    x = np.geomspace(1e-3, 8.0, 2001).astype(np.float32)
    for jf, tf in ((JA._eval_curve, TA._eval_curve),
                   (JA._eval_gain, TA._eval_gain)):
        np.testing.assert_allclose(tf(tc, torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(jc, jnp.asarray(x))),
                                   rtol=2.4e-7, atol=0)
