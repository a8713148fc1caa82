"""The port's meters (PeakMeter, Panometer, Correlometer, TruePeakMeter,
LoudnessMeter, ILUFSMeter) against the JAX package's, on float32 inputs
from numpy seeds, over calls with the state carried.

Bars:

* PeakMeter (a per-sample chain, ops/riders.py): output and state bit
  for bit.
* Panometer and Correlometer (element-wise over sliding sums of the same
  association, ops/sliding.py): within 2e-6 absolute of values in
  [0, 1] and [-1, 1]; XLA divides by the window as a product with its
  reciprocal, torch divides.  The carried windows equal exactly.
* TruePeakMeter: within 1e-6 absolute, tests/test_torch_sampling.py's
  bar for the same upsampler (XLA's dot and torch's sum add the 21
  taps in other orders); the history exactly.
* LoudnessMeter and ILUFSMeter: the K-weighting is the sequential
  cascade, where XLA contracts the DF2T body into FMAs and torch rounds
  each product and sum (tests/test_torch_filters.py), so the loudness
  is held at rtol 1e-5, the filter state at >= 50 dB and the window of
  weighted squares at >= 60 dB from the JAX package's; the gating's sums
  over the ring agree to rtol 1e-5.  The
  JAX package's own anchors hold on the port's output: surround +1.5
  dB, LFE excluded, the relative gate keeps the loud anchor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu.models.meters import correlometer as JC
from lsp_dsp_units_tpu.models.meters import loudness as JLd
from lsp_dsp_units_tpu.models.meters import peak as JP
from lsp_dsp_units_tpu.models.meters import true_peak as JT
from lsp_dsp_units_tpu.models.misc import broadcast as jbs

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch.models import meters as tmeters
from lsp_dsp_units_tpu_torch.models.meters import correlometer as TC
from lsp_dsp_units_tpu_torch.models.meters import loudness as TLd
from lsp_dsp_units_tpu_torch.models.meters import peak as TP
from lsp_dsp_units_tpu_torch.models.meters import true_peak as TT
from lsp_dsp_units_tpu_torch.models.misc import broadcast as tbs

SR = 48000


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _noise(seed, *shape, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _calls(x, t):
    return [x[..., k * t:(k + 1) * t] for k in range(x.shape[-1] // t)]


def test_peak_meter_matches_jax_bitwise():
    jm = JP.PeakMeter(SR, hold_ms=2.0, release_ms=5.0)
    tm = TP.PeakMeter(SR, hold_ms=2.0, release_ms=5.0)
    x = _noise(1, 3, 1536) * np.repeat(
        np.float32([1.0, 0.05, 0.6]), 512)[None, :]
    js, ts = jm.init_state((3,)), tm.init_state((3,), device="cpu")
    for xk in _calls(x, 512):
        js, jy = jm.process(js, jnp.asarray(xk))
        ts, ty = tm.process(ts, torch.from_numpy(xk))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    jn = _np(js)
    np.testing.assert_array_equal(ts.peak.numpy(), jn.peak)
    np.testing.assert_array_equal(ts.counter.numpy(), jn.counter)
    cs = convert.peak_meter_state_from_jax(jn, device="cpu")
    assert torch.equal(cs.peak, ts.peak) and torch.equal(cs.counter,
                                                         ts.counter)


@pytest.mark.parametrize("law", ["linear", "equal_power"])
def test_panometer_matches_jax(law):
    """One pair as the JAX package takes it; then three pairs batched in
    the port, each equal to its pair run alone."""
    jm = JP.Panometer(300, JP.PanLaw(law))
    tm = TP.Panometer(300, TP.PanLaw(law))
    a = _noise(2, 3, 1200)
    b = (0.7 * a + _noise(3, 3, 1200, scale=0.1)).astype(np.float32)
    js, ts = jm.init_state(), tm.init_state(device="cpu")
    for ak, bk in zip(_calls(a[0], 400), _calls(b[0], 400)):
        js, jy = jm.process(js, jnp.asarray(ak), jnp.asarray(bk))
        ts, ty = tm.process(ts, torch.from_numpy(ak), torch.from_numpy(bk))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-6)
    jn = _np(js)
    np.testing.assert_array_equal(ts.win_a.numpy(), jn.win_a)
    np.testing.assert_array_equal(ts.win_b.numpy(), jn.win_b)
    cs = convert.panometer_state_from_jax(jn, device="cpu")
    assert torch.equal(cs.win_a, ts.win_a)
    tsb, ysb = tm.init_state((3,), device="cpu"), []
    for ak, bk in zip(_calls(a, 400), _calls(b, 400)):
        tsb, y = tm.process(tsb, torch.from_numpy(ak), torch.from_numpy(bk))
        ysb.append(y)
    for r in range(3):
        tsr, ysr = tm.init_state(device="cpu"), []
        for ak, bk in zip(_calls(a[r], 400), _calls(b[r], 400)):
            tsr, y = tm.process(tsr, torch.from_numpy(ak),
                                torch.from_numpy(bk))
            ysr.append(y)
        assert torch.equal(torch.cat(ysb, -1)[r], torch.cat(ysr))
        assert torch.equal(tsb.win_a[r], tsr.win_a)


def test_correlometer_matches_jax():
    jm, tm = JC.Correlometer(window=480), TC.Correlometer(window=480)
    a = _noise(4, 3, 1536)
    b = (np.float32([[0.6], [-0.9], [0.0]]) * a
         + _noise(5, 3, 1536, scale=0.05)).astype(np.float32)
    js, ts = jm.init_state((3,)), tm.init_state((3,), device="cpu")
    for ak, bk in zip(_calls(a, 512), _calls(b, 512)):
        js, jy = jm.process(js, jnp.asarray(ak), jnp.asarray(bk))
        ts, ty = tm.process(ts, torch.from_numpy(ak), torch.from_numpy(bk))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-6)
    jn = _np(js)
    np.testing.assert_array_equal(ts.win_a.numpy(), jn.win_a)
    np.testing.assert_array_equal(ts.win_b.numpy(), jn.win_b)
    cs = convert.correlometer_state_from_jax(jn, device="cpu")
    assert torch.equal(cs.win_b, ts.win_b)
    assert ty[0, -1] > 0.9 and ty[1, -1] < -0.9 and abs(ty[2, -1]) < 0.3


def test_true_peak_meter_matches_jax():
    jm, tm = JT.TruePeakMeter(SR), TT.TruePeakMeter(SR)
    assert tm.ratio == jm.ratio == 4 and tm.latency() == jm.latency()
    t = np.arange(1536) / SR
    x = np.stack([0.5 * np.sin(2 * np.pi * 11993.5 * t),
                  _noise(6, 1536)]).astype(np.float32)
    js, ts = jm.init_state((2,)), tm.init_state((2,), device="cpu")
    for xk in _calls(x, 512):
        js, jy = jm.process(js, jnp.asarray(xk))
        ts, ty = tm.process(ts, torch.from_numpy(xk))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_array_equal(ts.hist.numpy(), np.asarray(js.hist))
    cs = convert.true_peak_state_from_jax(_np(js), device="cpu")
    _, jmax = jm.process_max(js, jnp.asarray(x[:, :512]))
    _, tmax = tm.process_max(cs, torch.from_numpy(x[:, :512]))
    np.testing.assert_allclose(tmax.numpy(), np.asarray(jmax), atol=1e-6)
    # the inter-sample peak: above the sample peak, below 0.52
    assert float(np.abs(x[0]).max()) - 1e-3 <= float(tmax[0]) < 0.52


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = out.numpy().astype(np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-300))


def _filt_close(jflt, tflt):
    """The weighting's carried state: >= 50 dB from the JAX package's
    (its 38 Hz pole carries each rounding on; tests/test_torch_filters.py
    holds the sequential Filter's state at >= 52 dB)."""
    assert _snr(jflt, tflt) >= 50.0


@pytest.mark.parametrize("period_ms", [400.0, 3000.0])
def test_loudness_meter_with_lfe_and_surround_matches_jax(period_ms):
    des = ["LEFT", "RIGHT", "LFE1", "LEFT_SURROUND"]
    jm = JLd.LoudnessMeter(SR, 4, period_ms, JLd.Weighting.K,
                           [jbs.Channel[d] for d in des])
    tm = TLd.LoudnessMeter(SR, 4, period_ms, TLd.Weighting.K,
                           [tbs.Channel[d] for d in des], device="cpu")
    np.testing.assert_array_equal(tm.weights.numpy(),
                                  np.float32([1.0, 1.0, 0.0, 1.41]))
    np.testing.assert_array_equal(
        tm._coeffs.numpy(), np.asarray(jm._coeffs, np.float32))
    x = _noise(7, 4, 2048)
    js, ts = jm.init_state(), tm.init_state()
    for xk in _calls(x, 1024):
        js, jy = jm.process(js, jnp.asarray(xk))
        ts, ty = tm.process(ts, torch.from_numpy(xk))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5)
    _filt_close(js.flt, ts.flt)
    # the weighted squares' history, of the same output: >= 60 dB
    assert _snr(js.window, ts.window) >= 60.0
    cs = convert.loudness_state_from_jax(_np(js), device="cpu")
    assert cs.window.shape == ts.window.shape


def test_loudness_meter_weighs_surround_and_drops_lfe():
    """A sine on a surround channel reads +1.5 dB over the same sine on
    the centre; on LFE it reads nothing (tests/test_bs1770.py's anchors,
    on a short steady window)."""
    t = np.arange(4096) / SR
    sine = (0.1 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)[None]
    louds = {}
    for d in ("CENTER", "LEFT_SURROUND", "LFE1"):
        m = TLd.LoudnessMeter(SR, 1, 40.0, designations=[tbs.Channel[d]],
                              device="cpu")
        _, y = m.process(m.init_state(), torch.from_numpy(sine))
        louds[d] = float(y[-1])
    db = 20 * np.log10(louds["LEFT_SURROUND"] / louds["CENTER"])
    assert abs(db - 20 * np.log10(np.sqrt(1.41))) < 1e-3
    assert louds["LFE1"] == 0.0


def _ilufs_pair(weighting, channels=1, designations=None):
    jd = None if designations is None else [jbs.Channel[d]
                                           for d in designations]
    td = None if designations is None else [tbs.Channel[d]
                                           for d in designations]
    jm = JLd.ILUFSMeter(SR, channels, JLd.Weighting(weighting), jd)
    tm = TLd.ILUFSMeter(SR, channels, TLd.Weighting(weighting), td,
                        device="cpu")
    return jm, tm


def _ilufs_run(jm, tm, x, t):
    js, ts = jm.init_state(), tm.init_state()
    for xk in _calls(x, t):
        js, jy = jm.process(js, jnp.asarray(xk))
        ts, ty = tm.process(ts, torch.from_numpy(xk))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5)
    jn = _np(js)
    for f in ("part_idx", "part_fill", "blk_full", "ring_pos", "ring_cnt"):
        assert getattr(ts, f) == getattr(jn, f).item(), f
    np.testing.assert_allclose(ts.ring.numpy(), jn.ring, rtol=1e-5)
    np.testing.assert_allclose(ts.part_sums.numpy(), jn.part_sums,
                               rtol=1e-5)
    np.testing.assert_allclose(float(ts.loudness), float(jn.loudness),
                               rtol=1e-5)
    return js, ts


def test_ilufs_relative_gating_matches_jax():
    """Loud and soft (-20 dB) sections, 2 s each, unweighted so the
    gating alone is under test: the relative gate (-10 LU) drops the
    soft blocks, in both packages.  Without it the mean of the two
    levels' powers reads 2.97 dB below the loud anchor; with it the
    reading is within 0.6 dB of the anchor (the blocks that straddle a
    change of level stay above the gate and pull it down 0.48 dB)."""
    t = np.arange(2 * SR) / SR
    loud = (0.1 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    x = np.concatenate([loud, 0.1 * loud, loud, 0.1 * loud])[None]
    jm, tm = _ilufs_pair("none")
    js, ts = _ilufs_run(jm, tm, x, 4 * 4800)
    lufs = 20 * np.log10(float(tm.loudness_lufs_gain(ts)))
    want = 20 * np.log10(0.1 / np.sqrt(2)) - 0.691
    assert abs(lufs - want) < 0.6
    np.testing.assert_allclose(float(tm.loudness_lufs_gain(ts)),
                               float(jm.loudness_lufs_gain(js)), rtol=1e-5)


def test_ilufs_k_weighted_with_lfe_matches_jax_and_state_converts():
    jm, tm = _ilufs_pair("k", 2, ["CENTER", "LFE1"])
    x = _noise(8, 2, 4 * 4800)
    x[1] *= 10.0                        # on LFE: excluded
    js, ts = _ilufs_run(jm, tm, x, 2 * 4800)
    _filt_close(js.flt, ts.flt)
    ts2 = convert.ilufs_state_from_jax(_np(js), device="cpu")
    assert ts2.part_idx == ts.part_idx and ts2.ring_cnt == ts.ring_cnt
    with pytest.raises(ValueError):
        tm.process(ts2, torch.zeros(2, 1000))
    js3, jy = jm.process(js, jnp.asarray(x[:, :4800]))
    ts3, ty = tm.process(ts2, torch.from_numpy(x[:, :4800]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5)


def test_meters_exports_match_jax():
    from lsp_dsp_units_tpu.models import meters as jmeters
    names = {n for n in dir(jmeters) if n[0].isupper()}
    assert names <= {n for n in dir(tmeters) if n[0].isupper()}
    consts = {n for n in dir(jbs) if isinstance(getattr(jbs, n), float)}
    assert consts == {n for n in dir(tbs)
                      if isinstance(getattr(tbs, n), float)}
    for n in consts:
        assert getattr(jbs, n) == getattr(tbs, n)
    for c in jbs.Channel:
        assert jbs.channel_weighting(c) == tbs.channel_weighting(
            tbs.Channel(c.value))
