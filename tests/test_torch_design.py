"""Port's host-side float64 design layer against the JAX package's:
filter design for every FilterType, the fused-cascade matrices, the
compressor and sidechain parameters.  All of it is numpy math, so the
arrays must agree exactly."""

import numpy as np
import pytest

from lsp_dsp_units_tpu.models.filters import design as jdesign
from lsp_dsp_units_tpu.ops import biquad_block as jbb
from lsp_dsp_units_tpu.models.dynamics.compressor import (
    Compressor as JCompressor, CompressorMode as JMode)
from lsp_dsp_units_tpu.models.util.sidechain import (
    Sidechain as JSidechain, SidechainMode as JSCMode)
from lsp_dsp_units_tpu import pipeline as jpipe

from lsp_dsp_units_tpu_torch.models.filters import design as tdesign
from lsp_dsp_units_tpu_torch.ops import biquad_block as tbb
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (
    Compressor as TCompressor, CompressorMode as TMode)
from lsp_dsp_units_tpu_torch.models.util.sidechain import (
    Sidechain as TSidechain, SidechainMode as TSCMode)
from lsp_dsp_units_tpu_torch import pipeline as tpipe


def test_filter_type_enum_matches():
    assert [t.value for t in tdesign.FilterType] == \
        [t.value for t in jdesign.FilterType]
    assert len(list(tdesign.FilterType)) == 81


@pytest.mark.parametrize("name", [t.name for t in jdesign.FilterType])
def test_design_filter_exact(name):
    for sr, freq, freq2, gain, slope, q in ((48000, 1000.0, 4000.0, 2.0, 2,
                                             0.7),
                                            (44100, 90.0, 12000.0, 0.3, 3,
                                             0.0)):
        jd = jdesign.design_filter(jdesign.FilterParams(
            ftype=jdesign.FilterType[name], slope=slope, freq=freq,
            freq2=freq2, gain=gain, quality=q), sr)
        td = tdesign.design_filter(tdesign.FilterParams(
            ftype=tdesign.FilterType[name], slope=slope, freq=freq,
            freq2=freq2, gain=gain, quality=q), sr)
        np.testing.assert_array_equal(np.asarray(td.biquads),
                                      np.asarray(jd.biquads))


@pytest.mark.parametrize("block", [512, 2048])
def test_precompute_fused_exact(block):
    eq = np.concatenate([jdesign.design_filter(p, 48000).biquads
                         for p in jpipe.default_eq_params(48000)], axis=0)
    jp = jbb.precompute_fused(eq, block)
    tp = tbb.precompute_fused(eq, block, device="cpu")
    for f in jbb.FusedCascadeParams._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_array_equal(tp.g_t.numpy(), np.asarray(jp.g_mat).T)


def test_default_eq_params_match():
    jb = [jdesign.design_filter(p, 48000).biquads
          for p in jpipe.default_eq_params(48000)]
    tb = [tdesign.design_filter(p, 48000).biquads
          for p in tpipe.default_eq_params(48000)]
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["DOWNWARD", "UPWARD", "BOOSTING"])
def test_compressor_build_exact(mode):
    kw = dict(attack_thresh=0.25, release_thresh=0.125, attack_ms=10.0,
              release_ms=80.0, knee=0.7071, ratio=4.0, hold_ms=2.0)
    jp = JCompressor(48000, mode=JMode[mode], **kw).build()
    tp = TCompressor(48000, mode=TMode[mode], **kw).build()
    for jk, tk in zip(jp.knees, tp.knees):
        np.testing.assert_array_equal(
            np.asarray([np.asarray(v) for v in jk], np.float32),
            np.asarray(tk, np.float32))
    for f in ("tau_attack", "tau_release", "release_thresh", "hold"):
        assert np.asarray(getattr(jp, f)) == getattr(tp, f), f


def test_sidechain_params_match():
    for ms in (10.0, 2.0 / 3.0, 0.01):
        j = JSidechain(48000, JSCMode.RMS, reactivity_ms=ms, gain=1.5)
        t = TSidechain(48000, TSCMode.RMS, reactivity_ms=ms, gain=1.5)
        assert (j.reactivity, j.tau, j.gain) == (t.reactivity, t.tau, t.gain)
