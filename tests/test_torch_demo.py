"""The port's demo (``tools/demo.py --cpu``) against the JAX package's
``examples/demo.py`` on the same WAV: a 2-channel 1 s file at 48 kHz
written from a seed, each of the five modes run through both ``main``s,
the output WAVs compared.  Bars: ``filter`` >= 95 dB (the scan's),
``chain`` >= 100 dB (``tests/test_torch_step.py``'s), ``loudness`` the
meter's output and the integrated LUFS gain within rtol 1e-5
(``tests/test_torch_meters.py``'s), ``sampler`` and ``stretch``
identical (the host sampler is exact).
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu.models.meters import (ILUFSMeter as JILUFS,
                                             Weighting as JWeighting)

from lsp_dsp_units_tpu_torch.tools import demo
from lsp_dsp_units_tpu_torch.utils.wavio import read_wav, write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48000
SCAN_DB = 95.0
CHAIN_DB = 100.0
LUFS_RTOL = 1e-5


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_demo", os.path.join(ROOT, "examples", "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """Two channels, 1 s: tones plus noise, peaks at -12 dBFS."""
    rng = np.random.default_rng(2024)
    t = np.arange(SR) / SR
    x = np.stack([np.sin(2 * np.pi * 220.0 * t) + 0.5 * np.sin(
        2 * np.pi * 3100.0 * t), np.sin(2 * np.pi * 330.0 * t + 1.0)])
    x = x + 0.3 * rng.standard_normal(x.shape)
    x *= 10 ** (-12 / 20) / np.abs(x).max()
    path = str(tmp_path_factory.mktemp("demo") / "in.wav")
    write_wav(path, x.astype(np.float32), SR)
    return path


def _run_both(wav, mode, tmp_path, monkeypatch):
    jout, tout = str(tmp_path / "jax.wav"), str(tmp_path / "torch.wav")
    monkeypatch.setattr(sys, "argv", ["demo.py", wav, jout, mode])
    _jax_demo().main()
    demo.main([wav, tout, mode, "--cpu"])
    (jy, jsr), (ty, tsr) = read_wav(jout), read_wav(tout)
    assert jsr == tsr == SR
    assert jy.shape == ty.shape and np.all(np.isfinite(ty))
    return jy, ty


@pytest.mark.parametrize("mode, bar", [("filter", SCAN_DB),
                                       ("chain", CHAIN_DB)])
def test_demo_filter_and_chain_match_jax(wav, tmp_path, monkeypatch, mode,
                                         bar):
    jy, ty = _run_both(wav, mode, tmp_path, monkeypatch)
    assert _snr(jy, ty) >= bar


def test_demo_loudness_matches_jax(wav, tmp_path, monkeypatch, capsys):
    """The meter's output WAV and the integrated loudness, the latter as
    the LUFS gain both meters hold."""
    jy, ty = _run_both(wav, "loudness", tmp_path, monkeypatch)
    np.testing.assert_allclose(ty, jy, rtol=LUFS_RTOL, atol=1e-9)
    assert "integrated loudness:" in capsys.readouterr().out
    x, sr = read_wav(wav)
    meter = JILUFS(sr, channels=2, weighting=JWeighting.K)
    t = (x.shape[1] // meter.block) * meter.block
    st, _ = meter.process(meter.init_state(), jnp.asarray(x[:, :t]))
    want = float(np.asarray(meter.loudness_lufs_gain(st)))
    _, got = demo.run_loudness(x, sr, "cpu")
    assert want > 0.0
    assert abs(got - want) <= LUFS_RTOL * want


@pytest.mark.parametrize("mode", ["sampler", "stretch"])
def test_demo_host_sampling_identical(wav, tmp_path, monkeypatch, mode):
    jy, ty = _run_both(wav, mode, tmp_path, monkeypatch)
    np.testing.assert_array_equal(ty, jy)


def test_demo_defaults_to_the_card(wav, tmp_path):
    """Without ``--cpu`` the demo runs on the card, and with none it
    fails instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would succeed")
    with pytest.raises((RuntimeError, AssertionError)):
        demo.main([wav, str(tmp_path / "out.wav"), "chain"])
    assert not (tmp_path / "out.wav").exists()
