"""Port's packed FFT (ops/fft_packed.py) against the JAX package's
Pallas four-step FFT run in interpret mode, compared in natural order
after each package's own unpack (the CUDA kernels against the plain
versions: tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsp_dsp_units_tpu.ops import pallas_fft as jfft
from lsp_dsp_units_tpu_torch.ops import fft_packed as tfft


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _j_unpacked(re, im, n):
    ure, uim = jfft.unpack_spectra(re, im, n)
    return np.asarray(ure), np.asarray(uim)


def _t_unpacked(re, im, n):
    ure, uim = tfft.unpack_spectra(re, im, n)
    return ure.numpy(), uim.numpy()


@pytest.mark.parametrize("n", [2048, 4096])
def test_rfft_packed_matches_jax(n):
    x = (np.random.default_rng(n).standard_normal((4, n))
         .astype(np.float32))
    jre, jim = _j_unpacked(*jfft.rfft_packed(jnp.asarray(x),
                                             interpret=True), n)
    tre, tim = _t_unpacked(*tfft.rfft_packed(torch.from_numpy(x)), n)
    assert _snr(jre, tre) >= 95.0 and _snr(jim, tim) >= 95.0


@pytest.mark.parametrize("n", [2048, 4096])
def test_rfft_packed_zeropad_matches_jax(n):
    x = (np.random.default_rng(n + 1).standard_normal((4, n // 2))
         .astype(np.float32))
    jre, jim = _j_unpacked(*jfft.rfft_packed_zeropad(jnp.asarray(x),
                                                     interpret=True), n)
    tre, tim = _t_unpacked(*tfft.rfft_packed_zeropad(torch.from_numpy(x)),
                           n)
    assert _snr(jre, tre) >= 95.0 and _snr(jim, tim) >= 95.0


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("half", [False, "first", "last"])
def test_irfft_packed_matches_jax(n, half):
    x = (np.random.default_rng(n + 2).standard_normal((4, n))
         .astype(np.float32))
    g = np.fft.rfft(x, axis=-1)
    re = g.real.astype(np.float32)
    im = g.imag.astype(np.float32)
    jy = np.asarray(jfft.irfft_packed(
        jfft.pack_spectra(jnp.asarray(re), jnp.asarray(im), n), n,
        interpret=True, half=half))
    ty = tfft.irfft_packed(*tfft.pack_spectra(torch.from_numpy(re),
                                              torch.from_numpy(im), n),
                           n, half=half).numpy()
    assert jy.shape == ty.shape
    assert _snr(jy, ty) >= 95.0


def test_pack_unpack_roundtrip_and_layout():
    n = 256
    m = n // 2
    rng = np.random.default_rng(5)
    re = torch.from_numpy(rng.standard_normal((3, m + 1)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((3, m + 1)).astype(np.float32))
    im[:, 0] = 0.0
    im[:, -1] = 0.0
    pre, pim = tfft.pack_spectra(re, im, n)
    assert pre.shape == (3, m)
    rev = tfft.bitrev(m)
    assert np.array_equal(rev[rev], np.arange(m))
    np.testing.assert_array_equal(pre[:, 5].numpy(), re[:, rev[5]].numpy())
    np.testing.assert_array_equal(pim[:, 0].numpy(), re[:, m].numpy())
    ure, uim = tfft.unpack_spectra(pre, pim, n)
    np.testing.assert_array_equal(ure.numpy(), re.numpy())
    np.testing.assert_array_equal(uim.numpy(), im.numpy())


def test_mul_packed_is_linear_convolution():
    """Zero-padded product in the packed domain, first-half inverse =
    linear convolution (the EQ's zero-state path)."""
    n, b = 1024, 512
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, b)).astype(np.float32)
    h = rng.standard_normal(b).astype(np.float32) * 0.1
    xr, xi = tfft.rfft_packed_zeropad(torch.from_numpy(x))
    hr, hi = tfft.rfft_packed_zeropad(torch.from_numpy(h[None]))
    y = tfft.irfft_packed(*tfft.mul_packed(xr, xi, hr, hi), n, "first")
    ref = np.stack([np.convolve(r.astype(np.float64), h)[:b] for r in x])
    assert _snr(ref, y.numpy()) >= 110.0


def test_wrapper_rejects_other_devices():
    x = torch.zeros(2, 256, device="meta")
    with pytest.raises(ValueError):
        tfft.rfft_packed(x)
