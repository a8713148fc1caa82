"""Port's EQ + ring-FDL linear path against the JAX package: the plain
version of the fused kernel (ops/fdl_fused.py) streamed over P + 3
blocks against ``eqfdl_fused_pallas`` in interpret mode, and the staged
plain units (cascade_block_fused, fdl_ring_step, parse_ir) against their
JAX counterparts.  Bars: y and u >= 95 dB (the packed FFT's contract);
the rings agree to the same bar after each is unpacked to natural order
(the CUDA kernel against the plain version: tests/test_torch_cuda.py).
The backward kernels' bytes bounds (``tools/launch_profile.py``) count
each input and output of the function once."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsp_dsp_units_tpu.models.filters.design import design_filter
from lsp_dsp_units_tpu.ops import biquad_block as jbb
from lsp_dsp_units_tpu.ops import fftconv as jfc
from lsp_dsp_units_tpu.ops import pallas_fft as jfft
from lsp_dsp_units_tpu.ops.pallas_fdl_fused import eqfdl_fused_pallas
from lsp_dsp_units_tpu.pipeline import default_eq_params

from lsp_dsp_units_tpu_torch.ops import biquad_block as tbb
from lsp_dsp_units_tpu_torch.ops import fft_packed as tfft
from lsp_dsp_units_tpu_torch.ops import fftconv as tfc
from lsp_dsp_units_tpu_torch.ops.fdl_fused import (eqfdl_fused,
                                                   eqfdl_fused_plain)
from lsp_dsp_units_tpu_torch.tools.launch_profile import launch_bytes


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _eq(bands=4, sr=48000):
    return np.concatenate([design_filter(p, sr).biquads
                           for p in default_eq_params(sr)[:bands]], axis=0)


def _ir(b, seed=9):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(3 * b - 17).astype(np.float32) * 0.1


def test_eqfdl_plain_matches_jax_pallas():
    c, b = 8, 2048
    nfft = 2 * b
    eq = _eq()
    jeq = jbb.precompute_fused(eq, b)
    teq = tbb.precompute_fused(eq, b, device="cpu")
    ir = _ir(b)
    jh = jfc.parse_ir(jnp.asarray(ir), b)
    th = tfc.parse_ir(torch.from_numpy(ir), b)
    p_n = jh.re.shape[-2]
    k2 = jeq.m_mat.shape[0]
    jheq = jfft.pack_spectra(jeq.h_re, jeq.h_im, nfft)
    jhp = jfft.pack_spectra(jh.re, jh.im, nfft)
    theq = tfft.pack_spectra(teq.h_re, teq.h_im, nfft)
    thp = tfft.pack_spectra(th.re, th.im, nfft)

    jst = jfc.init_ring_fdl(jh, (c,), packed=True)
    jsv = jnp.zeros((c, k2), jnp.float32)
    tst = tfc.init_ring_fdl(th, (c,), packed=True, device="cpu")
    tsv = torch.zeros(c, k2)
    rng = np.random.default_rng(10)
    for k in range(p_n + 3):
        x = (rng.standard_normal((c, b)) * 0.25).astype(np.float32)
        corr = jnp.einsum("bk,ck->cb", jeq.g_mat, jsv,
                          precision="highest")
        w = (int(jst.pos) + 1) % p_n
        rot = (w - jnp.arange(p_n)) % p_n
        jy, ju, jre, jim = eqfdl_fused_pallas(
            jst.spec_re, jst.spec_im, jnp.take(jhp[0], rot, axis=0),
            jnp.take(jhp[1], rot, axis=0), jheq[0], jheq[1],
            jnp.asarray(x), corr, jst.history, jnp.int32(w), nfft,
            interpret=True)
        jsv = (jnp.einsum("kj,cj->ck", jeq.m_mat, jsv, precision="highest")
               + jnp.einsum("kb,cb->ck", jeq.w_mat, jnp.asarray(x),
                            precision="highest"))
        jst = jfc.RingFDLState(jre, jim, ju, jnp.int32(w))

        xt = torch.from_numpy(x)
        xs = tfft.rfft_packed_zeropad(xt)
        assert tst.pos == (w - 1) % p_n
        ty, tu, tsv, _, _ = eqfdl_fused(
            tst.spec_re, tst.spec_im, thp[0], thp[1], theq[0], theq[1],
            xs[0], xs[1], xt, tsv, teq.g_t, teq.m_mat, teq.w_mat,
            tst.history, w)
        tst = tst._replace(history=tu, pos=w)

        assert _snr(ju, tu) >= 95.0, (k, "u")
        assert _snr(jy, ty) >= 95.0, (k, "y")
        assert _snr(jsv, tsv) >= 95.0, (k, "sv")
    for p in range(p_n):
        jn = jfft.unpack_spectra(jst.spec_re[p], jst.spec_im[p], nfft)
        tn = tfft.unpack_spectra(tst.spec_re[p], tst.spec_im[p], nfft)
        assert _snr(jn[0], tn[0]) >= 95.0 and _snr(jn[1], tn[1]) >= 95.0


def test_eqfdl_plain_matches_port_staged():
    """Fused plain form == staged plain units (cascade_block_fused +
    natural-order fdl_ring_step), as the JAX package's own
    test_eqfdl_fused_matches_staged holds its kernel."""
    c, b = 4, 512
    eq = _eq(8)
    teq = tbb.precompute_fused(eq, b, device="cpu")
    th = tfc.parse_ir(torch.from_numpy(_ir(b, 11)), b)
    p_n = th.re.shape[-2]
    heq = tfft.pack_spectra(teq.h_re, teq.h_im, 2 * b)
    hp = tfft.pack_spectra(th.re, th.im, 2 * b)
    k2 = teq.m_mat.shape[0]
    ring = tfc.init_ring_fdl(th, (c,), packed=True, device="cpu")
    nat = tfc.init_ring_fdl(th, (c,), packed=False, device="cpu")
    sv = torch.zeros(c, k2)
    eq_st = tbb.init_state(k2 // 2, (c,), "cpu")
    rng = np.random.default_rng(12)
    for k in range(p_n + 2):
        x = torch.from_numpy((rng.standard_normal((c, b)) * 0.25)
                             .astype(np.float32))
        u_ref, eq_st = tbb.cascade_block_fused(teq, eq_st, x)
        nat, y_ref = tfc.fdl_ring_step(th, nat, u_ref)
        w = (ring.pos + 1) % p_n
        y, u, sv = eqfdl_fused_plain(
            ring.spec_re, ring.spec_im, hp[0], hp[1], heq[0], heq[1],
            *tfft.rfft_packed_zeropad(x), x, sv, teq.g_t, teq.m_mat,
            teq.w_mat, ring.history, w)
        ring = ring._replace(history=u, pos=w)
        assert _snr(u_ref, u) >= 110.0 and _snr(y_ref, y) >= 110.0, k
        np.testing.assert_allclose(sv.numpy(),
                                   eq_st.reshape(c, k2).numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_cascade_block_fused_matches_jax():
    c, b = 3, 256
    eq = _eq(8)
    jp = jbb.precompute_fused(eq, b)
    tp = tbb.precompute_fused(eq, b, device="cpu")
    rng = np.random.default_rng(13)
    jst = jbb.init_state(eq.shape[0], (c,))
    tst = tbb.init_state(eq.shape[0], (c,), "cpu")
    for k in range(3):
        x = (rng.standard_normal((c, 2 * b)) * 0.25).astype(np.float32)
        jy, jst = jbb.cascade_block_fused(jp, jst, jnp.asarray(x))
        ty, tst = tbb.cascade_block_fused(tp, tst, torch.from_numpy(x))
        assert _snr(jy, ty) >= 110.0, k
        assert _snr(jst, tst) >= 110.0, k


def test_fdl_ring_step_natural_matches_jax():
    c, b = 3, 256
    ir = _ir(b, 14)
    jh = jfc.parse_ir(jnp.asarray(ir), b)
    th = tfc.parse_ir(torch.from_numpy(ir), b)
    assert _snr(jh.re, th.re) >= 120.0 and _snr(jh.im, th.im) >= 120.0
    jst = jfc.init_ring_fdl(jh, (c,))
    tst = tfc.init_ring_fdl(th, (c,), packed=False, device="cpu")
    rng = np.random.default_rng(15)
    for k in range(jh.re.shape[0] + 2):
        x = (rng.standard_normal((c, b)) * 0.25).astype(np.float32)
        jst, jy = jfc.fdl_ring_step(jh, jst, jnp.asarray(x))
        tst, ty = tfc.fdl_ring_step(th, tst, torch.from_numpy(x))
        assert int(jst.pos) == tst.pos
        assert _snr(jy, ty) >= 110.0, k
    assert _snr(jst.spec_re, tst.spec_re) >= 110.0


# the EQ adjoint's arguments at C channels, M = B packed positions and
# 2K = k2: inputs, then outputs
def _eq_adjoint_shapes(c, b, k2):
    ins = [(c, b)] * 6 + [(b,)] * 2 + [(c, k2), (k2, b), (k2, k2), (k2, b),
                                       (c, k2)]
    outs = [(c, b)] * 3 + [(b,)] * 2 + [(k2, b), (k2, k2), (k2, b), (c, k2)]
    return ins + outs


@pytest.mark.parametrize("c,b,p_n,k2", [(64, 8192, 6, 18), (13, 128, 1, 4),
                                        (65, 2048, 3, 40)])
def test_launch_bytes_count_each_input_and_output_once(c, b, p_n, k2):
    """The backward launches' bytes bounds: the EQ adjoint's two launches
    together move its 13 inputs and 9 outputs once (not the scratch
    between them), fdl_bwd its 7 inputs and 7 outputs; another build's
    launch has no count."""
    def nbytes(shapes):
        return 4 * sum(int(np.prod(s)) for s in shapes)
    assert (launch_bytes(f"eqfdl_bwd<{max(k2, 18)}>", c, b, p_n, k2)
            + launch_bytes("eqfdl_bwd_sums", c, b, p_n, k2)
            == nbytes(_eq_adjoint_shapes(c, b, k2)))
    ring, s, h = (p_n, c, b), (c, b), (p_n, b)
    assert launch_bytes("fdl_bwd", c, b, p_n, k2) == nbytes(
        [ring] * 4 + [s] * 2 + [h] * 2 + [ring] * 2 + [h] * 2 + [s] * 2)
    assert launch_bytes("eqfdl_bwd_mats", c, b, p_n, k2) is None


@pytest.mark.parametrize("c,b", [(64, 8192), (13, 128)])
def test_launch_bytes_of_the_frame_kernel(c, b):
    """The frame kernel's bytes bounds: the EQ route's form reads S's
    cotangent (2 planes) and u's, writes hist's, g_ut and g_ut's spectra
    (2); the convolver route's reads S's and writes hist's and x's."""
    plane = 4 * c * b
    assert launch_bytes("frame_bwd_kernel<true>", c, b, 6, 18) == 7 * plane
    assert launch_bytes("frame_bwd_kernel<false>", c, b, 6, 18) == 4 * plane
