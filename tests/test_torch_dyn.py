"""Port's dynamics tail against the JAX package: the plain version of
the fused kernel (ops/env.py) against ``chain_dyn_pallas`` in interpret
mode (>= 110 dB on y; window and envelope to rtol 1e-5; hold exact),
and the staged units (sliding_sum, peak_envelope, Sidechain,
Compressor) against their JAX counterparts (the CUDA kernel against
the plain version: tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsp_dsp_units_tpu.ops import dynamics as jdyn
from lsp_dsp_units_tpu.ops.pallas_env import chain_dyn_pallas
from lsp_dsp_units_tpu.ops.sliding import sliding_sum as jsliding
from lsp_dsp_units_tpu.models.dynamics.compressor import (
    Compressor as JCompressor)
from lsp_dsp_units_tpu.models.util.sidechain import (
    Sidechain as JSidechain, SidechainMode as JSCMode)

from lsp_dsp_units_tpu_torch.ops import dynamics as tdyn
from lsp_dsp_units_tpu_torch.ops.env import chain_dyn, chain_dyn_plain
from lsp_dsp_units_tpu_torch.ops.sliding import sliding_sum as tsliding
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (
    Compressor as TCompressor)
from lsp_dsp_units_tpu_torch.models.util.sidechain import (
    Sidechain as TSidechain, SidechainMode as TSCMode)

SR = 48000
COMP_KW = dict(attack_thresh=0.25, release_thresh=0.125, attack_ms=2.0,
               release_ms=10.0, knee=0.7071, ratio=4.0)


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def test_chain_dyn_plain_matches_jax_pallas():
    c, t = 4, 512
    jsc = JSidechain(SR, JSCMode.RMS, reactivity_ms=2.0 / 3.0)
    n = jsc.reactivity
    assert n == 32
    jcp = JCompressor(SR, **COMP_KW).build()
    tcp = TCompressor(SR, **COMP_KW).build()
    jwin = jsc.init_state((c,)).window
    jenv = jdyn.env_init((c,))
    twin = torch.zeros(c, n)
    tenv = tdyn.env_init((c,), "cpu")
    rng = np.random.default_rng(3)
    for k in range(4):
        x = (rng.standard_normal((c, t)) * 0.5).astype(np.float32)
        jwin, jenv, jy = chain_dyn_pallas(
            jwin, jenv, jnp.asarray(x), n, jsc.gain, jcp.tau_attack,
            jcp.tau_release, jcp.release_thresh, jcp.hold, jcp.knees,
            interpret=True)
        twin, tenv, ty = chain_dyn(
            twin, tenv, torch.from_numpy(x), n, jsc.gain, tcp.tau_attack,
            tcp.tau_release, tcp.release_thresh, tcp.hold, tcp.knees)
        assert _snr(jy, ty) >= 110.0, k
        np.testing.assert_allclose(twin.numpy(), np.asarray(jwin),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tenv.envelope.numpy(),
                                   np.asarray(jenv.envelope), rtol=1e-5)
        np.testing.assert_allclose(tenv.peak.numpy(),
                                   np.asarray(jenv.peak), rtol=1e-5)
        np.testing.assert_array_equal(tenv.hold.numpy(),
                                      np.asarray(jenv.hold))


def test_sidechain_and_compressor_match_jax():
    c, t = 3, 640
    jsc = JSidechain(SR, JSCMode.RMS, reactivity_ms=1.0)
    tsc = TSidechain(SR, TSCMode.RMS, reactivity_ms=1.0)
    kw = dict(COMP_KW, hold_ms=0.5)
    jc, tc = JCompressor(SR, **kw), TCompressor(SR, **kw)
    jcp, tcp = jc.build(), tc.build()
    assert tcp.hold == 24
    js, ts = jsc.init_state((c,)), tsc.init_state((c,), "cpu")
    je, te = jc.init_state((c,)), tc.init_state((c,), "cpu")
    rng = np.random.default_rng(4)
    for k in range(3):
        x = (rng.standard_normal((c, t)) * 0.5).astype(np.float32)
        js, jl = jsc.process(js, jnp.asarray(x))
        ts, tl = tsc.process(ts, torch.from_numpy(x))
        assert _snr(jl, tl) >= 120.0, k
        je, jg, jenv = jc.process(jcp, je, jl)
        te, tg, tenv = tc.process(tcp, te, torch.tensor(
            np.asarray(jl, np.float32)))
        assert _snr(jenv, tenv) >= 120.0, k
        assert _snr(jg, tg) >= 120.0, k
        np.testing.assert_array_equal(te.hold.numpy(), np.asarray(je.hold))


@pytest.mark.parametrize("length", [200, 1000])
def test_sliding_sum_matches_jax(length):
    n = 37
    frame = np.random.default_rng(length).random((2, length)).astype(
        np.float32)
    j = np.asarray(jsliding(jnp.asarray(frame), n, length - n))
    t = tsliding(torch.from_numpy(frame), n, length - n).numpy()
    # both difference float32 prefix sums, accumulated in another order:
    # a few ulps of the largest prefix
    tol = 4 * np.finfo(np.float32).eps * frame.sum(-1).max()
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)


def test_peak_envelope_gate_form_matches_jax():
    x = np.abs(np.random.default_rng(5).standard_normal((2, 300))).astype(
        np.float32)
    js, je = jdyn.peak_envelope(jdyn.env_init((2,)), jnp.asarray(x), 0.3,
                                0.01, 7, None)
    ts, tenv = tdyn.peak_envelope(tdyn.env_init((2,), "cpu"),
                                  torch.from_numpy(x),
                                  0.3, 0.01, 7, None)
    np.testing.assert_allclose(tenv.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_array_equal(ts.hold.numpy(), np.asarray(js.hold))
