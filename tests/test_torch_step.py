"""The slice ``FilterConvChain.step`` / ``bulk_step`` of the port against
the JAX package on the CPU: its linear modules (multi-block
``cascade_block_fused``, ``cascade_seq_fused``, the state-basis maps,
``fdl_step``/``fdl_process`` on every branch, ``ols_bulk_process``), the
device dispatch of ``cplx`` on CPU tensors, and the whole chain over
several calls from the same state (carried across by
lsp_dsp_units_tpu_torch.convert).  Inputs are float32 numpy arrays from
fixed seeds.  Bar: >= 100 dB (the ``step_ring`` bar of
tests/test_torch_chain.py), against the float64 ideal no worse than the
JAX package minus 1 dB."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benchmarks.chain_golden64 import golden_chain_f64
from lsp_dsp_units_tpu import pipeline as jpipe
from lsp_dsp_units_tpu.models.filters.design import design_filter
from lsp_dsp_units_tpu.ops import biquad_block as jbb
from lsp_dsp_units_tpu.ops import fftconv as jfc

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch import pipeline as tpipe
from lsp_dsp_units_tpu_torch.entry import entry
from lsp_dsp_units_tpu_torch.ops import biquad_block as tbb
from lsp_dsp_units_tpu_torch.ops import cplx
from lsp_dsp_units_tpu_torch.ops import fftconv as tfc

BAR_DB = 100.0


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _eq(sr=48000):
    return np.concatenate([design_filter(p, sr).biquads
                           for p in jpipe.default_eq_params(sr)], axis=0)


def _ir(taps, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(taps)
            * np.exp(-np.arange(taps) / (taps / 4))).astype(np.float32)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_cascade_block_fused_multiblock_matches_jax(m):
    c, b = 3, 128
    eq = _eq()
    jp, tp = jbb.precompute_fused(eq, b), tbb.precompute_fused(
        eq, b, device="cpu")
    rng = np.random.default_rng(40 + m)
    jst = jbb.init_state(eq.shape[0], (c,))
    tst = tbb.init_state(eq.shape[0], (c,), "cpu")
    for k in range(3):
        x = (rng.standard_normal((c, m * b)) * 0.25).astype(np.float32)
        jy, jst = jbb.cascade_block_fused(jp, jst, jnp.asarray(x))
        ty, tst = tbb.cascade_block_fused(tp, tst, _t(x))
        assert _snr(jy, ty) >= BAR_DB, k
        assert _snr(jst, tst) >= BAR_DB, k


def test_cascade_seq_fused_and_basis_maps_match_jax():
    c, b = 2, 64
    eq = _eq()
    jp, tp = jbb.precompute_fused(eq, b), tbb.precompute_fused(
        eq, b, device="cpu")
    rng = np.random.default_rng(44)
    s0 = (rng.standard_normal((c, eq.shape[0], 2)) * 0.1).astype(np.float32)
    for fn in ("state_to_fused", "state_from_fused"):
        j = getattr(jbb, fn)(jp, jnp.asarray(s0))
        t = getattr(tbb, fn)(tp, _t(s0))
        assert _snr(j, t) >= BAR_DB, fn
    x = (rng.standard_normal((c, 37)) * 0.25).astype(np.float32)
    jy, js = jbb.cascade_seq_fused(jp, jnp.asarray(s0), jnp.asarray(x))
    ty, ts = tbb.cascade_seq_fused(tp, _t(s0), _t(x))
    assert _snr(jy, ty) >= BAR_DB and _snr(js, ts) >= BAR_DB
    # a remainder chunk continues a block stream in the same basis
    xb = (rng.standard_normal((c, 2 * b)) * 0.25).astype(np.float32)
    yb, sb = tbb.cascade_block_fused(tp, ts, _t(xb))
    ys, ss = tbb.cascade_seq_fused(tp, ts, _t(xb))
    assert _snr(yb, ys) >= BAR_DB and _snr(sb, ss) >= BAR_DB


@pytest.mark.parametrize("m", [1, 3, 8])
def test_fdl_process_matches_jax(m):
    """m = 1 (fdl_step), m < P (new state keeps old spectra) and m >= P
    (new state from this call's frames alone); P = 6."""
    c, b = 3, 128
    ir = _ir(6 * b - 5, 50)
    jh = jfc.parse_ir(jnp.asarray(ir), b)
    th = tfc.parse_ir(_t(ir), b)
    assert th.re.shape == (6, b + 1)
    jst, tst = jfc.init_fdl(jh, (c,)), tfc.init_fdl(th, (c,), "cpu")
    rng = np.random.default_rng(50 + m)
    for k in range(3):
        x = (rng.standard_normal((c, m * b)) * 0.25).astype(np.float32)
        jst, jy = jfc.fdl_process(jh, jst, jnp.asarray(x))
        tst, ty = tfc.fdl_process(th, tst, _t(x))
        assert _snr(jy, ty) >= BAR_DB, k
        assert _snr(jst.spec_re, tst.spec_re) >= BAR_DB, k
        assert _snr(jst.spec_im, tst.spec_im) >= BAR_DB, k
        np.testing.assert_array_equal(tst.history.numpy(),
                                      np.asarray(jst.history))
    # the convolution is exact: against numpy's linear convolution
    gold = np.stack([np.convolve(r.astype(np.float64), ir)[:m * b]
                     for r in x])
    _, y = tfc.fdl_process(th, tfc.init_fdl(th, (c,), "cpu"), _t(x))
    assert _snr(gold, y) >= BAR_DB


def test_fdl_step_matches_jax():
    c, b = 2, 128
    ir = _ir(3 * b, 51)
    jh, th = jfc.parse_ir(jnp.asarray(ir), b), tfc.parse_ir(_t(ir), b)
    jst, tst = jfc.init_fdl(jh, (c,)), tfc.init_fdl(th, (c,), "cpu")
    rng = np.random.default_rng(52)
    for k in range(4):
        x = (rng.standard_normal((c, b)) * 0.25).astype(np.float32)
        jst, jy = jfc.fdl_step(jh, jst, jnp.asarray(x))
        tst, ty = tfc.fdl_step(th, tst, _t(x))
        assert _snr(jy, ty) >= BAR_DB, k
        assert _snr(jst.spec_re, tst.spec_re) >= BAR_DB, k


def test_ols_bulk_process_matches_jax():
    c, t = 3, 512
    ir = _ir(t + 1, 53)
    jh = jfc.ols_bulk_spectra(jnp.asarray(ir), t)
    th = tfc.ols_bulk_spectra(_t(ir), t)
    assert _snr(jh.re, th.re) >= BAR_DB
    jst, tst = jfc.init_ols_bulk(t, (c,)), tfc.init_ols_bulk(t, (c,), "cpu")
    rng = np.random.default_rng(54)
    for k in range(3):
        x = (rng.standard_normal((c, t)) * 0.25).astype(np.float32)
        jst, jy = jfc.ols_bulk_process(jh, jst, jnp.asarray(x))
        tst, ty = tfc.ols_bulk_process(th, tst, _t(x))
        assert _snr(jy, ty) >= BAR_DB, k
    with pytest.raises(ValueError, match="t_super"):
        tfc.ols_bulk_spectra(_t(_ir(t + 2, 55)), t)


def test_cplx_halves_on_cpu():
    """CPU tensors keep torch.fft; ``half=`` returns that half of the
    inverse."""
    rng = np.random.default_rng(56)
    x = _t(rng.standard_normal((2, 3, 256)))
    re, im = cplx.rfft_sc(x)
    full = cplx.irfft_sc((re, im), 256)
    torch.testing.assert_close(full, x, rtol=0, atol=1e-5)
    torch.testing.assert_close(cplx.irfft_sc((re, im), 256, half="first"),
                               full[..., :128], rtol=0, atol=0)
    torch.testing.assert_close(cplx.irfft_sc((re, im), 256, half="last"),
                               full[..., 128:], rtol=0, atol=0)
    pre, pim = cplx.rfft_sc(x[..., :128], 256)      # zero-padded input
    ref = torch.fft.rfft(x[..., :128], n=256)
    torch.testing.assert_close(pre, ref.real, rtol=0, atol=0)
    torch.testing.assert_close(pim, ref.imag, rtol=0, atol=0)


def _chains(rank, c):
    jchain = jpipe.FilterConvChain(48000, c, rank=rank, ir_seconds=0.05)
    tchain = tpipe.FilterConvChain(48000, c, rank=rank, ir_seconds=0.05,
                                   device="cpu")
    jp = jchain.build()
    return jchain, tchain, jp, convert.params_from_jax(_np_tree(jp),
                                                      device="cpu")


@pytest.mark.parametrize("rank", [9, 11])
def test_step_matches_jax(rank):
    """Three calls of two blocks each from a state the JAX chain has
    warmed up, then carried over by convert.state_from_jax."""
    c = 4
    jchain, tchain, jp, tp = _chains(rank, c)
    b = jchain.block
    rng = np.random.default_rng(60 + rank)
    xs = [(rng.standard_normal((c, 2 * b)) * 0.25 * (1 + k % 3)).astype(
        np.float32) for k in range(4)]
    jst = jchain.init_state(jp)
    jst, _ = jchain.step(jp, jst, jnp.asarray(xs[0]))
    tst = convert.state_from_jax(_np_tree(jst), device="cpu")
    own = tchain.init_state(tp)
    for a, b_ in zip(jax.tree_util.tree_leaves(_np_tree(jchain.init_state(
            jp))), (own.eq, *own.fdl, *own.sc, *own.env)):
        assert tuple(b_.shape) == a.shape
    gold = golden_chain_f64(tchain, tp, [x[:, i * b:(i + 1) * b]
                                         for x in xs for i in range(2)])
    for k, x in enumerate(xs[1:], start=1):
        jst, jy = jchain.step(jp, jst, jnp.asarray(x))
        tst, ty = tchain.step(tp, tst, _t(x))
        assert ty.shape == (c, 2 * b) and ty.dtype == torch.float32
        assert _snr(jy, ty) >= BAR_DB, k
        g = np.concatenate(gold[2 * k:2 * k + 2], axis=-1)
        assert _snr(g, ty) >= _snr(g, jy) - 1.0, k
    assert _snr(jst.fdl.spec_re, tst.fdl.spec_re) >= BAR_DB
    np.testing.assert_array_equal(tst.env.hold.numpy(),
                                  np.asarray(jst.env.hold))


def test_bulk_step_matches_jax():
    """Two super-blocks of eight blocks at rank 10 (the 0.05 s IR's 2400
    taps fit one super-block of 4096)."""
    c, rank, t_super = 4, 10, 4096
    jchain, tchain, jp, tp = _chains(rank, c)
    jh = jchain.build_bulk(t_super)
    th = tchain.build_bulk(t_super)
    assert _snr(jh.re, th.re) >= BAR_DB
    jst = jchain.init_bulk_state(jp, t_super)
    tst = convert.bulk_state_from_jax(_np_tree(jst), device="cpu")
    rng = np.random.default_rng(70)
    for k in range(2):
        x = (rng.standard_normal((c, t_super)) * 0.25).astype(np.float32)
        jst, jy = jchain.bulk_step(jp, jh, jst, jnp.asarray(x))
        tst, ty = tchain.bulk_step(tp, th, tst, _t(x))
        assert _snr(jy, ty) >= BAR_DB, k
    assert _snr(jst.conv.history, tst.conv.history) >= BAR_DB
    with pytest.raises(ValueError, match="multiple"):
        tchain.build_bulk(t_super + 1)


def test_step_rejects_partial_blocks():
    tchain = tpipe.FilterConvChain(48000, 2, rank=9, ir_seconds=0.01,
                                   device="cpu")
    tp = tchain.build()
    with pytest.raises(ValueError, match="multiple"):
        tchain.step(tp, tchain.init_state(tp), torch.zeros(2, 300))


def test_entry_runs_and_matches_jax():
    import __graft_entry__ as graft
    fn, (params, state, x) = entry("cpu")
    assert x.shape == (4, 512) and x.device.type == "cpu"
    _, y = fn(params, state, x)
    assert y.shape == (4, 512) and bool(torch.isfinite(y).all())
    jfn, (jp, jst, _) = graft.entry()
    rng = np.random.default_rng(80)
    xr = (rng.standard_normal((4, 512)) * 0.25).astype(np.float32)
    _, jy = jfn(jp, jst, jnp.asarray(xr))
    _, ty = fn(params, state, _t(xr))       # step leaves its input state
    assert _snr(jy, ty) >= BAR_DB
