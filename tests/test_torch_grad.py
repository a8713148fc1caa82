"""Gradients through the port against jax.grad on the CPU.

The JAX package pins differentiability in tests/test_differentiable.py
(a biquad stage fitted by Adam, jax.grad through ``FilterConvChain.step``
and through the Compressor's parameters).  Here the port's gradients are
held against ``jax.grad`` of the same JAX functions on the same float32
inputs, made with ``numpy.random.default_rng``: the chain's at a quiet
input (the JAX test's, where the compressor never engages) and a loud one
(where it does), two calls of ``step`` with the state carried, the
Compressor's 20 parameter leaves, and each ``torch.autograd.Function``'s
plain backward alone (``sliding_rms``, ``peak_envelope``, the packed
FFTs, ``biquad_cascade``; ``torch.autograd.gradcheck`` where the plain
route takes float64).  Bar: >= 100 dB against jax.grad (float32
gradients formed in another order), exact zeros where JAX's are zero;
gradcheck at its default tolerances in float64.  Routes without a
backward must raise under grad, and no wrapper's forward output may move
when nothing requires grad.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsp_dsp_units_tpu import pipeline as jpipe
from lsp_dsp_units_tpu.models.dynamics.compressor import Compressor as JComp
from lsp_dsp_units_tpu.models.util.sidechain import (
    Sidechain as JSidechain, SidechainMode as JMode)
from lsp_dsp_units_tpu.ops import biquad as jbq
from lsp_dsp_units_tpu.ops import dynamics as jdyn

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch import pipeline as tpipe
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (
    Compressor as TComp)
from lsp_dsp_units_tpu_torch.models.filters import (Filter, FilterParams,
                                                    FilterType)
from lsp_dsp_units_tpu_torch.ops import biquad as tbq
from lsp_dsp_units_tpu_torch.ops import dynamics as tdyn
from lsp_dsp_units_tpu_torch.ops import env_units as eu
from lsp_dsp_units_tpu_torch.ops import fft_packed as tfp
from lsp_dsp_units_tpu_torch.ops import limiter as tlim
from lsp_dsp_units_tpu_torch.ops import riders as trd
from lsp_dsp_units_tpu_torch.ops import env as tenv
from lsp_dsp_units_tpu_torch.ops import fdl_fused as tfdl
from lsp_dsp_units_tpu_torch.ops.env import chain_dyn
from lsp_dsp_units_tpu_torch.ops.fdl_fused import eqfdl_fused, fdl_fused
from lsp_dsp_units_tpu_torch.ops.ring_mac import ring_mac
from lsp_dsp_units_tpu_torch.ops.slicedma import batched_slice
from lsp_dsp_units_tpu_torch.parallel import mesh as pmesh
from lsp_dsp_units_tpu_torch.utils import tree

SR = 48000
BAR_DB = 100.0


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _grad(t):
    return np.zeros(t.shape) if t.grad is None else t.grad.numpy()


def _chains():
    jc = jpipe.FilterConvChain(SR, channels=4, rank=9, ir_seconds=0.02)
    jp = jc.build()
    tc = tpipe.FilterConvChain(SR, channels=4, rank=9, ir_seconds=0.02,
                               device="cpu")
    return jc, jp, tc, convert.params_from_jax(_np_tree(jp), device="cpu")


# ---------------------------------------------------------------------------
# tests/test_differentiable.py's three cases
# ---------------------------------------------------------------------------


def _mag_response(coeffs, n=512):
    """The port's twin of the JAX test's magnitude response: the
    cascade's impulse response through biquad_cascade (its autograd
    Function), then |rfft|."""
    imp = torch.zeros(n)
    imp[0] = 1.0
    y, _ = tbq.biquad_cascade(coeffs, tbq.init_state(coeffs.shape[0],
                                                     device="cpu"), imp)
    s = torch.fft.rfft(y)
    return torch.sqrt(s.real * s.real + s.imag * s.imag + 1e-12)


def test_gradient_fit_biquad_to_target_response():
    """One raw biquad stage fitted by torch.optim.Adam(lr=3e-2) to a
    designed peaking filter's magnitude response in 1000 steps, at the
    JAX test's own bars: the loss falls more than 1000x and the fit sits
    within 0.2 dB of the target in band."""
    target = _mag_response(Filter(SR, FilterParams(
        ftype=FilterType.DR_APO_PEAKING, freq=3000.0, gain=2.0,
        quality=2.0)).coefficients(device="cpu"))

    def loss_fn(c):
        return torch.mean((torch.log(_mag_response(c))
                           - torch.log(target)) ** 2)

    c = torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0]], requires_grad=True)
    opt = torch.optim.Adam([c], lr=3e-2)
    with torch.no_grad():
        l0 = float(loss_fn(c))
    for _ in range(1000):
        opt.zero_grad()
        loss = loss_fn(c)
        loss.backward()
        opt.step()
    with torch.no_grad():
        l1 = float(loss_fn(c))
        fitted = _mag_response(c).numpy()
    assert np.isfinite(l1) and l1 < l0 / 1000, (l0, l1)
    tgt = target.numpy()
    band = slice(4, 200)
    err_db = 20 * np.abs(np.log10(fitted[band]) - np.log10(tgt[band]))
    assert err_db.max() < 0.2, err_db.max()


@pytest.mark.parametrize("amp", [0.25, 2.0])
def test_chain_gradient_matches_jax(amp):
    """d sum(y^2) / dx through one ``step``: at 0.25 (the JAX test's
    input, the compressor idle) and at 2.0, where the compressor engages
    and the envelope's gradient must flow (it was cut before, 2.1 dB
    from JAX)."""
    jc, jp, tc, tp = _chains()
    js = jc.init_state(jp)
    ts = tc.init_state(tp)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, jc.block)) * amp).astype(np.float32)

    def energy(xin):
        _, y = jc.step(jp, js, xin)
        return jnp.sum(y * y)

    jg = np.asarray(jax.jit(jax.grad(energy))(jnp.asarray(x)))
    xt = _t(x, grad=True)
    st, y = tc.step(tp, ts, xt)
    torch.sum(y * y).backward()
    engaged = float(torch.mean((st.env.envelope > tp.comp.knees[0].start)
                               .float()))
    assert (engaged > 0) == (amp > 1.0), engaged
    assert np.all(np.isfinite(_grad(xt)))
    assert _snr(jg, _grad(xt)) >= BAR_DB


def test_chain_two_calls_gradient_matches_jax():
    """Two ``step`` calls with the state carried, loss the sum of both
    outputs squared: the gradient w.r.t. the first call's x flows through
    the carried EQ, FDL, sidechain window and envelope; so does the
    gradient w.r.t. the incoming state's float leaves (a non-zero state
    from a warm-up call; zero leaves where JAX's are zero: the
    sidechain's unused accumulator and the peak, which only steers
    branches)."""
    jc, jp, tc, tp = _chains()
    rng = np.random.default_rng(11)
    xs = [(rng.standard_normal((4, 2 * jc.block)) * 2.0).astype(np.float32)
          for _ in range(3)]
    js0, _ = jc.step(jp, jc.init_state(jp), jnp.asarray(xs[2]))
    leaves, treedef = jax.tree_util.tree_flatten(js0)
    floats = [i for i, v in enumerate(leaves)
              if jnp.issubdtype(v.dtype, jnp.floating)]

    def energy(x0, x1, fl):
        lv = list(leaves)
        for i, v in zip(floats, fl):
            lv[i] = v
        s, y0 = jc.step(jp, jax.tree_util.tree_unflatten(treedef, lv), x0)
        _, y1 = jc.step(jp, s, x1)
        return jnp.sum(y0 * y0) + jnp.sum(y1 * y1)

    jg0, jg1, jgs = jax.jit(jax.grad(energy, argnums=(0, 1, 2)))(
        *map(jnp.asarray, xs[:2]), [leaves[i] for i in floats])
    ts = convert.state_from_jax(_np_tree(js0), device="cpu")
    tl = tree.tree_flatten(ts)[0]
    for i in floats:
        tl[i].requires_grad_(True)
    x0, x1 = _t(xs[0], grad=True), _t(xs[1], grad=True)
    s, y0 = tc.step(tp, tree.tree_unflatten(tree.tree_flatten(ts)[1], tl),
                    x0)
    _, y1 = tc.step(tp, s, x1)
    (torch.sum(y0 * y0) + torch.sum(y1 * y1)).backward()
    assert _snr(jg0, _grad(x0)) >= BAR_DB
    assert _snr(jg1, _grad(x1)) >= BAR_DB
    paths = [p for p, _ in tree.leaves_with_path(ts)]
    for i, jg in zip(floats, jgs):
        jg, tg = np.asarray(jg), _grad(tl[i])
        if np.any(jg):
            assert _snr(jg, tg) >= BAR_DB, paths[i]
        else:
            assert not np.any(tg), paths[i]


def _loud_input(jc, blocks, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, blocks * jc.block)) * 2.0).astype(
        np.float32)


def _leaf_grads(comp):
    return [float(_grad(v)) for v in tree.tree_flatten(comp)[0]]


def test_bulk_step_gradient_matches_jax_and_step():
    """d sum(y^2) / dx and d / d the compressor's 20 leaves through one
    super-block of ``bulk_step`` (4 blocks, amplitude 2.0, the compressor
    engaged): against jax.grad of the JAX package's ``bulk_step`` and
    against the port's own ``step`` on the same input, >= 100 dB each."""
    jc, jp, tc, tp = _chains()
    x = _loud_input(jc, 4, 13)
    t = x.shape[-1]
    jh = jc.build_bulk(t)
    js = jc.init_bulk_state(jp, t)

    def energy(xin):
        _, y = jc.bulk_step(jp, jh, js, xin)
        return jnp.sum(y * y)

    jg = np.asarray(jax.jit(jax.grad(energy))(jnp.asarray(x)))
    grads = {}
    for route in ("bulk", "step"):
        p = tp._replace(comp=convert.compressor_params_from_jax(
            tp.comp, device="cpu", requires_grad=True))
        xt = _t(x, grad=True)
        if route == "bulk":
            _, y = tc.bulk_step(p, tc.build_bulk(t),
                                tc.init_bulk_state(p, t), xt)
        else:
            _, y = tc.step(p, tc.init_state(p), xt)
        torch.sum(y * y).backward()
        grads[route] = (_grad(xt), _leaf_grads(p.comp))
    (bx, bl), (sx, sl) = grads["bulk"], grads["step"]
    assert np.all(np.isfinite(bx)) and np.any(bl)
    assert _snr(jg, bx) >= BAR_DB
    assert _snr(sx, bx) >= BAR_DB
    for i, (a, b) in enumerate(zip(sl, bl)):
        assert (a == 0.0) == (b == 0.0), i
        if a:
            assert _snr(a, b) >= BAR_DB, (i, a, b)


def test_sharded_step_gradient_matches_step():
    """``sharded_step`` on a world of one (gloo, an in-process store, a
    (1, 1) mesh) at amplitude 2.0, where the compressor engages: d sum(y^2)
    / dx and d / d the compressor's 20 leaves against ``step``'s on the
    same input, >= 100 dB (the time axis's gather once cut the level's
    dependence on x: 78 % off in relative L2, with nothing raised).
    Without grad the sharded forward is bit for bit the one under grad."""
    jc, _, tc, tp = _chains()
    x = _loud_input(jc, 2, 17)
    grads, ys = {}, {}
    pmesh.init_distributed(num_processes=1, process_id=0, platform="cpu")
    try:
        mesh = pmesh.make_mesh(1, 1, "cpu")
        for route in ("sharded", "step"):
            p = tp._replace(comp=convert.compressor_params_from_jax(
                tp.comp, device="cpu", requires_grad=True))
            xt = _t(x, grad=True)
            if route == "sharded":
                fn = tc.sharded_step(mesh, p)
                st = pmesh.chan_sharding(mesh, tc.init_state(p))
                _, y = fn(st, xt)
                with torch.no_grad():
                    _, y_plain = fn(st, _t(x))
                assert torch.equal(y.detach(), y_plain)
            else:
                _, y = tc.step(p, tc.init_state(p), xt)
            torch.sum(y * y).backward()
            grads[route] = (_grad(xt), _leaf_grads(p.comp))
            ys[route] = y.detach().numpy()
    finally:
        torch.distributed.destroy_process_group()
    (hx, hl), (sx, sl) = grads["sharded"], grads["step"]
    assert _snr(ys["step"], ys["sharded"]) >= BAR_DB
    assert np.any(sl)
    assert _snr(sx, hx) >= BAR_DB
    for i, (a, b) in enumerate(zip(sl, hl)):
        assert (a == 0.0) == (b == 0.0), i
        if a:
            assert _snr(a, b) >= BAR_DB, (i, a, b)


@pytest.mark.parametrize("cfg", ["jax_test", "loud", "hold"])
def test_compressor_leaf_gradients_match_jax(cfg):
    """jax.grad w.r.t. all 20 leaves of CompressorParams (the JAX test
    casts each to float32): the JAX test's own quiet input, and a loud
    one through the chain's compressor and through one with a hold of 24
    samples.  Exact zeros where JAX's are zero, each other leaf >= 100
    dB."""
    kw = {"jax_test": {}, "loud": dict(attack_thresh=0.25,
                                       release_thresh=0.125, attack_ms=10.0,
                                       release_ms=80.0),
          "hold": dict(attack_thresh=0.3, release_thresh=0.1,
                       hold_ms=0.5)}[cfg]
    amp = 0.5 if cfg == "jax_test" else 2.0
    ju, tu = JComp(SR, **kw), TComp(SR, **kw)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 2048)) * amp).astype(np.float32)
    leaves, treedef = jax.tree_util.tree_flatten(ju.build())
    st = ju.init_state((2,))

    def out_energy(lv):
        _, y, _ = ju.process(jax.tree_util.tree_unflatten(treedef, lv), st,
                             jnp.asarray(x))
        return jnp.sum(y * y)

    jg = [float(g) for g in jax.jit(jax.grad(out_energy))(
        [jnp.asarray(v, jnp.float32) for v in leaves])]
    tp = convert.compressor_params_from_jax(
        [np.asarray(v) for v in leaves], device="cpu", requires_grad=True)
    tl = tree.tree_flatten(tp)[0]
    assert len(tl) == 20
    _, y, _ = tu.process(tp, tu.init_state((2,), "cpu"), _t(x))
    torch.sum(y * y).backward()
    tg = [float(_grad(v)) for v in tl]
    assert [g == 0.0 for g in jg] == [g == 0.0 for g in tg], (jg, tg)
    assert jg[19] == 0.0 and tg[19] == 0.0          # the hold
    for i, (a, b) in enumerate(zip(jg, tg)):
        if a:
            assert _snr(a, b) >= BAR_DB, (i, a, b)
    if cfg != "jax_test":
        assert tg[16] != 0.0                      # tau_attack moves it


# ---------------------------------------------------------------------------
# each Function's plain backward alone
# ---------------------------------------------------------------------------


def test_sliding_rms_backward_matches_jax():
    """The sidechain's RMS (x -> |x|, the sliding mean of squares over a
    carried window, sqrt) with cotangents on the level and on window':
    the port's plain backward against jax.grad of the JAX Sidechain,
    w.r.t. x and the window."""
    rng = np.random.default_rng(21)
    c, t = 3, 700
    js = JSidechain(SR, JMode.RMS, reactivity_ms=10.0)
    n = js.reactivity
    x = rng.standard_normal((c, t)).astype(np.float32)
    win = (rng.standard_normal((c, n)) ** 2 * 0.1).astype(np.float32)
    wl = rng.standard_normal((c, t)).astype(np.float32)
    ww = rng.standard_normal((c, n)).astype(np.float32)

    def loss(xin, w):
        s, lv = js.process(js.init_state((c,))._replace(window=w), xin)
        return jnp.sum(lv * wl) + jnp.sum(s.window * ww)

    jgx, jgw = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(win)))
    xt, wt = _t(x, grad=True), _t(win, grad=True)
    w_out, lv = eu.sliding_rms(wt, torch.abs(xt), n, 1.0)
    assert lv.grad_fn is not None
    (torch.sum(lv * _t(wl)) + torch.sum(w_out * _t(ww))).backward()
    assert _snr(jgx, _grad(xt)) >= BAR_DB
    assert _snr(jgw, _grad(wt)) >= BAR_DB


@pytest.mark.parametrize("t", [5, 300])
def test_sliding_rms_gradcheck(t):
    """float64 gradcheck of the plain route (T below and above N = 16)."""
    gen = torch.Generator().manual_seed(t)
    x = torch.randn(2, t, dtype=torch.float64, generator=gen)
    w = torch.rand(2, 16, dtype=torch.float64, generator=gen) + 0.1
    x.requires_grad_(True)
    w.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: eu.sliding_rms(b, a, 16, 1.5), (x, w))


@pytest.mark.parametrize("rt,hold", [(None, 0), (0.3, 0), (None, 24),
                                     (0.3, 24)])
def test_peak_envelope_backward_matches_jax(rt, hold):
    """The envelope with the release threshold on and off and a hold of
    0 and 24 samples, from a non-zero state, with cotangents on the
    envelope and on the state's envelope and peak: the port's plain
    backward against jax.grad of the JAX scan, w.r.t. x, the carried
    envelope and peak, and both taus."""
    rng = np.random.default_rng(31 + hold + (rt is not None))
    c, t = 3, 400
    x = np.abs(rng.standard_normal((c, t)) * np.linspace(0.2, 1.5, t)
               ).astype(np.float32)
    e0 = np.array([0.0, 0.4, 1.0], np.float32)
    p0 = np.array([0.0, 0.5, 1.0], np.float32)
    h0 = np.array([0, 3, 0], np.int32)
    ta, tr = np.float32(0.05), np.float32(0.01)
    w = [rng.standard_normal(s).astype(np.float32) for s in
         ((c, t), (c,), (c,))]

    def loss(xin, e, p, a, r):
        s, env = jdyn.peak_envelope(jdyn.EnvState(e, p, jnp.asarray(h0)),
                                    xin, a, r, hold, rt)
        return (jnp.sum(env * w[0]) + jnp.sum(s.envelope * w[1])
                + jnp.sum(s.peak * w[2]))

    jgs = [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(5)))(
        *map(jnp.asarray, (x, e0, p0, ta, tr)))]
    ins = [_t(v, grad=True) for v in (x, e0, p0, ta, tr)]
    s, env = eu.peak_envelope(
        tdyn.EnvState(ins[1], ins[2], torch.from_numpy(h0)), ins[0],
        ins[3], ins[4], hold, rt)
    (torch.sum(env * _t(w[0])) + torch.sum(s.envelope * _t(w[1]))
     + torch.sum(s.peak * _t(w[2]))).backward()
    for name, jg, v in zip(("x", "e0", "p0", "ta", "tr"), jgs, ins):
        assert (jg == 0).all() == (_grad(v) == 0).all(), name
        if np.any(jg):
            assert _snr(jg, _grad(v)) >= BAR_DB, name


def test_peak_envelope_backward_float_taus_and_rt():
    """Host-number taus get no gradient; a release threshold given as a
    tensor gets exact zeros (it only steers the branches), as under
    jax.grad."""
    rng = np.random.default_rng(41)
    x = _t(np.abs(rng.standard_normal((2, 64))), grad=True)
    rt = torch.tensor(0.2, requires_grad=True)
    _, env = eu.peak_envelope(tdyn.env_init((2,), "cpu"), x, 0.05, 0.01, 0,
                              rt)
    env.sum().backward()
    assert rt.grad is not None and float(rt.grad) == 0.0
    assert np.any(_grad(x))


FFT_CASES = ["rfft", "rfft_zeropad", "irfft", "irfft_first", "irfft_last"]


@pytest.mark.parametrize("case", FFT_CASES)
def test_fft_packed_gradcheck(case):
    """float64 gradcheck of each packed transform's adjoint (its plain
    route) at N = 128: the DC/Nyquist and interior weights, the 1/N
    scale, and the sign of the last half's odd bins."""
    gen = torch.Generator().manual_seed(FFT_CASES.index(case))
    n = 128
    if case.startswith("rfft"):
        x = torch.randn(2, n // 2 if case == "rfft_zeropad" else n,
                        dtype=torch.float64, generator=gen,
                        requires_grad=True)
        fn = tfp.rfft_packed_zeropad if case == "rfft_zeropad" \
            else tfp.rfft_packed
        assert torch.autograd.gradcheck(fn, (x,))
        return
    half = {"irfft": False, "irfft_first": "first",
            "irfft_last": "last"}[case]
    re, im = (torch.randn(2, n // 2, dtype=torch.float64, generator=gen,
                          requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, b: tfp.irfft_packed(a, b, n, half), (re, im))


@pytest.mark.parametrize("shared", [True, False])
def test_biquad_cascade_gradcheck(shared):
    """float64 gradcheck of the scan's adjoint w.r.t. coefficients,
    state and x: 2 stages, shared [K, 5] or per-row [2, K, 5]."""
    gen = torch.Generator().manual_seed(int(shared))
    base = torch.tensor([[0.5, 0.2, -0.1, 0.6, -0.3],
                         [0.9, -0.4, 0.2, -0.2, 0.1]], dtype=torch.float64)
    c = base if shared else base + 0.05 * torch.randn(
        2, 2, 5, dtype=torch.float64, generator=gen)
    c.requires_grad_(True)
    s = torch.randn(2, 2, 2, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    x = torch.randn(2, 19, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(tbq.biquad_cascade, (c, s, x))


def test_biquad_cascade_gradient_matches_jax():
    """float32 gradients of a 2-stage cascade w.r.t. coefficients, state
    and x against jax.grad of the JAX associative scan, with cotangents
    on y and the state'."""
    rng = np.random.default_rng(51)
    coeffs = np.array([[0.3, 0.25, 0.1, 1.2, -0.6],
                       [0.8, -0.5, 0.3, 0.5, -0.2]], np.float32)
    s0 = (rng.standard_normal((3, 2, 2)) * 0.1).astype(np.float32)
    x = rng.standard_normal((3, 600)).astype(np.float32)
    wy = rng.standard_normal((3, 600)).astype(np.float32)
    ws = rng.standard_normal((3, 2, 2)).astype(np.float32)

    def loss(c, s, xin):
        y, s2 = jbq.biquad_cascade(c, s, xin)
        return jnp.sum(y * wy) + jnp.sum(s2 * ws)

    jgs = [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (coeffs, s0, x)))]
    ins = [_t(v, grad=True) for v in (coeffs, s0, x)]
    y, s2 = tbq.biquad_cascade(*ins)
    (torch.sum(y * _t(wy)) + torch.sum(s2 * _t(ws))).backward()
    for name, jg, v in zip(("coeffs", "state", "x"), jgs, ins):
        assert _snr(jg, _grad(v)) >= BAR_DB, name


# ---------------------------------------------------------------------------
# routes without a backward raise; no forward moves without grad
# ---------------------------------------------------------------------------


def _req(*shape):
    return torch.ones(*shape, requires_grad=True)


def _env():
    return tdyn.env_init((2,), "cpu")


# ring_mac, batched_slice and the limiter stay without a backward: jax.grad
# raises on them in the JAX package too (pallas_call has no reverse mode;
# reverse mode does not go through the limiter's lax.while_loop)
RAISING = {
    "ring_mac": lambda: ring_mac(*[_req(2)] * 6, 0),
    "batched_slice": lambda: batched_slice(
        _req(64), torch.zeros(2, dtype=torch.int32), 8),
    "limiter": lambda: tlim.limiter((), torch.zeros(2, 4), torch.zeros(2),
                                    _req(2, 8), 1, False),
    "autogain": lambda: trd.autogain(None, (), _req(2, 8), _req(2, 8),
                                     _req(2, 8)),
    "simple_autogain": lambda: trd.simple_autogain(None, (), _req(2, 8),
                                                   _req(2, 8)),
    "surge_protector": lambda: trd.surge_protector(None, (), _req(2, 8)),
    "peak_meter": lambda: trd.peak_meter(None, (), _req(2, 8)),
    "dynproc_envelope": lambda: trd.dynproc_envelope(None, (), _req(2, 8)),
    "trigger": lambda: trd.trigger(None, (), _req(2, 8)),
    "depopper_forward": lambda: trd.depopper_forward(None, (), _req(2, 8)),
    "pmax": lambda: pmesh.pmax(_req(2), None),
    "_mul_add": lambda: eu.peak_envelope_plain(
        _env(), _req(2, 8), 0.1, 0.1, 0),
    "gate_envelope_plain": lambda: eu.gate_envelope_plain(
        _env(), torch.zeros(2, dtype=torch.int32), _req(2, 8), 0.1, 0.1, 0,
        0.5, 0.4),
}


@pytest.mark.parametrize("name", sorted(RAISING))
def test_routes_without_backward_raise(name):
    """Every kernel route whose backward is not ported, and every plain
    loop on the float32 FMA bit trick, raises under grad, naming itself,
    instead of returning a tensor cut from the graph; under no_grad the
    check stands aside."""
    key = "_mul_add" if name.endswith("_plain") else name
    with pytest.raises(RuntimeError, match=f"{key}.* has no backward"):
        RAISING[name]()


def test_guard_stands_aside_under_no_grad():
    """The same call under torch.no_grad() runs its plain route."""
    x = torch.rand(2, 8, requires_grad=True)
    with torch.no_grad():
        _, env = eu.peak_envelope_plain(_env(), x, 0.1, 0.1, 0)
        y, _ = tbq.biquad_cascade_seq(torch.tensor([[1.0, 0, 0, 0, 0]]),
                                      torch.zeros(2, 1, 2), x)
    assert env.shape == x.shape and torch.equal(y, x)


def test_forward_unchanged_without_grad():
    """With nothing requiring grad each differentiable wrapper runs its
    old route (no graph, the launch counters of the CPU path unmoved);
    with grad its Function's forward gives the same outputs bit for bit,
    and so does ``step``."""
    rng = np.random.default_rng(61)
    x = _t(np.abs(rng.standard_normal((3, 300))))
    win = _t(rng.random((3, 48)) * 0.1)
    coeffs = _t([[0.3, 0.25, 0.1, 1.2, -0.6], [0.8, -0.5, 0.3, 0.5, -0.2]])
    st = _t(rng.standard_normal((3, 2, 2)) * 0.1)
    calls = {
        "sliding_rms": lambda a: eu.sliding_rms(win, a, 48, 1.0),
        "peak_envelope": lambda a: eu.peak_envelope(
            tdyn.EnvState(torch.full((3,), 0.2), torch.full((3,), 0.3),
                          torch.tensor([0, 5, 0], dtype=torch.int32)),
            a, 0.05, 0.01, 24, 0.3),
        "rfft_packed": lambda a: tfp.rfft_packed(a[..., :256]),
        "rfft_packed_zeropad": lambda a: tfp.rfft_packed_zeropad(
            a[..., :128]),
        "irfft_packed": lambda a: tfp.irfft_packed(
            a[..., :64], a[..., 64:128], 128, "last"),
        "biquad_cascade": lambda a: tbq.biquad_cascade(coeffs, st, a),
    }
    counters = [eu.sliding_rms, eu.peak_envelope, tfp.rfft_packed,
                tfp.rfft_packed_zeropad, tfp.irfft_packed, tbq.biquad_cascade]
    before = [f.launches for f in counters]
    for name, fn in calls.items():
        plain = tree.tree_flatten(fn(x))[0]
        assert all(v.grad_fn is None for v in plain), name
        xg = x.clone().requires_grad_(True)
        graded = tree.tree_flatten(fn(xg))[0]
        assert any(v.grad_fn is not None for v in graded), name
        for a, b in zip(plain, graded):
            assert torch.equal(a, b.detach()), name
    assert [f.launches for f in counters] == before
    jc, jp, tc, tp = _chains()
    xs = _t(rng.standard_normal((4, 2 * jc.block)))
    _, y = tc.step(tp, tc.init_state(tp), xs)
    _, yg = tc.step(tp, tc.init_state(tp), xs.clone().requires_grad_(True))
    assert torch.equal(y, yg.detach())

    # the ring convolvers and the dynamics tail (#2, #4, #3): without grad
    # the ring is written in place and the outputs are the plain versions'
    # bit for bit; with grad a new ring, the caller's untouched, the same
    # bits
    gen = torch.Generator().manual_seed(62)

    def r(*shape):
        return torch.randn(*shape, generator=gen)
    p_n, c, b, k2 = 3, 2, 64, 4
    ring = (r(p_n, c, b), r(p_n, c, b))
    eq_in = (r(p_n, b), r(p_n, b), r(b), r(b), r(c, b), r(c, b), r(c, b),
             r(c, k2), r(k2, b), r(k2, k2), r(k2, b), r(c, b))
    fdl_in = eq_in[:2] + (eq_in[-1], eq_in[6])
    cp = TComp(SR, attack_thresh=0.25, release_thresh=0.125).build()
    dyn_in = (r(c, 16).abs(), tdyn.EnvState(r(c).abs(), r(c).abs(),
                                            torch.tensor([0, 2],
                                                         dtype=torch.int32)))
    dyn_args = (16, 1.0, cp.tau_attack, cp.tau_release, cp.release_thresh,
                3, cp.knees)
    cases = {
        "eqfdl_fused": (lambda rr, g: eqfdl_fused(
            *rr, *eq_in[:6], eq_in[6].clone().requires_grad_(g),
            *eq_in[7:], 1),
            lambda rr: tfdl.eqfdl_fused_plain(*rr, *eq_in, 1), 3),
        "fdl_fused": (lambda rr, g: fdl_fused(
            *rr, *fdl_in[:3], fdl_in[3].clone().requires_grad_(g), 2),
            lambda rr: (tfdl.fdl_fused_plain(*rr, *fdl_in, 2),), 1),
    }
    counters = [eqfdl_fused, fdl_fused, chain_dyn, tfdl.eqfdl_fused_bwd,
                tfdl.fdl_fused_bwd, tenv.chain_dyn_bwd]
    before = [f.launches for f in counters]
    for name, (call, plain, n_out) in cases.items():
        want_ring = [v.clone() for v in ring]
        want = plain(want_ring)
        rr = [v.clone() for v in ring]
        got = call(rr, False)
        assert got[n_out] is rr[0] and got[n_out + 1] is rr[1], name
        assert all(torch.equal(a, b_) for a, b_ in zip(want, got[:n_out]))
        assert torch.equal(rr[0], want_ring[0]), name
        assert torch.equal(rr[1], want_ring[1]), name
        rg = [v.clone() for v in ring]
        got_g = call(rg, True)
        assert got_g[0].grad_fn is not None, name
        assert torch.equal(rg[0], ring[0]) and torch.equal(rg[1], ring[1])
        for a, b_ in zip(got[:n_out + 2], got_g[:n_out + 2]):
            assert torch.equal(a, b_.detach()), name
    xd = r(c, 64) * 2.0
    want = tenv.chain_dyn_plain(*dyn_in, xd, *dyn_args)
    got = chain_dyn(*dyn_in, xd, *dyn_args)
    got_g = chain_dyn(*dyn_in, xd.clone().requires_grad_(True), *dyn_args)
    assert got_g[2].grad_fn is not None
    for a, b_, g_ in zip(tree.tree_flatten(want)[0], tree.tree_flatten(got)[0],
                         tree.tree_flatten(got_g)[0]):
        assert torch.equal(a, b_) and torch.equal(a, g_.detach())

    # step_ring: without grad the plain stages' bits, the ring in place;
    # with grad the same bits and the caller's ring untouched
    st0 = convert.ring_state_from_jax(_np_tree(jc.init_ring_state(jp)),
                                      device="cpu")
    xr = _t(rng.standard_normal((4, jc.block)) * 2.0)
    ring0 = st0.fdl.spec_re.clone()
    st1, y1 = tc.step_ring(tp, st0, xr)
    assert st1.fdl.spec_re is st0.fdl.spec_re
    assert not torch.equal(st0.fdl.spec_re, ring0)
    eqp, cpp = tp.eq_block, tp.comp
    ring_p = (ring0.clone(), torch.zeros_like(ring0))
    yp, _, _ = tfdl.eqfdl_fused_plain(
        *ring_p, tp.h_re, tp.h_im, tp.heq_re, tp.heq_im,
        *tfp.rfft_packed_zeropad_plain(xr), xr, st0.eq.reshape(4, -1),
        eqp.g_t, eqp.m_mat, eqp.w_mat, st0.fdl.history, st1.fdl.pos)
    _, _, yp = tenv.chain_dyn_plain(
        st0.sc.window, st0.env, yp, tc.sidechain.reactivity,
        tc.sidechain.gain, cpp.tau_attack, cpp.tau_release,
        cpp.release_thresh, cpp.hold, cpp.knees)
    assert torch.equal(y1, yp)
    assert torch.equal(st1.fdl.spec_re, ring_p[0])
    st0 = convert.ring_state_from_jax(_np_tree(jc.init_ring_state(jp)),
                                      device="cpu")
    st2, y2 = tc.step_ring(tp, st0, xr.clone().requires_grad_(True))
    assert torch.equal(y1, y2.detach()) and not torch.any(st0.fdl.spec_re)
    assert torch.equal(st2.fdl.spec_re.detach(), st1.fdl.spec_re)
    assert [f.launches for f in counters] == before
