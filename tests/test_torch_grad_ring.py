"""Gradients through ``FilterConvChain.step_ring`` and the packed-ring
convolver against jax.grad on the CPU.

The port's ``step_ring`` runs kernels #2 (``eqfdl_fused``) and #3
(``chain_dyn``) over a packed ring; on the CPU their plain versions, and
under autograd the ``torch.autograd.Function``s whose backwards are the
plain adjoints (``*_bwd_plain``).  The JAX package's ``step_ring`` on the
CPU runs its natural-order ring (the staged EQ, ``fdl_ring_step``, the
Sidechain and the Compressor), which ``jax.grad`` differentiates.  Both
run from one warm state over P + 2 blocks (the slot writes wrap the
ring, so a gradient crosses an overwritten slot), loss the sum of every
block's output squared, on float32 inputs made with
``numpy.random.default_rng``, at amplitude 0.25 (the compressor idle)
and 2.0 (the compressor engaged).  Held to >= 100 dB (``BAR_DB``): each block's x, every
float leaf of the incoming state (the ring through the packing map, in
natural order), the Compressor's 20 leaves, the IR and EQ spectra and
the EQ's g_mat, m_mat and w_mat; exact zeros where JAX's are zero.  A
Compressor leaf (a sum over one branch's steps of products with x - e,
where float32 rounding of the level moves x - e) is held to BAR_DB or,
where JAX's own gradient moves more than that when its inputs move by
one ulp (``ULP_RUNS`` runs), to that spread: at amplitude 2.0 the
release tau's gradient comes from a few steps of one channel, and JAX's
own moves 88.8 dB away under one such perturbation.  The
envelope's gradient jumps where a step's branch flips, so the branch
codes of both runs (ops/env_units.peak_envelope_codes) are compared
first: a channel whose branches differ is named and left out of the
loss (a channel's output depends on the shared parameters and its own
input alone, so the rest are held as they are).  The packed ``fdl_ring_step`` (kernel
#4) is held the same way against the JAX natural-order ring; each new
plain backward passes ``torch.autograd.gradcheck`` in float64 (the ring
MAC, #2, #4, #3 at a hold of 0 and of 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu import pipeline as jpipe
from lsp_dsp_units_tpu.ops import biquad_block as jbb
from lsp_dsp_units_tpu.ops import fftconv as jfc

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch import pipeline as tpipe
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (
    Compressor as TComp)
from lsp_dsp_units_tpu_torch.ops import dynamics as tdyn
from lsp_dsp_units_tpu_torch.ops import env as tenv
from lsp_dsp_units_tpu_torch.ops import env_units as eu
from lsp_dsp_units_tpu_torch.ops import fdl_fused as ff
from lsp_dsp_units_tpu_torch.ops import fft_packed as tfp
from lsp_dsp_units_tpu_torch.ops import fftconv as tfc
from lsp_dsp_units_tpu_torch.ops import ring_mac as trm

SR, C, RANK, IR_S = 48000, 4, 9, 0.02
BAR_DB = 100.0
ULP_RUNS = 3          # JAX's own runs one ulp of input away (the leaves)


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _grad(t):
    return np.zeros(t.shape) if t.grad is None else t.grad.numpy()


def _held(name, jg, tg, axis=None, keep=None, bar=BAR_DB):
    """JAX's gradient against the port's: the same zeros, and >= ``bar``
    dB where JAX's is not zero; ``keep`` the channels (on ``axis``)
    held."""
    jg, tg = np.asarray(jg, np.float64), np.asarray(tg, np.float64)
    if keep is not None:
        jg, tg = np.take(jg, keep, axis=axis), np.take(tg, keep, axis=axis)
    if not np.any(jg):
        assert not np.any(tg), name
        return
    db = _snr(jg, tg)
    assert db >= bar, (name, db)


@functools.lru_cache(maxsize=1)
def _setup():
    jc = jpipe.FilterConvChain(SR, channels=C, rank=RANK, ir_seconds=IR_S)
    jp = jc.build()
    tc = tpipe.FilterConvChain(SR, channels=C, rank=RANK, ir_seconds=IR_S,
                               device="cpu")
    p_n = jp.h_spectra.re.shape[-2]
    js0 = jc.init_ring_state(jp)
    leaves, treedef = jax.tree_util.tree_flatten(js0)
    floats = [i for i, v in enumerate(leaves)
              if jnp.issubdtype(v.dtype, jnp.floating)]
    ints = [i for i in range(len(leaves)) if i not in floats]
    comp_def = jax.tree_util.tree_structure(jp.comp)

    def loss(xs, fl, cl, hre, him, eqre, eqim, gm, mm, wm, il, wc):
        lv = [None] * len(leaves)
        for i, v in zip(floats + ints, list(fl) + list(il)):
            lv[i] = v
        st = jax.tree_util.tree_unflatten(treedef, lv)
        p = jp._replace(
            comp=jax.tree_util.tree_unflatten(comp_def, cl),
            eq_block=jp.eq_block._replace(h_re=eqre, h_im=eqim, g_mat=gm,
                                          m_mat=mm, w_mat=wm),
            h_spectra=jfc.Spectra(hre, him))

        def body(s, x):
            s, y = jc.step_ring(p, s, x)
            return s, jnp.sum(y * y * wc[:, None])
        return jnp.sum(jax.lax.scan(body, st, xs)[1])

    return (jc, jp, tc, p_n, (floats, ints),
            jax.jit(jax.grad(loss, argnums=tuple(range(10)))))


def _jax_codes(jc, jp, js, xs):
    """JAX's step_ring stage by stage (its CPU route): each block's
    envelope branch codes, from its level and envelope."""
    out = []
    for x in xs:
        y, eq = jbb.cascade_block_fused(jp.eq_block, js.eq, jnp.asarray(x))
        fdl, y = jfc.fdl_ring_step(jp.h_spectra, js.fdl, y)
        sc, level = jc.sidechain.process(js.sc, y)
        env_st, _, env = jc.compressor.process(jp.comp, js.env, level)
        out.append(eu.peak_envelope_codes(
            *(torch.from_numpy(np.array(v)) for v in
              (level, env, js.env.envelope, js.env.peak, js.env.hold)),
            int(np.asarray(jp.comp.hold)),
            float(np.asarray(jp.comp.release_thresh))))
        js = jpipe.ChainRingState(eq=eq, fdl=fdl, sc=sc, env=env_st)
    return torch.stack(out)


def _port_codes(tc, tp, ts, xs):
    """The port's step_ring stage by stage (no grad): each block's
    envelope branch codes, from chain_dyn_plain's level and envelope."""
    out = []
    with torch.no_grad():
        ts = tpipe.ChainRingState(
            eq=ts.eq.clone(), fdl=ts.fdl._replace(
                spec_re=ts.fdl.spec_re.clone(),
                spec_im=ts.fdl.spec_im.clone()), sc=ts.sc, env=ts.env)
        cp = tp.comp
        for x in xs:
            x = torch.from_numpy(x)
            c, k2 = x.shape[0], tp.eq_block.m_mat.shape[0]
            w = (ts.fdl.pos + 1) % tp.h_re.shape[0]
            y, u, sv2, rr, ri = ff.eqfdl_fused(
                ts.fdl.spec_re, ts.fdl.spec_im, tp.h_re, tp.h_im, tp.heq_re,
                tp.heq_im, *tfp.rfft_packed_zeropad(x), x,
                ts.eq.reshape(c, k2), tp.eq_block.g_t, tp.eq_block.m_mat,
                tp.eq_block.w_mat, ts.fdl.history, w)
            win, env_st, _, level, env = tenv._chain_dyn_plain(
                ts.sc.window, ts.env, y, tc.sidechain.reactivity,
                tc.sidechain.gain, cp.tau_attack, cp.tau_release,
                cp.release_thresh, cp.hold, cp.knees)
            out.append(eu.peak_envelope_codes(level, env, *ts.env, cp.hold,
                                              cp.release_thresh))
            ts = tpipe.ChainRingState(
                eq=sv2.reshape(ts.eq.shape),
                fdl=tfc.RingFDLState(rr, ri, u, w),
                sc=ts.sc._replace(window=win), env=env_st)
    return torch.stack(out)


@pytest.mark.parametrize("amp", [0.25, 2.0])
def test_step_ring_gradients_match_jax(amp):
    """jax.grad of the sum of P + 2 blocks' outputs squared through JAX's
    step_ring, from a warm state, against the port's backward: each
    block's x, the state's float leaves, the Compressor's 20 leaves, the
    IR and EQ spectra and g_mat, m_mat, w_mat."""
    jc, jp, tc, p_n, (floats, ints), jgrad = _setup()
    rng = np.random.default_rng(int(amp * 100))
    nb = p_n + 2
    xs = (rng.standard_normal((nb + 2, C, jc.block)) * amp
          ).astype(np.float32)
    js = jc.init_ring_state(jp)
    for x in xs[:2]:
        js, _ = jc.step_ring(jp, js, jnp.asarray(x))
    xs = xs[2:]
    # the envelope's branches in both runs; a channel whose branches
    # differ is named and left out of the loss (a channel's output
    # depends on the shared parameters and its own input alone)
    tcp = convert.params_from_jax(_np_tree(jp), device="cpu")
    tcs = convert.ring_state_from_jax(_np_tree(js), device="cpu")
    flips = (_jax_codes(jc, jp, js, xs) != _port_codes(tc, tcp, tcs, xs))
    flipped = sorted(set(torch.nonzero(flips)[:, 1].tolist()))
    keep = [c for c in range(C) if c not in flipped]
    print(f"amp {amp}: channels whose envelope branches differ: {flipped}")
    assert keep, flipped
    wc = np.zeros(C, np.float32)
    wc[keep] = 1.0

    jleaves = jax.tree_util.tree_flatten(js)[0]
    cl = [jnp.asarray(v, jnp.float32)
          for v in jax.tree_util.tree_leaves(jp.comp)]
    eqb = jp.eq_block
    jargs = (jnp.asarray(xs), [jleaves[i] for i in floats], cl,
             jp.h_spectra.re, jp.h_spectra.im, eqb.h_re, eqb.h_im,
             eqb.g_mat, eqb.m_mat, eqb.w_mat, [jleaves[i] for i in ints],
             jnp.asarray(wc))
    jgs = jax.tree_util.tree_map(np.asarray, jgrad(*jargs))

    tp = convert.params_from_jax(_np_tree(jp), device="cpu",
                                 requires_grad=True)
    ts, leaves = convert.ring_state_leaves_from_jax(_np_tree(js), "cpu")
    xt = torch.from_numpy(xs).requires_grad_(True)
    st, total = ts, 0.0
    for k in range(nb):
        st, y = tc.step_ring(tp, st, xt[k])
        total = total + torch.sum(y * y * torch.from_numpy(wc)[:, None])
    total.backward()

    # a compressor leaf is a sum over one branch's steps of products with
    # x - e, which the forward's float32 rounding moves: JAX's own
    # gradient at inputs one ulp away (x (1 +- 2^-23), signs from a seed)
    spread = np.full(20, np.inf)
    for seed in range(ULP_RUNS):
        sign = np.where(np.random.default_rng(seed).random(xs.shape) < 0.5,
                        -1.0, 1.0)
        jg_ulp = jgrad(jnp.asarray((xs * (1 + sign * 2.0 ** -23)
                                    ).astype(np.float32)), *jargs[1:])[2]
        spread = np.minimum(spread, [_snr(a, b) if np.any(a) else np.inf
                                     for a, b in zip(jgs[2], jg_ulp)])
    _held(f"x (flipped {flipped})", jgs[0], _grad(xt), 1, keep)
    names = ["eq", "ring_re", "ring_im", "history", "window", "rms",
             "envelope", "peak"]
    axes = [0, 1, 1, 0, 0, 0, 0, 0]
    for name, ax, jg, t in zip(names, axes, jgs[1], leaves):
        _held(f"{name} (flipped {flipped})", jg, _grad(t), ax, keep)
    comp = convert.tree.tree_flatten(tp.comp)[0]
    for i, (jg, t) in enumerate(zip(jgs[2], comp)):
        _held(f"comp leaf {i} (flipped {flipped}, JAX's own spread "
              f"{spread[i]:.1f} dB)", jg, _grad(t), bar=min(BAR_DB,
                                                           spread[i]))
    ours = (tp.h_spectra.re, tp.h_spectra.im, tp.eq_block.h_re,
            tp.eq_block.h_im, tp.eq_block.g_mat, tp.eq_block.m_mat,
            tp.eq_block.w_mat)
    for name, jg, t in zip(("h_re", "h_im", "heq_re", "heq_im", "g_mat",
                            "m_mat", "w_mat"), jgs[3:], ours):
        _held(f"{name} (flipped {flipped})", jg, _grad(t))
    engaged = float(torch.mean((st.env.envelope > tp.comp.knees[0].start)
                               .float()))
    print(f"amp {amp}: {100 * engaged:.0f} % of the channels' envelopes "
          f"end above the first knee")
    assert engaged > 0 or amp < 1.0, engaged


def test_fdl_ring_step_packed_gradients_match_jax():
    """The packed ring's convolver block (kernel #4's route) over P + 2
    blocks against jax.grad of the JAX natural-order fdl_ring_step: x,
    the incoming ring (natural order, through the packing), the history
    and the IR spectra."""
    jc, jp, tc, p_n, _, _ = _setup()
    rng = np.random.default_rng(44)
    b = jc.block
    xs = rng.standard_normal((p_n + 4, C, b)).astype(np.float32)
    jh = jp.h_spectra
    js = jfc.init_ring_fdl(jh, (C,))
    for x in xs[:2]:
        js, _ = jfc.fdl_ring_step(jh, js, jnp.asarray(x))
    xs = xs[2:]

    def loss(x_all, re, im, hist, hre, him):
        s = js._replace(spec_re=re, spec_im=im, history=hist)

        def body(s, x):
            s, y = jfc.fdl_ring_step(jfc.Spectra(hre, him), s, x)
            return s, jnp.sum(y * y)
        return jnp.sum(jax.lax.scan(body, s, x_all)[1])

    jgs = [np.asarray(g) for g in jax.jit(jax.grad(
        loss, argnums=tuple(range(6))))(jnp.asarray(xs), js.spec_re,
                                        js.spec_im, js.history, jh.re,
                                        jh.im)]
    ins = [torch.tensor(np.asarray(v), requires_grad=True) for v in
           (xs, js.spec_re, js.spec_im, js.history, jh.re, jh.im)]
    spec = tfp.pack_spectra(ins[1], ins[2], 2 * b)
    st = tfc.RingFDLState(spec[0], spec[1], ins[3], int(js.pos))
    total = 0.0
    for k in range(p_n + 2):
        st, y = tfc.fdl_ring_step(tfc.Spectra(ins[4], ins[5]), st, ins[0][k])
        total = total + torch.sum(y * y)
    total.backward()
    for name, jg, t in zip(("x", "ring_re", "ring_im", "history", "h_re",
                            "h_im"), jgs, ins):
        _held(name, jg, _grad(t))


# ---------------------------------------------------------------------------
# float64 gradcheck of each new plain backward
# ---------------------------------------------------------------------------

_D = torch.float64


def _r(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, dtype=_D) * scale
            ).requires_grad_(True)


class _RingMac(torch.autograd.Function):
    """The ring MAC out of place (ring' returned), backward
    ring_mac_bwd_plain: the adjoint alone under gradcheck."""

    @staticmethod
    def forward(ctx, ring_re, ring_im, h_re, h_im, s_re, s_im, w, packed):
        r_re, r_im = ring_re.clone(), ring_im.clone()
        acc = trm.ring_mac_plain(r_re, r_im, h_re, h_im, s_re, s_im, w,
                                 packed)
        ctx.save_for_backward(r_re, r_im, h_re, h_im)
        ctx.w, ctx.packed = w, packed
        return acc + (r_re, r_im)

    @staticmethod
    def backward(ctx, g_re, g_im, g_ring_re, g_ring_im):
        r_re, r_im, h_re, h_im = ctx.saved_tensors
        out = trm.ring_mac_bwd_plain(r_re, r_im, h_re, h_im, g_re, g_im,
                                     g_ring_re, g_ring_im, ctx.w,
                                     ctx.packed)
        return out + (None, None)


@pytest.mark.parametrize("packed", [True, False])
def test_ring_mac_bwd_plain_gradcheck(packed):
    """The MAC's adjoint over a packed ring (position 0's real bins
    slot-wise) and a natural one, the slot written mid-ring."""
    gen = torch.Generator().manual_seed(3)
    p_n, c, f = 3, 2, 8 if packed else 9
    args = [_r(gen, p_n, c, f), _r(gen, p_n, c, f), _r(gen, p_n, f),
            _r(gen, p_n, f), _r(gen, c, f), _r(gen, c, f)]
    assert torch.autograd.gradcheck(
        lambda *a: _RingMac.apply(*a, 1, packed), args)


@pytest.mark.parametrize("w", [0, 2])
def test_eqfdl_fused_gradcheck(w):
    """#2's plain backward in float64 w.r.t. all 14 tensors (P = 3,
    C = 2, B = 16, 2K = 4)."""
    gen = torch.Generator().manual_seed(10 + w)
    p_n, c, b, k2 = 3, 2, 16, 4
    args = [_r(gen, p_n, c, b), _r(gen, p_n, c, b), _r(gen, p_n, b),
            _r(gen, p_n, b), _r(gen, b), _r(gen, b), _r(gen, c, b),
            _r(gen, c, b), _r(gen, c, b), _r(gen, c, k2), _r(gen, k2, b),
            _r(gen, k2, k2), _r(gen, k2, b), _r(gen, c, b)]
    assert torch.autograd.gradcheck(lambda *a: ff.eqfdl_fused(*a, w), args)


@pytest.mark.parametrize("w", [0, 2])
def test_fdl_fused_gradcheck(w):
    """#4's plain backward in float64 w.r.t. the ring, the IR, the
    history and x."""
    gen = torch.Generator().manual_seed(20 + w)
    p_n, c, b = 3, 2, 16
    args = [_r(gen, p_n, c, b), _r(gen, p_n, c, b), _r(gen, p_n, b),
            _r(gen, p_n, b), _r(gen, c, b), _r(gen, c, b)]
    assert torch.autograd.gradcheck(lambda *a: ff.fdl_fused(*a, w), args)


@pytest.mark.parametrize("hold", [0, 3])
def test_chain_dyn_gradcheck(hold):
    """#3's plain backward in float64 at a hold of 0 and of 3 samples
    (one channel entering with 2 held samples left), the level crossing
    both of the first knee's ends, w.r.t. x, the window, the envelope and
    peak, both taus and the first knee's eight fields."""
    gen = torch.Generator().manual_seed(30 + hold)
    n, t = 8, 40
    cp = TComp(SR, attack_thresh=0.25, release_thresh=0.125, attack_ms=1.0,
               release_ms=3.0).build()
    x = (torch.randn(2, t, generator=gen, dtype=_D)
         * torch.linspace(0.1, 0.6, t, dtype=_D)).requires_grad_(True)
    win = (torch.rand(2, n, generator=gen, dtype=_D) * 0.05
           ).requires_grad_(True)
    e0 = torch.tensor([0.05, 0.3], dtype=_D, requires_grad=True)
    p0 = torch.tensor([0.1, 0.35], dtype=_D, requires_grad=True)
    h0 = torch.tensor([0, 2], dtype=torch.int32)
    taus = [torch.tensor(v, dtype=_D, requires_grad=True) for v in (0.3, 0.1)]
    k0 = [torch.tensor(float(v), dtype=_D, requires_grad=True)
          for v in cp.knees[0]]

    def fn(x, win, e0, p0, ta, tr, *k0v):
        w2, st, y = tenv.chain_dyn(
            win, tdyn.EnvState(e0, p0, h0), x, n, 1.5, ta, tr, 0.125, hold,
            (tdyn.CompKnee(*k0v), cp.knees[1]))
        return w2, st.envelope, st.peak, y

    _, env = tenv._chain_dyn_plain(
        win.detach(), tdyn.EnvState(e0.detach(), p0.detach(), h0),
        x.detach(), n, 1.5, 0.3, 0.1, 0.125, hold, cp.knees)[3:]
    lo, hi = cp.knees[0].start, cp.knees[0].end
    assert (env < lo).any() and (env > hi).any()
    assert ((env > lo) & (env < hi)).any()
    assert torch.autograd.gradcheck(fn, (x, win, e0, p0, *taus, *k0))
