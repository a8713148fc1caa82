"""The port's biquad cascades (lsp_dsp_units_tpu_torch/ops/biquad.py)
against the JAX package's ops/biquad.py, following tests/test_biquad.py's
cases, on float32 inputs from numpy seeds.

Bars:

* The time-parallel scan (``biquad_cascade``, ``dyn_biquad_cascade``,
  ``stage_prefix``/``stage_apply``, ``impulse_response``) equals the JAX
  package's bit for bit: the port repeats ``jax.lax.associative_scan``'s
  combine tree, and XLA rounds that combine's products and sums one by
  one on the CPU, as torch does.
* The sequential forms' plain versions against the JAX ``lax.scan`` at
  the JAX tests' own bars between two forms of a cascade: y >= 100 dB per
  row (``test_assoc_matches_seq``; >= 90 dB for the per-sample form,
  ``test_dyn_biquad_seq_matches_assoc_and_golden``), the state within
  rtol 1e-4 / atol 1e-5.  XLA contracts the scan body's ``c * y + s``
  into FMAs on the CPU, torch rounds the product and the sum separately,
  and the recurrence carries each difference on: the two packages sit as
  far from each other as each sits from the float64 recurrence (K = 9:
  118.3 dB apart, 119.6 and 122.1 dB from float64; the varying bell:
  113.2 dB apart, 115.5 and 116.7 dB), and the gap scales with the row's
  level (1.8e-5 at a peak of 15 in the per-channel case), so an
  element-wise rtol 1e-5 / atol 1e-6 does not hold.
* Both forms against the float64 recurrence ``np_biquad_cascade_f64`` at
  the JAX test's > 95 dB, and the JAX test's own bars between forms
  (assoc vs seq > 100 dB, streaming > 110 dB, dynamic > 90 dB).

The CUDA kernels (csrc/biquad.cu) cannot run here.  Their schedule
(chain lane k runs stage k on chunk s - k at slot s, from and into
shared-memory chunk buffers by parity; the copy warps stage x and the
per-sample coefficients a slot ahead and write y and the saved stage
signals a slot behind; partial last chunks; groups of 32 stages chained)
is modelled in numpy float32 below, reading the constants from the
source, and run through the real wrapper in place of the library, both
forms: it must agree with the plain version bit for bit, and every
shared-memory read must find the sample and the coefficient it wants.
(The kernel itself against its plain version: tests/test_torch_cuda.py,
on the card.)
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu.ops import biquad as jb
from lsp_dsp_units_tpu.models.filters.design import (
    FilterParams as JParams, FilterType as JType, design_filter as jdesign)

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import biquad as tb

SEQ_DB, DYN_SEQ_DB = 100.0, 90.0
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    err = np.sum((out - ref) ** 2)
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-300) / max(err, 1e-300))


def _stable_biquads(rng, k, max_pole_radius=0.98):
    """Random stable biquads (tests/test_biquad.py's generator)."""
    coeffs = np.zeros((k, 5))
    for i in range(k):
        r = rng.uniform(0.2, max_pole_radius)
        th = rng.uniform(0.05, np.pi - 0.05)
        b = rng.normal(size=3) * 0.5
        coeffs[i] = [b[0], b[1], b[2], 2.0 * r * np.cos(th), -r * r]
    return coeffs.astype(np.float32)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _seq_close(t_out, j_out, db=SEQ_DB):
    """Plain seq y against JAX seq: >= ``db`` per row of the last axis."""
    t_out, j_out = np.asarray(t_out), np.asarray(j_out)
    assert t_out.shape == j_out.shape
    t2 = t_out.reshape(-1, t_out.shape[-1]) if t_out.ndim else t_out[None]
    j2 = j_out.reshape(t2.shape)
    worst = min(_snr(j, t) for j, t in zip(j2, t2))
    assert worst >= db, worst


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _jax_np(out):
    return tuple(np.asarray(v) for v in out)


def _torch_np(out):
    return tuple(v.numpy() for v in out)


def test_assoc_matches_golden_and_jax():
    rng = np.random.default_rng(42)
    c = _stable_biquads(rng, 4)
    x = _f32(rng, 4096)
    golden = jb.np_biquad_cascade_f64(c, x)
    jc, tc = _pair(c)
    jx, tx = _pair(x)
    jy, js = _jax_np(jb.biquad_cascade(jc, jb.init_state(4), jx))
    ty, ts = _torch_np(tb.biquad_cascade(tc, tb.init_state(4, device="cpu"),
                                         tx))
    assert _snr(golden, ty) > 95.0
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("k", [1, 3, 9])
def test_seq_matches_jax_assoc_and_golden(k):
    """From a non-zero state on 3 channels: the plain seq against JAX seq
    (y and state), against the assoc scan (> 100 dB, state rtol 1e-4),
    and from zero state against the float64 recurrence."""
    rng = np.random.default_rng(7 + k)
    c = _stable_biquads(rng, k)
    x = _f32(rng, 3, 1024)
    s0 = _f32(rng, 3, k, 2, scale=0.1)
    jc, tc = _pair(c)
    jx, tx = _pair(x)
    js0, ts0 = _pair(s0)
    jy, js = _jax_np(jb.biquad_cascade_seq(jc, js0, jx))
    ty, ts = _torch_np(tb.biquad_cascade_seq(tc, ts0, tx))
    _seq_close(ty, jy)
    np.testing.assert_allclose(ts, js, **STATE_TOL)
    ay, a_s = _torch_np(tb.biquad_cascade(tc, ts0, tx))
    assert _snr(ty, ay) > 100.0
    np.testing.assert_allclose(a_s, ts, rtol=1e-4, atol=1e-5)
    gy, _ = _torch_np(tb.biquad_cascade_seq(
        tc, tb.init_state(k, (3,), device="cpu"), tx))
    assert _snr(jb.np_biquad_cascade_f64(c, x[1]), gy[1]) > 95.0


@pytest.mark.parametrize("chunk", [31, 127, 257])
@pytest.mark.parametrize("method", ["assoc", "seq"])
def test_streaming_invariance(chunk, method):
    """Chunks with the state carried == one shot (> 110 dB), and each
    chunk's output agrees with the JAX package's on the same stream."""
    fn_t = tb.biquad_cascade if method == "assoc" else tb.biquad_cascade_seq
    fn_j = jb.biquad_cascade if method == "assoc" else jb.biquad_cascade_seq
    rng = np.random.default_rng(3)
    c = _stable_biquads(rng, 2)
    x = _f32(rng, 1000)
    jc, tc = _pair(c)
    full, _ = fn_t(tc, tb.init_state(2, device="cpu"), torch.from_numpy(x))
    ts, js = tb.init_state(2, device="cpu"), jb.init_state(2)
    outs, jouts = [], []
    for i in range(0, len(x), chunk):
        y, ts = fn_t(tc, ts, torch.from_numpy(x[i:i + chunk]))
        jy, js = fn_j(jc, js, jnp.asarray(x[i:i + chunk]))
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
    y, jy = np.concatenate(outs), np.concatenate(jouts)
    assert _snr(full.numpy(), y) > 110.0
    if method == "assoc":
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        _seq_close(y, jy)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **STATE_TOL)


@pytest.mark.parametrize("method", ["assoc", "seq"])
def test_batched_and_per_channel_coefficients(method):
    """Shared [K, 5] over 8 channels, per-channel [8, K, 5], and the
    Crossover's [B, 1, K, 5] against a broadcast x [B, C, T]: each row is
    its single-channel result, and the whole agrees with JAX."""
    fn_t = tb.biquad_cascade if method == "assoc" else tb.biquad_cascade_seq
    fn_j = jb.biquad_cascade if method == "assoc" else jb.biquad_cascade_seq

    def check(t_out, j_out, state=False):
        if method == "assoc":
            np.testing.assert_array_equal(t_out, j_out)
        elif state:
            np.testing.assert_allclose(t_out, j_out, **STATE_TOL)
        else:
            _seq_close(t_out, j_out)

    rng = np.random.default_rng(11)
    c = _stable_biquads(rng, 2)
    x = _f32(rng, 8, 512)
    jx, tx = _pair(x)
    st = tb.init_state(2, (8,), device="cpu")
    y, st2 = fn_t(torch.from_numpy(c), st, tx)
    assert y.shape == (8, 512) and st2.shape == (8, 2, 2)
    y0, _ = fn_t(torch.from_numpy(c), tb.init_state(2, device="cpu"), tx[3])
    np.testing.assert_allclose(y[3].numpy(), y0.numpy(), rtol=1e-5,
                               atol=1e-6)
    check(y.numpy(), np.asarray(fn_j(jnp.asarray(c), jb.init_state(2, (8,)),
                                     jx)[0]))

    cc = np.stack([_stable_biquads(rng, 2) for _ in range(8)])
    y2, s2 = fn_t(torch.from_numpy(cc), st, tx)
    yr, _ = fn_t(torch.from_numpy(cc[5]), tb.init_state(2, device="cpu"),
                 tx[5])
    np.testing.assert_allclose(y2[5].numpy(), yr.numpy(), rtol=1e-5,
                               atol=1e-6)
    jy2, js2 = fn_j(jnp.asarray(cc), jb.init_state(2, (8,)), jx)
    check(y2.numpy(), np.asarray(jy2))
    check(s2.numpy(), np.asarray(js2), state=True)

    cb = np.stack([_stable_biquads(rng, 3) for _ in range(4)])[:, None]
    xb = x[None, :3, :200]
    ty, ts = fn_t(torch.from_numpy(cb),
                  tb.init_state(3, (4, 3), device="cpu"),
                  torch.from_numpy(xb).expand(4, 3, 200))
    jy, js = fn_j(jnp.asarray(cb), jb.init_state(3, (4, 3)),
                  jnp.broadcast_to(jnp.asarray(xb), (4, 3, 200)))
    check(ty.numpy(), np.asarray(jy))
    check(ts.numpy(), np.asarray(js), state=True)


def test_dyn_constant_equals_static():
    """Per-sample coefficients that do not vary: the assoc form within the
    JAX test's rtol 1e-4 of the static one, the seq form identical (the
    same operations in the same order), both as JAX's."""
    rng = np.random.default_rng(5)
    c = _stable_biquads(rng, 2)
    x = _f32(rng, 256)
    dyn = np.broadcast_to(c, (256, 2, 5)).copy()
    tx = torch.from_numpy(x)
    st = tb.init_state(2, device="cpu")
    y1, _ = tb.biquad_cascade(torch.from_numpy(c), st, tx)
    y2, _ = tb.dyn_biquad_cascade(torch.from_numpy(dyn), st, tx)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-5)
    jy2, _ = jb.dyn_biquad_cascade(jnp.asarray(dyn), jb.init_state(2),
                                   jnp.asarray(x))
    np.testing.assert_array_equal(y2.numpy(), np.asarray(jy2))
    s1, _ = tb.biquad_cascade_seq(torch.from_numpy(c), st, tx)
    s2, _ = tb.dyn_biquad_cascade_seq(torch.from_numpy(dyn), st, tx)
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())


def _varying_bell(t):
    """tests/test_biquad.py's time-varying 1 kHz bell: [T, 2, 5]."""
    base = jdesign(JParams(ftype=JType.BT_RLC_BELL, slope=2, freq=1000.0,
                           gain=2.0, quality=1.0), 48000).biquads
    mod = 1.0 + 0.02 * np.sin(np.linspace(0, 6.0, t))[:, None, None]
    dyn = (base[None, :, :] * mod).astype(np.float32)
    dyn[..., 3:] = base[None, :, 3:]
    return dyn


def test_dyn_seq_matches_assoc_golden_and_jax():
    rng = np.random.default_rng(11)
    t, k = 512, 2
    x = _f32(rng, t)
    dyn = _varying_bell(t)
    jc, tc = _pair(dyn)
    jx, tx = _pair(x)
    st = tb.init_state(k, device="cpu")
    y_seq, s_seq = _torch_np(tb.dyn_biquad_cascade_seq(tc, st, tx))
    y_as, _ = _torch_np(tb.dyn_biquad_cascade(tc, st, tx))
    assert _snr(y_as, y_seq) > 90.0
    # float64 recurrence with the same per-sample coefficients
    yg = np.zeros(t)
    s = np.zeros((k, 2))
    for n in range(t):
        v = float(x[n])
        for i in range(k):
            b0, b1, b2, a1, a2 = (float(cv) for cv in dyn[n, i])
            y = b0 * v + s[i, 0]
            s[i, 0] = b1 * v + a1 * y + s[i, 1]
            s[i, 1] = b2 * v + a2 * y
            v = y
        yg[n] = v
    assert _snr(yg, y_seq) > 90.0
    np.testing.assert_allclose(s_seq, s, atol=1e-4)
    jy, js = _jax_np(jb.dyn_biquad_cascade_seq(jc, jb.init_state(k), jx))
    _seq_close(y_seq, jy, DYN_SEQ_DB)
    np.testing.assert_allclose(s_seq, js, **STATE_TOL)
    ja, _ = _jax_np(jb.dyn_biquad_cascade(jc, jb.init_state(k), jx))
    np.testing.assert_array_equal(y_as, ja)
    # odd length
    y_odd, _ = tb.dyn_biquad_cascade_seq(tc[:511], st, tx[:511])
    assert y_odd.shape == (511,)


def test_impulse_response():
    rng = np.random.default_rng(9)
    c = _stable_biquads(rng, 3)
    ir = tb.impulse_response(torch.from_numpy(c), 64).numpy()
    golden = jb.np_biquad_cascade_f64(c, np.eye(1, 64, 0,
                                                dtype=np.float32)[0])
    assert _snr(golden, ir) > 95.0
    np.testing.assert_array_equal(
        ir, np.asarray(jb.impulse_response(jnp.asarray(c), 64)))
    assert tb.impulse_response(torch.from_numpy(c), 64).device.type == "cpu"


def test_stage_prefix_apply_with_state():
    """The split that parallel/time_iir.py uses: prefix maps then the
    incoming state, identical to JAX's, and to one assoc stage."""
    rng = np.random.default_rng(13)
    b0, b1, b2, a1, a2 = (np.float32(v) for v in _stable_biquads(rng, 1)[0])
    x = _f32(rng, 2, 300)
    s_in = _f32(rng, 2, 2, scale=0.5)
    ta, tv = tb.stage_prefix(torch.from_numpy(x), *(torch.tensor(v) for v in
                                                    (b0, b1, b2, a1, a2)))
    ja, jv = jb.stage_prefix(jnp.asarray(x), *(jnp.asarray(v) for v in
                                               (b0, b1, b2, a1, a2)))
    for t_, j_ in zip(ta + tv, ja + jv):
        np.testing.assert_array_equal(t_.numpy(), np.asarray(j_))
    ty, ts = tb.stage_apply(torch.from_numpy(x), torch.tensor(b0), ta, tv,
                            torch.from_numpy(s_in))
    jy, js = jb.stage_apply(jnp.asarray(x), jnp.asarray(b0), ja, jv,
                            jnp.asarray(s_in))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    c = torch.tensor([[b0, b1, b2, a1, a2]])
    y1, s1 = tb.biquad_cascade(c, torch.from_numpy(s_in)[:, None, :],
                               torch.from_numpy(x))
    np.testing.assert_array_equal(y1.numpy(), ty.numpy())
    np.testing.assert_array_equal(s1[:, 0].numpy(), ts.numpy())


@pytest.mark.parametrize("fn", [tb.biquad_cascade, tb.biquad_cascade_seq,
                                tb.biquad_cascade_seq_plain],
                         ids=lambda f: f.__name__)
def test_empty_block_and_empty_cascade(fn):
    rng = np.random.default_rng(1)
    c = torch.from_numpy(_stable_biquads(rng, 2))
    st = torch.from_numpy(_f32(rng, 3, 2, 2))
    x0 = torch.zeros(3, 0)
    y, s = fn(c, st, x0)
    assert y.shape == (3, 0) and s is st
    x = torch.from_numpy(_f32(rng, 3, 10))
    y, s = fn(c[:0], st[:, :0], x)
    assert y is x and s.shape == (3, 0, 2)
    jy, js = jb.biquad_cascade(jnp.asarray(c.numpy()),
                               jnp.asarray(st.numpy()), jnp.zeros((3, 0)))
    assert jy.shape == (3, 0) and js.shape == st.shape


@pytest.mark.parametrize("fn", [tb.dyn_biquad_cascade,
                                tb.dyn_biquad_cascade_seq,
                                tb.dyn_biquad_cascade_seq_plain],
                         ids=lambda f: f.__name__)
def test_dyn_empty_block_and_empty_cascade(fn):
    st = torch.zeros(2, 2)
    y, s = fn(torch.zeros(0, 2, 5), st, torch.zeros(0))
    assert y.shape == (0,) and s is st
    x = torch.ones(4)
    y, s = fn(torch.zeros(4, 0, 5), torch.zeros(0, 2), x)
    assert y is x


def test_np_biquad_cascade_f64_is_the_jax_one():
    rng = np.random.default_rng(2)
    c = _stable_biquads(rng, 3)
    x = _f32(rng, 200)
    np.testing.assert_array_equal(tb.np_biquad_cascade_f64(c, x),
                                  jb.np_biquad_cascade_f64(c, x))


def test_init_state():
    s = tb.init_state(5, (2, 3), device="cpu")
    assert s.shape == (2, 3, 5, 2) and s.dtype == torch.float32
    assert not bool(s.any())
    assert tuple(s.shape) == jb.init_state(5, (2, 3)).shape


# -- the kernel's schedule, modelled in numpy ---------------------------------

SRC = os.path.join(os.path.dirname(__file__), "..", "lsp_dsp_units_tpu_torch",
                   "csrc", "biquad.cu")
MAX_SMEM = 232448          # the H100's shared memory a block (227 KB)


def _consts():
    with open(SRC) as f:
        src = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kLanes", "kChunk", "kBatch", "kDynBatch")}


def _floats(addr, n):
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(addr))


def _model_run(x_p, c_p, s_in_p, y_p, s_out_p, save_p, rows, t_n, k_n, k0,
               kg, row_stride, t_stride, dyn):
    """``lsp_biquad_seq`` / ``lsp_biquad_seq_save`` slot by slot in numpy
    float32: at slot s chain lane k runs chunk s - k of its stage from its
    input buffer (by the chunk's parity) into the next stage's; the copy
    warps stage slot s + 1's inputs (x's chunk, per sample each stage's
    coefficients of chunk s + 1 - k) and write out slot s - 1's outputs
    (the last stage's chunk into y; saving, every stage's chunk).  Within a
    slot the copies of the next inputs land before the chain reads and the
    outputs are read after the chain wrote, lane after lane, so that a
    buffer shared within a slot shows: every shared-memory read must find
    the sample (and the coefficient) it wants."""
    kc = _consts()
    chunk, batch = kc["kChunk"], kc["kDynBatch" if dyn else "kBatch"]
    assert 1 <= kg <= kc["kLanes"] and k0 + kg <= k_n
    assert chunk % batch == 0 and batch % 4 == 0
    sig_stride, coef_stride = 2 * chunk + 4, 2 * 5 * chunk + 4
    smem = 4 * ((kg + 1) * sig_stride + (kg * coef_stride if dyn else 0))
    assert smem <= MAX_SMEM
    x_a = _floats(x_p.value, rows * t_n).reshape(rows, t_n)
    y_a = _floats(y_p.value, rows * t_n).reshape(rows, t_n)
    s_in = _floats(s_in_p.value, rows * k_n * 2).reshape(rows, k_n, 2)
    s_out = _floats(s_out_p.value, rows * k_n * 2).reshape(rows, k_n, 2)
    c_len = (rows - 1) * row_stride + (t_n - 1) * t_stride + k_n * 5
    c_a = _floats(c_p.value, c_len)
    save = None if save_p is None else _floats(
        save_p.value, (k_n + 1) * rows * t_n).reshape(k_n + 1, rows, t_n)
    f32 = np.float32
    nch = -(-t_n // chunk)

    def clen(n):
        return min(chunk, t_n - n * chunk)

    for r in range(rows):
        c_grp = r * row_stride + k0 * 5
        sig = np.zeros((kg + 1, 2, chunk), f32)
        sig_tag = np.full((kg + 1, 2, chunk), -1)
        coef = np.zeros((kg, 2, 5, chunk), f32)
        coef_tag = np.full((kg, 2, chunk), -1)
        s1 = s_in[r, k0:k0 + kg, 0].astype(f32)
        s2 = s_in[r, k0:k0 + kg, 1].astype(f32)
        cst = c_a[c_grp:c_grp + kg * 5].reshape(kg, 5).astype(f32)
        written = np.zeros(t_n, int)
        saved = np.zeros((kg, t_n), int)

        def copy_in(s):
            n1 = s + 1
            if n1 < nch:
                ln, t0 = clen(n1), n1 * chunk
                sig[0, n1 & 1, :ln] = x_a[r, t0:t0 + ln]
                sig_tag[0, n1 & 1, :ln] = np.arange(t0, t0 + ln)
            if not dyn:
                return
            for k in range(kg):
                n = n1 - k
                if 0 <= n < nch:
                    ln, t0 = clen(n), n * chunk
                    at = (c_grp + (t0 + np.arange(ln))[:, None] * t_stride
                          + k * 5 + np.arange(5)[None, :])
                    coef[k, n & 1, :, :ln] = c_a[at].T
                    coef_tag[k, n & 1, :ln] = np.arange(t0, t0 + ln)

        def copy_out(s):
            ny = s - kg
            if 0 <= ny < nch:
                ln, t0 = clen(ny), ny * chunk
                assert (sig_tag[kg, ny & 1, :ln] == np.arange(t0, t0 + ln)
                        ).all()
                y_a[r, t0:t0 + ln] = sig[kg, ny & 1, :ln]
                written[t0:t0 + ln] += 1
            if save is None:
                return
            for k in range(kg):
                n = s - 1 - k
                if 0 <= n < nch:
                    ln, t0 = clen(n), n * chunk
                    assert (sig_tag[k + 1, n & 1, :ln]
                            == np.arange(t0, t0 + ln)).all()
                    save[k0 + k + 1, r, t0:t0 + ln] = sig[k + 1, n & 1, :ln]
                    saved[k, t0:t0 + ln] += 1

        def chain(k, n):
            ln, t0 = clen(n), n * chunk
            assert (sig_tag[k, n & 1, :ln] == np.arange(t0, t0 + ln)).all()
            if dyn:
                assert (coef_tag[k, n & 1, :ln]
                        == np.arange(t0, t0 + ln)).all()
            a1, a2 = s1[k], s2[k]
            for i in range(ln):
                c0, c1, c2, c3, c4 = (coef[k, n & 1, :, i] if dyn
                                      else cst[k])
                yin = sig[k, n & 1, i]
                yi = f32(c0 * yin) + a1
                n1 = f32(c1 * yin) + f32(c3 * yi) + a2
                a2 = f32(c2 * yin) + f32(c4 * yi)
                a1 = n1
                sig[k + 1, n & 1, i] = yi
                sig_tag[k + 1, n & 1, i] = t0 + i
            s1[k], s2[k] = a1, a2

        copy_in(-1)
        for s in range(nch + kg):
            copy_in(s)
            for k in range(kg):
                if 0 <= s - k < nch:
                    chain(k, s - k)
            copy_out(s)
        assert (written == 1).all()
        assert save is None or (saved == 1).all()
        s_out[r, k0:k0 + kg, 0] = s1
        s_out[r, k0:k0 + kg, 1] = s2
    return 0


def _model_launch(x_p, c_p, s_in_p, y_p, s_out_p, rows, t_n, k_n, k0, kg,
                  row_stride, t_stride, dyn, stream):
    return _model_run(x_p, c_p, s_in_p, y_p, s_out_p, None, rows, t_n, k_n,
                      k0, kg, row_stride, t_stride, dyn)


def _model_launch_save(x_p, c_p, s_in_p, y_p, s_out_p, save_p, rows, t_n,
                       k_n, k0, kg, row_stride, t_stride, dyn, stream):
    assert save_p.value is not None
    return _model_run(x_p, c_p, s_in_p, y_p, s_out_p, save_p, rows, t_n,
                      k_n, k0, kg, row_stride, t_stride, dyn)


class _ModelLib:
    lsp_biquad_seq = staticmethod(_model_launch)
    lsp_biquad_seq_save = staticmethod(_model_launch_save)


def _model_inputs(kind, k, t, rows=2):
    """(coeffs, state, x) of a schedule case: ``kind`` shared, per_row,
    per_sample or broadcast (x and the state expanded from one row)."""
    rng = np.random.default_rng(k * 1000 + t)
    x = torch.from_numpy(_f32(rng, rows, t))
    st = torch.from_numpy(_f32(rng, rows, k, 2, scale=0.2))
    if kind in ("shared", "broadcast"):
        c = torch.from_numpy(_stable_biquads(rng, k))
    elif kind == "per_row":
        c = torch.from_numpy(np.stack([_stable_biquads(rng, k)
                                       for _ in range(rows)]))
    else:
        base = _stable_biquads(rng, k)
        mod = 1.0 + 0.02 * rng.standard_normal((rows, t, k, 5))
        c = torch.from_numpy((base * mod).astype(np.float32))
    if kind == "broadcast":
        x = x[:1].expand(3, t)
        st = st[:1].expand(3, k, 2)
    return c, st, x


# the chunk is 128 samples: T below, at and about it; K of one group, a
# full group, and two or more (33, 34, 40)
@pytest.mark.parametrize("case", [
    ("shared", 9, 100), ("shared", 1, 1), ("per_row", 33, 45),
    ("per_sample", 9, 70), ("per_sample", 4, 1), ("per_sample", 34, 33),
    ("per_sample", 2, 63), ("shared", 5, 95), ("broadcast", 3, 64),
    ("shared", 9, 127), ("shared", 9, 128), ("shared", 9, 129),
    ("per_sample", 4, 129), ("per_sample", 4, 255), ("shared", 2, 385),
    ("per_row", 32, 200), ("shared", 33, 130), ("shared", 40, 257),
    ("per_sample", 1, 300), ("per_sample", 32, 260)])
def test_kernel_schedule_model_is_the_plain_loop(case, monkeypatch):
    """The wrapper's CUDA route (broadcasting, strides, groups of 32
    stages) with the kernel replaced by its numpy model, on CPU tensors:
    identical to the plain version, state included."""
    kind, k, t = case
    monkeypatch.setattr(_build, "load", lambda name, sigs: _ModelLib)
    monkeypatch.setattr(_build, "stream_of", lambda t: ctypes.c_void_p(0))
    c, st, x = _model_inputs(kind, k, t)
    dyn = kind == "per_sample"
    plain = (tb.dyn_biquad_cascade_seq_plain if dyn
             else tb.biquad_cascade_seq_plain)
    before = (tb.biquad_cascade_seq.launches,
              tb.dyn_biquad_cascade_seq.launches)
    y, s = tb._seq_cuda(c, st, x, dyn)
    assert tb.biquad_cascade_seq.launches - before[0] == -(-k // 32)
    assert (tb.dyn_biquad_cascade_seq.launches - before[1]
            == (-(-k // 32) if dyn else 0))
    py, ps = plain(c, st, x)
    np.testing.assert_array_equal(y.numpy(), py.numpy())
    np.testing.assert_array_equal(s.numpy(), ps.numpy())


@pytest.mark.parametrize("case", [
    ("shared", 9, 129), ("per_row", 3, 128), ("per_sample", 4, 200),
    ("per_sample", 33, 40), ("shared", 1, 5)])
def test_kernel_schedule_model_saves_the_stage_signals(case, monkeypatch):
    """The saving form's model through the wrapper: the stage signals
    [K + 1, rows, T], y and the state identical to the plain loop's."""
    kind, k, t = case
    monkeypatch.setattr(_build, "load", lambda name, sigs: _ModelLib)
    monkeypatch.setattr(_build, "stream_of", lambda t: ctypes.c_void_p(0))
    c, st, x = _model_inputs(kind, k, t)
    dyn = kind == "per_sample"
    y, s, sig = tb._seq_cuda(c, st, x, dyn, save=True)
    py, ps, psig = tb._seq_plain_run(c, st, x, dyn, save=True)
    for a, b in ((y, py), (s, ps), (sig, psig)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_seq_wrapper_takes_the_plain_loop_on_cpu():
    rng = np.random.default_rng(4)
    c = torch.from_numpy(_stable_biquads(rng, 2))
    x = torch.from_numpy(_f32(rng, 2, 40))
    st = tb.init_state(2, (2,), device="cpu")
    before = tb.biquad_cascade_seq.launches
    y, s = tb.biquad_cascade_seq(c, st, x)
    py, ps = tb.biquad_cascade_seq_plain(c, st, x)
    assert tb.biquad_cascade_seq.launches == before
    assert torch.equal(y, py) and torch.equal(s, ps)
