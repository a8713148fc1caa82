"""The control units, the quantized counter, state checkpoints and the
public ``cplx``/``fftconv`` helpers of the port against the JAX package
on the CPU, from the same float32 inputs (fixed seeds).

Bars: identical wherever the JAX unit is exact, which is everywhere here
but ``direct_conv_block`` (a sum of K products, which XLA's dot and
torch's sum add in other orders: >= 120 dB, the float32 class of a dot
product of up to 128 terms; 138 dB read at 128).  The ramps of Bypass
and Crossfade are identical because the JAX units' element-wise
operations, called op by op, round each product and each sum on its
own, as torch does; the quantized counter's bucket is a true division
(held here against the product with the reciprocal, which moves samples
to other levels).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu import pipeline as jpipe
from lsp_dsp_units_tpu.models import ctl as jctl
from lsp_dsp_units_tpu.models.stat import QuantizedCounter as JQC
from lsp_dsp_units_tpu.ops import cplx as jcplx
from lsp_dsp_units_tpu.ops import fftconv as jfc
from lsp_dsp_units_tpu.utils import state as jstate

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch import pipeline as tpipe
from lsp_dsp_units_tpu_torch.models import ctl as tctl
from lsp_dsp_units_tpu_torch.models.stat import QuantizedCounter as TQC
from lsp_dsp_units_tpu_torch.ops import cplx as tcplx
from lsp_dsp_units_tpu_torch.ops import fftconv as tfc
from lsp_dsp_units_tpu_torch.utils import profiling, state as tstate
from lsp_dsp_units_tpu_torch.utils.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same(j, t):
    """Every leaf of a JAX tree equal to the port tree's, in order."""
    jl = jax.tree_util.tree_leaves(j)
    tl = [v for _, v in leaves_with_path(t)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- Bypass, Crossfade ------------------------------------------------------

@pytest.mark.parametrize("time_ms", [5.0, 3.3])
def test_bypass_matches_jax(time_ms):
    """Ramps toward dry and back, across call boundaries and into the
    clamps, per channel."""
    jb, tb = jctl.Bypass(48000, time_ms), tctl.Bypass(48000, time_ms)
    rng = np.random.default_rng(1)
    js, ts = jb.init_state((3,)), tb.init_state((3,), device="cpu")
    switches = [True, None, np.array([False, True, True]), None, False, True]
    for k, sw in enumerate(switches):
        if sw is not None:
            js, ts = jb.set_bypass(js, sw), tb.set_bypass(ts, sw)
        dry, wet = _f32(rng, 3, 97 + 31 * k), _f32(rng, 3, 97 + 31 * k)
        js, jy = jb.process(js, jnp.asarray(dry), jnp.asarray(wet))
        ts, ty = tb.process(ts, torch.from_numpy(dry), torch.from_numpy(wet))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        _same(js, ts)
        np.testing.assert_array_equal(tb.is_bypassed(ts).numpy(),
                                      np.asarray(jb.is_bypassed(js)))


@pytest.mark.parametrize("sources", ["both", "in", "out", "none"])
def test_crossfade_matches_jax(sources):
    jc, tc = jctl.Crossfade(48000, 0.0021), tctl.Crossfade(48000, 0.0021)
    rng = np.random.default_rng(2)
    js, ts = jc.init_state(), tc.init_state(device="cpu")
    plan = ["toggle", 40, 30, "toggle", 64, "reset", "toggle", 7, "toggle",
            200, 5]
    for step in plan:
        if step == "toggle":
            js, ts = jc.toggle(js), tc.toggle(ts)
        elif step == "reset":
            js, ts = jc.reset(js), tc.reset(ts)
        else:
            a, b = _f32(rng, 2, step), _f32(rng, 2, step)
            ja = jnp.asarray(a) if sources in ("both", "out") else None
            jb = jnp.asarray(b) if sources in ("both", "in") else None
            ta = torch.from_numpy(a) if ja is not None else None
            tb = torch.from_numpy(b) if jb is not None else None
            js, jy = jc.process(js, ja, jb, step)
            ts, ty = tc.process(ts, ta, tb, step)
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        _same(js, ts)
        assert bool(tc.active(ts)) == bool(jc.active(js))


# -- Counter, Toggle, Blink -------------------------------------------------

def _attrs(obj, names):
    return {n: getattr(obj, n) for n in names}


def test_counter_matches_jax():
    names = ("sample_rate", "frequency", "initial", "current", "fired",
             "_preserve_initial")
    rng = np.random.default_rng(3)
    jc, tc = jctl.Counter(48000, 7.3), tctl.Counter(48000, 7.3)
    for k in range(300):
        op = k % 11
        if op == 3:
            args = (int(rng.choice([44100, 96000, 8000])), bool(k % 2))
            jc.set_sample_rate(*args), tc.set_sample_rate(*args)
        elif op == 5:
            args = (float(rng.uniform(0.5, 40.0)), bool(k % 3))
            jc.set_frequency(*args), tc.set_frequency(*args)
        elif op == 7:
            args = (int(rng.integers(1, 9000)), bool(k % 2))
            jc.set_initial_value(*args), tc.set_initial_value(*args)
        elif op == 8:
            (jc.preserve_frequency, jc.preserve_initial_value)[k % 2]()
            (tc.preserve_frequency, tc.preserve_initial_value)[k % 2]()
        elif op == 9:
            assert tc.commit() == jc.commit()
        elif op == 10 and k % 4 == 0:
            assert tc.reset() == jc.reset()
        else:
            n = int(rng.integers(0, 20000))
            assert tc.submit(n) == jc.submit(n)
        assert tc.pending() == jc.pending()
        assert _attrs(tc, names) == _attrs(jc, names)


def test_toggle_matches_jax():
    rng = np.random.default_rng(4)
    jt, tt = jctl.Toggle(), tctl.Toggle()
    for k in range(200):
        v = float(rng.uniform(0.0, 1.0))
        if k % 5 == 4:
            off = bool(k % 2)
            assert tt.commit(off) == jt.commit(off)
        elif k == 100:
            jt.init(), tt.init()
        else:
            assert tt.submit(v) == jt.submit(v)
        assert tt.pending() == jt.pending()
        assert (tt.value, tt.state) == (jt.value, jt.state)


def test_blink_matches_jax():
    rng = np.random.default_rng(5)
    jb, tb = jctl.Blink(48000, 0.1), tctl.Blink(48000, 0.1)
    for k in range(200):
        v = float(rng.uniform(0.0, 2.0))
        op = k % 7
        if op == 0:
            jb.blink(v), tb.blink(v)
        elif op == 1:
            jb.blink_max(v), tb.blink_max(v)
        elif op == 2:
            jb.blink_min(v), tb.blink_min(v)
        elif op == 3 and k % 3 == 0:
            jb.set_default(v, v / 4), tb.set_default(v, v / 4)
        elif op == 4 and k % 5 == 0:
            jb.set_sample_rate(44100), tb.set_sample_rate(44100)
        n = int(rng.integers(0, 3000))
        assert tb.process(n) == jb.process(n)
        assert vars(tb) == vars(jb)


# -- QuantizedCounter -------------------------------------------------------

def _qc_input(rng, qc, n):
    """Values across the range, below and above it, the exact bucket
    edges and their float32 neighbours, NaNs and values whose index
    overflows int32."""
    x = rng.uniform(qc.minimum - 0.4 * (qc.maximum - qc.minimum),
                    qc.maximum + 0.4 * (qc.maximum - qc.minimum),
                    n).astype(np.float32)
    edges = (np.float32(qc.minimum) + np.arange(-2, qc.levels + 2,
                                                dtype=np.float32)
             * np.float32(qc.step)).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 1e12, -1e12, 3e9, np.nan],
                       np.float32)
    x = np.concatenate([x, edges, np.nextafter(edges, np.float32(np.inf)),
                        np.nextafter(edges, np.float32(-np.inf)), special])
    return rng.permutation(x)


@pytest.mark.parametrize("cfg", [
    dict(minimum=-1.0, maximum=1.0, levels=256),
    dict(minimum=0.0, maximum=1.0, levels=10),
    dict(minimum=-3.3, maximum=2.9, levels=1000, period=700),
    dict(minimum=-0.7, maximum=1.3, levels=37, period=300, capacity=450),
], ids=["default", "step0.1", "period", "capacity"])
def test_quantized_counter_matches_jax(cfg):
    """Every field identical over calls shorter and longer than the ring
    (period 0 and > 0)."""
    jq, tq = JQC(**cfg), TQC(**cfg)
    rng = np.random.default_rng(6)
    js, ts = jq.init_state(), tq.init_state(device="cpu")
    for n in (50, 1200, 13, 333):
        x = _qc_input(rng, tq, n)
        js = jq.process(js, jnp.asarray(x))
        ts = tq.process(ts, torch.from_numpy(x))
        _same(js, ts)


def test_quantized_counter_bucket_is_a_true_division():
    """The JAX unit's bucket is (x - min) / step rounded once: a product
    with the reciprocal of step would move samples to other levels."""
    tq = TQC(-3.3, 2.9, 1000)
    x = _qc_input(np.random.default_rng(7), tq, 20000)
    d = (np.where(np.isnan(x), np.float32(tq.minimum), x)
         - np.float32(tq.minimum)).astype(np.float32)
    recip = np.trunc(d * (np.float32(1.0) / np.float32(tq.step)))
    true = np.trunc(d / np.float32(tq.step))
    moved = np.isfinite(true) & (true != recip) & (true >= 0) \
        & (true < tq.levels)
    assert moved.sum() > 0
    js = JQC(-3.3, 2.9, 1000).process(JQC(-3.3, 2.9, 1000).init_state(),
                                      jnp.asarray(x))
    ts = tq.process(tq.init_state(device="cpu"), torch.from_numpy(x))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    want = np.bincount(true[moved].astype(np.int64), minlength=tq.levels)
    got = np.bincount(recip[moved].astype(np.int64), minlength=tq.levels)
    assert not np.array_equal(want, got)


# -- cplx and fftconv helpers ----------------------------------------------

def test_cplx_helpers_match_jax():
    rng = np.random.default_rng(8)
    ar, ai, br, bi, g = (_f32(rng, 3, 65) for _ in range(5))
    ja, jb = (jnp.asarray(ar), jnp.asarray(ai)), (jnp.asarray(br),
                                                  jnp.asarray(bi))
    ta, tb = (torch.from_numpy(ar), torch.from_numpy(ai)), (
        torch.from_numpy(br), torch.from_numpy(bi))
    jz, tz = jcplx.sc_to(ja), tcplx.sc_to(ta)
    jw, tw = jcplx.sc_to(jb), tcplx.sc_to(tb)
    pairs = [
        (jcplx.sc_from(jz), tcplx.sc_from(tz)),
        (jcplx.sc_rmul(ja, jnp.asarray(g)),
         tcplx.sc_rmul(ta, torch.from_numpy(g))),
        (jcplx.sc_add(ja, jb), tcplx.sc_add(ta, tb)),
        (jcplx.sc_concat([ja, jb], 0), tcplx.sc_concat([ta, tb], 0)),
        (jcplx.sc_concat([ja, jb], -1), tcplx.sc_concat([ta, tb], -1)),
        (jcplx.sc_zeros((2, 5)), tcplx.sc_zeros((2, 5), device="cpu")),
        (jcplx.sc_conj(ja), tcplx.sc_conj(ta)),
        (jcplx.sc_abs(ja), tcplx.sc_abs(ta)),
        (jcplx.cmul(jz, jw), tcplx.cmul(tz, tw)),
        (jcplx.crmul(jz, jnp.asarray(g)), tcplx.crmul(tz,
                                                      torch.from_numpy(g))),
        (jz, tz),
    ]
    for k, (j, t) in enumerate(pairs):
        j = j if isinstance(j, tuple) else (j,)
        t = t if isinstance(t, tuple) else (t,)
        for u, v in zip(j, t):
            assert v.dtype in (torch.float32, torch.complex64), k
            np.testing.assert_array_equal(v.numpy(), np.asarray(u),
                                          err_msg=str(k))


@pytest.mark.parametrize("k, b", [(1, 16), (17, 64), (128, 100)])
def test_direct_conv_block_matches_jax(k, b):
    rng = np.random.default_rng(9 + k)
    h, hist, x = _f32(rng, k), _f32(rng, 2, k - 1), _f32(rng, 2, b)
    jy = np.asarray(jfc.direct_conv_block(jnp.asarray(h), jnp.asarray(hist),
                                          jnp.asarray(x)))
    ty = tfc.direct_conv_block(torch.from_numpy(h), torch.from_numpy(hist),
                               torch.from_numpy(x)).numpy()
    err = np.sum((ty.astype(np.float64) - jy) ** 2)
    assert 10 * np.log10(np.sum(jy.astype(np.float64) ** 2)
                         / max(err, 1e-30)) >= 120.0
    full = np.concatenate([hist, x], -1)
    gold = np.stack([jfc.np_convolve_golden(r, h)[k - 1:] for r in full])
    np.testing.assert_allclose(ty, gold, rtol=1e-4, atol=1e-4)


def test_np_convolve_golden_matches_jax():
    rng = np.random.default_rng(10)
    x, h = _f32(rng, 500), _f32(rng, 77)
    np.testing.assert_array_equal(tfc.np_convolve_golden(x, h),
                                  jfc.np_convolve_golden(x, h))


# -- checkpoints ------------------------------------------------------------

def _chain_pair():
    jc = jpipe.FilterConvChain(48000, channels=3, rank=8, ir_seconds=0.02)
    tc = tpipe.FilterConvChain(48000, 3, rank=8, ir_seconds=0.02,
                               device="cpu")
    jp = jc.build()
    tp = convert.params_from_jax(_np(jp), device="cpu")
    return jc, tc, jp, tp


def test_chain_checkpoint_jax_to_port(tmp_path):
    """A JAX ``ChainState`` saved after two calls loads into the port's:
    leaves bitwise, and the port's next call identical to its call from
    the converted state."""
    jc, tc, jp, tp = _chain_pair()
    rng = np.random.default_rng(11)
    js = jc.init_state(jp)
    for _ in range(2):
        js, _ = jc.step(jp, js, jnp.asarray(_f32(rng, 3, 256, scale=0.25)))
    jstate.save_state(str(tmp_path / "jax_chain"), js)
    ts = tstate.load_state(str(tmp_path / "jax_chain"),
                           tc.init_state(tp))
    _same(js, ts)
    x = torch.from_numpy(_f32(rng, 3, 256, scale=0.25))
    _, y_ckpt = tc.step(tp, ts, x)
    _, y_conv = tc.step(tp, convert.state_from_jax(_np(js), device="cpu"), x)
    np.testing.assert_array_equal(y_ckpt.numpy(), y_conv.numpy())


def test_chain_checkpoint_port_to_jax(tmp_path):
    """The port's ``ChainState`` saved after two calls loads into the JAX
    package's: leaves bitwise, and the JAX step continues from it as from
    the port's own arrays."""
    jc, tc, jp, tp = _chain_pair()
    rng = np.random.default_rng(12)
    ts = tc.init_state(tp)
    for _ in range(2):
        ts, _ = tc.step(tp, ts, torch.from_numpy(_f32(rng, 3, 256,
                                                      scale=0.25)))
    tstate.save_state(str(tmp_path / "port_chain.npz"), ts)
    js = jstate.load_state(str(tmp_path / "port_chain.npz"),
                           jc.init_state(jp))
    _same(js, ts)
    x = jnp.asarray(_f32(rng, 3, 256, scale=0.25))
    _, y_ckpt = jc.step(jp, js, x)
    direct = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(js),
        [jnp.asarray(v.numpy()) for _, v in leaves_with_path(ts)])
    _, y_direct = jc.step(jp, direct, x)
    np.testing.assert_array_equal(np.asarray(y_ckpt), np.asarray(y_direct))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_quantized_counter_checkpoint(tmp_path, direction):
    """The windowed counter saved by one package after two calls and
    continued by the other: identical to the first package continuing."""
    cfg = dict(minimum=-1.0, maximum=1.0, levels=64, period=500,
               capacity=700)
    jq, tq = JQC(**cfg), TQC(**cfg)
    rng = np.random.default_rng(13)
    xs = [_qc_input(rng, tq, n) for n in (300, 450, 211)]
    js, ts = jq.init_state(), tq.init_state(device="cpu")
    for x in xs[:2]:
        js = jq.process(js, jnp.asarray(x))
        ts = tq.process(ts, torch.from_numpy(x))
    path = str(tmp_path / "qc")
    if direction == "jax_to_port":
        jstate.save_state(path, js)
        ts = tstate.load_state(path, tq.init_state(device="cpu"))
    else:
        tstate.save_state(path, ts)
        js = jstate.load_state(path, jq.init_state())
    js = jq.process(js, jnp.asarray(xs[2]))
    ts = tq.process(ts, torch.from_numpy(xs[2]))
    _same(js, ts)


def test_dump_state_paths_match_jax():
    """The same path strings, the same arrays; None leaves skipped; the
    visitor's text the same."""
    jc, tc, jp, tp = _chain_pair()
    js = jc.init_state(jp)
    ts = convert.state_from_jax(_np(js), device="cpu")
    jd, td = jstate.dump_state((js, None, {"b": 1, "a": [2.0]})), \
        tstate.dump_state((ts, None, {"b": 1, "a": [2.0]}))
    assert list(td) == list(jd)
    for k in jd:
        np.testing.assert_array_equal(td[k], jd[k])
    jw, tw = jstate.StateDumper(), tstate.StateDumper()
    jw.write_tree("chain", js)
    tw.write_tree("chain", ts)
    assert tw.text() == jw.text()


def test_convert_ctl_states():
    jb, jc, jq = jctl.Bypass(), jctl.Crossfade(), JQC(period=10)
    pairs = [
        (jb.set_bypass(jb.init_state((2,)), True),
         convert.bypass_state_from_jax),
        (jc.toggle(jc.init_state()), convert.crossfade_state_from_jax),
        (jq.process(jq.init_state(),
                    jnp.linspace(-2, 2, 25, dtype=jnp.float32)),
         convert.quantized_counter_state_from_jax),
    ]
    for j, fn in pairs:
        _same(j, fn(_np(j), device="cpu"))


# -- profiling --------------------------------------------------------------

def test_profiling_time_fn_and_trace(tmp_path):
    x = torch.ones(64, 64)
    sec, rate = profiling.time_fn(lambda a: (a @ a, {"n": 1}), x, iters=2,
                                  windows=2, samples_per_call=64)
    assert sec > 0 and rate == pytest.approx(64 / sec)
    assert len(profiling.tensor_leaves((x, None, {"b": [x, 3]}))) == 2
    with profiling.trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert prof is not None
    assert any(os.scandir(tmp_path))


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import lsp_dsp_units_tpu_torch.parallel.mesh\n"
            "import lsp_dsp_units_tpu_torch.parallel.halo\n"
            "import lsp_dsp_units_tpu_torch.parallel.time_iir\n"
            "import lsp_dsp_units_tpu_torch.parallel.fused_iir\n"
            "import lsp_dsp_units_tpu_torch.parallel.meters\n"
            "import lsp_dsp_units_tpu_torch.parallel.launch\n"
            "import lsp_dsp_units_tpu_torch.parallel.drive\n"
            "import lsp_dsp_units_tpu_torch.models.ctl\n"
            "import lsp_dsp_units_tpu_torch.models.stat\n"
            "import lsp_dsp_units_tpu_torch.utils.state\n"
            "import lsp_dsp_units_tpu_torch.utils.profiling\n"
            "import lsp_dsp_units_tpu_torch.tools.multihost_demo\n"
            "import lsp_dsp_units_tpu_torch.entry\n"
            "import lsp_dsp_units_tpu_torch.models.threed\n"
            "import lsp_dsp_units_tpu_torch.shared\n"
            "import lsp_dsp_units_tpu_torch.tools.serve\n"
            "import lsp_dsp_units_tpu_torch.tools.room_demo\n"
            "import lsp_dsp_units_tpu_torch.tools.demo\n"
            "import lsp_dsp_units_tpu_torch.tools.tour\n"
            "import lsp_dsp_units_tpu_torch.tools.cpu_probe\n"
            "import lsp_dsp_units_tpu_torch.tools.launch_profile\n"
            "import lsp_dsp_units_tpu_torch.tools.grad_profile\n"
            "import lsp_dsp_units_tpu_torch.tools.ab_kernels\n"
            "import lsp_dsp_units_tpu_torch.ops.env_units\n"
            "import lsp_dsp_units_tpu_torch.ops.fft_packed\n"
            "import lsp_dsp_units_tpu_torch.ops.biquad\n"
            "import lsp_dsp_units_tpu_torch.ops.dynamics\n"
            "import lsp_dsp_units_tpu_torch.models.dynamics.compressor\n"
            "import lsp_dsp_units_tpu_torch.models.util.sidechain\n"
            "import lsp_dsp_units_tpu_torch.pipeline\n"
            "import lsp_dsp_units_tpu_torch.convert\n"
            "import lsp_dsp_units_tpu_torch.utils.tree\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lsp_dsp_units_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
