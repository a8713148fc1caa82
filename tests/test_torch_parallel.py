"""The port's sharded layer (``parallel/`` on ``torch.distributed``) against
the JAX package's (``shard_map`` on conftest's 8 virtual CPU devices), on
the same mesh shapes.

The port's side runs in gloo worker processes, one a rank, spawned once
per mesh shape by a module-scoped fixture (``parallel.launch.spawn`` of
``parallel.drive.run_cases``: the workers import only the port).  Inputs
are float32 arrays from fixed seeds.  Bars: the time-sharded primitives
>= 120 dB from JAX's sharded result (the JAX package's own bar for its
halo FIR against the sequential FDL), ``sharded_step`` >= 100 dB from
JAX's over 3 calls (the port's ``step`` bar) and >= 95 dB from the port's
own ``step`` (the JAX package's bar for its sharded chain), its gradient
under one call the same bars against ``step``'s and ``jax.grad``'s, the
meters within 1e-5 relative; the halo is exact, and every carried state
is bitwise the same on every rank that holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from lsp_dsp_units_tpu import pipeline as jpipe
from lsp_dsp_units_tpu.models.meters.loudness import ILUFSMeter as JILUFS
from lsp_dsp_units_tpu.ops import biquad as jbq
from lsp_dsp_units_tpu.ops import biquad_block as jbb
from lsp_dsp_units_tpu.ops import fftconv as jfc
from lsp_dsp_units_tpu.parallel import mesh as jmesh
from lsp_dsp_units_tpu.parallel.fused_iir import (
    fused_cascade_time_sharded as jfused)
from lsp_dsp_units_tpu.parallel.halo import (
    fir_conv_time_sharded as jfir, left_halo as jhalo)
from lsp_dsp_units_tpu.parallel.meters import (
    global_correlation as jcor, global_mean_square as jms,
    global_true_peak as jtp, ilufs_integrated_time_sharded as jilufs)
from lsp_dsp_units_tpu.parallel.time_iir import (
    biquad_cascade_time_sharded as jbq_time)

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch import pipeline as tpipe
from lsp_dsp_units_tpu_torch.models.meters.loudness import ILUFSMeter
from lsp_dsp_units_tpu_torch.parallel import drive, launch
from lsp_dsp_units_tpu_torch.utils.tree import leaves_with_path, tree_flatten

SPAWN_S = 120.0
PRIM_DB = 120.0
CHAIN_JAX_DB = 100.0
CHAIN_STEP_DB = 95.0
METER_RTOL = 1e-5
T_AX, C_AX = jmesh.TIME_AXIS, jmesh.CHAN_AXIS


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _stable_biquads(rng, k):
    out = np.zeros((k, 5))
    for i in range(k):
        r = rng.uniform(0.3, 0.97)
        th = rng.uniform(0.1, np.pi - 0.1)
        out[i] = [rng.normal() * 0.5, rng.normal() * 0.5, rng.normal() * 0.5,
                  2 * r * np.cos(th), -r * r]
    return out


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_mesh(chan, time):
    return jmesh.make_mesh(chan=chan, time=time,
                           devices=jax.devices()[:chan * time])


def _time_map(fn, mesh, n_in, out_specs, check_vma=True):
    spec = P(None, T_AX)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                             out_specs=out_specs, check_vma=check_vma))


# -- the port's side: one spawn per mesh shape ------------------------------

N_TIME = 4                        # the time-sharded primitives' mesh (1, 4)
BLOCK = 128


def _time_inputs():
    rng = np.random.default_rng(0)
    meter_t = N_TIME * 4 * 4800                 # 4 quarters of 100 ms a rank
    loud = _f32(rng, 2, meter_t, scale=0.2)
    loud[:, meter_t // 2: meter_t // 2 + 6 * 4800] *= 1e-5   # a quiet gap
    return dict(
        arange=np.arange(N_TIME * 16, dtype=np.float32).reshape(1, -1),
        ir_long=_f32(rng, 1500), x_long=_f32(rng, 1, N_TIME * 512),
        ir_stream=_f32(rng, 1100),
        xs_stream=[_f32(rng, 2, N_TIME * 2 * BLOCK) for _ in range(3)],
        iir3=_stable_biquads(rng, 3), x_iir=_f32(rng, 2, N_TIME * 256),
        x_fused=_f32(rng, 2, N_TIME * 512), iir4=_stable_biquads(rng, 4),
        x_deep=_f32(rng, 2, N_TIME * 8 * BLOCK),
        mx=_f32(rng, 2, N_TIME * 256), my=_f32(rng, 2, N_TIME * 256),
        loud=loud)


TIN = _time_inputs()

CHAINS = {
    # (chan, time): (channels, rank, ir_seconds, inputs).  (2, 2): random
    # input, 2 blocks a time rank; (4, 2): the JAX package's dry-run
    # shape, DC input
    (2, 2): (4, 9, 0.05, [_f32(np.random.default_rng(11 + k), 4, 1024,
                               scale=0.25) for k in range(3)]),
    (4, 2): (8, 8, 0.02, [np.full((8, 512), 0.1, np.float32)] * 3),
}
# one call of each mesh's chain under grad, at amplitude 2.0 (the
# compressor engaged), 2 blocks a time rank
GRAD_X = {shape: _f32(np.random.default_rng(21 + channels), channels,
                      shape[1] * 2 * (1 << (rank - 1)), scale=2.0)
          for shape, (channels, rank, _, _) in CHAINS.items()}


def _spawn(chan, time, cases):
    return launch.spawn(drive.run_cases, chan * time,
                        args=(chan, time, cases), device="cpu",
                        timeout=SPAWN_S)


@pytest.fixture(scope="module")
def time_ranks():
    t = TIN
    return _spawn(1, N_TIME, {
        "halo4": ("left_halo", dict(x=t["arange"], overlap=4)),
        "halo40": ("left_halo", dict(x=t["arange"], overlap=40)),
        "fir_long": ("fir", dict(ir=t["ir_long"], block=BLOCK,
                                 xs=[t["x_long"]], carry=False)),
        "fir_stream": ("fir", dict(ir=t["ir_stream"], block=BLOCK,
                                   xs=t["xs_stream"], carry=True)),
        "biquad": ("biquad_time", dict(coeffs=t["iir3"], x=t["x_iir"])),
        "fused": ("fused_time", dict(coeffs=t["iir3"], block=BLOCK,
                                     x=t["x_fused"])),
        "fused_deep": ("fused_time", dict(coeffs=t["iir4"], block=BLOCK,
                                          x=t["x_deep"])),
        "meters": ("meters", dict(x=t["mx"], y=t["my"], both_axes=False)),
        "ilufs": ("ilufs", dict(x=t["loud"], sample_rate=48000)),
    })


@pytest.fixture(scope="module")
def chain_ranks():
    out = {}
    for (chan, time), (channels, rank, ir_s, xs) in CHAINS.items():
        out[(chan, time)] = _spawn(chan, time, {
            "chain": ("chain", dict(xs=xs, channels=channels, rank=rank,
                                    ir_seconds=ir_s)),
            "chain_grad": ("chain_grad", dict(
                x=GRAD_X[(chan, time)], channels=channels, rank=rank,
                ir_seconds=ir_s)),
            "meters": ("meters", dict(x=TIN["mx"], y=TIN["my"],
                                      both_axes=True))})
    return out


def _same_on_every_rank(ranks, name, key):
    first = ranks[0][name][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name][key], first)


# -- the time-sharded primitives --------------------------------------------

@pytest.mark.parametrize("overlap", [4, 40])
def test_left_halo(time_ranks, overlap):
    """Exact; 40 > the shard's 16 samples spans three shards."""
    x = TIN["arange"]
    mesh = _jax_mesh(1, N_TIME)
    g = jax.jit(shard_map(lambda v: jhalo(v, overlap, T_AX), mesh=mesh,
                          in_specs=P(C_AX, T_AX), out_specs=P(C_AX, T_AX)))
    want = np.asarray(g(jnp.asarray(x)))
    got = time_ranks[0][f"halo{overlap}"]
    np.testing.assert_array_equal(got, want)
    for i in range(N_TIME):
        lo = i * 16 - overlap
        idx = np.arange(lo, i * 16)
        np.testing.assert_array_equal(
            got[0, i * overlap:(i + 1) * overlap], np.where(idx >= 0, idx, 0))


def test_fir_chained_halo(time_ranks):
    """An IR of 1500 taps (12 partitions of 128) over shards of 512."""
    t = TIN
    h = jfc.parse_ir(jnp.asarray(t["ir_long"]), BLOCK)
    g = _time_map(lambda v: jfir(h, BLOCK, v, T_AX), _jax_mesh(1, N_TIME),
                  1, P(None, T_AX))
    want = np.asarray(g(jnp.asarray(t["x_long"])))
    got = time_ranks[0]["fir_long"]["y"][0]
    assert _snr(want, got) >= PRIM_DB
    golden = jfc.np_convolve_golden(t["x_long"][0], t["ir_long"])
    assert _snr(golden, got[0]) >= 90.0


def test_fir_streaming_carry(time_ranks):
    """Three calls with the FDL carried (9 partitions, longer than a
    shard): each call against JAX's, the carry bitwise the same on every
    rank and against JAX's."""
    t = TIN
    h = jfc.parse_ir(jnp.asarray(t["ir_stream"]), BLOCK)
    fdl = jfc.FDLState(P(), P(), P())
    g = jax.jit(shard_map(
        lambda c, v: jfir(h, BLOCK, v, T_AX, carry=c)[::-1],
        mesh=_jax_mesh(1, N_TIME), in_specs=(fdl, P(None, T_AX)),
        out_specs=(fdl, P(None, T_AX))))
    carry = jfc.init_fdl(h, (2,))
    res = time_ranks[0]["fir_stream"]
    for k, x in enumerate(t["xs_stream"]):
        carry, y = g(carry, jnp.asarray(x))
        assert _snr(y, res["y"][k]) >= PRIM_DB, k
    for field in range(3):
        for r in time_ranks[1:]:
            np.testing.assert_array_equal(r["fir_stream"]["carry"][field],
                                          res["carry"][field])
        assert _snr(carry[field], res["carry"][field]) >= PRIM_DB, field


def test_biquad_cascade_time_sharded(time_ranks):
    t = TIN
    c = jnp.asarray(t["iir3"], jnp.float32)

    def f(v):
        return jbq_time(c, jbq.init_state(3, (v.shape[0],)), v, T_AX)

    g = _time_map(f, _jax_mesh(1, N_TIME), 1, (P(None, T_AX), P(None)))
    y, s = g(jnp.asarray(t["x_iir"]))
    res = time_ranks[0]["biquad"]
    assert _snr(y, res["y"]) >= PRIM_DB
    assert _snr(s, res["state"]) >= PRIM_DB
    _same_on_every_rank(time_ranks, "biquad", "state")


@pytest.mark.parametrize("name, coeffs, x", [
    ("fused", "iir3", "x_fused"), ("fused_deep", "iir4", "x_deep")])
def test_fused_cascade_time_sharded(time_ranks, name, coeffs, x):
    """1 and 8 blocks a shard (the deep shard's M^8 and G M^j from the
    host's float64)."""
    t = TIN
    k = len(t[coeffs])
    fp = jbb.precompute_fused(t[coeffs], BLOCK)

    def f(v):
        return jfused(fp, jbb.init_state(k, (v.shape[0],)), v, T_AX)

    g = _time_map(f, _jax_mesh(1, N_TIME), 1, (P(None, T_AX), P(None)),
                  check_vma=False)
    y, s = g(jnp.asarray(t[x]))
    res = time_ranks[0][name]
    assert _snr(y, res["y"]) >= PRIM_DB
    assert _snr(s, res["state"]) >= PRIM_DB
    _same_on_every_rank(time_ranks, name, "state")


def _jax_meters(axes, mesh):
    def f(a, b):
        return jms(a, axes), jtp(a, axes), jcor(a, b, axes)

    # the input is replicated over 'chan': a reduction over both axes sums
    # its copies, which the varying-axes check refuses
    g = _time_map(f, mesh, 2, (P(None), P(None), P(None)),
                  check_vma=isinstance(axes, str))
    return g(jnp.asarray(TIN["mx"]), jnp.asarray(TIN["my"]))


def _check_meters(ranks, want):
    for key, w in zip(("ms", "tp", "cor"), want):
        for r in ranks:
            np.testing.assert_allclose(r["meters"][key], np.asarray(w),
                                       rtol=METER_RTOL)
    np.testing.assert_array_equal(ranks[0]["meters"]["tp"],
                                  np.asarray(want[1]))


def test_global_meters_time(time_ranks):
    """Mean square, true peak (exact) and correlation over the time
    group."""
    _check_meters(time_ranks, _jax_meters(T_AX, _jax_mesh(1, N_TIME)))


def test_global_meters_both_axes(chain_ranks):
    """A tuple of groups reduces over both mesh dimensions, as a tuple
    of axis names does."""
    _check_meters(chain_ranks[(2, 2)],
                  _jax_meters((C_AX, T_AX), _jax_mesh(2, 2)))


def test_ilufs_integrated_time_sharded(time_ranks):
    """Within 1e-5 relative of JAX's sharded gate and of the port's
    sequential meter, the same on every rank."""
    x = TIN["loud"]
    meter = JILUFS(sample_rate=48000, channels=2, max_int_time_s=10.0)
    fp = jbb.precompute_fused(np.asarray(meter._coeffs), meter.blk_size)
    g = _time_map(lambda v: jilufs(meter, fp, v, T_AX),
                  _jax_mesh(1, N_TIME), 1, P(), check_vma=False)
    want = float(g(jnp.asarray(x)))
    tm = ILUFSMeter(sample_rate=48000, channels=2, max_int_time_s=10.0,
                    device="cpu")
    seq = float(tm.process(tm.init_state(), torch.from_numpy(x))[0].loudness)
    got = [float(r["ilufs"]) for r in time_ranks]
    assert want > 0.0 and len(set(got)) == 1
    assert abs(got[0] - want) <= METER_RTOL * want
    assert abs(got[0] - seq) <= METER_RTOL * seq


# -- the sharded chain ------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(CHAINS))
def test_sharded_step_matches_jax(chain_ranks, shape):
    """3 calls of ``sharded_step`` against the JAX package's on the same
    (chan, time) mesh, state carried; ranks of a channel shard hold the
    same state, bit for bit."""
    channels, rank, ir_s, xs = CHAINS[shape]
    chain = jpipe.FilterConvChain(48000, channels=channels, rank=rank,
                                  ir_seconds=ir_s)
    params = chain.build()
    mesh = _jax_mesh(*shape)
    step = chain.sharded_step(mesh, params)
    st = chain.init_state(params)
    spec = NamedSharding(mesh, P(C_AX, T_AX))
    ranks = chain_ranks[shape]
    for k, x in enumerate(xs):
        st, y = step(st, jax.device_put(jnp.asarray(x), spec))
        assert _snr(y, ranks[0]["chain"]["y"][k]) >= CHAIN_JAX_DB, k
    chan, time = shape
    for c in range(chan):
        row = ranks[c * time:(c + 1) * time]
        for other in row[1:]:
            for (path, u), (_, v) in zip(
                    leaves_with_path(row[0]["chain"]["state"]),
                    leaves_with_path(other["chain"]["state"])):
                np.testing.assert_array_equal(u, v, err_msg=path)


@pytest.mark.parametrize("shape", sorted(CHAINS))
def test_sharded_step_matches_own_step(chain_ranks, shape):
    """The port's sharded chain against its own single-process ``step``
    on the same inputs."""
    channels, rank, ir_s, xs = CHAINS[shape]
    chain = tpipe.FilterConvChain(48000, channels, rank=rank,
                                  ir_seconds=ir_s, device="cpu")
    params = chain.build()
    st = chain.init_state(params)
    for k, x in enumerate(xs):
        st, y = chain.step(params, st, torch.from_numpy(x))
        got = chain_ranks[shape][0]["chain"]["y"][k]
        assert _snr(y.numpy(), got) >= CHAIN_STEP_DB, k


@pytest.mark.parametrize("shape", sorted(CHAINS))
def test_sharded_step_gradient(chain_ranks, shape):
    """d sum(y^2) / dx through one call of the sharded chain, each rank's
    loss its own shard's, the gradient gathered: against the port's own
    ``step`` on the whole input (>= 95 dB, the sharded forward's bar) and
    against jax.grad through the JAX package's ``shard_map`` chain on the
    same mesh (>= 100 dB); the compressor's leaves' gradients, summed over
    the ranks, against ``step``'s (>= 95 dB, zeros at the same leaves)."""
    channels, rank, ir_s, _ = CHAINS[shape]
    x = GRAD_X[shape]
    ranks = chain_ranks[shape]
    got = ranks[0]["chain_grad"]["x"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["chain_grad"]["x"], got)
    leaves = np.sum([r["chain_grad"]["comp"] for r in ranks], axis=0)

    chain = tpipe.FilterConvChain(48000, channels, rank=rank,
                                  ir_seconds=ir_s, device="cpu")
    params = chain.build()
    params = params._replace(comp=convert.compressor_params_from_jax(
        params.comp, device="cpu", requires_grad=True))
    xt = torch.tensor(x, requires_grad=True)
    _, y = chain.step(params, chain.init_state(params), xt)
    torch.sum(y * y).backward()
    assert _snr(xt.grad.numpy(), got) >= CHAIN_STEP_DB
    want = [0.0 if v.grad is None else float(v.grad)
            for v in tree_flatten(params.comp)[0]]
    assert any(want)
    for i, (a, b) in enumerate(zip(want, leaves)):
        assert (a == 0.0) == (b == 0.0), i
        if a:
            assert _snr(a, b) >= CHAIN_STEP_DB, (i, a, b)

    jchain = jpipe.FilterConvChain(48000, channels=channels, rank=rank,
                                   ir_seconds=ir_s)
    jparams = jchain.build()
    mesh = _jax_mesh(*shape)
    step = jchain.sharded_step(mesh, jparams)
    st = jchain.init_state(jparams)
    spec = NamedSharding(mesh, P(C_AX, T_AX))

    def energy(v):
        _, yj = step(st, v)
        return jnp.sum(yj * yj)

    jg = jax.grad(energy)(jax.device_put(jnp.asarray(x), spec))
    assert _snr(np.asarray(jg), got) >= CHAIN_JAX_DB
