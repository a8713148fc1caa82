"""The port's standalone ring convolver against the JAX package: the plain
versions of the fused convolver block (ops/fdl_fused.py::fdl_fused) and
of the ring MAC (ops/ring_mac.py) against ``fdl_fused_pallas`` and
``ring_mac_pallas`` in interpret mode, the packed ``fdl_ring_step``
against the JAX package's, the ``Convolver`` unit and ``BlockStream``,
and JAX ring states carried across (convert.ring_fdl_from_jax).

Bars: y >= 95 dB where a packed FFT is on either side (the JAX package's
own packed-path contract), >= 110 dB elsewhere; the JAX package's
scrambled-packed spectra and the port's bit-reversed ones are compared
after each side unpacks its own.  The CUDA kernels against these plain
versions: tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsp_dsp_units_tpu.models.util.convolver import Convolver as JConvolver
from lsp_dsp_units_tpu.models.util.convolver import (
    convolve_oneshot as jconvolve_oneshot)
from lsp_dsp_units_tpu.ops import fftconv as jfc
from lsp_dsp_units_tpu.ops import pallas_fft as jfft
from lsp_dsp_units_tpu.ops.cplx import rfft_sc as jrfft_sc
from lsp_dsp_units_tpu.ops.pallas_fdl import ring_mac_pallas
from lsp_dsp_units_tpu.ops.pallas_fdl_fused import fdl_fused_pallas

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch.models.util import (
    CONVOLVER_RANK_MAX, CONVOLVER_RANK_MIN, Convolver, convolve_oneshot)
from lsp_dsp_units_tpu_torch.ops import fft_packed as tfft
from lsp_dsp_units_tpu_torch.ops import fftconv as tfc
from lsp_dsp_units_tpu_torch.ops.cplx import irfft_sc, rfft_sc
from lsp_dsp_units_tpu_torch.ops.fdl_fused import fdl_fused, fdl_fused_plain
from lsp_dsp_units_tpu_torch.ops.ring_mac import ring_mac, ring_mac_plain
from lsp_dsp_units_tpu_torch.utils.blocks import BlockStream, pad_to_multiple


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _x(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _unpacked_rings_db(jst, tst, n):
    """Worst SNR over the ring slots, each side unpacked to natural
    order by its own package."""
    worst = 1e9
    for p in range(jst.spec_re.shape[0]):
        jn = jfft.unpack_spectra(jst.spec_re[p], jst.spec_im[p], n)
        tn = tfft.unpack_spectra(tst.spec_re[p], tst.spec_im[p], n)
        worst = min(worst, _snr(jn[0], tn[0]), _snr(jn[1], tn[1]))
    return worst


def _ir_setup(block, taps, seed):
    rng = np.random.default_rng(seed)
    ir = _x(rng, taps, scale=0.2)
    return (rng, jfc.parse_ir(jnp.asarray(ir), block),
            tfc.parse_ir(torch.from_numpy(ir), block))


def test_fdl_fused_plain_matches_jax_pallas():
    """Kernel #4's plain version against fdl_fused_pallas (interpret
    mode) over P + 3 streamed blocks: the JAX side gets pre-rotated IR
    spectra and the frame, the port the unrotated spectra, slot w and
    [hist, x]."""
    block, c = 2048, 8
    n = 2 * block
    rng, jh, th = _ir_setup(block, block * 3 + 101, 11)
    p_n = jh.re.shape[-2]
    jhp = jfft.pack_spectra(jh.re, jh.im, n)
    thp = tfft.pack_spectra(th.re, th.im, n)
    jst = jfc.init_ring_fdl(jh, (c,), packed=True)
    tst = tfc.init_ring_fdl(th, (c,), packed=True, device="cpu")
    for k in range(p_n + 3):
        x = _x(rng, c, block)
        w = (int(jst.pos) + 1) % p_n
        rot = (w - jnp.arange(p_n)) % p_n
        frame = jnp.concatenate([jst.history, jnp.asarray(x)], axis=-1)
        jy, jre, jim = fdl_fused_pallas(
            jst.spec_re, jst.spec_im, jnp.take(jhp[0], rot, axis=0),
            jnp.take(jhp[1], rot, axis=0), frame, jnp.int32(w), n,
            interpret=True, x3=jfft.X3)
        jst = jfc.RingFDLState(jre, jim, jnp.asarray(x), jnp.int32(w))
        xt = torch.from_numpy(x)
        ty = fdl_fused_plain(tst.spec_re, tst.spec_im, thp[0], thp[1],
                             tst.history, xt, w)
        tst = tst._replace(history=xt, pos=w)
        assert _snr(jy, ty) >= 95.0, k
    assert _unpacked_rings_db(jst, tst, n) >= 95.0


def test_packed_fdl_ring_step_matches_jax():
    """The port's fdl_ring_step on a packed ring (fdl_fused, the plain
    version on the CPU) against the JAX package's packed ring step, and
    against the natural-order ring of either package."""
    block, c = 2048, 8
    n = 2 * block
    rng, jh, th = _ir_setup(block, block * 3 + 101, 12)
    p_n = jh.re.shape[-2]
    jst = jfc.init_ring_fdl(jh, (c,), packed=True)
    tst = tfc.init_ring_fdl(th, (c,), packed=True, device="cpu")
    nat = tfc.init_ring_fdl(th, (c,), device="cpu")
    assert tst.spec_re.shape == jst.spec_re.shape == (p_n, c, block)
    before = fdl_fused.launches
    for k in range(p_n + 3):
        x = _x(rng, c, block)
        jst, jy = jfc.fdl_ring_step(jh, jst, jnp.asarray(x))
        tst, ty = tfc.fdl_ring_step(th, tst, torch.from_numpy(x))
        nat, ny = tfc.fdl_ring_step(th, nat, torch.from_numpy(x))
        assert tst.pos == int(jst.pos) == nat.pos
        assert _snr(jy, ty) >= 95.0, k
        assert _snr(ny, ty) >= 110.0, k
    assert fdl_fused.launches == before          # CPU: the plain version
    assert _unpacked_rings_db(jst, tst, n) >= 95.0


def test_packed_ring_needs_supported_block():
    h = tfc.parse_ir(torch.ones(100), 32)         # frame 64 < 128
    with pytest.raises(ValueError, match="packed FFT"):
        tfc.init_ring_fdl(h, (2,), packed=True, device="cpu")
    ring = tfc.init_ring_fdl(h, (2,), device="cpu")
    assert ring.spec_re.shape == (4, 2, 33)


def test_packed_ir_is_cached_per_spectra():
    _, _, th = _ir_setup(256, 700, 3)
    a = tfc.packed_ir(th)
    assert tfc.packed_ir(th)[0] is a[0]
    th.re.mul_(2.0)                                # changed in place
    b = tfc.packed_ir(th)
    assert b[0] is not a[0]
    torch.testing.assert_close(b[0], 2.0 * a[0])


def _jax_ring_mac_step(jst, jh, x, p_n, packed):
    """One block of the JAX three-kernel form; also returns the frame's
    natural-order spectrum, which the port's side is fed too."""
    frame = jnp.concatenate([jst.history, x], axis=-1)
    nat = jrfft_sc(frame)
    n = frame.shape[-1]
    sr, si = nat
    hre, him = jh.re, jh.im
    if packed:
        sr, si = jfft.pack_spectra(sr, si, n)
        hre, him = jfft.pack_spectra(hre, him, n)
    w = (int(jst.pos) + 1) % p_n
    rot = (w - jnp.arange(p_n)) % p_n
    acc_re, acc_im, buf_re, buf_im = ring_mac_pallas(
        jst.spec_re, jst.spec_im, jnp.take(hre, rot, axis=-2),
        jnp.take(him, rot, axis=-2), sr, si, jnp.int32(w), interpret=True,
        packed_dc=packed)
    return (jfc.RingFDLState(buf_re, buf_im, x, jnp.int32(w)),
            (acc_re, acc_im), [torch.tensor(np.asarray(v), dtype=torch.float32)
                                      for v in nat])


@pytest.mark.parametrize("packed", [False, True])
def test_ring_mac_plain_matches_jax_pallas(packed):
    """Kernel #9's plain version against ring_mac_pallas (interpret
    mode) over 2P + 3 blocks, both fed the same frame spectra: natural
    order (F = B + 1) and packed (packed_dc; compared after each side
    unpacks its own).  The port's three-kernel step (rfft -> ring_mac ->
    irfft) against the natural ring step."""
    block, c = 256, 16
    n = 2 * block
    rng, jh, th = _ir_setup(block, block * 5 + 37, 7)
    p_n = jh.re.shape[-2]
    f_n = block if packed else block + 1
    jst = jfc.RingFDLState(jnp.zeros((p_n, c, f_n), jnp.float32),
                           jnp.zeros((p_n, c, f_n), jnp.float32),
                           jnp.zeros((c, block), jnp.float32),
                           jnp.int32(p_n - 1))
    ring = [torch.zeros(p_n, c, f_n), torch.zeros(p_n, c, f_n)]
    pos = p_n - 1
    thp = tfft.pack_spectra(th.re, th.im, n) if packed else (th.re, th.im)
    nat = tfc.init_ring_fdl(th, (c,), device="cpu")
    for k in range(2 * p_n + 3):
        x = _x(rng, c, block)
        jst, jacc, s = _jax_ring_mac_step(jst, jh, jnp.asarray(x), p_n,
                                          packed)
        if packed:
            s = tfft.pack_spectra(*s, n)
        pos = (pos + 1) % p_n
        acc = ring_mac(*ring, *thp, *s, pos, packed_dc=packed)
        if packed:
            jacc = jfft.unpack_spectra(*jacc, n)
            y = tfft.irfft_packed_plain(*acc, n, "last")
            acc = tfft.unpack_spectra(*acc, n)
        else:
            y = irfft_sc(acc, n)[..., block:]
        assert pos == int(jst.pos)
        assert min(_snr(jacc[0], acc[0]), _snr(jacc[1], acc[1])) >= 110.0, k
        nat, y_ref = tfc.fdl_ring_step(th, nat, torch.from_numpy(x))
        assert _snr(y_ref, y) >= 110.0, k
    if packed:
        jring = jfft.unpack_spectra(jst.spec_re, jst.spec_im, n)
        ring = tfft.unpack_spectra(*ring, n)
    else:
        jring = (jst.spec_re, jst.spec_im)
    for j, t in zip(jring, ring):
        np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-6)


def test_ring_mac_writes_slot_and_reads_new_spectrum():
    """Slot w is read as the new spectrum and then written; no other
    slot changes."""
    rng = np.random.default_rng(5)
    p_n, c, f_n, w = 4, 3, 9, 2
    ring = [torch.from_numpy(_x(rng, p_n, c, f_n)) for _ in range(2)]
    h = [torch.from_numpy(_x(rng, p_n, f_n)) for _ in range(2)]
    s = [torch.from_numpy(_x(rng, c, f_n)) for _ in range(2)]
    old = [r.clone() for r in ring]
    acc_re, acc_im = ring_mac_plain(*ring, *h, *s, w)
    want = torch.zeros(c, f_n, dtype=torch.complex128)
    for p in range(p_n):
        v = s if p == w else (old[0][p], old[1][p])
        q = (w - p) % p_n
        want += (torch.complex(v[0], v[1]).to(torch.complex128)
                 * torch.complex(h[0][q], h[1][q]).to(torch.complex128))
    torch.testing.assert_close(acc_re.double(), want.real, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(acc_im.double(), want.imag, atol=1e-5,
                               rtol=1e-5)
    for r, o, sv in zip(ring, old, s):
        assert torch.equal(r[w], sv)
        keep = [p for p in range(p_n) if p != w]
        assert torch.equal(r[keep], o[keep])


def test_convolver_matches_jax():
    """Convolver at rank 9 against the JAX package's, 8 calls of 1 to 3
    blocks (the single-block fdl_step and the multi-block fdl_process
    branches)."""
    rng = np.random.default_rng(21)
    ir = _x(rng, 1000, scale=0.2)
    jc = JConvolver(ir, rank=9)
    tc = Convolver(ir, rank=9, device="cpu")
    assert tc.block == jc.block == 256 and tc.partitions == jc.partitions
    assert tc.latency() == 0
    jst, tst = jc.init_state((3,)), tc.init_state((3,))
    for k in range(8):
        x = _x(rng, 3, tc.block * (1 + k % 3), scale=0.3)
        jst, jy = jc.process(jst, jnp.asarray(x))
        tst, ty = tc.process(tst, torch.from_numpy(x))
        assert _snr(jy, ty) >= 110.0, k


@pytest.mark.parametrize("rank,block", [(1, 1 << (CONVOLVER_RANK_MIN - 1)),
                                        (20, 1 << (CONVOLVER_RANK_MAX - 1))])
def test_convolver_rank_clipped(rank, block):
    assert Convolver(np.ones(8, np.float32), rank=rank,
                     device="cpu").block == block


def test_convolve_oneshot_matches_jax():
    rng = np.random.default_rng(22)
    x, h = _x(rng, 3, 1000), _x(rng, 300, scale=0.2)
    jy = jconvolve_oneshot(jnp.asarray(x), jnp.asarray(h))
    ty = convolve_oneshot(torch.from_numpy(x), torch.from_numpy(h))
    assert ty.shape == (3, 1000)
    assert _snr(jy, ty) >= 110.0


def test_convolver_odd_chunk_streaming_matches_direct():
    """The JAX package's BlockStream test (reference
    utest/util/convolver.cpp:87-125): a 31-tap ramp IR against a sparse
    impulse train, streamed in 31-sample chunks."""
    ir = np.arange(1.0, 32.0, dtype=np.float32)
    n = 0x2000
    src = np.zeros(n + ir.size, np.float32)
    j = np.arange(0, n, 5)
    src[j] = np.where(np.arange(j.size) % 3 == 0, 1.0,
                      np.where(np.arange(j.size) % 3 == 1, 0.1, 0.01)
                      ).astype(np.float32)
    conv = Convolver(ir, rank=9, device="cpu")
    bs = BlockStream(conv.process, conv.init_state(), conv.block,
                     device="cpu")
    assert bs.latency == conv.block
    out = [bs.push(src[i:i + 31]) for i in range(0, src.size, 31)]
    out.append(bs.flush())
    y = np.concatenate(out)[conv.block:]
    golden = np.convolve(src.astype(np.float64),
                         ir.astype(np.float64))[:src.size]
    err = np.abs(y[:src.size] - golden).max()
    assert err < 1e-3 * np.abs(golden).max(), err


def test_pad_to_multiple():
    x, pad = pad_to_multiple(np.ones((2, 10), np.float32), 4)
    assert pad == 2 and x.shape == (2, 12) and not x[:, 10:].any()
    y, pad = pad_to_multiple(x, 4)
    assert pad == 0 and y is x


@pytest.mark.parametrize("jax_packed,port_packed",
                         [(False, False), (False, True), (True, True)])
def test_ring_state_from_jax_mid_stream(jax_packed, port_packed):
    """Both packages run from a JAX ring state taken mid-stream: natural,
    or the JAX package's scrambled-packed ring unpacked with its own
    unpack_spectra, into the port's natural or packed ring."""
    block, c = 1024, 2
    n = 2 * block
    rng, jh, th = _ir_setup(block, int(block * 2.5), 31)
    p_n = jh.re.shape[-2]
    jst = jfc.init_ring_fdl(jh, (c,), packed=jax_packed)
    for _ in range(p_n + 1):
        jst, _ = jfc.fdl_ring_step(jh, jst, jnp.asarray(_x(rng, c, block)))
    carried = jst
    if jax_packed:
        nat = [jfft.unpack_spectra(jst.spec_re[p], jst.spec_im[p], n)
               for p in range(p_n)]
        carried = jst._replace(spec_re=jnp.stack([v[0] for v in nat]),
                               spec_im=jnp.stack([v[1] for v in nat]))
    tst = convert.ring_fdl_from_jax(
        jfc.RingFDLState(*(np.asarray(v) for v in carried)),
        packed=port_packed, device="cpu")
    assert tst.pos == int(jst.pos)
    assert tst.spec_re.shape[-1] == (block if port_packed else block + 1)
    bar = 95.0 if jax_packed or port_packed else 110.0
    for k in range(p_n + 1):
        x = _x(rng, c, block)
        jst, jy = jfc.fdl_ring_step(jh, jst, jnp.asarray(x))
        tst, ty = tfc.fdl_ring_step(th, tst, torch.from_numpy(x))
        assert _snr(jy, ty) >= bar, k


def test_ring_state_from_jax_rejects_packed_ring():
    st = jfc.RingFDLState(np.zeros((2, 1, 8), np.float32),
                          np.zeros((2, 1, 8), np.float32),
                          np.zeros((1, 8), np.float32), np.int32(1))
    with pytest.raises(ValueError, match="unpack"):
        convert.ring_fdl_from_jax(st, device="cpu")
