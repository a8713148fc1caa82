"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA
device.  The file imports no JAX, so on a machine without JAX it runs
alone, skipping the repository's JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu_torch import pipeline as tpipe
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (
    Compressor, CompressorMode)
from lsp_dsp_units_tpu_torch.models.dynamics.expander import (
    Expander, ExpanderMode)
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate
from lsp_dsp_units_tpu_torch.models.filters.design import design_filter
from lsp_dsp_units_tpu_torch.models.util.sidechain import (
    Sidechain, SidechainMode)
from lsp_dsp_units_tpu_torch.ops import biquad_block as tbb
from lsp_dsp_units_tpu_torch.ops import cplx
from lsp_dsp_units_tpu_torch.ops import dynamics as tdyn
from lsp_dsp_units_tpu_torch.ops import env_units as eu
from lsp_dsp_units_tpu_torch.ops import fft_packed as tfft
from lsp_dsp_units_tpu_torch.ops import fftconv as tfc
from lsp_dsp_units_tpu_torch.ops.env import chain_dyn, chain_dyn_plain
from lsp_dsp_units_tpu_torch.models.sampling import device_mix as tdm
from lsp_dsp_units_tpu_torch.ops import slicedma
from lsp_dsp_units_tpu_torch.ops.fdl_fused import (eqfdl_fused,
                                                   eqfdl_fused_plain,
                                                   fdl_fused, fdl_fused_plain,
                                                   fdl_launch_shape)
from lsp_dsp_units_tpu_torch.ops.ring_mac import ring_mac, ring_mac_plain

pytestmark = pytest.mark.cuda


def _snr(ref, out):
    ref = np.asarray(ref.cpu() if torch.is_tensor(ref) else ref, np.float64)
    out = np.asarray(out.cpu() if torch.is_tensor(out) else out, np.float64)
    err = out - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0, device=None):
    return (torch.randn(*shape, generator=gen) * scale).to(device)


@pytest.mark.parametrize("rows", [1, 8, 64, 133])
@pytest.mark.parametrize("n", [128, 256, 2048, 16384, 32768])
def test_fft_kernels_match_plain(cuda_device, n, rows):
    """Two blocks per row (a cluster for the inverse): odd row counts and
    more blocks than SMs pair every row's blocks correctly, in every
    mode, at >= 125 dB."""
    gen = torch.Generator().manual_seed(n + rows)
    x = _randn(gen, rows, n, device=cuda_device)
    xh = x[:, :n // 2].contiguous()
    before = (tfft.rfft_packed.launches, tfft.rfft_packed_zeropad.launches,
              tfft.irfft_packed.launches)
    for got, want in ((tfft.rfft_packed(x), tfft.rfft_packed_plain(x)),
                      (tfft.rfft_packed_zeropad(xh),
                       tfft.rfft_packed_zeropad_plain(xh))):
        assert _snr(want[0], got[0]) >= 125.0
        assert _snr(want[1], got[1]) >= 125.0
    rre, rim = tfft.rfft_packed_plain(x)
    for half in (False, "first", "last"):
        y = tfft.irfft_packed(rre, rim, n, half)
        ry = tfft.irfft_packed_plain(rre, rim, n, half)
        assert y.shape == ry.shape
        assert _snr(ry, y) >= 125.0, half
    torch.cuda.synchronize()
    after = (tfft.rfft_packed.launches, tfft.rfft_packed_zeropad.launches,
             tfft.irfft_packed.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 3]


@pytest.mark.parametrize("c, b, parts", [(8, 2048, 3), (64, 8192, 6)])
def test_eqfdl_kernel_matches_plain(cuda_device, c, b, parts):
    """Over P + 2 blocks: y, u, EQ state and ring >= 95 dB from the plain
    version; [64, 8192] with P = 6 is step_ring's shape.  The frame,
    MAC and inverse of the cluster schedule are the one-block
    schedule's, so fdl_fused (#4) on a copy of the ring with the frame
    [hist || u] gives eqfdl's y and ring slot bit for bit."""
    sr = 48000
    eq = np.concatenate([design_filter(p, sr).biquads
                         for p in tpipe.default_eq_params(sr)], axis=0)
    teq = tbb.precompute_fused(eq, b, device=cuda_device)
    gen = torch.Generator().manual_seed(16)
    ir = _randn(gen, parts * b - 17, scale=0.1, device=cuda_device)
    th = tfc.parse_ir(ir, b)
    heq = tfft.pack_spectra(teq.h_re, teq.h_im, 2 * b)
    hp = tfft.pack_spectra(th.re, th.im, 2 * b)
    p_n = th.re.shape[0]
    assert p_n == parts
    k2 = teq.m_mat.shape[0]
    ring_k = tfc.init_ring_fdl(th, (c,), packed=True,
                                device=cuda_device)
    ring_p = tfc.init_ring_fdl(th, (c,), packed=True,
                                device=cuda_device)
    sv_k = sv_p = torch.zeros(c, k2, device=cuda_device)
    before = (eqfdl_fused.launches, fdl_fused.launches)
    for k in range(p_n + 2):
        x = _randn(gen, c, b, scale=0.25, device=cuda_device)
        xs = tfft.rfft_packed_zeropad_plain(x)
        w = (ring_k.pos + 1) % p_n
        mats = (teq.g_t, teq.m_mat, teq.w_mat)
        ring_f = (ring_k.spec_re.clone(), ring_k.spec_im.clone())
        yk, uk, sv_k = eqfdl_fused(ring_k.spec_re, ring_k.spec_im, hp[0],
                                   hp[1], heq[0], heq[1], *xs, x, sv_k,
                                   *mats, ring_k.history, w)
        yf = fdl_fused(*ring_f, hp[0], hp[1], ring_k.history, uk, w)
        yp, up, sv_p = eqfdl_fused_plain(ring_p.spec_re, ring_p.spec_im,
                                         hp[0], hp[1], heq[0], heq[1], *xs,
                                         x, sv_p, *mats, ring_p.history, w)
        ring_k = ring_k._replace(history=uk, pos=w)
        ring_p = ring_p._replace(history=up, pos=w)
        assert _snr(up, uk) >= 95.0, (k, "u")
        assert _snr(yp, yk) >= 95.0, (k, "y")
        assert _snr(sv_p, sv_k) >= 95.0, (k, "sv")
        assert _snr(ring_p.spec_re, ring_k.spec_re) >= 95.0, (k, "ring")
        assert torch.equal(yf, yk), k
        assert torch.equal(ring_f[0], ring_k.spec_re), k
        assert torch.equal(ring_f[1], ring_k.spec_im), k
    torch.cuda.synchronize()
    assert (eqfdl_fused.launches - before[0],
            fdl_fused.launches - before[1]) == (p_n + 2, p_n + 2)


@pytest.mark.parametrize("t", [480, 1000, 1024, 8192])
def test_chain_dyn_kernel_matches_plain(cuda_device, t):
    """t = 480 (= the window) and 1000 end in a short pipeline chunk and
    run the envelope's tail past the last full batch; 8192 is the main
    path's block of 32 chunks."""
    c, n = 8, 480
    cp = Compressor(48000, attack_thresh=0.25, release_thresh=0.125,
                    attack_ms=2.0, release_ms=10.0, hold_ms=0.2).build()
    gen = torch.Generator().manual_seed(6)
    wk = wp = torch.zeros(c, n, device=cuda_device)
    ek = ep = tdyn.env_init((c,), cuda_device)
    for k in range(3):
        x = _randn(gen, c, t, scale=0.5 * (k + 1), device=cuda_device)
        args = (n, 1.0, cp.tau_attack, cp.tau_release, cp.release_thresh,
                cp.hold, cp.knees)
        wk, ek, yk = chain_dyn(wk, ek, x, *args)
        wp, ep, yp = chain_dyn_plain(wp, ep, x, *args)
        assert _snr(yp, yk) >= 110.0, k
        torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(ek.envelope, ep.envelope, rtol=1e-5,
                                   atol=0.0)
        torch.testing.assert_close(ek.peak, ep.peak, rtol=1e-5, atol=0.0)
        assert torch.equal(ek.hold, ep.hold)
    torch.cuda.synchronize()


def test_chain_dyn_kernel_hold_and_threshold_heavy(cuda_device):
    """Bursts around the release threshold with a long hold: the level
    crosses the threshold both ways and the hold runs out many times per
    block."""
    c, n, t = 8, 480, 4096
    cp = Compressor(48000, attack_thresh=0.2, release_thresh=0.1,
                    attack_ms=1.0, release_ms=5.0, hold_ms=4.0).build()
    gen = torch.Generator().manual_seed(8)
    k = torch.arange(t)
    wk = wp = torch.zeros(c, n, device=cuda_device)
    ek = ep = tdyn.env_init((c,), cuda_device)
    for blk in range(3):
        amp = torch.where((k + 97 * blk) % 700 < 350, 0.4, 0.05)
        x = (torch.randn(c, t, generator=gen) * amp).to(cuda_device)
        args = (n, 1.0, cp.tau_attack, cp.tau_release, cp.release_thresh,
                cp.hold, cp.knees)
        wk, ek, yk = chain_dyn(wk, ek, x, *args)
        wp, ep, yp = chain_dyn_plain(wp, ep, x, *args)
        assert _snr(yp, yk) >= 110.0, blk
        torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(ek.envelope, ep.envelope, rtol=1e-5,
                                   atol=0.0)
        torch.testing.assert_close(ek.peak, ep.peak, rtol=1e-5, atol=0.0)
        assert torch.equal(ek.hold, ep.hold)
    torch.cuda.synchronize()


def test_step_ring_on_card_matches_cpu(cuda_device):
    c = 8
    cg = tpipe.FilterConvChain(48000, c, rank=12, ir_seconds=0.2,
                               device=cuda_device)
    cc = tpipe.FilterConvChain(48000, c, rank=12, ir_seconds=0.2,
                               device="cpu")
    pg, pc = cg.build(), cc.build()
    sg, sc = cg.init_ring_state(pg), cc.init_ring_state(pc)
    rng = np.random.default_rng(9)
    before = (tfft.rfft_packed_zeropad.launches, eqfdl_fused.launches,
              chain_dyn.launches)
    for k in range(6):
        x = (rng.standard_normal((c, cg.block)) * 0.25).astype(np.float32)
        sg, yg = cg.step_ring(pg, sg, torch.from_numpy(x).to(cuda_device))
        sc, yc = cc.step_ring(pc, sc, torch.from_numpy(x))
        assert _snr(yc, yg) >= 95.0, k
    after = (tfft.rfft_packed_zeropad.launches, eqfdl_fused.launches,
             chain_dyn.launches)
    assert all(a - b == 6 for a, b in zip(after, before))


# ---------------------------------------------------------------------------
# slice 2: step / bulk_step and the dynamics units (ops/env_units.py)
# ---------------------------------------------------------------------------


def _levels(gen, c, t, device):
    """|noise| under a half-sine swell, so every knee and branch runs."""
    swell = torch.sin(torch.linspace(0.0, torch.pi, t))
    return (torch.randn(c, t, generator=gen).abs() * 0.6 * swell).to(device)


@pytest.mark.parametrize("c", [3, 64])
@pytest.mark.parametrize("t", [1, 300, 479, 480, 481, 2049, 16383, 16384])
def test_sliding_rms_kernel_matches_plain(cuda_device, t, c):
    """Time tiles of 1024 with their halos: T < N (the halo lies in the
    window alone), T = N +- 1, a ragged last tile, T % 4 != 0 (the
    scalar path); level >= 110 dB against the plain float32 cumsum form,
    window exact."""
    n = 480
    gen = torch.Generator().manual_seed(t)
    win = (_randn(gen, c, n, scale=0.3) ** 2).to(cuda_device)
    x = _randn(gen, c, t, scale=0.25, device=cuda_device)
    before = eu.sliding_rms.launches
    wk, lk = eu.sliding_rms(win, x, n, 1.5)
    wp, lp = eu.sliding_rms_plain(win, x, n, 1.5)
    torch.cuda.synchronize()
    assert eu.sliding_rms.launches == before + 1
    assert torch.equal(wk, wp)
    assert _snr(lp, lk) >= 110.0


@pytest.mark.parametrize("case", ["hold24", "hold0", "hold0_tr_gt_ta"])
@pytest.mark.parametrize("t", [2048, 2047])
@pytest.mark.parametrize("rt", [None, 0.2])
def test_peak_envelope_kernel_matches_plain(cuda_device, t, rt, case):
    """Bitwise: a hold of 24 samples from a random state (the reference
    step throughout); a hold of 0 from env_init (the predicate-free step
    in every batch that starts where the envelope cannot hold); the same
    with release faster than attack (tr > ta: the reference step)."""
    c = 8
    gen = torch.Generator().manual_seed(t)
    x = _levels(gen, c, t, cuda_device)
    ta, tr = 0.05, 0.01
    if case == "hold24":
        hold = 24
        st = tdyn.EnvState(torch.rand(c, generator=gen).to(cuda_device),
                           torch.rand(c, generator=gen).to(cuda_device),
                           torch.randint(0, 9, (c,), generator=gen,
                                         dtype=torch.int32).to(cuda_device))
    else:
        hold = 0
        st = tdyn.env_init((c,), cuda_device)
        if case == "hold0_tr_gt_ta":
            tr = 0.2
    before = eu.peak_envelope.launches
    sk, ek = tdyn.peak_envelope(st, x, ta, tr, hold, rt)
    sp, ep = tdyn.peak_envelope_plain(st, x, ta, tr, hold, rt)
    torch.cuda.synchronize()
    assert eu.peak_envelope.launches == before + 1
    assert torch.equal(ek, ep)
    for a, b in zip(sk, sp):
        assert torch.equal(a, b)


def test_gate_envelope_kernel_matches_plain(cuda_device):
    c, t = 8, 2048
    gen = torch.Generator().manual_seed(7)
    x = _levels(gen, c, t, cuda_device)
    x[:, t // 2:] *= 0.02
    st = tdyn.env_init((c,), cuda_device)
    cur = torch.zeros(c, dtype=torch.int32, device=cuda_device)
    args = (x, 0.05, 0.02, 8, 0.2, 0.075)
    sk, ck, ek, cvk = eu.gate_envelope(st, cur, *args)
    sp, cp_, ep, cvp = eu.gate_envelope_plain(st, cur, *args)
    torch.cuda.synchronize()
    assert torch.equal(ek, ep) and torch.equal(cvk, cvp)
    assert torch.equal(ck, cp_)
    assert int((cvk[:, 1:] != cvk[:, :-1]).sum()) >= 2 * c
    for a, b in zip(sk, sp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t", [2 * 2048 + 3 * 32 + 8, 2 * 2048 + 3 * 32 + 7])
@pytest.mark.parametrize("hold", [0, 24])
def test_gate_envelope_kernel_hold0_and_hold_matches_plain(cuda_device, hold,
                                                           t):
    """The gate's default hold of 0 samples (release no faster than
    attack: the chain runs the predicate-free step) and a hold of 24
    (the reference step), from env_init and from curve 0 and 1, over two
    chunks and a ragged third whose rows are (T % 4 == 0) or are not
    16-byte aligned: envelope, curve track, curve and state bitwise."""
    c = 8
    gen = torch.Generator().manual_seed(t + hold)
    x = torch.cat([_levels(gen, c, 2048, cuda_device),
                   _levels(gen, c, t - 2048, cuda_device)], dim=-1)
    x[:, 1400:2048] *= 0.02
    x[:, -600:] *= 0.02
    st = tdyn.env_init((c,), cuda_device)
    cur = (torch.arange(c, dtype=torch.int32) % 2).to(cuda_device)
    args = (x, 0.05, 0.02, hold, 0.2, 0.075)
    before = eu.gate_envelope.launches
    sk, ck, ek, cvk = eu.gate_envelope(st, cur, *args)
    sp, cp_, ep, cvp = eu.gate_envelope_plain(st, cur, *args)
    torch.cuda.synchronize()
    assert eu.gate_envelope.launches == before + 1
    assert torch.equal(ek, ep) and torch.equal(cvk, cvp)
    assert torch.equal(ck, cp_)
    assert int((cvk[:, 1:] != cvk[:, :-1]).sum()) >= 3 * c
    for a, b in zip(sk, sp):
        assert torch.equal(a, b)


def test_cplx_packed_route_matches_torch_fft(cuda_device):
    gen = torch.Generator().manual_seed(3)
    x = _randn(gen, 2, 3, 4096, device=cuda_device)
    before = tfft.rfft_packed.launches
    re, im = cplx.rfft_sc(x)
    assert tfft.rfft_packed.launches == before + 1
    ref = torch.fft.rfft(x)
    assert _snr(ref.real, re) >= 95.0 and _snr(ref.imag, im) >= 95.0
    y = cplx.irfft_sc((re, im), 4096, half="last")
    assert y.shape == (2, 3, 2048)
    assert _snr(x[..., 2048:], y) >= 95.0
    zre, _ = cplx.rfft_sc(x[..., :2048], 4096)
    assert _snr(torch.fft.rfft(x[..., :2048], n=4096).real, zre) >= 95.0


def test_units_on_card_match_cpu(cuda_device):
    c, t, sr = 8, 4096, 48000
    gen = torch.Generator().manual_seed(11)
    sig = _randn(gen, c, t, scale=0.3) * torch.sin(
        torch.linspace(0.0, torch.pi, t))
    units = [Compressor(sr, mode=m, attack_thresh=0.1, release_thresh=0.05,
                        attack_ms=2.0, release_ms=20.0)
             for m in CompressorMode]
    units += [Expander(sr, mode=m, attack_thresh=0.1, attack_ms=2.0,
                       release_ms=20.0) for m in ExpanderMode]
    units.append(Gate(sr, threshold=0.1, zone=0.5, hyst_threshold=0.08,
                      attack_ms=2.0, release_ms=20.0))
    for mode in SidechainMode:
        side = Sidechain(sr, mode, reactivity_ms=5.0)
        sg, lg = side.process(side.init_state((c,), cuda_device),
                              sig.to(cuda_device))
        sc, lc = side.process(side.init_state((c,), "cpu"), sig)
        assert _snr(lc, lg) >= 110.0, mode
        for unit in units:
            p = unit.build()
            _, gg, eg = unit.process(p, unit.init_state((c,), cuda_device),
                                     lg)
            _, gc, ec = unit.process(p, unit.init_state((c,), "cpu"), lc)
            assert _snr(ec, eg) >= 110.0, (mode, type(unit).__name__)
            assert _snr(gc, gg) >= 110.0, (mode, type(unit).__name__)
    torch.cuda.synchronize()


def test_step_and_bulk_on_card_match_cpu(cuda_device):
    c = 8
    cg = tpipe.FilterConvChain(48000, c, rank=12, ir_seconds=0.2,
                               device=cuda_device)
    cc = tpipe.FilterConvChain(48000, c, rank=12, ir_seconds=0.2,
                               device="cpu")
    pg, pc = cg.build(), cc.build()
    sg, sc = cg.init_state(pg), cc.init_state(pc)
    rng = np.random.default_rng(10)
    counters = (tfft.rfft_packed, tfft.rfft_packed_zeropad,
                tfft.irfft_packed, eu.sliding_rms, eu.peak_envelope)
    before = [f.launches for f in counters]
    for k in range(3):
        x = (rng.standard_normal((c, 2 * cg.block)) * 0.25).astype(
            np.float32)
        sg, yg = cg.step(pg, sg, torch.from_numpy(x).to(cuda_device))
        sc, yc = cc.step(pc, sc, torch.from_numpy(x))
        assert _snr(yc, yg) >= 95.0, k
    assert all(f.launches - b >= 3 for f, b in zip(counters, before))
    t_super = 4 * cg.block * 4
    hg, hc = cg.build_bulk(t_super), cc.build_bulk(t_super)
    bg, bc = cg.init_bulk_state(pg, t_super), cc.init_bulk_state(pc, t_super)
    for k in range(2):
        x = (rng.standard_normal((c, t_super)) * 0.25).astype(np.float32)
        bg, yg = cg.bulk_step(pg, hg, bg, torch.from_numpy(x).to(cuda_device))
        bc, yc = cc.bulk_step(pc, hc, bc, torch.from_numpy(x))
        assert _snr(yc, yg) >= 95.0, k
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# slice 3: the ring convolver (ops/fdl_fused.fdl_fused, ops/ring_mac) and
# the sampler (ops/slicedma, models/sampling/device_mix)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c, b, parts", [(8, 2048, 3), (5, 64, 2),
                                         (64, 8192, 6)])
def test_fdl_fused_kernel_matches_plain(cuda_device, c, b, parts):
    """A 2-block cluster per channel: [64, 8192] with P = 6 is the ring
    path's shape, B = 64 the smallest frame the split schedule takes."""
    gen = torch.Generator().manual_seed(21)
    th = tfc.parse_ir(_randn(gen, parts * b - 17, scale=0.1,
                             device=cuda_device), b)
    hp = tfft.pack_spectra(th.re, th.im, 2 * b)
    p_n = th.re.shape[0]
    ring_k = tfc.init_ring_fdl(th, (c,), packed=True, device=cuda_device)
    ring_p = tfc.init_ring_fdl(th, (c,), packed=True, device=cuda_device)
    before = fdl_fused.launches
    for k in range(p_n + 2):
        x = _randn(gen, c, b, scale=0.25, device=cuda_device)
        w = (ring_k.pos + 1) % p_n
        yk = fdl_fused(ring_k.spec_re, ring_k.spec_im, hp[0], hp[1],
                       ring_k.history, x, w)
        yp = fdl_fused_plain(ring_p.spec_re, ring_p.spec_im, hp[0], hp[1],
                             ring_p.history, x, w)
        ring_k = ring_k._replace(history=x, pos=w)
        ring_p = ring_p._replace(history=x, pos=w)
        assert _snr(yp, yk) >= 95.0, k
        assert _snr(ring_p.spec_re[w], ring_k.spec_re[w]) >= 95.0, k
        assert _snr(ring_p.spec_im[w], ring_k.spec_im[w]) >= 95.0, k
    torch.cuda.synchronize()
    assert fdl_fused.launches == before + p_n + 2


def test_fdl_fused_refuses_a_frame_below_the_split_schedule(cuda_device):
    """B = 32 (M = 32 complex points) is below the pair mapping's
    octaves: refused, nothing launched."""
    c, b, p_n = 2, 32, 2
    ring = [torch.zeros(p_n, c, b, device=cuda_device) for _ in range(2)]
    h = [torch.zeros(p_n, b, device=cuda_device) for _ in range(2)]
    x = torch.zeros(c, b, device=cuda_device)
    before = fdl_fused.launches
    with pytest.raises(ValueError, match="power of two"):
        fdl_fused(*ring, *h, x, x, 0)
    with pytest.raises(ValueError, match="power of two"):
        fdl_launch_shape(2 * b, c)
    assert fdl_fused.launches == before


def test_fdl_launch_shape_is_a_cluster_of_two_all_resident(cuda_device):
    shape = fdl_launch_shape(16384, 64)
    assert shape["blocks_per_channel"] == 2
    assert shape["smem_bytes"] == (4096 + 256) * 8
    assert shape["clusters_resident"] >= 64


def test_packed_ring_step_on_card_matches_cpu(cuda_device):
    c, b = 4, 1024
    rng = np.random.default_rng(22)
    ir = (rng.standard_normal(2 * b + 300) * 0.2).astype(np.float32)
    hg = tfc.parse_ir(torch.from_numpy(ir).to(cuda_device), b)
    hc = tfc.parse_ir(torch.from_numpy(ir), b)
    sg = tfc.init_ring_fdl(hg, (c,), packed=True, device=cuda_device)
    sc = tfc.init_ring_fdl(hc, (c,), packed=True, device="cpu")
    before = fdl_fused.launches
    for k in range(5):
        x = (rng.standard_normal((c, b)) * 0.25).astype(np.float32)
        sg, yg = tfc.fdl_ring_step(hg, sg, torch.from_numpy(x).to(cuda_device))
        sc, yc = tfc.fdl_ring_step(hc, sc, torch.from_numpy(x))
        assert _snr(yc, yg) >= 95.0, k
    assert fdl_fused.launches == before + 5


@pytest.mark.parametrize("packed", [False, True])
def test_ring_mac_kernel_matches_plain(cuda_device, packed):
    """Both round every product and sum once: exact."""
    p_n, c, b, w = 5, 8, 1024, 3
    f_n = b if packed else b + 1
    gen = torch.Generator().manual_seed(23)
    ring_k = [_randn(gen, p_n, c, f_n, device=cuda_device) for _ in range(2)]
    ring_p = [r.clone() for r in ring_k]
    h = [_randn(gen, p_n, f_n, device=cuda_device) for _ in range(2)]
    sp = [_randn(gen, c, f_n, device=cuda_device) for _ in range(2)]
    before = ring_mac.launches
    ak = ring_mac(*ring_k, *h, *sp, w, packed_dc=packed)
    ap = ring_mac_plain(*ring_p, *h, *sp, w, packed_dc=packed)
    torch.cuda.synchronize()
    assert ring_mac.launches == before + 1
    for k_, p_ in zip(ak + tuple(ring_k), ap + tuple(ring_p)):
        assert torch.equal(k_, p_)


@pytest.mark.parametrize("size", [128, 1024, 2048])
@pytest.mark.parametrize("v_n", [1, 300, 4097])
def test_batched_slice_kernel_matches_plain(cuda_device, v_n, size):
    """Every residual r = s & 3 (one warp per window composes its output
    from aligned 16-byte loads), the edges, the clamp limit and beyond,
    a negative start; V = 4097 leaves a block with one live warp."""
    n = 1 << 16
    lim = n - size - 1024
    gen = torch.Generator().manual_seed(24 + v_n + size)
    bank = _randn(gen, n, device=cuda_device)
    edge = [0, 1, 2, 3, 127, 128, 1023, 1024, lim - 1, lim, lim + 9, -3]
    rnd = torch.randint(0, lim, (max(v_n - len(edge), 0),),
                        generator=gen).tolist()
    picks = [(edge + rnd)[:v_n]] if v_n > 1 else [[s] for s in edge]
    for pick in picks:
        starts = torch.tensor(pick, dtype=torch.int32, device=cuda_device)
        before = slicedma.batched_slice.launches
        got = slicedma.batched_slice(bank, starts, size)
        want = slicedma.batched_slice_plain(bank, starts, size)
        torch.cuda.synchronize()
        assert slicedma.batched_slice.launches == before + 1
        assert got.shape == (v_n, size) and torch.equal(got, want), pick
    if v_n > 1:
        assert {s % 4 for s in pick if 0 < s < lim} == {0, 1, 2, 3}


def test_mix_block_dma_on_card_matches_gather(cuda_device):
    rng = np.random.default_rng(7)
    samples = [(rng.normal(size=m) * 0.25).astype(np.float32)
               for m in (40000, 30000)]
    block = 512
    specs = [dict(sample_id=v % 2, channel=v % 3, volume=0.05 + 0.01 * v,
                  delay=(v * 211) % 3000, loop=(v % 3 == 0), loop_start=500,
                  loop_end=20000) for v in range(40)]
    bank, bank_len = tdm.build_bank(samples)
    bank_p, _, pad = tdm.build_bank_padded(samples, block)
    voices, st_a = tdm.build_voices(specs, 3, [40000, 30000])
    cvoices, st_c = tdm.build_voices(specs, 3, [40000, 30000], device="cpu")
    cbank, _ = tdm.build_bank(samples, device="cpu")
    st_b = st_a
    before = slicedma.batched_slice.launches
    for b in range(40):
        st_a, ya = tdm.mix_block(bank, bank_len, voices, st_a, block)
        st_b, yb = tdm.mix_block_dma(bank_p, bank_len, pad, voices, st_b,
                                     block)
        st_c, yc = tdm.mix_block(cbank, bank_len, cvoices, st_c, block)
        assert torch.equal(ya, yb), b
        torch.testing.assert_close(yb.cpu(), yc, rtol=0.0, atol=1e-6)
    torch.cuda.synchronize()
    assert torch.equal(st_a.pos, st_b.pos)
    assert torch.equal(st_b.pos.cpu(), st_c.pos)
    assert slicedma.batched_slice.launches == before + 80

