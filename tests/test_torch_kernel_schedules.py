"""The schedules of the redesigned CUDA kernels, modelled on the CPU.

The packed FFT (``csrc/fft_packed.cu``) runs the radix-2 transform of
``csrc/fft_packed.cuh`` as two blocks per row (after the first DIF stage
the halves are independent; the inverse's last DIT stage pairs them
across a cluster) with up to four stages per shared-memory pass.  A
numpy model of that schedule in float64 must be bitwise equal to a numpy
model of the in-place radix-2 transform, one stage per pass over one
block's M points, with the untangle (the schedule the kernels first ran,
kept here as the reference): the same butterflies on the same operands.
Both must also agree with the plain versions.  This holds the
index maths (groups, twiddle indices, pair ranges per half, the cross
stage) that only the card could otherwise show.

The EQ + convolver kernel (``csrc/fdl_fused.cu``, ``eqfdl_kernel``)
runs the same split as a two-block cluster per channel: the EQ inverse's
last stage, fused with the u correction and the frame's first DIF stage,
and the FDL inverse's last stage cross the halves; the MAC pass runs on
each half's own octaves.  A float64 model of that schedule must equal a
model of the one-block schedule bitwise, and ``eqfdl_fused_plain``
within the card's tolerance.  ``fdl_kernel`` runs the same cluster
schedule from the frame [hist || x], whose first DIF stage each block
forms for its own half as it loads its first register pass; its model
is held against the one-block model and ``fdl_fused_plain`` likewise.

The dynamics tail (``csrc/env.cu``) and the peak envelope
(``csrc/env_units.cu``) replace their envelope step, where the envelope
cannot hold, by one with no compare on the envelope's path:
max(e_rise, min(e_rel, +-inf)).  Written out in torch with the plain
version's correctly rounded FMA (``_mul_add``) and run as each kernel's
chain thread runs it (its chunk and batch sizes) beside the reference
step, it must equal ``peak_envelope_plain`` bit for bit.

The gate envelope (``csrc/env_units.cu``) takes its curve switch off the
chain: a warp scans each finished chunk's envelopes, every sample a map
on the curve {0, 1} and the maps composed per lane, across lanes and
across tiles.  A numpy model of that scan must equal the serial switch.

The batched slice (``csrc/slicedma.cu``) copies each window with one
warp: aligned 16-byte loads, the right neighbour's by a shuffle, and the
four outputs selected by the start's residual r = s & 3.  A numpy model
of that copy, with its batches of loads, must equal ``bank[s : s +
size]`` bitwise and read inside the bank.  The sliding RMS
(``csrc/env_units.cu``) runs independent time tiles, each from its own
halo of N frame values: a float64 model of the halo sums and in-tile
scans must give the plain version's window' exactly and its level
within the card's tolerance.
"""

import os
import re

import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu_torch.ops import env_units as eu
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.ops.dynamics import EnvState
from lsp_dsp_units_tpu_torch.ops.fdl_fused import (eqfdl_fused_plain,
                                                   fdl_fused_plain)
from lsp_dsp_units_tpu_torch.ops.slicedma import SLACK, batched_slice_plain

SIZES = [1 << k for k in range(7, 16)]          # 128 ... 32768
RADIX_BITS = 4                                   # stages per register pass


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    err = out - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-300))


def _twiddles(n):
    """The kernels' float32 tables as complex128."""
    wst, wnb = fp.tables(n, torch.device("cpu"))
    wst, wnb = wst.double().numpy(), wnb.double().numpy()
    return wst[:, 0] + 1j * wst[:, 1], wnb[:, 0] + 1j * wnb[:, 1]


def _pair_of(t):
    """fft_packed.cuh::pair_of on an array of pair numbers."""
    v = t + 1
    hb = 1 << (np.floor(np.log2(v)).astype(np.int64))
    j = v + hb
    return j, 6 * hb - 1 - j


def _untangle(a, b, wk):
    bc = np.conj(b)
    e = (a + bc) * 0.5
    d = a - bc
    o = 0.5 * d.imag - 0.5j * d.real
    wo = wk * o
    return e + wo, np.conj(e - wo)


def _retangle(xk, xmk, wk):
    xc = np.conj(xmk)
    e = (xk + xc) * 0.5
    o = ((xk - xc) * 0.5) * np.conj(wk)
    io = -o.imag + 1j * o.real
    return e + io, np.conj(e - io)


def _untangle0(z0):
    return (z0.real + z0.imag) + 1j * (z0.real - z0.imag)


def _retangle0(x0):
    return 0.5 * (x0.real + x0.imag) + 0.5j * (x0.real - x0.imag)


def _dif_butterfly(a, c, w):
    return a + c, (a - c) * w


def _dit_butterfly(a, c, w):
    c = c * np.conj(w)
    return a + c, a - c


# --- the one-block in-place radix-2 schedule, one stage per pass -----------


def _ref_forward(z, wst):
    buf = z.copy()
    m = buf.size
    h = m // 2
    while h >= 1:
        b = np.arange(m // 2)
        j = b & (h - 1)
        i = 2 * b - j
        buf[i], buf[i + h] = _dif_butterfly(buf[i], buf[i + h], wst[h + j])
        h //= 2
    return buf


def _ref_inverse_core(buf, wst):
    buf = buf.copy()
    m = buf.size
    h = 1
    while h < m:
        b = np.arange(m // 2)
        j = b & (h - 1)
        i = 2 * b - j
        buf[i], buf[i + h] = _dit_butterfly(buf[i], buf[i + h], wst[h + j])
        h *= 2
    return buf


def _untangle_all(buf, wnb):
    m = buf.size
    out = np.empty(m, np.complex128)
    j, jp = _pair_of(np.arange(m // 2 - 1))
    out[j], out[jp] = _untangle(buf[j], buf[jp], wnb[j])
    out[0] = _untangle0(buf[0])
    out[1] = np.conj(buf[1])
    return out


def _retangle_all(spec, wnb):
    m = spec.size
    buf = np.empty(m, np.complex128)
    j, jp = _pair_of(np.arange(m // 2 - 1))
    buf[j], buf[jp] = _retangle(spec[j], spec[jp], wnb[j])
    buf[0] = _retangle0(spec[0])
    buf[1] = np.conj(spec[1])
    return buf


# --- the two-block schedule of fft_packed.cu --------------------------------


def _radix_pass(buf, wst, lo, kk, inverse):
    """radix_pass: groups of 2^kk points differing in bits [lo, lo + kk),
    kk stages on each group in registers."""
    p = 1 << kk
    g = np.arange(buf.size // p)
    mask = (1 << lo) - 1
    base = (g & mask) | ((g >> lo) << (lo + kk))
    idx = base[:, None] + (np.arange(p) << lo)[None, :]
    v = buf[idx]
    jl = base & mask
    for s in (range(kk) if inverse else range(kk - 1, -1, -1)):
        half = 1 << s
        h = 1 << (lo + s)
        for r0 in range(0, p, 2 * half):
            for q in range(half):
                w = wst[h + jl + (q << lo)]
                fly = _dit_butterfly if inverse else _dif_butterfly
                v[:, r0 + q], v[:, r0 + q + half] = fly(
                    v[:, r0 + q], v[:, r0 + q + half], w)
    out = buf.copy()
    out[idx] = v
    return out


def _half_pairs(b, l):
    t0 = (l >> 1) - 1 if b else 0
    count = (l >> 1) if b else (l >> 1) - 1
    return _pair_of(t0 + np.arange(count))


def _split_forward(z, wst, wnb, half_input):
    """rfft_packed_kernel for one row: z complex [M] (its upper half zero
    when half_input, which the kernel then never reads)."""
    m = z.size
    l = m // 2
    log_l = l.bit_length() - 1
    out = np.full(m, np.nan + 0j)
    for b in (0, 1):
        i = np.arange(l)
        a = z[i]
        if half_input:
            buf = a * wst[l + i] if b else a.copy()
        else:
            buf = _dif_butterfly(a, z[i + l], wst[l + i])[b]
        rem = log_l
        while rem > 0:
            kk = min(RADIX_BITS, rem)
            rem -= kk
            buf = _radix_pass(buf, wst, rem, kk, inverse=False)
        off = b * l
        j, jp = _half_pairs(b, l)
        assert np.all((j >= off) & (j < off + l) & (jp >= off)
                      & (jp < off + l))
        out[j], out[jp] = _untangle(buf[j - off], buf[jp - off], wnb[j])
        if b == 0:
            out[0] = _untangle0(buf[0])
            out[1] = np.conj(buf[1])
    assert not np.isnan(out).any()
    return out


def _split_inverse(spec, wst, wnb, half):
    """irfft_packed_kernel for one row: packed complex [M] -> complex
    natural [M] (or its first / last half), scaled by 1/M."""
    m = spec.size
    l = m // 2
    log_l = l.bit_length() - 1
    bufs = []
    for b in (0, 1):
        off = b * l
        buf = np.full(l, np.nan + 0j)
        j, jp = _half_pairs(b, l)
        buf[j - off], buf[jp - off] = _retangle(spec[j], spec[jp], wnb[j])
        if b == 0:
            buf[0] = _retangle0(spec[0])
            buf[1] = np.conj(spec[1])
        assert not np.isnan(buf).any()
        lo = 0
        while lo < log_l:
            kk = min(RADIX_BITS, log_l - lo)
            buf = _radix_pass(buf, wst, lo, kk, inverse=True)
            lo += kk
        bufs.append(buf)
    out = np.full(m, np.nan + 0j)
    for b in (0, 1):
        i = np.arange(b * (l >> 1), (b + 1) * (l >> 1))
        out[i], out[i + l] = _dit_butterfly(bufs[0][i], bufs[1][i],
                                            wst[l + i])
    out = out * (1.0 / m)
    return {0: out, 1: out[:l], 2: out[l:]}[half]


def _ref_inverse(spec, wst, wnb, half):
    m = spec.size
    out = _ref_inverse_core(_retangle_all(spec, wnb), wst) * (1.0 / m)
    return {0: out, 1: out[:m // 2], 2: out[m // 2:]}[half]


def _as_real(zc):
    y = np.empty(2 * zc.size)
    y[0::2], y[1::2] = zc.real, zc.imag
    return y


@pytest.mark.parametrize("n", SIZES)
def test_fft_split_forward_matches_radix2_and_plain(n):
    m = n // 2
    wst, wnb = _twiddles(n)
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n)
    xh = x[:m].copy()
    for half_input, xin in ((False, x), (True, np.concatenate(
            [xh, np.zeros(m)]))):
        z = xin[0::2] + 1j * xin[1::2]
        new = _split_forward(z, wst, wnb, half_input)
        ref = _untangle_all(_ref_forward(z, wst), wnb)
        assert np.array_equal(new, ref), half_input
        plain = (fp.rfft_packed_zeropad_plain(torch.from_numpy(xh))
                 if half_input else fp.rfft_packed_plain(torch.from_numpy(x)))
        assert _snr(plain[0].numpy(), new.real) >= 130.0, half_input
        assert _snr(plain[1].numpy(), new.imag) >= 130.0, half_input


@pytest.mark.parametrize("half", [0, 1, 2])
@pytest.mark.parametrize("n", SIZES)
def test_fft_split_inverse_matches_radix2_and_plain(n, half):
    wst, wnb = _twiddles(n)
    rng = np.random.default_rng(n + half)
    re, im = fp.rfft_packed_plain(torch.from_numpy(rng.standard_normal(n)))
    spec = re.numpy() + 1j * im.numpy()
    new = _split_inverse(spec, wst, wnb, half)
    assert np.array_equal(new, _ref_inverse(spec, wst, wnb, half))
    mode = {0: False, 1: "first", 2: "last"}[half]
    plain = fp.irfft_packed_plain(re, im, n, mode).numpy()
    assert plain.shape == (2 * new.size,)
    assert _snr(plain, _as_real(new)) >= 130.0


# --- the two-block cluster schedule of eqfdl_kernel (fdl_fused.cu) ---------


def _pmul(a, b, idx):
    """Packed product at packed positions idx: complex except position
    0, slot-wise there."""
    out = a * b
    z = idx == 0
    out[z] = a[z].real * b[z].real + 1j * (a[z].imag * b[z].imag)
    return out


def _mac_at(idx, s, ring, h, w):
    """acc at packed positions idx = sum_p ring'[p] H[(w - p) % P], p in
    order, slot w read as S (the kernel's MAC over its own positions)."""
    p_n = len(ring)
    acc = np.zeros(len(idx), np.complex128)
    for p in range(p_n):
        v = s[idx] if p == w else ring[p][idx]
        acc = acc + _pmul(v, h[(w - p) % p_n][idx], idx)
    return acc


def _g_corr(g_t, sv, idx):
    """g_mat @ sv at complex outputs idx, k in order (FMA chain per n)."""
    gz = g_t[:, 0::2] + 1j * g_t[:, 1::2]
    corr = np.zeros(len(idx), np.complex128)
    for k in range(g_t.shape[0]):
        corr = corr + gz[k, idx] * sv[k]
    return corr


def _eq_state_rows(m_mat, w_mat, sv, x, rows):
    return {k: float(m_mat[k] @ sv + w_mat[k] @ x) for k in rows}


def _eqfdl_one_block(xs, heq, x, sv, g_t, m_mat, w_mat, hist, ring, h, w,
                     wst, wnb):
    """eqfdl_kernel's one-block schedule: the EQ inverse, u over all M/2
    points, then the convolver block on the frame [hist || u]."""
    m = xs.size
    l = m // 2
    inv_m = 1.0 / m
    buf = _ref_inverse_core(_retangle_all(_pmul(xs, heq, np.arange(m)),
                                          wnb), wst)
    n = np.arange(l)
    u = buf[:l] * inv_m + _g_corr(g_t, sv, n)
    hz = hist[0::2] + 1j * hist[1::2]
    y, s = _fdl_one_block(hz, u, ring, h, w, wst, wnb)
    sv2 = _eq_state_rows(m_mat, w_mat, sv, x, range(len(sv)))
    return y, u, s, sv2


def _fdl_one_block(hz, xz, ring, h, w, wst, wnb):
    """The one-block schedule of the convolver block on the frame
    [hz || xz] (complex [M/2] each): the first DIF stage fused into the
    load, the other stages from span M/4, the MAC over every pair, the
    inverse, the last half."""
    l = hz.size
    m = 2 * l
    n = np.arange(l)
    frame = np.concatenate([hz + xz, (hz - xz) * wst[l + n]])
    h_ = l // 2
    while h_ >= 1:
        b = np.arange(l)
        j = b & (h_ - 1)
        i = 2 * b - j
        frame[i], frame[i + h_] = _dif_butterfly(frame[i], frame[i + h_],
                                                 wst[h_ + j])
        h_ //= 2
    s = _untangle_all(frame, wnb)
    acc = _mac_at(np.arange(m), s, ring, h, w)
    out = _ref_inverse_core(_retangle_all(acc, wnb), wst)
    return out[l:] * (1.0 / m), s


def _eqfdl_cluster(xs, heq, x, sv, g_t, m_mat, w_mat, hist, ring, h, w,
                   wst, wnb):
    """eqfdl_kernel's cluster schedule: block b holds packed positions
    [b L, (b+1) L) and does its pairs, its register passes, its quarter
    of each cross-half stage and its rows of the EQ state."""
    m = xs.size
    l = m // 2
    log_l = l.bit_length() - 1
    inv_m = 1.0 / m
    prod = _pmul(xs, heq, np.arange(m))
    bufs = []
    for b in (0, 1):                               # (a), the EQ inverse
        off = b * l
        buf = np.full(l, np.nan + 0j)
        j, jp = _half_pairs(b, l)
        buf[j - off], buf[jp - off] = _retangle(prod[j], prod[jp], wnb[j])
        if b == 0:
            buf[0] = _retangle0(prod[0])
            buf[1] = np.conj(prod[1])
        assert not np.isnan(buf).any()
        lo = 0
        while lo < log_l:
            kk = min(RADIX_BITS, log_l - lo)
            buf = _radix_pass(buf, wst, lo, kk, inverse=True)
            lo += kk
        bufs.append(buf)
    hz = hist[0::2] + 1j * hist[1::2]
    u = np.full(l, np.nan + 0j)
    new = [np.full(l, np.nan + 0j) for _ in (0, 1)]
    for b in (0, 1):                               # u + the frame's stage
        i = np.arange(b * (l >> 1), (b + 1) * (l >> 1))
        lower, _ = _dit_butterfly(bufs[0][i], bufs[1][i], wst[l + i])
        u[i] = lower * inv_m + _g_corr(g_t, sv, i)
        new[0][i], new[1][i] = _dif_butterfly(hz[i], u[i], wst[l + i])
    y, s = _fdl_tail_cluster(new, log_l, ring, h, w, wst, wnb)
    k2 = len(sv)
    sv2 = {}
    for b in (0, 1):                               # rows k = b, b + 2, ...
        sv2.update(_eq_state_rows(m_mat, w_mat, sv, x, range(b, k2, 2)))
    assert not np.isnan(u).any()
    return y, u, s, sv2


def _fdl_tail_cluster(new, rem0, ring, h, w, wst, wnb):
    """fdl_fused.cu::fdl_tail: from the two blocks' buffers after the
    frame's stages down to span 2^rem0, the other DIF stages, the MAC on
    each block's own pairs, the DIT stages but the last, and each block's
    quarter of the last stage (-> y)."""
    l = new[0].size
    m = 2 * l
    log_l = l.bit_length() - 1
    s = np.full(m, np.nan + 0j)
    acc = np.full(m, np.nan + 0j)
    for b in (0, 1):                               # frame forward, MAC
        buf = new[b]
        assert not np.isnan(buf).any()
        rem = rem0
        while rem > 0:
            kk = min(RADIX_BITS, rem)
            rem -= kk
            buf = _radix_pass(buf, wst, rem, kk, inverse=False)
        off = b * l
        j, jp = _half_pairs(b, l)
        s[j], s[jp] = _untangle(buf[j - off], buf[jp - off], wnb[j])
        own = np.concatenate([j, jp])
        if b == 0:
            s[0] = _untangle0(buf[0])
            s[1] = np.conj(buf[1])
            own = np.concatenate([[0, 1], own])
        assert np.all((own >= off) & (own < off + l))
        acc[own] = _mac_at(own, s, ring, h, w)
    bufs = []
    for b in (0, 1):                               # the FDL inverse
        off = b * l
        buf = np.full(l, np.nan + 0j)
        j, jp = _half_pairs(b, l)
        buf[j - off], buf[jp - off] = _retangle(acc[j], acc[jp], wnb[j])
        if b == 0:
            buf[0] = _retangle0(acc[0])
            buf[1] = np.conj(acc[1])
        lo = 0
        while lo < log_l:
            kk = min(RADIX_BITS, log_l - lo)
            buf = _radix_pass(buf, wst, lo, kk, inverse=True)
            lo += kk
        bufs.append(buf)
    y = np.full(l, np.nan + 0j)
    for b in (0, 1):
        i = np.arange(b * (l >> 1), (b + 1) * (l >> 1))
        _, y[i] = _dit_butterfly(bufs[0][i], bufs[1][i], wst[l + i])
    assert not (np.isnan(y).any() or np.isnan(s).any())
    return y * (1.0 / m), s


def _fdl_cluster(hz, xz, ring, h, w, wst, wnb):
    """fdl_kernel's cluster schedule: block b forms its half of the
    frame's first DIF stage as it loads its first register pass (both
    blocks read hz and xz), then fdl_tail."""
    l = hz.size
    log_l = l.bit_length() - 1
    kk = min(RADIX_BITS, log_l)
    i = np.arange(l)
    new = [_radix_pass(_dif_butterfly(hz, xz, wst[l + i])[b], wst,
                       log_l - kk, kk, inverse=False) for b in (0, 1)]
    return _fdl_tail_cluster(new, log_l - kk, ring, h, w, wst, wnb)


@pytest.mark.parametrize("m", [1 << k for k in range(8, 14)])   # 256 ... 8192
def test_eqfdl_cluster_schedule_matches_one_block_and_plain(m):
    """Two channels, a ring of P = 4 with slot w = 2 written, 2K = 6 EQ
    state rows: y, u, the written slot and the EQ state of the cluster
    schedule are bitwise the one-block schedule's, and within the card
    test's 95 dB of eqfdl_fused_plain."""
    n = 2 * m
    p_n, c, k2, w = 4, 2, 6, 2
    wst, wnb = _twiddles(n)
    rng = np.random.default_rng(m)
    f32 = np.float32
    x = (rng.standard_normal((c, m)) * 0.25).astype(f32)
    hist = (rng.standard_normal((c, m)) * 0.25).astype(f32)
    ring = rng.standard_normal((2, p_n, c, m)).astype(f32)
    h = (rng.standard_normal((2, p_n, m)) * 0.1).astype(f32)
    heq = rng.uniform(0.5, 1.5, (2, m)).astype(f32)
    sv = (rng.standard_normal((c, k2)) * 0.1).astype(f32)
    g_t = (rng.standard_normal((k2, m)) * 0.01).astype(f32)
    m_mat = (rng.standard_normal((k2, k2)) * 0.3).astype(f32)
    w_mat = (rng.standard_normal((k2, m)) * 0.01).astype(f32)
    xs = [t.numpy() for t in fp.rfft_packed_zeropad_plain(torch.from_numpy(x))]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        ring[0], ring[1], h[0], h[1], heq[0], heq[1], xs[0], xs[1], x, sv,
        g_t, m_mat, w_mat, hist)]
    ring_after = [a.clone() for a in args[:2]]
    py, pu, psv = eqfdl_fused_plain(*ring_after, *args[2:], w)
    hz = h[0].astype(np.float64) + 1j * h[1]
    heqz = heq[0].astype(np.float64) + 1j * heq[1]
    for ch in range(c):
        rz = ring[0, :, ch].astype(np.float64) + 1j * ring[1, :, ch]
        xsz = xs[0][ch].astype(np.float64) + 1j * xs[1][ch]
        common = (xsz, heqz, x[ch].astype(np.float64), sv[ch].astype(
            np.float64), g_t.astype(np.float64), m_mat.astype(np.float64),
            w_mat.astype(np.float64), hist[ch].astype(np.float64), rz, hz, w,
            wst, wnb)
        one = _eqfdl_one_block(*common)
        new = _eqfdl_cluster(*common)
        for name, a, b in zip(("y", "u", "slot"), one[:3], new[:3]):
            assert np.array_equal(a, b), (ch, name)
        assert one[3] == new[3], ch
        assert _snr(py[ch].numpy(), _as_real(new[0])) >= 95.0, ch
        assert _snr(pu[ch].numpy(), _as_real(new[1])) >= 95.0, ch
        assert _snr(ring_after[0][w, ch].numpy(), new[2].real) >= 95.0, ch
        assert _snr(ring_after[1][w, ch].numpy(), new[2].imag) >= 95.0, ch
        assert _snr(psv[ch].numpy(), [new[3][k] for k in range(k2)]) >= 95.0


@pytest.mark.parametrize("m", [1 << k for k in range(8, 14)])   # 256 ... 8192
def test_fdl_cluster_schedule_matches_one_block_and_plain(m):
    """Two channels, a ring of P = 4 with slot w = 1 written: y and the
    written slot of fdl_kernel's cluster schedule are bitwise the
    one-block schedule's, and within the card test's 95 dB of
    fdl_fused_plain."""
    n = 2 * m
    p_n, c, w = 4, 2, 1
    wst, wnb = _twiddles(n)
    rng = np.random.default_rng(m + 1)
    f32 = np.float32
    x = (rng.standard_normal((c, m)) * 0.25).astype(f32)
    hist = (rng.standard_normal((c, m)) * 0.25).astype(f32)
    ring = rng.standard_normal((2, p_n, c, m)).astype(f32)
    h = (rng.standard_normal((2, p_n, m)) * 0.1).astype(f32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        ring[0], ring[1], h[0], h[1], hist, x)]
    ring_after = [a.clone() for a in args[:2]]
    py = fdl_fused_plain(*ring_after, *args[2:], w)
    hz = h[0].astype(np.float64) + 1j * h[1]
    for ch in range(c):
        rz = ring[0, :, ch].astype(np.float64) + 1j * ring[1, :, ch]
        frame = [a[ch].astype(np.float64) for a in (hist, x)]
        frame = [a[0::2] + 1j * a[1::2] for a in frame]
        one = _fdl_one_block(*frame, rz, hz, w, wst, wnb)
        new = _fdl_cluster(*frame, rz, hz, w, wst, wnb)
        for name, a, b in zip(("y", "slot"), one, new):
            assert np.array_equal(a, b), (ch, name)
        assert _snr(py[ch].numpy(), _as_real(new[0])) >= 95.0, ch
        assert _snr(ring_after[0][w, ch].numpy(), new[1].real) >= 95.0, ch
        assert _snr(ring_after[1][w, ch].numpy(), new[1].imag) >= 95.0, ch


# --- the gate's curve track as a scan (env_units.cu) ------------------------

SCAN_CHUNK, SCAN_RUN, SCAN_LANES = 2048, 4, 32     # kChunk, kRun, a warp
STAY = 2                                           # the identity map


def _curve_map(e, k0_end, k1_start):
    """env_units.cu::curve_map: bit s = the curve after a sample at
    level e for curve s before it."""
    return (e > k0_end).astype(np.int64) | (
        np.where(e < k1_start, 0, 2).astype(np.int64))


def _then(f, g):
    """The map "f, then g"."""
    return ((g >> (f & 1)) & 1) | (((g >> (f >> 1)) & 1) << 1)


def _curve_scan(env, cur, k0_end, k1_start):
    """curve_scan as warp 1 runs it over one channel: per chunk, tiles of
    128 samples; lane i composes samples 4 i .. 4 i + 3 (past the end:
    stay), a shuffle scan composes the lanes, and the carried curve
    selects each sample's bit."""
    t_n = env.size
    out = np.full(t_n, -1, np.int64)
    stuck = cur not in (0, 1)
    lane = np.arange(SCAN_LANES)
    for c0 in range(0, t_n, SCAN_CHUNK):
        ln = min(SCAN_CHUNK, t_n - c0)
        buf = np.full(SCAN_CHUNK, np.float32(777.0))   # stale levels
        buf[:ln] = env[c0:c0 + ln]
        for t0 in range(0, ln, SCAN_RUN * SCAN_LANES):
            t = t0 + SCAN_RUN * lane
            m = []
            for r in range(SCAN_RUN):
                mr = np.where(t + r < ln,
                              _curve_map(buf[t + r], k0_end, k1_start), STAY)
                m.append(mr if r == 0 else _then(m[-1], mr))
            incl = m[-1].copy()
            off = 1
            while off < SCAN_LANES:
                before = np.roll(incl, off)             # __shfl_up_sync
                incl = np.where(lane >= off, _then(before, incl), incl)
                off <<= 1
            excl = np.where(lane == 0, STAY, np.roll(incl, 1))
            before_run = 0 if stuck else (excl >> cur) & 1
            for r in range(SCAN_RUN):
                c = np.full(SCAN_LANES, cur) if stuck else (
                    (m[r] >> before_run) & 1)
                ok = t + r < ln
                out[c0 + t[ok] + r] = c[ok]
                if r == SCAN_RUN - 1:
                    cur = int(c[-1])
    assert (out >= 0).all() or stuck
    return out, cur


def _curve_serial(env, cur, k0_end, k1_start):
    """The reference step's switch, sample by sample."""
    out = np.empty(env.size, np.int64)
    for t, e in enumerate(env):
        if cur == 0 and e > k0_end:
            cur = 1
        elif cur == 1 and e < k1_start:
            cur = 0
        out[t] = cur
    return out, cur


@pytest.mark.parametrize("cur0", [0, 1, 2])
@pytest.mark.parametrize("k0_end, k1_start", [
    (0.5, 0.25),          # the gate's: hysteresis between the two
    (0.25, 0.5),          # crossed: levels between them toggle
    (0.375, 0.375),       # equal
])
def test_gate_curve_scan_matches_serial_switch(k0_end, k1_start, cur0):
    """Two chunks and a ragged third (T = 2 x 2048 + 3 x 128 + 5): a
    slow wave across both thresholds with noise, levels exactly on each
    threshold, runs of NaN, and stretches that stay on one side for more
    than a tile.  A carried curve of 2 never switches."""
    t_n = 2 * SCAN_CHUNK + 3 * SCAN_RUN * SCAN_LANES + 5
    rng = np.random.default_rng(17)
    k = np.arange(t_n)
    env = (0.375 + 0.3 * np.sin(2 * np.pi * k / 700)
           + 0.05 * rng.standard_normal(t_n)).astype(np.float32)
    env[(k // 300) % 4 == 3] = np.float32(0.3)      # between, for 300
    env[k % 11 == 0] = np.float32(k0_end)           # on a threshold
    env[k % 13 == 0] = np.float32(k1_start)
    env[(k % 257) < 3] = np.nan
    env[-2:] = (np.float32(0.9), np.float32(0.0))   # switches in the tail
    k0, k1 = np.float32(k0_end), np.float32(k1_start)
    want, want_cur = _curve_serial(env, cur0, k0, k1)
    got, got_cur = _curve_scan(env, cur0, k0, k1)
    assert np.array_equal(got, want)
    assert got_cur == want_cur
    if cur0 in (0, 1):
        assert np.abs(np.diff(want)).sum() >= 8
        assert np.isnan(env).sum() > 0
    else:
        assert (want == 2).all()


# --- the envelope steps of env.cu ------------------------------------------


def _step_free(x, e, ta, tr, rt):
    """env.cu::free_step (peak == e, hold 0, hold time 0, tr <= ta): the
    release threshold as b = +-inf, then max(e_rise, min(e_rel, b))."""
    d = x - e
    e_rise = eu._mul_add(ta, d, e)
    e_rel = eu._mul_add(tr, d, e)
    inf = torch.full_like(e, float("inf"))
    b = inf if rt is None else torch.where(torch.signbit(rt - e), inf, -inf)
    return torch.maximum(e_rise, torch.minimum(e_rel, b))


# (kChunk, kBatch) of the chain threads: env.cu's, env_units.cu's
GEOMETRY = {"env": (256, 32), "env_units": (2048, 32)}
RT, TA = 0.3, 0.05


def _levels(t):
    """Six channels of detector levels (float32): a noisy swell across
    the threshold, exactly RT for half the block and then below it (the
    envelope falls from exactly RT), a square wave across it,
    impulses into silence, steps that repeat, and a slow ramp; channel 3
    is overwritten with the envelope itself at every 5th step."""
    rng = np.random.default_rng(5)
    k = np.arange(t)
    swell = np.sin(np.pi * k / t)
    x = np.stack([
        np.abs(rng.standard_normal(t)) * 0.6 * swell,
        np.where(k < t // 2, RT, 0.1),
        np.where((k // 150) % 2 == 0, 0.55, 0.05),
        np.where(k % 300 < 3, 0.9, 0.0) + 0.01,
        np.repeat(rng.uniform(0.0, 0.7, t // 40 + 1), 40)[:t],
        0.6 * k / t,
    ]).astype(np.float32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("geometry", GEOMETRY)
@pytest.mark.parametrize("tr", [0.004, 0.2])
@pytest.mark.parametrize("rt", [RT, None])
@pytest.mark.parametrize("nh", [0, 3, 40])
def test_reordered_envelope_step_is_bitwise_the_plain_one(nh, rt, tr,
                                                          geometry):
    """The chain thread of env.cu or env_units.cu (peak_envelope) as it
    runs: per chunk, batches of 32 that start where the envelope cannot
    hold (peak == e, hold 0, a hold time of 0, tr <= ta, ta >= 0) take
    free_step (and end with peak := e), the others and each chunk's tail
    the reference step.  Channels 2 and 4 start with peak != e and a
    hold; channel 5 rises under a peak it never reaches, so its peak
    stays apart from e for the whole block."""
    chunk, batch = GEOMETRY[geometry]
    t = 3000                 # tails: 11 x 256 + 184, 2048 + 29 x 32 + 24
    x = _levels(t)
    ta = torch.tensor(TA, dtype=torch.float32)
    tr_t = torch.tensor(tr, dtype=torch.float32)
    nh_t = torch.tensor(nh, dtype=torch.int32)
    rt_t = None if rt is None else torch.tensor(rt, dtype=torch.float32)
    e = torch.tensor([0.0, RT, 0.2, 0.5, 0.0, 0.0], dtype=torch.float32)
    peak = e + torch.tensor([0.0, 0.0, 0.1, 0.0, 0.3, 0.9])
    hold = torch.tensor([0, 0, 2, nh, 1, 0], dtype=torch.int32)
    st0 = EnvState(e, peak, hold)
    free_ok = nh == 0 and tr <= TA and TA >= 0
    seen = dict(equal=0, at_rt=0, fall_at_rt=0, up=0, down=0, expiry=0,
                free=0, general=0)
    env = torch.empty_like(x)
    free = torch.zeros_like(e, dtype=torch.bool)
    for k in range(t):
        in_batch = k % chunk < (min(chunk, t - k // chunk * chunk)
                                // batch * batch)
        if k % batch == 0:
            free = (e == peak) & (hold == 0) & free_ok & in_batch
        if k % 5 == 0:
            x[3, k] = e[3]                      # x == e
        xk = x[:, k]
        seen["equal"] += int((xk == e).sum())
        seen["at_rt"] += int((e == RT).sum())
        seen["fall_at_rt"] += int(((e == RT) & (xk < e) & (hold == 0)).sum())
        e_g, peak_g, hold_g = eu._env_step_plain(xk, e, peak, hold, ta, tr_t,
                                                 nh_t, rt_t)
        e2 = torch.where(free, _step_free(xk, e, ta, tr_t, rt_t), e_g)
        hold2 = torch.where(free, hold, hold_g)
        peak = torch.where(free, peak, peak_g)
        seen["free"] += int(free.sum())
        seen["general"] += int((~free).sum())
        seen["up"] += int(((e <= RT) & (e2 > RT)).sum())
        seen["down"] += int(((e > RT) & (e2 <= RT)).sum())
        seen["expiry"] += int(((hold == 1) & (hold2 == 0)).sum())
        e, hold = e2, hold2
        env[:, k] = e
        if k % batch == batch - 1:
            peak = torch.where(free, e, peak)
    st, ref = eu.peak_envelope_plain(st0, x, TA, tr, nh, rt)
    assert torch.equal(env, ref)
    assert torch.equal(e, st.envelope) and torch.equal(peak, st.peak)
    assert torch.equal(hold, st.hold)
    for what in ("equal", "at_rt", "fall_at_rt", "up", "down", "general"):
        assert seen[what] > 0, what
    assert seen["free"] > 0 or not free_ok
    assert seen["expiry"] > 0


# --- the batched slice as a warp-per-window copy (slicedma.cu) -------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lsp_dsp_units_tpu_torch", "csrc")


def _csrc_const(name, const):
    """An ``int`` constant of a CUDA source, so the models run with the
    kernels' own geometry."""
    with open(os.path.join(CSRC, name)) as f:
        return int(re.search(rf"constexpr int {const} = (\d+);",
                             f.read()).group(1))


SLICE_WARPS = _csrc_const("slicedma.cu", "kWarps")
SLICE_STEP = _csrc_const("slicedma.cu", "kStep")
SLICE_BATCH = _csrc_const("slicedma.cu", "kBatch")


def _slice_warp_copy(bank, starts, size):
    """slice_kernel over every block and warp at once: warp w of block b
    copies window v = b * kWarps + w (none past V); its start is clamped
    and r = s & 3; per batch of kBatch steps of 128 samples, lane l loads
    the float4 at (s - r) + 128 k + 4 l, lane 0 also the step after the
    batch (where r != 0); each lane takes the float4 offered by lane
    (l + 1) % 32 (lane 0 offers the next step's) and keeps samples r ..
    r + 3 of the pair.  Every address read is checked against the bank;
    every output sample must be written exactly once."""
    n = bank.size
    lim = n - size - SLACK
    v_n = starts.size
    blocks = -(-v_n // SLICE_WARPS)
    v = (np.arange(blocks)[:, None] * SLICE_WARPS
         + np.arange(SLICE_WARPS)).ravel()
    v = v[v < v_n]
    s = np.clip(starts[v].astype(np.int64), 0, lim)
    r = s & 3
    base = s - r
    lane = np.arange(32)
    right = (lane + 1) % 32
    quad = np.arange(4)
    out = np.zeros((v_n, size), np.float32)
    writes = np.zeros((v_n, size), np.int64)
    steps = size // SLICE_STEP
    for k0 in range(0, steps, SLICE_BATCH):
        nb = min(SLICE_BATCH, steps - k0)
        a = []
        for j in range(nb + 1):
            idx = (base[:, None, None] + SLICE_STEP * (k0 + j)
                   + 4 * lane[None, :, None] + quad)        # [V, 32, 4]
            used = np.ones(idx.shape[:2], bool)
            if j == nb:                                      # lane 0, r != 0
                used = (lane[None, :] == 0) & (r[:, None] != 0)
            assert (idx[..., 0] % 4 == 0).all()
            assert idx[used].min(initial=0) >= 0
            assert idx[used].max(initial=0) < n
            a.append(np.where(used[..., None], bank[np.clip(idx, 0, n - 1)],
                              np.float32(np.nan)))
        for j in range(nb):
            offer = a[j].copy()
            offer[:, 0] = a[j + 1][:, 0]
            pair = np.concatenate([a[j], offer[:, right]], axis=-1)
            got = np.take_along_axis(pair, r[:, None, None] + quad, axis=-1)
            col = SLICE_STEP * (k0 + j) + 4 * lane[:, None] + quad   # [32, 4]
            out[v[:, None, None], col[None]] = got
            writes[v[:, None, None], col[None]] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("size", [128, 1024, 2048])
@pytest.mark.parametrize("v_n", [1, 300, 4097])
def test_slice_warp_copy_is_bitwise_the_window(v_n, size):
    """Every residual r, the starts 0, 1, 1023, lim - 1, lim, beyond lim
    and negative (V = 1: one launch each), random starts; V = 4097 leaves
    a last block with one live warp."""
    n = 4 * size + SLACK + 640
    rng = np.random.default_rng(v_n + size)
    bank = rng.standard_normal(n).astype(np.float32)
    lim = n - size - SLACK
    edge = [0, 1, 2, 3, 1023, lim - 1, lim, lim + 5, lim + 1000, -1, -77]
    rnd = rng.integers(0, lim, max(v_n - len(edge), 0)).tolist()
    picks = [[s] for s in edge] if v_n == 1 else [(edge + rnd)[:v_n]]
    for pick in picks:
        starts = np.array(pick, np.int32)
        got = _slice_warp_copy(bank, starts, size)
        s = np.clip(starts.astype(np.int64), 0, lim)
        assert np.array_equal(got, bank[s[:, None] + np.arange(size)]), pick
        want = batched_slice_plain(torch.from_numpy(bank),
                                   torch.from_numpy(starts), size)
        assert np.array_equal(got, want.numpy())
    seen = {s % 4 for p in picks for s in p if 0 <= s <= lim}
    assert seen == {0, 1, 2, 3}


# --- the sliding RMS as independent time tiles (env_units.cu) ---------------

RMS_ITEMS = _csrc_const("env_units.cu", "kRmsItems")
RMS_TILE = _csrc_const("env_units.cu", "kRmsTile")
N_WIN, RMS_GAIN = 480, 1.5


def _rms_tiles(win, x, n, g, tile):
    """sliding_rms_kernel in float64 over every block (c, tile): the halo
    frame[t0 .. t0 + N - 1] summed as the block's threads read it (thread
    i takes t0 + i, t0 + i + threads, ...); the tile's differences
    frame[t + N] - frame[t], four consecutive per thread, scanned per
    thread, across the lanes of each warp and across the warps; each
    level that sum over N rounded once to float32 before its sqrt.
    window' entries are written by the slice of the grid that covers
    them.  Every level and window' entry must be written exactly once."""
    c_n, t_n = x.shape
    threads = tile // RMS_ITEMS
    warps = threads // 32
    v = (np.abs(x) * np.float32(g)).astype(np.float32)
    frame = np.concatenate([win, (v * v).astype(np.float32)], axis=-1)
    f64 = frame.astype(np.float64)
    tiles = -(-t_n // tile)
    level = np.zeros((c_n, t_n), np.float32)
    w_out = np.zeros((c_n, n), np.float32)
    writes = np.zeros(t_n + n, np.int64)
    for tl in range(tiles):
        t0 = tl * tile
        parts = np.zeros((c_n, threads))
        for j0 in range(t0, t0 + n, threads):
            j = j0 + np.arange(threads)
            ok = j < t0 + n
            parts += np.where(ok, f64[:, np.minimum(j, n + t_n - 1)], 0.0)
        halo = parts.reshape(c_n, warps, 32).sum(-1).sum(-1)
        t = t0 + np.arange(tile)
        ok = t < t_n
        new = np.where(ok, f64[:, np.minimum(t + n, n + t_n - 1)], 0.0)
        old = np.where(ok, f64[:, np.minimum(t, n + t_n - 1)], 0.0)
        pre = np.cumsum((new - old).reshape(c_n, threads, RMS_ITEMS), -1)
        run = pre[..., -1].reshape(c_n, warps, 32)
        incl = np.cumsum(run, -1)
        tot = incl[..., -1]
        before = np.cumsum(tot, -1) - tot
        base = halo[:, None, None] + before[..., None] + (incl - run)
        s = (base.reshape(c_n, threads)[..., None] + pre).reshape(c_n, tile)
        lv = np.sqrt(np.maximum(s / n, 0.0).astype(np.float32))
        level[:, t[ok]] = lv[:, ok]
        writes[t[ok]] += 1
        i = np.arange(n)            # tl * threads + tid + m * tiles * threads
        i = i[(i // threads) % tiles == tl]
        w_out[:, i] = frame[:, t_n + i]
        writes[t_n + i] += 1
    assert (writes == 1).all()
    return w_out, level


@pytest.mark.parametrize("tile", [RMS_TILE, RMS_TILE // 2])
@pytest.mark.parametrize("t", [1, 300, 479, 480, 481, 2049, 16383, 16384])
def test_rms_tiles_match_plain_and_float64(t, tile):
    """T < N (the first tiles' halos lie in the window), T = N +- 1, a
    ragged last tile, one and many tiles: window' exact against the
    plain version, level >= 110 dB against its float32 cumsum form and
    >= 140 dB against the float64 ideal."""
    c = 3
    rng = np.random.default_rng(t)
    win = ((rng.standard_normal((c, N_WIN)) * 0.3) ** 2).astype(np.float32)
    x = (rng.standard_normal((c, t)) * 0.25).astype(np.float32)
    w_got, l_got = _rms_tiles(win, x, N_WIN, RMS_GAIN, tile)
    w_want, l_want = eu.sliding_rms_plain(torch.from_numpy(win),
                                          torch.from_numpy(x), N_WIN,
                                          RMS_GAIN)
    assert np.array_equal(w_got, w_want.numpy())
    assert _snr(l_want.numpy(), l_got) >= 110.0
    v = (np.abs(x) * np.float32(RMS_GAIN)).astype(np.float32)
    cs = np.cumsum(np.concatenate([win, (v * v).astype(np.float32)], -1)
                   .astype(np.float64), -1)
    cs = np.pad(cs, ((0, 0), (1, 0)))
    ideal = np.sqrt(np.maximum((cs[:, N_WIN + 1:N_WIN + 1 + t]
                                - cs[:, 1:1 + t]) / N_WIN, 0.0))
    assert _snr(ideal, l_got) >= 140.0
