"""The limiter kernel's schedule (``csrc/limiter.cu``, ``limiter_kernel``),
modelled in numpy float32 on the CPU.

The kernel runs a block a row.  The ALR (where on) stores the row's
levels, runs the peak follower on one thread and multiplies the knee
gains in.  Then it keeps the first-index
maximum of each tile of levels (16 << shift samples; the shift grows
only on rows too long for kMaxTiles tiles) and of each group of 32 tiles
(at most 32 groups, a lane each of warp 0), and two warps run the
passes: warp 0 refreshes the groups the last pass touched and takes the
loudest group (its first among equals), that group's first tile with
that level and that tile's first index as the peak; a thread a tile of
those the patch window overlaps applies the patch to its samples and
rescans its tile.  Levels compare as ordered integers (NaN below all).  The
model below repeats that schedule with the constants read from the
source, runs through the real wrapper (``ops/limiter.limiter``'s CUDA
branch) in place of the library, and holds each pass's peak and level against the first-index argmax
of all the levels, and the tile and group maxima after every pass
against a full rescan; the gain, gcarry', alr_env' and the pass counts
must equal ``limiter_plain``'s bit for bit.  Drives: equal maxima in one
tile and across tiles, peaks whose patch crosses either end of the
levels (into the carried gains before and after them), a row that reaches the 1024-pass cap, ALR on and off (the
attack tau above and below the release tau), batched rows with different
pass counts, T not a multiple of the tile, the scratch form and a row of
longer tiles.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu_torch.models.dynamics.limiter import (Limiter,
                                                            LimiterMode)
from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import limiter as lo
from lsp_dsp_units_tpu_torch.ops.env_units import _mul_add

SRC = os.path.join(os.path.dirname(__file__), "..", "lsp_dsp_units_tpu_torch",
                   "csrc", "limiter.cu")
MAX_SMEM = 232448          # the H100's shared memory a block (227 KB)
f32 = np.float32
INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1


def _consts():
    with open(SRC) as f:
        src = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kTileLog", "kGroupLog", "kMaxTiles", "kMaxIters",
                      "kPeaksMax")}


def _tile_shift(t_n, kc):
    sh = 0
    while ((t_n - 1) >> (kc["kTileLog"] + sh)) + 1 > kc["kMaxTiles"]:
        sh += 1
    return sh


def _tile_words(t_n, p_n, kc):
    tbits = kc["kTileLog"] + _tile_shift(t_n, kc)
    n_t = ((t_n - 1) >> tbits) + 1
    # the tiles' keys and indices, the groups' (32 each), the patch with
    # a tile of zeros either side
    return 2 * n_t + 64 + p_n + 2 * (1 << tbits)


def _smem_bytes(t_n, la, p_n, alr):
    b = 4 * (_tile_words(t_n, p_n, _consts()) + (3 if alr else 2) * t_n
             + 5 * la)
    return b if b <= MAX_SMEM else 0


def _arr(p, n, dtype):
    ct = ctypes.c_int if dtype == np.int32 else ctypes.c_float
    return np.ctypeslib.as_array((ct * n).from_address(p.value))


def _fma(a, b, c):
    t = [torch.from_numpy(np.asarray(v, f32)) for v in (a, b, c)]
    return _mul_add(*torch.broadcast_tensors(*t)).numpy()


def _key(v):
    """Levels as ordered integers, NaN below all."""
    v = np.asarray(v, f32)
    b = v.view(np.int32).astype(np.int64)
    return np.where(np.isnan(v), INT_MIN, np.where(b >= 0, b, b ^ 0x7fffffff))


def _level(k):
    b = np.int64(k)
    return np.array(b if b >= 0 else b ^ 0x7fffffff, np.int64).astype(
        np.int32).view(f32)


# the counts of the last model run
STATS = {}


def _model(sc_p, gi_p, ei_p, patch_p, gain_p, go_p, eo_p, passes_p,
           scratch_p, rows, t_n, la, p_n, middle, thr, ks, ke, alr_gain, h0,
           h1, h2, tau_att, tau_rel, alr, stream):
    kc = _consts()
    assert (scratch_p is None) == (_smem_bytes(t_n, la, p_n, alr) > 0)
    thr, ks, ke, alr_gain, h0, h1, h2, ta, tr = (f32(v) for v in (
        thr, ks, ke, alr_gain, h0, h1, h2, tau_att, tau_rel))
    l5, w_n = 5 * la, t_n + 5 * la
    sc = _arr(sc_p, rows * t_n, f32).reshape(rows, t_n)
    g_in = _arr(gi_p, rows * l5, f32).reshape(rows, l5)
    e_in = _arr(ei_p, rows, f32)
    patch = _arr(patch_p, p_n, f32).copy()
    gain = _arr(gain_p, rows * t_n, f32).reshape(rows, t_n)
    g_out = _arr(go_p, rows * l5, f32).reshape(rows, l5)
    e_out = _arr(eo_p, rows, f32)
    passes = _arr(passes_p, rows, np.int32)
    tsh = _tile_shift(t_n, kc)
    tbits = kc["kTileLog"] + tsh
    n_t = ((t_n - 1) >> tbits) + 1
    gl = kc["kGroupLog"]
    n_g = ((n_t - 1) >> gl) + 1
    assert n_g <= 32          # a group a lane of the pass warp
    stats = dict(passes=[], tiles_rescanned=0, ties=0, alr_steps=0,
                 before_levels=0, past_levels=0, tsh=tsh)
    for r in range(rows):
        g = np.concatenate([g_in[r], np.ones(t_n, f32)])
        asc = np.abs(sc[r])

        def lvl():
            return (asc * g[la:la + t_n]).astype(f32)

        e = e_in[r]
        if alr:
            s_all = lvl()
            env = np.empty(t_n, f32)
            for i in range(t_n):
                s = s_all[i]
                e = f32(_fma(ta if s > e else tr, f32(s - e), e))
                env[i] = e
            stats["alr_steps"] += t_n
            m = np.maximum(env, f32(1e-12))
            herm = (_fma(h0, env, h1) + (h2 / m).astype(f32)).astype(f32)
            gg = np.where(env >= ke, (alr_gain / m).astype(f32),
                          np.where(env > ks, herm, f32(1)))
            g[la:la + t_n] = (g[la:la + t_n] * gg).astype(f32)
        e_out[r] = e

        def scan(u):
            # a tile's largest level (NaN ignored) as a key, and the
            # first index holding it (a float compare)
            i = np.arange(u << tbits, min((u + 1) << tbits, t_n))
            lv = lvl()[i]
            m = np.fmax.reduce(lv)
            return int(_key(m)), (int(i[np.argmax(lv == m)])
                                  if (lv == m).any() else INT_MAX)

        def rescan():
            k, x = zip(*(scan(u) for u in range(n_t)))
            return np.array(k, np.int64), np.array(x, np.int64)

        tkey, tidx = rescan()
        def group(q):
            # a group's key and its first tile's index
            tq = tkey[q << gl:(q + 1) << gl]
            return tq.max(), tidx[(q << gl) + int(np.argmax(tq == tq.max()))]

        gkey, gidx = (np.array(v, np.int64) for v in zip(
            *(group(q) for q in range(n_g))))
        knee, iters = f32(1), 0
        while iters < kc["kMaxIters"]:
            best = int(gkey.max())
            s = _level(best)
            if not s > thr:
                break
            q = int(np.argmax(gkey == best))
            peak = int(gidx[q])
            lv = lvl()
            assert peak == int(np.argmax(np.where(np.isnan(lv), -np.inf,
                                                  lv))), iters
            assert lv[peak].view(np.int32) == s.view(np.int32)
            stats["ties"] += int((lv == s).sum() > 1)
            k = f32(f32(s - _fma(thr, knee, f32(-1e-6)))
                    / np.maximum(s, f32(1e-12)))
            start = la + peak - middle
            at = start + np.arange(p_n)
            ok = (at >= 0) & (at < w_n)
            stats["before_levels"] += int(at[0] < la)
            stats["past_levels"] += int(at[-1] >= la + t_n)
            g[at[ok]] = (g[at[ok]] * _fma(-k, patch[ok], f32(1))).astype(f32)
            lo_, hi_ = max(peak - middle, 0), min(peak - middle + p_n,
                                                  t_n) - 1
            if lo_ <= hi_:
                for u in range(lo_ >> tbits, (hi_ >> tbits) + 1):
                    tkey[u], tidx[u] = scan(u)
                    stats["tiles_rescanned"] += 1
                for qq in range(lo_ >> tbits >> gl, (hi_ >> tbits >> gl) + 1):
                    gkey[qq], gidx[qq] = group(qq)
            # the kept maxima equal a full rescan
            fk, fi = rescan()
            assert (tkey == fk).all() and (tidx == fi).all(), iters
            iters += 1
            if iters % kc["kPeaksMax"] == 0:
                knee = f32(knee * f32(0.9886))
        passes[r] = iters
        stats["passes"].append(iters)
        lv = lvl()
        corr = np.minimum(f32(1), (thr / np.maximum(lv, f32(1e-12))
                                   ).astype(f32))
        g[la:la + t_n] = (g[la:la + t_n] * corr).astype(f32)
        gain[r] = g[:t_n]
        g_out[r] = g[t_n:]
    STATS.clear()
    STATS.update(stats)
    return 0


class _ModelLib:
    lsp_limiter = staticmethod(_model)
    lsp_limiter_smem_bytes = staticmethod(_smem_bytes)


@pytest.fixture
def model(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name, sigs: _ModelLib)
    monkeypatch.setattr(_build, "is_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "stream_of", lambda t: ctypes.c_void_p(0))


def _drive(kind, rows, t, rng):
    """Sidechains [rows, T] float32."""
    base = rng.standard_normal((rows, t)).astype(f32)
    if kind == "rising":         # rows from quiet to loud: pass counts
        return base * np.geomspace(0.05, 30.0, rows).astype(f32)[:, None]
    if kind == "cap":            # the loudest row at the 1024 cap
        return base * np.array([0.1, 300.0][:rows], f32)[:, None]
    if kind == "ties_in_tile":   # equal peaks in one tile
        x = base * f32(0.1)
        x[:, 100] = x[:, 103] = x[:, 110] = f32(2.0)
        x[:, 50] = f32(-2.0)
        return x
    if kind == "ties_across":    # equal peaks in tiles and groups apart
        x = base * f32(0.1)
        for i in (40, 300, 1200, 1999):
            x[:, min(i, t - 1)] = f32(3.0)
        return x
    if kind == "edges":          # peaks at both ends of the levels
        x = base * f32(0.1)
        x[:, :3] = f32(4.0)
        x[:, -3:] = f32(-5.0)
        return x
    if kind == "quiet":          # few passes
        x = base * f32(0.05)
        x[:, t // 3] = f32(1.5)
        return x
    raise ValueError(kind)


def _run(kind, rows, t, *, alr=False, la_ms=2.0, mode=LimiterMode.HERM_THIN,
         att=0.1, rel=0.1, seed=0):
    rng = np.random.default_rng(seed)
    lim = Limiter(48000, mode, threshold=0.2, lookahead_ms=la_ms,
                  attack_ms=att, release_ms=rel, alr=alr)
    p = lim.build(device="cpu")
    sc = torch.from_numpy(_drive(kind, rows, t, rng))
    st = lim.init_state((rows,), device="cpu")
    gc = st[0] * torch.from_numpy(
        (0.9 + 0.1 * rng.random((rows, 5 * lim.lookahead))).astype(f32))
    env = torch.from_numpy((rng.random(rows) * 0.5).astype(f32))
    want = lo.limiter_plain(p, gc, env, sc, lim.lookahead, alr)
    before = lo.limiter.launches
    got = lo.limiter(p, gc, env, sc, lim.lookahead, alr)
    assert lo.limiter.launches == before + 1
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      a.numpy().view(np.int32))
    return dict(STATS)


@pytest.mark.parametrize("kind,rows,t,alr", [
    ("rising", 4, 777, False), ("rising", 3, 1000, True),
    ("ties_in_tile", 2, 600, False), ("ties_across", 2, 2100, False),
    ("edges", 2, 501, False), ("edges", 1, 333, True),
    ("quiet", 2, 1, False), ("quiet", 2, 33, True)])
def test_limiter_schedule_model_is_the_plain_loop(model, kind, rows, t, alr):
    """The model through the wrapper, bit for bit the plain loop: gain,
    gcarry', alr_env' and the pass counts."""
    _run(kind, rows, t, alr=alr, seed=rows * 100 + t)


def test_limiter_schedule_model_at_the_cap(model):
    """A row that reaches the 1024-pass cap beside one that needs few:
    the knee's lowering and the clamp."""
    st = _run("cap", 2, 2500, seed=5)
    assert max(st["passes"]) == lo.MAX_PATCH_ITERS
    assert min(st["passes"]) < lo.MAX_PATCH_ITERS


@pytest.mark.parametrize("att,rel", [(0.1, 3.0), (3.0, 0.1)])
def test_limiter_schedule_model_alr_taus(model, att, rel):
    """The ALR with the attack tau above and below the release tau."""
    st = _run("rising", 2, 900, alr=True, la_ms=5.0,
              mode=LimiterMode.EXP_WIDE, att=att, rel=rel, seed=9)
    assert st["alr_steps"] == 2 * 900


def test_limiter_schedule_model_takes_each_route(model):
    """Ties in a tile and across tiles, patches past both ends of the
    levels (into the carry before them and after them), rows with different pass counts, a T that is no multiple of
    the tile."""
    st = _run("ties_across", 2, 2100, seed=3)
    assert st["ties"] > 0
    st = _run("edges", 2, 501, seed=4)
    assert st["before_levels"] > 0 and st["past_levels"] > 0
    st = _run("rising", 4, 777, seed=6)
    assert len(set(st["passes"])) > 2 and st["tiles_rescanned"] > 0


def test_limiter_schedule_model_scratch_and_long_tiles(model):
    """The scratch form (a row too long for shared memory) and rows long
    enough for longer tiles."""
    kc = _consts()
    t_long = (kc["kMaxTiles"] << (kc["kTileLog"] + 1)) + 1
    assert _smem_bytes(30000, 96, 289, False) == 0
    st = _run("quiet", 1, 30000, seed=7)
    assert st["tsh"] == _tile_shift(30000, kc) > 0 and st["passes"][0] > 0
    st = _run("quiet", 1, t_long, seed=8)
    assert st["tsh"] == 2 and st["passes"][0] > 0


def test_limiter_smem_fits_the_main_path():
    """[64, 16384] fits shared memory at both of config 4's limiters
    (HERM_THIN 2 ms, EXP_WIDE 5 ms with ALR); 30000 samples do not."""
    for la, alr in ((96, False), (240, True)):
        assert _smem_bytes(16384, la, 3 * la + 1, alr) > 0
        assert _smem_bytes(30000, la, 3 * la + 1, alr) == 0
