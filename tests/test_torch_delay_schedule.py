"""The dynamic delay adjoint's kernel schedule (``csrc/delay.cu``,
``delay_bwd_kernel``), modelled in numpy float32 on the CPU.

The kernel runs the adjoint in reverse time a block a row, in slots of
kBwdChunk steps: producer warps turn a chunk's delays into its slots
(tail, feed, head) and mark each step of a batch of 32 fw (its tail is
the one the step before wrote: take it from that step) or slow (any
other slot it reads written by a step before it in the batch, or f == 0,
its feed its own tail: the serial order); the chain warp, a lane a step,
loads the lam values of a batch's other steps at once and runs the batch
as segments split at its slow steps (a segment's steps at once, fw runs
resolved by shuffles, its stores; then the slow step alone); the
consumers write g_x and fgain's cotangent a slot later.  The model below
repeats that schedule with the chunk and batch read from the source,
runs through the real wrapper (``ops/delay._delay_bwd_cuda``) in place of
the library, and holds every value a step takes from the batch's loads
(or from the step before) against what the serial order reads at that
step, every step's results against the serial order's, a segment's
stores against each other (no two lanes on one slot) and the ring after
every segment and slow step against the serial order's, bit for bit; the
outputs must equal ``dynamic_delay_bwd_plain``'s bit for bit.  The
drives alias on purpose: delays of 0, f = 0, f = d, delays below the
batch, ramps to max_delay (whose feed meets a head zeroed a few steps
before), the card test's random delays, fast LFO sweeps and
chip_smoke.py's own drive, T about the chunk and the batch, max_delay 0,
and a ring above shared memory (the scratch row).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import delay as tdelay
from lsp_dsp_units_tpu_torch.tools import serial_profile

SRC = os.path.join(os.path.dirname(__file__), "..", "lsp_dsp_units_tpu_torch",
                   "csrc", "delay.cu")
MAX_SMEM = 232448          # the H100's shared memory a block (227 KB)
f32 = np.float32


def _consts():
    with open(SRC) as f:
        src = f.read()
    warps = int(re.search(r"constexpr int kBwdWarps = (\d+);",
                          src).group(1))
    assert re.search(r"constexpr int kBwdChunk = 32 \* kBwdWarps;", src)
    return {"kBwdChunk": 32 * warps, "kBwdBatch": 32}


def _rec_words(chunk):
    # tail, feed, head, code, g_y, fgain; g_x, lam[feed]: by parity
    return 2 * 8 * chunk


def _smem_bytes(max_delay):
    b = 4 * (_rec_words(_consts()["kBwdChunk"]) + max_delay + 1)
    return b if b <= MAX_SMEM else 0


def _arr(p, n, dtype):
    ct = ctypes.c_int if dtype == np.int32 else ctypes.c_float
    return np.ctypeslib.as_array((ct * n).from_address(p.value))


def _bits(v):
    return np.asarray(v, f32).view(np.int32)


# the counts of the last model run: steps taken from the batch's start,
# of those with lam[tail] from the step before, serial steps
STATS = {}


def _model_bwd(gy_p, d_p, g_p, fd_p, s_p, gout_p, gin_p, gx_p, gg_p,
               scratch_p, rows, t_n, max_delay, stream):
    kc = _consts()
    chunk, batch = kc["kBwdChunk"], kc["kBwdBatch"]
    m = max_delay + 1
    assert (scratch_p is None) == (_smem_bytes(max_delay) > 0)
    gy_a, g_a, s_a, gx_a, gg_a = (
        _arr(p, rows * t_n, f32).reshape(rows, t_n)
        for p in (gy_p, g_p, s_p, gx_p, gg_p))
    d_a, fd_a = (_arr(p, rows * t_n, np.int32).reshape(rows, t_n)
                 for p in (d_p, fd_p))
    g_out, g_in = (_arr(p, rows * m, f32).reshape(rows, m)
                   for p in (gout_p, gin_p))
    nch = -(-t_n // chunk)
    stats = dict(steps=0, from_w=0, from_zero=0, f0=0, d0=0, fd=0,
                 max_iters=0)
    assert batch == 32
    i = np.arange(chunk)
    p = i % batch
    for r in range(rows):
        h_end = (m - 1 + t_n) % m
        lam = np.empty(m, f32)
        lam[(h_end + 1 + np.arange(m)) % m] = g_out[r]
        ref = lam.copy()          # lam as the serial order leaves it
        rec = {k: np.zeros((2, chunk), np.int32)
               for k in ("tail", "feed", "head", "src_t", "src_f", "src_h",
                         "depth")}
        rec.update({k: np.zeros((2, chunk), f32) for k in ("gy", "g")})
        rec.update({k: np.zeros((2, chunk), bool)
                    for k in ("on", "f0", "d0", "fd", "store_w", "store_z")})
        out = {k: np.zeros((2, chunk), f32) for k in ("gx", "lf")}
        tag = np.full(2, -1)          # the chunk each record buffer holds
        out_tag = np.full(2, -1)

        def produce(n):
            par, j = n & 1, n * chunk + i
            on = j < t_n
            t = np.where(on, t_n - 1 - j, 0)
            d = np.where(on, np.clip(d_a[r, t], 0, max_delay), 0)
            f = np.minimum(np.maximum(np.where(on, fd_a[r, t], 0), 0), d)
            head = np.where(on, t % m, 0)
            tail = (head - d) % m
            feed = (tail + f) % m
            # the batch's last step (its steps on are its first lanes)
            last = np.repeat(on.reshape(-1, batch).sum(1) - 1, batch)
            # the latest step before each in its batch whose tail is a
            # slot it reads, and whether a step after it writes its tail
            # or head, from the batch's tails one lane at a time
            kw = {x: np.full(chunk, -1) for x in ("t", "f", "h")}
            later_t = np.zeros(chunk, bool)
            later_h = np.zeros(chunk, bool)
            for k in range(batch):
                tk = np.repeat(tail.reshape(-1, batch)[:, k], batch)
                onk = np.repeat(on.reshape(-1, batch)[:, k], batch)
                prev, nxt = onk & (k < p), onk & (k > p)
                for x, v in (("t", tail), ("f", feed), ("h", head)):
                    kw[x] = np.where(prev & (tk == v), k, kw[x])
                later_t |= nxt & (tk == tail)
                later_h |= nxt & (tk == head)

            def zero_before(x):
                # the latest step before whose head is x: heads run t + 1,
                # t + 2, ... over the steps before
                u = (x - head) % m
                k = p - np.where(u == 0, m, u)
                return np.where(k >= 0, k, -1)

            def src(kw_x, kz_x):
                # -1: the batch's load; 32: zero; else the lane's W
                return np.where(np.maximum(kw_x, kz_x) < 0, -1,
                                np.where(kz_x >= kw_x, 32, kw_x))

            fields = dict(
                tail=tail, feed=feed, head=head, on=on,
                src_t=src(kw["t"], zero_before(tail)),
                src_f=src(kw["f"], zero_before(feed)),
                src_h=src(kw["h"], zero_before(head)),
                gy=np.where(on, gy_a[r, t], 0), g=np.where(on, g_a[r, t], 0),
                f0=f == 0, d0=d == 0, fd=(f == d) & (d != 0),
                # the last write of a slot in the batch is the one stored:
                # W unless a later step writes the tail or zeroes it (the
                # step d after, or the step itself where d = 0: its head
                # is its tail); the zero unless a later step writes the
                # head (or zeroes it again, M steps on)
                store_w=on & ~later_t & ~(p + d <= last),
                store_z=on & ~later_h & ~(p + m <= last))
            # the depth: 0 where the tail and feed take no W from a
            # lane, else one more than the sources' most (they lie below)
            lane_t = on & (fields["src_t"] >= 0) & (fields["src_t"] < 32)
            lane_f = (on & (f != 0) & (fields["src_f"] >= 0)
                      & (fields["src_f"] < 32))
            depth = np.zeros(chunk, int)
            for q in range(batch):
                at = np.flatnonzero(p == q)
                for lane, src_k in ((lane_t, "src_t"), (lane_f, "src_f")):
                    srcs = at - q + fields[src_k][at].clip(0, 31)
                    depth[at] = np.maximum(depth[at], np.where(
                        lane[at], depth[srcs] + 1, 0))
            fields["depth"] = depth
            for k, v in fields.items():
                rec[k][par] = v
            tag[par] = n

        def serial(mem, ti, fi, hi, gy, gv):
            a = mem[ti]
            lt = f32(a + gy)
            mem[ti] = lt
            lf = mem[fi]
            w = f32(lt + f32(lf * gv))
            mem[ti] = w
            gx = mem[hi]
            mem[hi] = 0
            return a, lt, w, gx, lf

        def chain(n):
            par = n & 1
            assert tag[par] == n
            ln = min(chunk, t_n - n * chunk)
            q = np.arange(batch)
            for b in range(0, ln, batch):
                c = {k: v[par, b:b + batch] for k, v in rec.items()}
                on, f0, d0, fd = c["on"], c["f0"], c["d0"], c["fd"]
                assert (on == (q < min(batch, ln - b))).all()
                st, sf, sh = c["src_t"], c["src_f"], c["src_h"]
                gy, gv = c["gy"], c["g"]
                # the batch's loads, at once, of the slots no step before
                # wrote
                a_pre = np.where(on & (st < 0), lam[c["tail"]], 0).astype(f32)
                lf_pre = np.where(on & ~f0 & (sf < 0), lam[c["feed"]],
                                  0).astype(f32)
                gx_pre = np.where(on & ~d0 & ~fd & (sh < 0),
                                  lam[c["head"]], 0).astype(f32)

                def take(src, pre, w):
                    return np.where(src < 0, pre, np.where(
                        src == 32, f32(0), w[src & 31])).astype(f32)

                # the first round from the loads alone (a W from a lane
                # taken as 0), then as many as the batch's most depth
                w = np.zeros(batch, f32)
                iters = 1 + int(c["depth"][on].max(initial=0))
                for _ in range(iters):
                    lt = (take(st, a_pre, w) + gy).astype(f32)
                    lf = np.where(f0, lt, take(sf, lf_pre, w)).astype(f32)
                    w = (lt + (lf * gv).astype(f32)).astype(f32)
                gx = np.where(d0, w, np.where(fd, lf, take(sh, gx_pre, w))
                              ).astype(f32)
                # each step against the serial order
                for k in np.flatnonzero(on):
                    a_r, lt_r, w_r, gx_r, lf_r = serial(
                        ref, c["tail"][k], c["feed"][k], c["head"][k], gy[k],
                        gv[k])
                    assert _bits(lt_r) == _bits(lt[k]), (n, b + k)
                    assert _bits(w_r) == _bits(w[k]), (n, b + k)
                    assert _bits(gx_r) == _bits(gx[k]), (n, b + k)
                    assert _bits(lf_r) == _bits(lf[k]), (n, b + k)
                stats["steps"] += int(on.sum())
                stats["from_w"] += int(((st >= 0) & (st < 32))[on].sum())
                stats["from_zero"] += int((st == 32)[on].sum()
                                          + (sf == 32)[on & ~f0].sum())
                stats["f0"] += int(f0[on].sum())
                stats["d0"] += int(d0[on].sum())
                stats["fd"] += int(fd[on].sum())
                stats["max_iters"] = max(stats["max_iters"], iters)
                # the stores: one lane a slot, W or zero
                sw, sz = c["store_w"], c["store_z"]
                ti, hi = c["tail"][sw], c["head"][sz]
                assert len(set(ti)) == len(ti) and len(set(hi)) == len(hi)
                assert not set(ti) & set(hi)
                lam[ti] = w[sw]
                lam[hi] = 0
                out["gx"][par, b:b + batch][on] = gx[on]
                out["lf"][par, b:b + batch][on] = lf[on]
                np.testing.assert_array_equal(lam.view(np.int32),
                                              ref.view(np.int32))
            out_tag[par] = n

        def consume(n):
            par = n & 1
            assert out_tag[par] == n
            ln = min(chunk, t_n - n * chunk)
            t = t_n - 1 - (n * chunk + np.arange(ln))
            gx_a[r, t] = out["gx"][par, :ln]
            gg_a[r, t] = out["lf"][par, :ln] * s_a[r, t]

        produce(0)
        for s in range(nch + 1):
            # the next chunk's records land before the chain reads, the
            # last chunk's outputs are read after it wrote
            if s + 1 < nch:
                produce(s + 1)
            if s < nch:
                chain(s)
            if s > 0:
                consume(s - 1)
        g_in[r] = lam
    STATS.clear()
    STATS.update(stats)
    return 0


class _ModelLib:
    lsp_dynamic_delay_bwd = staticmethod(_model_bwd)
    lsp_delay_bwd_smem_bytes = staticmethod(_smem_bytes)


@pytest.fixture
def model(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name, sigs: _ModelLib)
    monkeypatch.setattr(_build, "stream_of", lambda t: ctypes.c_void_p(0))


def _lfo(t, max_delay, period, rows):
    """Delays swept by a sine of ``period`` samples over 0..max_delay,
    the rows' phases spread."""
    n = np.arange(t)[None, :] / period + np.arange(rows)[:, None] / rows
    return ((np.sin(2 * np.pi * n) + 1) * 0.5 * max_delay).astype(np.int32)


def _drive(kind, rows, t, max_delay, rng):
    if kind == "chip_smoke":
        d, f = serial_profile.synth_drive()
        sel = np.linspace(0, d.shape[0] - 1, rows).astype(int)
        return d[sel, 3000:3000 + t], f[sel, 3000:3000 + t]
    if kind == "card_random":
        return (rng.integers(-3, max_delay + 5, (rows, t)),
                rng.integers(-3, max_delay + 2, (rows, t)))
    if kind == "lfo":
        d = _lfo(t, max_delay, 400, rows)
        return d, rng.integers(0, max_delay + 1, (rows, t))
    if kind == "lfo_f0":
        return _lfo(t, max_delay, 300, rows), np.zeros((rows, t))
    if kind == "d0":
        return np.zeros((rows, t)), rng.integers(-2, 3, (rows, t))
    if kind == "f_eq_d":
        d = rng.integers(0, max_delay + 1, (rows, t))
        return d, d
    if kind == "f0":
        return rng.integers(0, max_delay + 1, (rows, t)), np.zeros((rows, t))
    if kind == "top":            # ramps to max_delay: fw on heads zeroed
        d = max_delay - 13 + (np.arange(t) % 16)
        return np.broadcast_to(d, (rows, t)), rng.integers(1, 6, (rows, t))
    if kind == "short":          # delays below the batch
        d = rng.integers(0, 9, (rows, t))
        return d, rng.integers(0, 9, (rows, t))
    raise ValueError(kind)


def _run(kind, rows, t, max_delay, seed):
    rng = np.random.default_rng(seed)
    d, f = (torch.from_numpy(np.asarray(v).astype(np.int32))
            for v in _drive(kind, rows, t, max_delay, rng))
    buf = torch.from_numpy(rng.standard_normal((rows, max_delay + 1)
                                               ).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((rows, t)).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((rows, t)) * 0.5
                          ).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((rows, t)).astype(np.float32))
    gb = torch.from_numpy(rng.standard_normal((rows, max_delay + 1)
                                              ).astype(np.float32))
    _, _, s = tdelay._delay_plain(buf, x, d, g, f, max_delay, save=True)
    ref = tdelay.dynamic_delay_bwd_plain(buf, x, d, g, f, s, gy, gb,
                                         max_delay)
    before = tdelay.dynamic_delay_bwd.launches
    out = tdelay._delay_bwd_cuda(x, d, g, f, s, gy, gb, max_delay)
    assert tdelay.dynamic_delay_bwd.launches == before + 1
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      a.numpy().view(np.int32))
    return dict(STATS)


@pytest.mark.parametrize("kind,rows,t,max_delay", [
    ("chip_smoke", 3, 700, 4800), ("card_random", 2, 777, 64),
    ("card_random", 1, 1, 64), ("card_random", 5, 257, 0),
    ("card_random", 1, 300, 60000), ("lfo", 2, 1100, 600),
    ("lfo", 1, 255, 40), ("lfo_f0", 2, 513, 200), ("d0", 2, 400, 50),
    ("f_eq_d", 2, 300, 30), ("f0", 2, 271, 30), ("short", 3, 529, 8),
    ("short", 2, 17, 100), ("short", 1, 15, 3), ("lfo", 1, 256, 4800),
    ("top", 2, 400, 40), ("top", 1, 300, 16)])
def test_delay_bwd_schedule_model_is_the_plain_adjoint(model, kind, rows, t,
                                                       max_delay):
    """The model through the wrapper, bit for bit the plain adjoint, and
    every lam value a step takes from its batch's loads or from a step
    before the one the serial order reads."""
    _run(kind, rows, t, max_delay, seed=rows * 1000 + t + max_delay)


@pytest.mark.parametrize("kind,keys", [
    ("lfo", ("from_w", "from_zero", "fd")), ("chip_smoke", ("from_w", "fd")),
    ("top", ("from_w", "from_zero")), ("d0", ("d0", "f0")), ("f0", ("f0",)),
    ("f_eq_d", ("fd",)), ("short", ("from_w", "d0", "f0"))])
def test_delay_bwd_schedule_model_takes_each_route(model, kind, keys):
    """The drives run the routes they are meant to: a read from a step
    before in the batch (its W, or a zero), the feed on the step's own
    tail (f = 0), the head on it (d = 0), the feed on the head (f = d);
    and some batch runs more than its first round (a step that takes a W
    from a lane)."""
    st = _run(kind, 2, 640, 300 if kind != "chip_smoke" else 4800, seed=7)
    assert all(st[k] > 0 for k in keys), st
    if "from_w" in keys:
        assert st["max_iters"] > 1, st


def test_delay_bwd_smem_threshold_leaves_room_for_the_records():
    """lam lives in shared memory beside the records up to 227 KB less
    them; above, the wrapper passes the scratch row (the model asserts
    the wrapper's choice)."""
    chunk = _consts()["kBwdChunk"]
    top = MAX_SMEM // 4 - _rec_words(chunk) - 1
    assert _smem_bytes(top) == MAX_SMEM - (MAX_SMEM % 4)
    assert _smem_bytes(top + 1) == 0
    assert 4800 < top < 60000
