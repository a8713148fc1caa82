"""The dynamic delay forward's kernel schedule (``csrc/delay.cu``,
``delay_kernel``), modelled in numpy float32 on the CPU.

The kernel runs a block a row, in slots of kFwdChunk steps: producer
warps turn a chunk's delays into its slots (head, tail, feed) and, for
each of a step's two reads (tail, feed), name the last write before it
in its batch of 32: the step's own head (its x), the latest step before
it that wrote the slot (its head: x; its feed: r, the feed where a step
wrote both), or none (the ring at the batch's start); they also record
the batch's depth (a step's: 0 where no read takes an r, else one more
than its sources' most), the x values the step's reads take, and mark
the batch's last write of each slot.  The chain warp, a lane a step,
loads a batch's ring values at once, computes every r in a first round
and settles the steps that take an r (by shuffles) in one round per
level of depth; each written slot is
stored once, by its last writer.  The consumers write y (and s, in the
saving form) a slot later.  The model below repeats that schedule with
the chunk and batch read from the source, runs through the real wrapper
(``ops/delay._delay_cuda``) in place of the library, and holds every
value a step reads (tail and feed), its r and its y against the serial
order's at that step, the batch's stores against each other (one a
slot) and the ring after every batch against the serial order's, bit
for bit; the outputs (y, s, the ring) must equal
``_delay_plain(save=True)``'s bit for bit.  The drives alias on
purpose: delays of 0, f = 0, f = d, d - f >= M - 31 (a feed written
early in a batch overwritten by a later head), max_delay 0 and below
the batch (a head written twice in a batch), delays below the batch,
ramps to max_delay, the card test's random delays and chip_smoke.py's
own LFO drive, T about the chunk and the batch, and a ring above shared
memory (the scratch row).
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
RING, X, R = 0, 1, 2       # where a read takes its value


def _consts():
    with open(SRC) as f:
        src = f.read()
    warps = int(re.search(r"constexpr int kFwdWarps = (\d+);",
                          src).group(1))
    assert re.search(r"constexpr int kFwdChunk = 32 \* kFwdWarps;", src)
    rec = int(re.search(r"constexpr int kFwdRecWords = 2 \* (\d+) \* "
                        r"kFwdChunk;", src).group(1))
    return {"kFwdChunk": 32 * warps, "kFwdBatch": 32, "kFwdStepWords": rec}


def _rec_words(chunk):
    # (tail, feed, head, code), (x, fgain, x_tail, x_feed); (y, s): by
    # parity
    assert _consts()["kFwdStepWords"] == 10
    return 2 * 10 * chunk


def _smem_bytes(max_delay):
    b = 4 * (_rec_words(_consts()["kFwdChunk"]) + max_delay + 1)
    return b if b <= MAX_SMEM else 0


def _arr(p, n, dtype):
    ct = ctypes.c_int if dtype == np.int32 else ctypes.c_float
    return np.ctypeslib.as_array((ct * n).from_address(p.value))


def _bits(v):
    return np.asarray(v, f32).view(np.int32)


# the counts of the last model run
STATS = {}


def _model_fwd(x_p, d_p, g_p, fd_p, bin_p, bout_p, y_p, scratch_p, s_p,
               rows, t_n, max_delay, stream):
    kc = _consts()
    chunk, batch = kc["kFwdChunk"], kc["kFwdBatch"]
    assert batch == 32
    m = max_delay + 1
    assert (scratch_p is None) == (_smem_bytes(max_delay) > 0)
    x_a, g_a, y_a = (_arr(p, rows * t_n, f32).reshape(rows, t_n)
                     for p in (x_p, g_p, y_p))
    s_a = None if s_p is None else _arr(s_p, rows * t_n, f32).reshape(
        rows, t_n)
    d_a, fd_a = (_arr(p, rows * t_n, np.int32).reshape(rows, t_n)
                 for p in (d_p, fd_p))
    b_in, b_out = (_arr(p, rows * m, f32).reshape(rows, m)
                   for p in (bin_p, bout_p))
    nch = -(-t_n // chunk)
    stats = dict(steps=0, own_x=0, from_x=0, from_r=0, f0=0, max_rounds=0,
                 head_twice=0, feed_overwritten=0)
    i = np.arange(chunk)
    p = i % batch
    for r in range(rows):
        ring = b_in[r].copy()     # the state's layout is the circular one
        ref = ring.copy()         # the ring as the serial order leaves it
        rec, out = {}, {}
        tag = np.full(2, -1)      # the chunk each record buffer holds
        out_tag = np.full(2, -1)

        def produce(n):
            par, j = n & 1, n * chunk + i
            on = j < t_n
            jj = np.where(on, j, 0)
            d = np.where(on, np.clip(d_a[r, jj], 0, max_delay), 0)
            f = np.minimum(np.maximum(np.where(on, fd_a[r, jj], 0), 0), d)
            head = np.where(on, j % m, 0)
            tail = (head - d) % m
            feed = (tail + f) % m
            fo = np.where(on, feed, -1 - p)
            last = np.repeat(on.reshape(-1, batch).sum(1) - 1, batch)
            # the latest feed write before each step in its batch on its
            # tail, on its feed; and a later feed on its head, its feed
            kw_t, kw_f = np.full(chunk, -1), np.full(chunk, -1)
            later_h = np.zeros(chunk, bool)
            later_f = np.zeros(chunk, bool)
            for k in range(batch):
                fk = np.repeat(fo.reshape(-1, batch)[:, k], batch)
                prev, nxt = k < p, k > p
                kw_t = np.where(prev & (fk == tail), k, kw_t)
                kw_f = np.where(prev & (fk == fo), k, kw_f)
                later_h |= nxt & (fk == head)
                later_f |= nxt & (fk == fo)

            def source(kw, back, own):
                # the head write back steps behind is lane p - back's
                kx = p - back
                kind = np.where((kw >= 0) & (kw >= kx), R,
                                np.where(kx >= 0, X, RING))
                lane = np.where(kind == R, kw, np.where(kind == X, kx, 0))
                return np.where(own, X, kind), np.where(own, p, lane)

            kt, lt = source(kw_t, d, d == 0)
            kf, lf = source(kw_f, d - f, f == d)
            back_r = np.where(d > f, m - (d - f), m)
            fields = dict(
                tail=tail, feed=feed, head=head, on=on, kt=kt, lt=lt, kf=kf,
                lf=lf, f0=f == 0,
                x=np.where(on, x_a[r, jj], 0).astype(f32),
                g=np.where(on, g_a[r, jj], 0).astype(f32),
                store_x=on & (feed != head) & (p + m > last) & ~later_h,
                store_r=on & (p + back_r > last) & ~later_f)
            # the depth: 0 where no read takes an r, else one more than
            # its sources' most (they lie below)
            depth = np.zeros(chunk, int)
            for q in range(batch):
                at = np.flatnonzero(p == q)
                for kk, ll in ((kt, lt), (kf, lf)):
                    srcs = at - q + ll[at]
                    depth[at] = np.maximum(depth[at], np.where(
                        kk[at] == R, depth[srcs] + 1, 0))
            # the records carry the batch's most depth, and the x values
            # the reads take (a shuffle in the producers)
            fields["depth"] = np.repeat(depth.reshape(-1, batch).max(1),
                                        batch)
            xb = fields["x"]
            fields["xt"] = xb[i - p + lt]
            fields["xf"] = xb[i - p + lf]
            for k, v in fields.items():
                rec.setdefault(k, np.zeros((2, chunk), v.dtype))[par] = v
            tag[par] = n

        def serial(k, c):
            """One step of the serial order on ref: (s, the feed's value,
            r, y)."""
            ref[c["head"][k]] = c["x"][k]
            s = ref[c["tail"][k]]
            rf = ref[c["feed"][k]]
            w = f32(rf + f32(s * c["g"][k]))
            ref[c["feed"][k]] = w
            return s, rf, w, w if c["f0"][k] else s

        def chain(n):
            par = n & 1
            assert tag[par] == n
            ln = min(chunk, t_n - n * chunk)
            q = np.arange(batch)
            for b in range(0, ln, batch):
                c = {k: v[par, b:b + batch] for k, v in rec.items()}
                on = c["on"]
                assert (on == (q < min(batch, ln - b))).all()
                kt, lt, kf, lf = c["kt"], c["lt"], c["kf"], c["lf"]
                xv, gv = c["x"], c["g"]
                # the batch's loads, at once, of the slots it reads (an
                # r taken from the ring only stands in until its round)
                bt = np.where(kt == X, c["xt"], ring[c["tail"]]).astype(f32)
                bf = np.where(kf == X, c["xf"], ring[c["feed"]]).astype(f32)
                # the first round from them, then as many as the batch's
                # most depth
                s = bt
                rf = bf
                w = (rf + (s * gv).astype(f32)).astype(f32)
                assert (c["depth"] == c["depth"][0]).all()
                rounds = 1 + int(c["depth"][0])
                for _ in range(rounds - 1):
                    s = np.where(kt == R, w[lt], bt).astype(f32)
                    rf = np.where(kf == R, w[lf], bf).astype(f32)
                    w = (rf + (s * gv).astype(f32)).astype(f32)
                y = np.where(c["f0"], w, s).astype(f32)
                # each step against the serial order: what it reads, its
                # r and its y
                for k in np.flatnonzero(on):
                    s_r, rf_r, w_r, y_r = serial(k, c)
                    assert _bits(s_r) == _bits(s[k]), (n, b + k)
                    assert _bits(rf_r) == _bits(rf[k]), (n, b + k)
                    assert _bits(w_r) == _bits(w[k]), (n, b + k)
                    assert _bits(y_r) == _bits(y[k]), (n, b + k)
                kinds = np.concatenate([kt[on], kf[on]])
                own = np.concatenate([lt[on], lf[on]]) == np.concatenate(
                    [q[on], q[on]])
                stats["steps"] += int(on.sum())
                stats["own_x"] += int(((kinds == X) & own).sum())
                stats["from_x"] += int(((kinds == X) & ~own).sum())
                stats["from_r"] += int((kinds == R).sum())
                stats["f0"] += int(c["f0"][on].sum())
                stats["max_rounds"] = max(stats["max_rounds"], rounds)
                hd = c["head"][on]
                stats["head_twice"] += len(hd) - len(set(hd))
                stats["feed_overwritten"] += int(sum(
                    (c["head"][on][k + 1:] == c["feed"][k]).any()
                    for k in np.flatnonzero(on)
                    if c["feed"][k] != c["head"][k]))
                # the stores: one lane a slot, x or r
                sx, sr = c["store_x"], c["store_r"]
                hi, fi = c["head"][sx], c["feed"][sr]
                assert len(set(hi)) == len(hi) and len(set(fi)) == len(fi)
                assert not set(hi) & set(fi)
                ring[hi] = xv[sx]
                ring[fi] = w[sr]
                for k in ("y", "s"):
                    out.setdefault(k, np.zeros((2, chunk), f32))
                out["y"][par, b:b + batch][on] = y[on]
                out["s"][par, b:b + batch][on] = s[on]
                np.testing.assert_array_equal(ring.view(np.int32),
                                              ref.view(np.int32))
            out_tag[par] = n

        def consume(n):
            par = n & 1
            assert out_tag[par] == n
            ln = min(chunk, t_n - n * chunk)
            t = n * chunk + np.arange(ln)
            y_a[r, t] = out["y"][par, :ln]
            if s_a is not None:
                s_a[r, t] = out["s"][par, :ln]

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
        h_end = (m - 1 + t_n) % m
        b_out[r] = ring[(h_end + 1 + np.arange(m)) % m]
    STATS.clear()
    STATS.update(stats)
    return 0


class _ModelLib:
    lsp_dynamic_delay_save = staticmethod(_model_fwd)
    lsp_delay_smem_bytes = staticmethod(_smem_bytes)

    @staticmethod
    def lsp_dynamic_delay(*a):
        return _model_fwd(*a[:8], None, *a[8:])


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
    if kind == "wrap":           # d - f >= M - 31: a later head on the feed
        d = rng.integers(max_delay - 8, max_delay + 1, (rows, t))
        return d, rng.integers(0, 12, (rows, t))
    if kind == "top":            # ramps to max_delay
        d = max_delay - 13 + (np.arange(t) % 16)
        return np.broadcast_to(d, (rows, t)), rng.integers(1, 6, (rows, t))
    if kind == "short":          # delays below the batch
        d = rng.integers(0, 9, (rows, t))
        return d, rng.integers(0, 9, (rows, t))
    raise ValueError(kind)


def _run(kind, rows, t, max_delay, seed, save=True):
    rng = np.random.default_rng(seed)
    d, f = (torch.from_numpy(np.asarray(v).astype(np.int32))
            for v in _drive(kind, rows, t, max_delay, rng))
    buf = torch.from_numpy(rng.standard_normal((rows, max_delay + 1)
                                               ).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((rows, t)).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((rows, t)) * 0.5
                          ).astype(np.float32))
    ref = tdelay._delay_plain(buf, x, d, g, f, max_delay, save=True)
    before = tdelay.dynamic_delay.launches
    out = tdelay._delay_cuda(buf, x, d, g, f, max_delay, save=save)
    assert tdelay.dynamic_delay.launches == before + 1
    for a, b in zip(ref[:3 if save else 2], out):
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      a.numpy().view(np.int32))
    return dict(STATS)


@pytest.mark.parametrize("kind,rows,t,max_delay", [
    ("chip_smoke", 3, 700, 4800), ("card_random", 2, 777, 64),
    ("card_random", 1, 1, 64), ("card_random", 5, 257, 0),
    ("card_random", 1, 300, 60000), ("card_random", 2, 290, 52992),
    ("lfo", 2, 1100, 600), ("lfo", 1, 255, 40), ("lfo_f0", 2, 513, 200),
    ("d0", 2, 400, 50), ("f_eq_d", 2, 300, 30), ("f0", 2, 271, 30),
    ("short", 3, 529, 8), ("short", 2, 17, 100), ("short", 1, 15, 3),
    ("wrap", 2, 600, 100), ("wrap", 1, 300, 40), ("lfo", 1, 256, 4800),
    ("top", 2, 400, 40), ("top", 1, 300, 16), ("card_random", 2, 513, 20)])
def test_delay_fwd_schedule_model_is_the_serial_order(model, kind, rows, t,
                                                      max_delay):
    """The model through the wrapper's saving form, bit for bit the plain
    loop's y, s and ring, and every value a step reads the serial
    order's."""
    _run(kind, rows, t, max_delay, seed=rows * 1000 + t + max_delay)


@pytest.mark.parametrize("kind,t,max_delay", [
    ("chip_smoke", 513, 4800), ("short", 300, 8), ("card_random", 257, 0)])
def test_delay_fwd_schedule_model_plain_form(model, kind, t, max_delay):
    """The same through the plain form (no s written)."""
    _run(kind, 2, t, max_delay, seed=t + max_delay, save=False)


@pytest.mark.parametrize("kind,max_delay,keys", [
    ("lfo", 300, ("own_x", "from_r")), ("chip_smoke", 4800,
                                        ("own_x", "from_r")),
    ("short", 300, ("own_x", "from_x", "from_r", "f0")),
    ("wrap", 100, ("feed_overwritten",)),
    ("card_random", 20, ("head_twice", "from_x", "from_r")),
    ("d0", 300, ("own_x", "f0")), ("f_eq_d", 300, ("own_x",))])
def test_delay_fwd_schedule_model_takes_each_route(model, kind, max_delay,
                                                   keys):
    """The drives run the routes they are meant to: a read of the step's
    own head, of an x or an r of a step before in the batch, f = 0, a
    head written twice in a batch (M <= 32), a feed overwritten by a
    later head (d - f >= M - 31); and some batch runs more than its
    first round where a read takes an r."""
    st = _run(kind, 2, 640, max_delay, seed=11)
    assert all(st[k] > 0 for k in keys), st
    if "from_r" in keys:
        assert st["max_rounds"] > 1, st


def test_delay_fwd_smem_threshold_leaves_room_for_the_records():
    """The ring lives in shared memory beside the records up to 227 KB
    less them; above, the wrapper passes the scratch row (the model
    asserts the wrapper's choice)."""
    chunk = _consts()["kFwdChunk"]
    top = MAX_SMEM // 4 - _rec_words(chunk) - 1
    assert _smem_bytes(top) == MAX_SMEM - (MAX_SMEM % 4)
    assert _smem_bytes(top + 1) == 0
    assert top == 52991
