"""SamplePlayer — polyphonic sample playback on the batch model
(reference: src/main/sampling/SamplePlayer.cpp, helpers/playback.cpp,
helpers/batch.cpp, Playback.h, PlaySettings.h, sampling/types.h).

The reference schedules playback as a chain of *batches* — HEAD (from
the start position to the loop), LOOP (one pass over the loop range,
direction per loop mode), TAIL (leaving the loop to the sample end) —
where consecutive non-sequential batches overlap by a crossfade
(playback.cpp:408-454: the previous batch fades out while the next
fades in; a HEAD extends forward into the loop instead of shifting).
This port keeps that state machine on the host (it is tiny, data
independent control flow) and mixes each batch overlap as one
vectorized gather + fade-weight add per block — the per-sample batch
loop of helpers/batch.cpp becomes array math.  A copy of the JAX
package's models/sampling/player.py: host numpy, the semantics the
device mixdown (device_mix.py) is held to.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from lsp_dsp_units_tpu_torch.models.sampling.sample import Sample


class LoopMode(enum.Enum):
    """(reference sampling/types.h:79-132, sample_loop_t)"""
    NONE = "none"
    DIRECT = "direct"                     # always start -> end
    REVERSE = "reverse"                   # always end -> start
    DIRECT_HALF_PP = "direct_half_pp"     # ping-pong, leave any direction
    REVERSE_HALF_PP = "reverse_half_pp"
    DIRECT_FULL_PP = "direct_full_pp"     # leave only after reversed part
    REVERSE_FULL_PP = "reverse_full_pp"   # leave only after direct part
    DIRECT_SMART_PP = "direct_smart_pp"   # leave only after direct part
    REVERSE_SMART_PP = "reverse_smart_pp"


_PP_MODES = {LoopMode.DIRECT_HALF_PP, LoopMode.REVERSE_HALF_PP,
             LoopMode.DIRECT_FULL_PP, LoopMode.REVERSE_FULL_PP,
             LoopMode.DIRECT_SMART_PP, LoopMode.REVERSE_SMART_PP}
_DIRECT_FIRST = {LoopMode.DIRECT, LoopMode.DIRECT_HALF_PP,
                 LoopMode.DIRECT_FULL_PP, LoopMode.DIRECT_SMART_PP}
# leave-the-loop permission (playback.cpp:272-335): after which batch
# direction may a TAIL follow?  HALF_PP modes leave in ANY direction
# (playback.cpp:317-334 groups them with plain DIRECT/REVERSE); only
# the FULL/SMART ping-pongs schedule one more opposite pass.
_LEAVE_AFTER_REVERSE = {LoopMode.DIRECT_FULL_PP}
_LEAVE_AFTER_DIRECT = {LoopMode.REVERSE_FULL_PP, LoopMode.DIRECT_SMART_PP,
                       LoopMode.REVERSE_SMART_PP}


class XFadeType(enum.Enum):
    LINEAR = "linear"
    CONST_POWER = "const_power"


@dataclass
class PlaySettings:
    """(reference PlaySettings.h parameter bag)"""
    sample_id: int = 0
    channel: int = 0
    volume: float = 1.0
    delay: int = 0
    start: int = 0
    loop_start: int = -1
    loop_end: int = -1
    loop_mode: LoopMode = LoopMode.NONE
    xfade_type: XFadeType = XFadeType.LINEAR
    xfade_length: int = 0
    reverse: bool = False


_HEAD, _LOOP, _TAIL = 0, 1, 2


@dataclass
class _Batch:
    ts: int          # playback-relative output timestamp
    start: int       # sample range [start, end): end > start plays
    end: int         # forward; end < start plays start-1 .. end
    btype: int
    fade_in: int = 0
    fade_out: int = 0
    extended: bool = False   # HEAD already extended by xfade

    @property
    def length(self) -> int:
        return abs(self.end - self.start)

    @property
    def forward(self) -> bool:
        return self.end >= self.start


_PLAY, _STOP, _CANCEL, _DONE = 0, 1, 2, 3


@dataclass
class Playback:
    """Handle over a live playback (reference Playback.h)."""
    settings: PlaySettings
    serial: int = 0
    state: int = _PLAY
    clock: int = 0                     # samples rendered so far
    chain: List["_Batch"] = field(default_factory=list)
    loop_mode: LoopMode = LoopMode.NONE
    loop_start: int = 0
    loop_end: int = 0
    xfade: int = 0
    cancel_at: int = -1
    cancel_len: int = 0

    @property
    def active(self) -> bool:
        return self.state != _DONE

    def stop(self, delay: int = 0) -> None:
        """Leave the loop gracefully at timestamp ``clock + delay``:
        loop passes keep scheduling while the stop point lies beyond
        the end of the batch being planned, then the mode's leave rule
        applies and the tail plays (reference playback.cpp:732-741
        stop_playback sets nCancelTime = nTimestamp + delay;
        loop_not_allowed at :42-63 compares it with the batch end).

        NOTE reference-verbatim: a second stop() while already in the
        STOP state is IGNORED (playback.cpp:735-736 guards
        ``enState != STATE_PLAY``) — a pending stop time cannot be
        shortened or extended; use cancel() to override it."""
        if self.state == _PLAY:
            self.state = _STOP
            self.cancel_at = self.clock + int(delay)

    def cancel(self, fadeout: int = 0, delay: int = 0) -> None:
        """Fade out over ``fadeout`` samples starting at
        ``clock + delay`` and deactivate (reference
        playback.cpp:744-765 cancel_playback / apply_fade_out)."""
        if self.state in (_PLAY, _STOP):
            self.state = _CANCEL
            self.cancel_at = self.clock + int(delay)
            self.cancel_len = int(fadeout)


# -- batch state machine (reference helpers/playback.cpp) -----------------


def _initial_batch(pb: Playback, sample_len: int) -> _Batch:
    s = pb.settings
    start = min(max(int(s.start), 0), sample_len - 1)
    rev = bool(s.reverse)

    if pb.loop_mode == LoopMode.NONE:
        return _Batch(ts=int(s.delay), start=start,
                      end=0 if rev else sample_len, btype=_TAIL)

    ls, le = pb.loop_start, pb.loop_end
    if start < ls:
        if rev:
            return _Batch(int(s.delay), start, 0, _TAIL)
        return _Batch(int(s.delay), start, ls, _HEAD)
    if start < le:
        if pb.loop_mode in _DIRECT_FIRST:
            end = ls if rev else le
        else:
            end = le if rev else ls
        return _Batch(int(s.delay), start, end, _LOOP)
    if rev:
        return _Batch(int(s.delay), start, le, _HEAD)
    return _Batch(int(s.delay), start, sample_len, _TAIL)


def _loop_batch_after(pb: Playback, cur: _Batch) -> _Batch:
    """Next LOOP batch range per the loop mode (playback.cpp:338-395)."""
    ls, le = pb.loop_start, pb.loop_end
    rev = bool(pb.settings.reverse)
    mode = pb.loop_mode
    if mode == LoopMode.DIRECT:
        return _Batch(0, le if rev else ls, ls if rev else le, _LOOP)
    if mode == LoopMode.REVERSE:
        return _Batch(0, ls if rev else le, le if rev else ls, _LOOP)
    # ping-pong: reverse the direction of the current loop batch; after
    # a HEAD, the first repeat direction comes from the mode family
    if cur.btype == _HEAD:
        if mode in _DIRECT_FIRST:
            return _Batch(0, le if rev else ls, ls if rev else le, _LOOP)
        return _Batch(0, ls if rev else le, le if rev else ls, _LOOP)
    if cur.forward:
        return _Batch(0, le, ls, _LOOP)
    return _Batch(0, ls, le, _LOOP)


def _may_leave_loop(pb: Playback, cur: _Batch) -> bool:
    mode = pb.loop_mode
    if mode in _LEAVE_AFTER_REVERSE:
        return (not cur.forward) if not pb.settings.reverse else cur.forward
    if mode in _LEAVE_AFTER_DIRECT:
        return cur.forward if not pb.settings.reverse else (not cur.forward)
    return True        # DIRECT / REVERSE / HALF_PP: leave any time


def _tail_batch(pb: Playback, sample_len: int) -> _Batch:
    if pb.settings.reverse:
        return _Batch(0, pb.loop_start, 0, _TAIL)
    return _Batch(0, pb.loop_end, sample_len, _TAIL)


def _sequential(prev: _Batch, nxt: _Batch) -> bool:
    """No crossfade needed when the next batch continues exactly
    (playback.cpp:35-40)."""
    if prev.end != nxt.start:
        return False
    return nxt.forward if prev.forward else (not nxt.forward)


def _compute_next(pb: Playback, cur: _Batch,
                  sample_len: int) -> Optional[_Batch]:
    """compute_next_batch (playback.cpp:409-454): range + crossfade
    timing.  Mutates ``cur``'s fade_out/end for the overlap — a batch's
    fades are FINAL only once its successor has been computed."""
    if cur is None or cur.btype == _TAIL:
        return None
    # stop/cancel do not kill the loop outright: passes keep scheduling
    # while the cancellation point lies strictly beyond the end of the
    # batch whose successor is being planned (playback.cpp:42-63
    # loop_not_allowed: nCancelTime <= nTimestamp + batch_len).  The
    # length is the pre-extension one — the reference plans successors
    # before applying the head's crossfade extension.
    base_len = cur.length - (pb.xfade if cur.extended else 0)
    loop_allowed = (pb.state == _PLAY
                    or pb.cancel_at > cur.ts + base_len)
    if cur.btype == _HEAD and not loop_allowed:
        # after-head tail skips the loop; in reverse the head ends at
        # loop_end and the tail continues DOWN to 0 (playback.cpp:193-201)
        if pb.settings.reverse:
            nxt = _Batch(0, pb.loop_end, 0, _TAIL)
        else:
            nxt = _Batch(0, pb.loop_start, sample_len, _TAIL)
    elif not loop_allowed and _may_leave_loop(pb, cur):
        nxt = _tail_batch(pb, sample_len)
    else:
        nxt = _loop_batch_after(pb, cur)

    # timestamp from the UNextended length (reference computes it before
    # the head extension, playback.cpp:431)
    nxt.ts = cur.ts + base_len
    cur.fade_out = 0
    nxt.fade_in = 0
    xf = pb.xfade
    if xf > 0 and not _sequential(cur, nxt):
        cur.fade_out = xf
        nxt.fade_in = xf
        if cur.btype == _HEAD:
            # head end extension is UNCONDITIONALLY += (so a reverse
            # head gets shortened by xf) — reference-verbatim behavior
            # (playback.cpp:452 `s->nEnd += pb->nXFade`, no bReverse
            # branch); parity wins over symmetry
            if not cur.extended:
                cur.end += xf
                cur.extended = True
        else:
            nxt.ts -= xf
            if nxt.btype == _TAIL:
                # unconditional -= like the reference (playback.cpp:449),
                # which shifts a reverse tail the "wrong" way — parity
                nxt.start -= xf
    return nxt


# -- mixing ---------------------------------------------------------------


def _mix_batch(out: np.ndarray, data: np.ndarray, b: _Batch, t0: int,
               volume: float, fade: XFadeType) -> None:
    """Accumulate the overlap of batch ``b`` with output window
    [t0, t0+len(out)) (reference helpers/batch.cpp, vectorized).

    Hot path at high polyphony (a 256-voice mixdown calls this once per
    voice-batch per block — benchmarks/polyphony.py), so the common
    case — a contiguous monotone segment with no fade crossing the
    window — mixes as a strided slice with a scalar weight: no index
    gather, no weight array, no f64 round trip."""
    blen = b.length
    lo = max(b.ts, t0)
    hi = min(b.ts + blen, t0 + out.size)
    if hi <= lo:
        return
    r0, r1 = lo - b.ts, hi - b.ts
    fi = min(b.fade_in, blen)
    fo = min(b.fade_out, blen)

    # fast path: the window overlap touches no fade region (weight is
    # identically 1 there) and stays inside the sample, so the batch
    # mixes as a strided slice; arithmetic stays f64-then-round, bit
    # identical to the general path below
    if r0 >= fi and r1 <= blen - fo:
        seg = None
        if b.forward:
            i0, i1 = b.start + r0, b.start + r1
            if i0 >= 0 and i1 <= data.size:
                seg = data[i0:i1]
        else:
            hi_i = b.start - r0          # exclusive top, stepping down
            lo_i = b.start - r1
            if lo_i >= 0 and hi_i <= data.size:
                seg = data[hi_i - 1: lo_i - 1 if lo_i > 0 else None: -1]
        if seg is not None:
            out[lo - t0:hi - t0] += (seg.astype(np.float64)
                                     * volume).astype(np.float32)
            return

    rel = np.arange(r0, r1)
    idx = (b.start + rel) if b.forward else (b.start - 1 - rel)
    np.clip(idx, 0, data.size - 1, out=idx)
    g = data[idx].astype(np.float64)
    w = np.ones(rel.size)
    if fi > 0:
        m = rel < fi
        w[m] = rel[m] / fi
    if fo > 0:
        m = rel >= blen - fo
        w[m] = np.minimum(w[m], (blen - rel[m]) / fo)
    if fade is XFadeType.CONST_POWER:
        w = np.sqrt(w)
    out[lo - t0:hi - t0] += (g * w * volume).astype(np.float32)


class SamplePlayer:
    def __init__(self, max_samples: int = 64, max_playbacks: int = 64):
        self.samples: Dict[int, Sample] = {}
        self.max_samples = int(max_samples)
        self.max_playbacks = int(max_playbacks)
        self.playbacks: List[Playback] = []
        self._serial = 0
        self.gain = 1.0

    # -- bank management (reference SamplePlayer bind/unbind) --------------
    def bind(self, sample_id: int, sample: Sample) -> None:
        """Bind a sample into the bank; the bank size is bounded like
        the reference's init(max_samples) allocation."""
        if sample_id not in self.samples \
                and len(self.samples) >= self.max_samples:
            raise ValueError(
                f"sample bank full ({self.max_samples}); unbind first "
                f"or construct SamplePlayer(max_samples=...) larger")
        self.samples[sample_id] = sample

    def unbind(self, sample_id: int) -> Optional[Sample]:
        return self.samples.pop(sample_id, None)

    def set_gain(self, gain: float) -> None:
        self.gain = float(gain)

    # -- playback control (reference SamplePlayer::play, :368-412) ---------
    def play(self, settings: PlaySettings) -> Optional[Playback]:
        smp = self.samples.get(settings.sample_id)
        if smp is None or smp.length == 0:
            return None
        if len(self.playbacks) >= self.max_playbacks:
            self.playbacks.pop(0)       # steal the oldest
        self._serial += 1
        pb = Playback(settings=settings, serial=self._serial)
        n = smp.length
        ls, le = int(settings.loop_start), int(settings.loop_end)
        pb.loop_mode = settings.loop_mode
        if (ls < 0 or le < 0 or ls == le or ls >= n or le > n):
            pb.loop_mode = LoopMode.NONE
        else:
            if le < ls:
                ls, le = le, ls
            pb.loop_start, pb.loop_end = ls, le
            pb.xfade = min(int(settings.xfade_length), (le - ls) // 2)
        pb.chain = [_initial_batch(pb, n)]
        nxt = _compute_next(pb, pb.chain[0], n)
        if nxt is not None:
            pb.chain.append(nxt)
        self.playbacks.append(pb)
        return pb

    def stop(self) -> int:
        n = len(self.playbacks)
        self.playbacks.clear()
        return n

    # -- mixing (reference SamplePlayer::process + process_playback) -------
    def process(self, count: int,
                src: Optional[np.ndarray] = None) -> np.ndarray:
        """Mix ``count`` output samples of all active playbacks (mono).

        With ``src`` given, the playbacks are mixed ON TOP of it — the
        reference's ``process(dst, src, count)`` passthrough form
        (SamplePlayer.cpp process with dst != src)."""
        if src is not None:
            src = np.asarray(src, np.float32)
            assert src.size == count
        out = np.zeros(count, np.float32)
        keep: List[Playback] = []
        for pb in self.playbacks:
            smp = self.samples.get(pb.settings.sample_id)
            if smp is None or smp.length == 0 or not pb.active:
                continue
            ch = min(pb.settings.channel, smp.channels - 1)
            data = smp.data[ch]
            n = smp.length
            # a stop() may invalidate precomputed LOOP successors
            # (reference recompute_next_batch): drop and recompute —
            # but only successors that have NOT started rendering yet
            # (ts >= clock); un-planning a batch that is already
            # sounding would orphan its half-rendered crossfade and
            # click at the stop sample
            if pb.state != _PLAY and len(pb.chain) > 1 \
                    and pb.chain[1].btype == _LOOP \
                    and pb.chain[1].ts >= pb.clock:
                del pb.chain[1:]
                nxt = _compute_next(pb, pb.chain[0], n)
                if nxt is not None:
                    pb.chain.append(nxt)

            t0, t1 = pb.clock, pb.clock + count
            vol = pb.settings.volume * self.gain
            buf = np.zeros(count, np.float32)

            # grow the chain so every batch overlapping the window has
            # its successor computed (fades are final only then)
            i = 0
            while i < len(pb.chain):
                b = pb.chain[i]
                if b.btype != _TAIL and i == len(pb.chain) - 1:
                    nxt = _compute_next(pb, b, n)
                    if nxt is not None:
                        pb.chain.append(nxt)
                if b.ts >= t1:
                    break
                i += 1

            for b in pb.chain:
                if b.ts < t1:
                    _mix_batch(buf, data, b, t0, vol,
                               pb.settings.xfade_type)

            # cancel fadeout envelope (reference apply_fade_out) — must
            # run BEFORE completion bookkeeping or a fade that ends on
            # the same block as the tail would be skipped
            if pb.state == _CANCEL:
                t = np.arange(t0, t1)
                if pb.cancel_len > 0:
                    env = np.clip(1.0 - (t - pb.cancel_at)
                                  / pb.cancel_len, 0.0, 1.0)
                else:
                    env = (t < pb.cancel_at).astype(np.float32)
                buf *= env.astype(np.float32)
                if t1 >= pb.cancel_at + pb.cancel_len:
                    pb.state = _DONE

            # drop batches fully behind the window
            while pb.chain and pb.chain[0].ts + pb.chain[0].length <= t1:
                if len(pb.chain) == 1:
                    if pb.chain[0].btype == _TAIL:
                        pb.chain.clear()
                        pb.state = _DONE
                    break
                pb.chain.pop(0)

            out += buf
            pb.clock = t1
            if pb.active:
                keep.append(pb)
        self.playbacks = keep
        return out if src is None else out + src
