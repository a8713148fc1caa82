"""Device-side batched SamplePlayer mixdown: the port of
models/sampling/device_mix.py.

Voices live as tensors on the device, and a block is one read of each
voice's window from a flat sample bank followed by one routing product:

  idx[v, t]  = playhead folding (delay, span, DIRECT loop, one-shot end)
  vals[v, t] = bank_flat[sample_id[v] * L + idx] * gain[v]
  out[c, t]  = sum_v route[c, v] * vals[v, t]

:func:`mix_block` reads the windows with a plain gather;
:func:`mix_block_dma` reads them with ops/slicedma.py's
:func:`batched_slice` (the CUDA kernel on the card), two windows per
voice per block, and is sample-exact against :func:`mix_block` on its
scope (every looping voice's span at least a block).  That scope is
checked once, from host numbers, when the voice table is built
(``DeviceVoices.min_loop_span``), never per block: a block reads nothing
back from the device.

The routing product is computed in float64 and rounded once, so no TF32
or matmul-precision setting can change it (the JAX package computes it
at Precision.HIGHEST).

Scope: DIRECT loop or one-shot (NONE) voices without crossfades, one
output channel per voice; everything else stays on the host player
(models/sampling/player.py), whose semantics the mixdown is held to.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops.slicedma import SLACK, batched_slice


class DeviceVoices(NamedTuple):
    """Static per-voice configuration (device tensors, [V] each)."""
    sample_id: torch.Tensor   # int32 row in the bank
    length: torch.Tensor      # int32 playable length of that sample
    gain: torch.Tensor        # float32 mix gain (volume)
    loop_on: torch.Tensor     # float32 1.0 = DIRECT loop, 0.0 = one-shot
    loop_start: torch.Tensor  # int32
    loop_end: torch.Tensor    # int32 (exclusive)
    route: torch.Tensor       # [C, V] float32 output-channel routing
    min_loop_span: int        # host: smallest loop_end - loop_start of a
                              # looping voice (a large value if none)


class DeviceMixState(NamedTuple):
    pos: torch.Tensor         # [V] int32 playhead; negative while delayed


NO_LOOP_SPAN = 2 ** 31 - 1


def min_loop_span(loop_on: np.ndarray, loop_start: np.ndarray,
                  loop_end: np.ndarray) -> int:
    """Smallest span of the looping voices, from host numbers."""
    on = np.asarray(loop_on) > 0.5
    span = (np.asarray(loop_end, np.int64)
            - np.asarray(loop_start, np.int64))[on]
    return int(span.min()) if span.size else NO_LOOP_SPAN


def build_bank(samples: Sequence[np.ndarray], device="cuda"
               ) -> Tuple[torch.Tensor, int]:
    """Stack mono sample arrays into one flat bank on ``device``.

    Returns (bank_flat [S * L], L) with rows zero-padded to the longest
    sample."""
    arrs = [np.asarray(s, np.float32).reshape(-1) for s in samples]
    max_len = max((a.shape[0] for a in arrs), default=1)
    bank = np.zeros((len(arrs), max_len), np.float32)
    for i, a in enumerate(arrs):
        bank[i, :a.shape[0]] = a
    return torch.from_numpy(bank.reshape(-1)).to(device), max_len


def build_voices(specs: Sequence[dict], channels: int,
                 sample_lengths: Sequence[int], device="cuda"
                 ) -> Tuple[DeviceVoices, DeviceMixState]:
    """Voice table from dicts with keys: sample_id, channel, volume,
    delay, loop (bool), loop_start, loop_end."""
    v = len(specs)
    sid = np.zeros(v, np.int32)
    length = np.zeros(v, np.int32)
    gain = np.zeros(v, np.float32)
    loop_on = np.zeros(v, np.float32)
    ls = np.zeros(v, np.int32)
    le = np.ones(v, np.int32)
    route = np.zeros((channels, v), np.float32)
    pos = np.zeros(v, np.int32)
    for i, s in enumerate(specs):
        sid[i] = s["sample_id"]
        length[i] = sample_lengths[s["sample_id"]]
        gain[i] = s.get("volume", 1.0)
        loop_on[i] = 1.0 if s.get("loop", False) else 0.0
        ls[i] = s.get("loop_start", 0)
        le[i] = min(s.get("loop_end", length[i]), length[i])
        route[s.get("channel", 0) % channels, i] = 1.0
        pos[i] = -int(s.get("delay", 0))
    return voices_from_host(sid, length, gain, loop_on, ls, le, route, pos,
                            device)


def voices_from_host(sample_id, length, gain, loop_on, loop_start,
                     loop_end, route, pos, device="cuda"
                     ) -> Tuple[DeviceVoices, DeviceMixState]:
    """Voice table and state from host arrays of the layout above."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return (DeviceVoices(
        sample_id=t(sample_id, torch.int32), length=t(length, torch.int32),
        gain=t(gain, torch.float32), loop_on=t(loop_on, torch.float32),
        loop_start=t(loop_start, torch.int32),
        loop_end=t(loop_end, torch.int32), route=t(route, torch.float32),
        min_loop_span=min_loop_span(loop_on, loop_start, loop_end)),
        DeviceMixState(pos=t(pos, torch.int32)))


def route_mix(route: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out [C, T] = route [C, V] @ vals [V, T], in float64, rounded once
    to float32: no TF32 or matmul-precision setting reaches it."""
    return (route.double() @ vals.double()).to(torch.float32)


def _advance(voices: DeviceVoices, pos: torch.Tensor, span: torch.Tensor,
             block: int) -> DeviceMixState:
    """Advance the playheads, keeping looping ones folded so positions
    never overflow."""
    new_pos = pos + block
    wrap = (voices.loop_on > 0.5) & (new_pos >= voices.loop_end)
    folded = voices.loop_start + torch.remainder(
        new_pos - voices.loop_start, span)
    return DeviceMixState(pos=torch.where(wrap, folded, new_pos))


def mix_block(bank_flat: torch.Tensor, bank_len: int, voices: DeviceVoices,
              state: DeviceMixState, block: int
              ) -> Tuple[DeviceMixState, torch.Tensor]:
    """One [C, block] mixdown step, the windows read by a gather.

    Playhead semantics (the host player's DIRECT/NONE modes without
    crossfade): samples before position 0 are silence (delay); a looping
    voice folds positions >= loop_end back into [loop_start, loop_end); a
    one-shot voice goes silent at its sample length."""
    pos = state.pos
    t = torch.arange(block, dtype=torch.int32, device=pos.device)
    idx = pos[:, None] + t[None, :]                        # [V, T]
    span = torch.clamp(voices.loop_end - voices.loop_start, min=1)
    folded = voices.loop_start[:, None] + torch.remainder(
        idx - voices.loop_start[:, None], span[:, None])
    looping = (voices.loop_on[:, None] > 0.5) & \
        (idx >= voices.loop_end[:, None])
    idx_f = torch.where(looping, folded, idx)
    audible = (idx >= 0) & (looping | (idx_f < voices.length[:, None]))
    flat = (voices.sample_id[:, None].to(torch.int64) * bank_len
            + torch.clamp(idx_f, 0, bank_len - 1))
    vals = bank_flat[torch.clamp(flat, 0, bank_flat.shape[0] - 1)]
    vals = torch.where(audible, vals, 0.0) * voices.gain[:, None]
    return _advance(voices, pos, span, block), route_mix(voices.route, vals)


def build_bank_padded(samples: Sequence[np.ndarray], block: int,
                      device="cuda") -> Tuple[torch.Tensor, int, int]:
    """Bank for :func:`mix_block_dma`: ``block`` zeros prepended, so a
    delayed voice's window (playhead still negative) lands in silence,
    plus ``block + 1024`` samples of tail slack for the slice's contract,
    the total padded to a multiple of 128.  Returns (bank_flat, L,
    pad)."""
    arrs = [np.asarray(s, np.float32).reshape(-1) for s in samples]
    bank_len = max((a.shape[0] for a in arrs), default=1)
    pad = int(block)
    total = pad + len(arrs) * bank_len + int(block) + SLACK
    total += (-total) % 128
    out = np.zeros(total, np.float32)
    for i, a in enumerate(arrs):
        out[pad + i * bank_len:pad + i * bank_len + a.shape[0]] = a
    return torch.from_numpy(out).to(device), bank_len, pad


def mix_block_dma(bank_pad: torch.Tensor, bank_len: int, pad: int,
                  voices: DeviceVoices, state: DeviceMixState, block: int
                  ) -> Tuple[DeviceMixState, torch.Tensor]:
    """:func:`mix_block` with each voice's window read as one contiguous
    slice (ops/slicedma.py) instead of a gather: the window at the
    playhead and the window one loop span back, of which each sample
    takes the one its fold selects.  Requires ``pad >= block`` and every
    looping voice's span >= block (at most one wrap per block)."""
    if pad < block:
        raise ValueError(f"pad {pad} < block {block}")
    if voices.min_loop_span < block:
        raise ValueError(
            f"mix_block_dma needs every looping voice's span >= block "
            f"({voices.min_loop_span} < {block}); use mix_block")
    pos = state.pos
    span = torch.clamp(voices.loop_end - voices.loop_start, min=1)
    base = voices.sample_id * bank_len + pad       # sample row origin
    lim = bank_pad.shape[0] - block - SLACK
    start1 = torch.clamp(base + pos, 0, lim)
    start2 = torch.clamp(base + pos - span, 0, lim)
    w1 = batched_slice(bank_pad, start1, block)
    w2 = batched_slice(bank_pad, start2, block)

    t = torch.arange(block, dtype=torch.int32, device=pos.device)
    idx = pos[:, None] + t[None, :]
    looping = (voices.loop_on[:, None] > 0.5) & \
        (idx >= voices.loop_end[:, None])
    idx_f = torch.where(looping, idx - span[:, None], idx)
    audible = (idx >= 0) & (looping | (idx_f < voices.length[:, None]))
    vals = torch.where(looping, w2, w1)
    vals = torch.where(audible, vals, 0.0) * voices.gain[:, None]
    return _advance(voices, pos, span, block), route_mix(voices.route, vals)
