"""Canonical embedding demo (the reference's mtest pattern,
src/test/mtest/demo.cpp:35-105): load WAV -> configure unit -> stream
process() in blocks -> save WAV.  The port's twin of the JAX package's
``examples/demo.py``, on the card unless ``--cpu`` is given.

    python3 -m lsp_dsp_units_tpu_torch.tools.demo in.wav out.wav
        [filter|chain|loudness|sampler|stretch] [--cpu]

Modes and what they run on the card:

* ``filter``: a BWC hi-shelf, +6 dB at 1 kHz, slope 2, streamed through
  ``BlockStream`` in blocks of 4096 (``Filter.process``'s time-parallel
  scan: kernel ``biquad_scan``);
* ``chain``: ``FilterConvChain(sr, channels, rank=12, ir_seconds=0.5)``,
  one ``step`` over the input cut to whole blocks (kernel #1's packed
  FFTs, #5 the sliding RMS, #6 the peak envelope);
* ``loudness``: the integrated BS.1770 loudness with K-weighting
  (``biquad_seq``); prints it and writes the meter's output;
* ``sampler``: the host ``SamplePlayer`` looping the middle half
  ping-pong with a linear crossfade, rendered to 3x the input's length;
* ``stretch``: a pitch-preserving 1.5x ``Sample.stretch`` with a linear
  crossfade.

The sampler and the stretch run on the host in numpy, on either device.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.filters import (Filter, FilterParams,
                                                    FilterType)
from lsp_dsp_units_tpu_torch.models.meters import ILUFSMeter, Weighting
from lsp_dsp_units_tpu_torch.models.sampling import (
    LoopMode, PlaySettings, Sample, SampleCrossfade, SamplePlayer,
    XFadeType)
from lsp_dsp_units_tpu_torch.pipeline import FilterConvChain
from lsp_dsp_units_tpu_torch.utils.blocks import BlockStream
from lsp_dsp_units_tpu_torch.utils.units import gain_to_db
from lsp_dsp_units_tpu_torch.utils.wavio import read_wav, write_wav

FILTER_BLOCK = 4096


def run_filter(x: np.ndarray, sr: int, device) -> np.ndarray:
    """The reference demo's configuration: BWC hi-shelf +6 dB at 1 kHz,
    slope 2, in blocks of 4096."""
    flt = Filter(sr, FilterParams(ftype=FilterType.BT_BWC_HISHELF, slope=2,
                                  freq=1000.0, gain=2.0))
    coeffs = flt.coefficients(device=device)
    bs = BlockStream(lambda st, xb: flt.process(st, xb, coeffs),
                     flt.init_state((x.shape[0],), device=device),
                     FILTER_BLOCK, (x.shape[0],), device=device)
    # push() output is delayed one block; the aligned signal is [block :
    # block + n] of push + flush (the leading zeros are the BlockStream
    # latency, the flush tail completes the last block)
    full = np.concatenate([bs.push(x), bs.flush()], axis=-1)
    return full[:, FILTER_BLOCK:FILTER_BLOCK + x.shape[1]]


def run_chain(x: np.ndarray, sr: int, device) -> np.ndarray:
    """One ``step`` of the C-channel chain over the whole blocks of x."""
    chain = FilterConvChain(sr, channels=x.shape[0], rank=12,
                            ir_seconds=0.5, device=device)
    params = chain.build()
    t = (x.shape[1] // chain.block) * chain.block
    _, y = chain.step(params, chain.init_state(params),
                      torch.from_numpy(np.ascontiguousarray(x[:, :t]))
                      .to(device))
    return y.cpu().numpy()


def run_loudness(x: np.ndarray, sr: int, device
                 ) -> Tuple[np.ndarray, float]:
    """(the meter's output [1, T], the integrated loudness as a LUFS
    gain) over the whole 100 ms quarters of x."""
    meter = ILUFSMeter(sr, channels=x.shape[0], weighting=Weighting.K,
                       device=device)
    t = (x.shape[1] // meter.block) * meter.block
    st, out = meter.process(meter.init_state(), torch.from_numpy(
        np.ascontiguousarray(x[:, :t])).to(device))
    return out.cpu().numpy()[None], float(meter.loudness_lufs_gain(st))


def run_sampler(src: str, n: int, sr: int) -> np.ndarray:
    """Loop the middle half of ``src`` ping-pong with crossfades for 2n
    samples, then n more after stopping (the SamplePlayer batch model)."""
    bank = SamplePlayer()
    bank.bind(0, Sample.load(src))
    pb = bank.play(PlaySettings(
        sample_id=0, loop_start=n // 4, loop_end=3 * n // 4,
        loop_mode=LoopMode.DIRECT_HALF_PP,
        xfade_length=min(n // 8, sr // 50), xfade_type=XFadeType.LINEAR))
    y = bank.process(2 * n)
    pb.stop()
    return np.concatenate([y, bank.process(n)])[None, :]


def run_stretch(src: str) -> np.ndarray:
    """Pitch-preserving 1.5x time stretch of ``src``."""
    s = Sample.load(src)
    s.stretch(int(s.length * 1.5), fade_type=SampleCrossfade.LINEAR)
    return s.data


MODES = ("filter", "chain", "loudness", "sampler", "stretch")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("mode", nargs="?", default="filter", choices=MODES)
    ap.add_argument("--cpu", action="store_true",
                    help="process on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")

    x, sr = read_wav(args.src)
    print(f"{args.src}: {x.shape[0]} ch, {x.shape[1]} samples @ {sr} Hz")
    if args.mode == "filter":
        y = run_filter(x, sr, dev)
    elif args.mode == "chain":
        y = run_chain(x, sr, dev)
    elif args.mode == "loudness":
        y, gain = run_loudness(x, sr, dev)
        print(f"integrated loudness: {float(gain_to_db(gain)):.4f} LUFS")
    elif args.mode == "sampler":
        y = run_sampler(args.src, x.shape[1], sr)
    else:
        y = run_stretch(args.src)
    write_wav(args.dst, y, sr)
    print(f"wrote {args.dst}: peak {np.abs(y).max():.4f}")


if __name__ == "__main__":
    main()
