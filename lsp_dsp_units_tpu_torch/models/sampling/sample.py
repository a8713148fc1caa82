"""Sample — in-memory multi-channel audio buffer
(reference: src/main/sampling/Sample.cpp): the port of
models/sampling/sample.py, host numpy as there.

Covers the reference surface: init/resize/stretch/insert/append, gain,
fades, reverse, normalize, WAV load/save, and the reference's own
32-period polyphase Lanczos resampling with an LRX pre-filter for
down-conversions (Sample.cpp:961-1207; oracle parity in
the JAX package's tests/test_reference_oracle_wave3.py).  Host numpy
storage ([channels, length]); content moves to the device as tensors
when processors consume it (device_mix.build_bank).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.misc import fade as fade_ops
from lsp_dsp_units_tpu_torch.ops import resample as rs
from lsp_dsp_units_tpu_torch.utils import wavio


class SampleNormalize(enum.Enum):
    NONE = "none"
    ABOVE = "above"       # only amplify if below target
    BELOW = "below"       # only attenuate if above target
    ALWAYS = "always"


class SampleCrossfade(enum.Enum):
    """Chunk crossfade law for time-stretching
    (reference sampling/types.h:67-78)."""
    LINEAR = "linear"
    CONST_POWER = "const_power"


def _put_chunk(dst: np.ndarray, src: np.ndarray, doff: int, soff: int,
               length: int, fade_in: int, fade_out: int,
               fade: SampleCrossfade) -> None:
    """Accumulate a source chunk into dst with fade ramps on its edges
    (reference Sample.cpp:399-457).  Linear: ramp i/len; const-power:
    sqrt of the linear ramp, so overlapped chunks keep unit power."""
    w = np.ones(length, np.float32)
    if fade_in > 0:
        r = np.arange(fade_in, dtype=np.float32) / fade_in
        w[:fade_in] = r
    if fade_out > 0:
        r = (fade_out - np.arange(fade_out, dtype=np.float32)) / fade_out
        w[length - fade_out:] = r
    if fade is SampleCrossfade.CONST_POWER:
        w = np.sqrt(w)
    dst[..., doff:doff + length] += src[..., soff:soff + length] * w


class Sample:
    def __init__(self, channels: int = 0, length: int = 0,
                 sample_rate: int = 48000):
        self.data = np.zeros((channels, length), np.float32)
        self.sample_rate = int(sample_rate)

    # -- construction -------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "Sample":
        # WAV via the native reader; other formats via the
        # optional soundfile path (wavio.read_audio)
        data, sr = wavio.read_audio(path)
        s = cls(0, 0, sr)
        s.data = np.asarray(data, np.float32)
        return s

    def save(self, path: str) -> None:
        wavio.write_audio(path, self.data, self.sample_rate)

    @property
    def channels(self) -> int:
        return self.data.shape[0]

    @property
    def length(self) -> int:
        return self.data.shape[1]

    def init(self, channels: int, length: int) -> "Sample":
        self.data = np.zeros((channels, length), np.float32)
        return self

    def resize(self, length: int) -> "Sample":
        c, n = self.data.shape
        if length <= n:
            self.data = self.data[:, :length].copy()
        else:
            self.data = np.concatenate(
                [self.data, np.zeros((c, length - n), np.float32)], axis=1)
        return self

    def append(self, other: np.ndarray) -> "Sample":
        other = np.atleast_2d(np.asarray(other, np.float32))
        self.data = np.concatenate([self.data, other], axis=1)
        return self

    def prepend(self, samples: int) -> "Sample":
        """Insert silence at the head (reference Sample.h:301)."""
        return self.insert(0, samples)

    def set_channels(self, channels: int) -> "Sample":
        """Grow/shrink the channel count keeping existing data
        (reference Sample.h:272); new channels are silent."""
        c, n = self.data.shape
        if channels <= c:
            self.data = self.data[:channels].copy()
        else:
            self.data = np.concatenate(
                [self.data, np.zeros((channels - c, n), np.float32)])
        return self

    def save_range(self, path: str, offset: int,
                   count: Optional[int] = None) -> int:
        """Save a sub-range to a WAV file, returning the number of
        samples written (reference Sample.h:352-362)."""
        count = self.length - offset if count is None else count
        chunk = self.data[:, offset:offset + count]
        wavio.write_wav(path, chunk, self.sample_rate)
        return chunk.shape[1]

    def insert(self, pos: int, samples: int) -> "Sample":
        c = self.channels
        z = np.zeros((c, samples), np.float32)
        self.data = np.concatenate(
            [self.data[:, :pos], z, self.data[:, pos:]], axis=1)
        return self

    def cut(self, pos: int, samples: int) -> "Sample":
        self.data = np.concatenate(
            [self.data[:, :pos], self.data[:, pos + samples:]], axis=1)
        return self

    def stretch(self, new_length: int, chunk_size: int = 0,
                fade_type: SampleCrossfade = SampleCrossfade.CONST_POWER,
                fade_size: float = 0.5, start: int = 0,
                end: Optional[int] = None) -> "Sample":
        """Pitch-preserving time stretch of the region [start, end):
        overlapping source chunks are laid onto the new timeline with
        crossfades between them (reference Sample.cpp:523-613).

        ``chunk_size=0`` selects the automatic size
        ``src_length / (2 - fade_size/2)``; ``fade_size`` is the relative
        crossfade fraction of a chunk in [0, 1].

        Fade law: ``CONST_POWER`` keeps noise-like material at constant
        power but can peak up to sqrt(2)x on coherent (tonal) content
        when overlapped chunks land in phase; ``LINEAR`` bounds coherent
        peaks at the input amplitude but dips power on uncorrelated
        material.  (Same trade-off as the reference's put_chunk laws,
        Sample.cpp:399-457.)"""
        end = self.length if end is None else end
        if start > self.length or end > self.length or start > end:
            raise ValueError("bad stretch range")
        src_length = end - start
        if src_length == new_length:
            return self

        out = np.zeros((self.channels,
                        self.length - src_length + new_length), np.float32)
        out[:, :start] = self.data[:, :start]
        out[:, start + new_length:] = self.data[:, end:]
        dst = out[:, start:start + new_length]
        src = self.data[:, start:end]

        if src_length <= 1:
            # degenerate region: hold the boundary value
            # (reference do_simple_stretch, Sample.cpp:459-484)
            dst[:] = src[:, :1] if src_length else 0.0
            self.data = out
            return self

        # clamp per the reference: effective fade fraction in [0, 0.5]
        fade_size = float(np.clip(fade_size * 0.5, 0.0, 0.5))
        if chunk_size == 0:
            chunk_size = int(src_length / (2.0 - fade_size))
        else:
            chunk_size = min(chunk_size, src_length)
        fade_length = int(chunk_size * fade_size)

        if new_length + fade_length <= chunk_size * 2:
            # two chunks with one crossfade (Sample.cpp:486-521)
            fade_length = min(fade_length, new_length)
            c1 = (new_length + fade_length) >> 1
            c2 = new_length - c1 + fade_length
            _put_chunk(dst, src, 0, 0, c1, 0, fade_length, fade_type)
            _put_chunk(dst, src, new_length - c2, src_length - c2, c2,
                       fade_length, 0, fade_type)
            self.data = out
            return self

        eff = chunk_size - fade_length
        n_chunks = (new_length - fade_length) // eff
        last_len = new_length - n_chunks * eff
        _put_chunk(dst, src, 0, 0, chunk_size, 0, fade_length, fade_type)
        for j in range(1, n_chunks):
            soff = (j * (src_length - chunk_size)) // (n_chunks - 1)
            _put_chunk(dst, src, j * eff, soff, chunk_size,
                       fade_length, fade_length, fade_type)
        _put_chunk(dst, src, new_length - last_len, src_length - last_len,
                   last_len, fade_length, 0, fade_type)
        self.data = out
        return self

    def stretch_resample(self, new_length: int, start: int = 0,
                         end: Optional[int] = None) -> "Sample":
        """Stretch the region [start, end) by Lanczos resampling it
        (changes pitch; companion to the reference-style :meth:`stretch`)."""
        end = self.length if end is None else end
        region = self.data[:, start:end]
        n = region.shape[1]
        if n == 0 or new_length == n:
            return self
        stretched = np.stack([
            rs.resample_fractional(region[c], n, new_length)
            for c in range(self.channels)])
        stretched = stretched[:, :new_length].astype(np.float32)
        if stretched.shape[1] < new_length:
            stretched = np.pad(stretched,
                               ((0, 0), (0, new_length
                                         - stretched.shape[1])))
        self.data = np.concatenate(
            [self.data[:, :start], stretched, self.data[:, end:]], axis=1)
        return self

    # -- edits ---------------------------------------------------------------
    def apply_gain(self, gain: float, pos: int = 0,
                   count: Optional[int] = None) -> "Sample":
        count = self.length - pos if count is None else count
        self.data[:, pos:pos + count] *= np.float32(gain)
        return self

    def reverse(self, channel: Optional[int] = None) -> "Sample":
        if channel is None:
            self.data = self.data[:, ::-1].copy()
        else:
            self.data[channel] = self.data[channel][::-1]
        return self

    def fade_in(self, length: int) -> "Sample":
        self.data = fade_ops.fade_in(
            torch.from_numpy(np.ascontiguousarray(self.data)),
            length).numpy()
        return self

    def fade_out(self, length: int) -> "Sample":
        self.data = fade_ops.fade_out(
            torch.from_numpy(np.ascontiguousarray(self.data)),
            length).numpy()
        return self

    def normalize(self, gain: float,
                  mode: SampleNormalize = SampleNormalize.ALWAYS,
                  ) -> "Sample":
        peak = float(np.abs(self.data).max()) if self.data.size else 0.0
        if peak <= 0.0 or mode == SampleNormalize.NONE:
            return self
        # reference Sample.cpp:958-968: ABOVE acts only when the peak is
        # ABOVE the target (attenuates), BELOW only when it is below
        # (amplifies)
        if mode == SampleNormalize.ABOVE and peak <= gain:
            return self
        if mode == SampleNormalize.BELOW and peak >= gain:
            return self
        self.data *= np.float32(gain / peak)
        return self

    # -- resampling (reference Sample.cpp:961-1207) -------------------------
    _RS_KPERIODS = 32.0
    _RS_RPERIODS = 1.0 / 32.0

    @staticmethod
    def _lanczos1(k_step: float, p: float, t: float, a: float,
                  count: int) -> np.ndarray:
        """dsp::lanczos1: dst[i] = sinc(x)*sinc(x*a) at x = i*k - p,
        zero outside |x| < t (x carries the pi factor)."""
        x = np.arange(count, dtype=np.float64) * float(k_step) - float(p)
        ax = np.abs(x)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = (np.sin(x) / x) * (np.sin(x * a) / (x * a))
        v = np.where(ax < 1e-10, 1.0, v)
        v = np.where(ax >= t, 0.0, v)
        return v.astype(np.float32)

    def _complex_resample(self, new_rate: int) -> np.ndarray:
        """Polyphase Lanczos scatter (complex_upsample/complex_downsample,
        Sample.cpp:1015-1207): per source phase i, a fractional-offset
        kernel accumulates src[i::src_step] at stride dst_step."""
        import math
        f32 = np.float32
        sr = self.sample_rate
        gcd = math.gcd(int(new_rate), int(sr))
        src_step = sr // gcd
        dst_step = int(new_rate) // gcd
        kf = f32(dst_step) / f32(src_step)
        rkf = f32(np.float32(np.pi) * f32(src_step) / f32(dst_step))
        if new_rate > sr:
            k_base = int(f32(self._RS_KPERIODS) * kf)
            k_center = k_base + 1
            k_len = 2 * k_center + 1
            t = self._RS_KPERIODS * np.pi
        else:
            t = float(f32(self._RS_KPERIODS) * f32(np.pi) * rkf)
            k_center = int(f32(self._RS_KPERIODS + 1.0))
            k_len = int(2 * k_center + float(rkf) + 1)
        k_size = (k_len + 1 + 3) & ~3          # align_size(k_len+1, 4)
        n = self.length
        new_samples = int(kf * f32(n))
        b_len = new_samples + k_size
        dst = np.zeros((self.channels, b_len), np.float32)
        for i in range(src_step):
            p = int(kf * f32(i))
            dt = float(f32(i) * kf - f32(p))
            k = self._lanczos1(float(rkf), (k_center + dt) * float(rkf),
                               t, self._RS_RPERIODS, k_size)
            sj = self.data[:, i:n:src_step]
            if sj.shape[1] == 0:
                continue
            # scatter-add kernels at xp = p + m*dst_step == convolution
            # of the zero-stuffed phase with the kernel
            up_len = p + (sj.shape[1] - 1) * dst_step + 1
            up = np.zeros((self.channels, up_len), np.float32)
            up[:, p::dst_step] = sj
            for c in range(self.channels):
                conv = np.convolve(up[c], k)
                m = min(conv.size, b_len)
                dst[c, :m] += conv[:m]
        # shift by k_center and drop k_len samples (Sample.cpp:1119-1129)
        out = dst[:, k_center:]
        final = b_len - k_len
        return np.ascontiguousarray(out[:, :final])

    def resample(self, new_rate: int) -> "Sample":
        """reference Sample::resample (Sample.cpp:1209-1270): integer
        up-ratios use the single-phase kernel, any down-conversion first
        pre-filters with an LRX low-pass at 0.475 * new_rate (slope 4,
        Q 0.75), integer down-ratios then decimate."""
        new_rate = int(new_rate)
        if new_rate == self.sample_rate or self.channels == 0:
            self.sample_rate = new_rate if self.channels else \
                self.sample_rate
            return self
        if new_rate > self.sample_rate:
            self.data = self._complex_resample(new_rate)
        else:
            # pre-filter: remove content above the new Nyquist
            from lsp_dsp_units_tpu_torch.models.filters.design import (
                FilterParams, FilterType, design_filter)
            fp = FilterParams(ftype=FilterType.BT_LRX_LOPASS, slope=4,
                              freq=0.475 * new_rate, gain=1.0,
                              quality=0.75)
            coeffs = np.asarray(
                design_filter(fp, self.sample_rate).biquads, np.float64)
            filtered = np.empty_like(self.data)
            for c in range(self.channels):
                y = self.data[c].astype(np.float32)
                for b0, b1, b2, a1, a2 in coeffs:
                    s1 = np.float32(0.0)
                    s2 = np.float32(0.0)
                    x = y
                    y = np.empty_like(x)
                    b0, b1, b2, a1, a2 = (np.float32(b0), np.float32(b1),
                                          np.float32(b2), np.float32(a1),
                                          np.float32(a2))
                    for j in range(x.size):
                        out = np.float32(b0 * x[j] + s1)
                        s1 = np.float32(b1 * x[j] + a1 * out + s2)
                        s2 = np.float32(b2 * x[j] + a2 * out)
                        y[j] = out
                filtered[c] = y
            tmp = Sample(self.channels, filtered.shape[1],
                         self.sample_rate)
            tmp.data = filtered
            if self.sample_rate % new_rate == 0:
                # fast_downsample: plain decimation (Sample.cpp:986-1008)
                step = self.sample_rate // new_rate
                self.data = np.ascontiguousarray(
                    filtered[:, ::step][:, : self.length // step])
            else:
                self.data = tmp._complex_resample(new_rate)
        self.sample_rate = new_rate
        return self
