"""Minimal dependency-free WAV I/O (host side): a copy of the JAX
package's utils/wavio.py (numpy only).

Replaces the reference's ``mm::InAudioFileStream``/``OutAudioFileStream``
(libsndfile-backed, reference src/main/sampling/Sample.cpp:34-35,659,753)
for the formats the tests need: PCM16/24/32 and float32 RIFF WAVE.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (data [channels, frames] float32 in [-1,1], sr)."""
    with open(path, "rb") as fh:
        riff = fh.read(12)
        if riff[0:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        data = None
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[0:4], struct.unpack("<I", hdr[4:8])[0]
            payload = fh.read(size)
            if size & 1:
                fh.read(1)
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"missing fmt/data chunk: {path}")
        (audio_fmt, n_ch, sr, _brate, _balign, bits) = struct.unpack(
            "<HHIIHH", fmt[:16])
        if audio_fmt == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
            audio_fmt = struct.unpack("<H", fmt[24:26])[0]
        if audio_fmt == 3:  # float
            if bits == 32:
                x = np.frombuffer(data, "<f4").astype(np.float32)
            elif bits == 64:
                x = np.frombuffer(data, "<f8").astype(np.float32)
            else:
                raise ValueError(f"unsupported float bits: {bits}")
        elif audio_fmt == 1:  # PCM
            if bits == 16:
                x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            elif bits == 32:
                x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
            elif bits == 24:
                raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
                ints = (raw[:, 0].astype(np.int32)
                        | (raw[:, 1].astype(np.int32) << 8)
                        | (raw[:, 2].astype(np.int32) << 16))
                ints = np.where(ints >= (1 << 23), ints - (1 << 24), ints)
                x = ints.astype(np.float32) / 8388608.0
            elif bits == 8:
                x = (np.frombuffer(data, np.uint8).astype(np.float32)
                     - 128.0) / 128.0
            else:
                raise ValueError(f"unsupported PCM bits: {bits}")
        else:
            raise ValueError(f"unsupported WAV format: {audio_fmt}")
        frames = x.size // n_ch
        return x[:frames * n_ch].reshape(frames, n_ch).T.copy(), sr


def write_wav(path: str, data: np.ndarray, sample_rate: int,
              float32: bool = True) -> None:
    """Write [channels, frames] (or [frames]) data to a WAV file."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None]
    n_ch, frames = data.shape
    inter = data.T.reshape(-1)
    if float32:
        payload = inter.astype("<f4").tobytes()
        bits, fmt_code = 32, 3
    else:
        payload = (np.clip(inter, -1.0, 1.0) * 32767.0).astype(
            "<i2").tobytes()
        bits, fmt_code = 16, 1
    byte_rate = sample_rate * n_ch * bits // 8
    block_align = n_ch * bits // 8
    with open(path, "wb") as fh:
        fh.write(b"RIFF")
        fh.write(struct.pack("<I", 36 + len(payload)))
        fh.write(b"WAVE")
        fh.write(b"fmt ")
        fh.write(struct.pack("<IHHIIHH", 16, fmt_code, n_ch, sample_rate,
                             byte_rate, block_align, bits))
        fh.write(b"data")
        fh.write(struct.pack("<I", len(payload)))
        fh.write(payload)


# ---------------------------------------------------------------------------
# Optional multi-format I/O (reference: mm::InAudioFileStream reads
# everything libsndfile supports, Sample.cpp:753-830).  The WAV path
# above stays dependency-free; other formats route through the
# ``soundfile`` package when it is installed.
# ---------------------------------------------------------------------------

def _soundfile():
    try:
        import soundfile
        return soundfile
    except ImportError:
        return None


def have_soundfile() -> bool:
    """True when the optional libsndfile-backed path is available."""
    return _soundfile() is not None


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Read any supported audio file -> ([channels, frames] float32,
    sample_rate).  WAV always works (native reader); FLAC/AIFF/OGG/...
    need the optional ``soundfile`` package."""
    if str(path).lower().endswith(".wav"):
        return read_wav(path)
    sf = _soundfile()
    if sf is None:
        raise RuntimeError(
            f"reading {path!r} needs the optional 'soundfile' package "
            "(libsndfile); the dependency-free path supports WAV only")
    data, sr = sf.read(path, dtype="float32", always_2d=True)
    return np.ascontiguousarray(data.T), int(sr)


def write_audio(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write [channels, frames] (or [frames]) audio; format from the
    file extension.  WAV always works; others need ``soundfile``."""
    if str(path).lower().endswith(".wav"):
        write_wav(path, data, sample_rate)
        return
    sf = _soundfile()
    if sf is None:
        raise RuntimeError(
            f"writing {path!r} needs the optional 'soundfile' package "
            "(libsndfile); the dependency-free path supports WAV only")
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None]
    sf.write(path, data.T, int(sample_rate))
