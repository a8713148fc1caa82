"""Parametric filter design — analog prototype cascades + digitization.

Re-derivation (float64, host numpy) of the reference's filter design layer
(reference: src/main/filters/Filter.cpp):

* analog prototypes as second-order rational cascades
  ``H(p) = (t0 + t1 p + t2 p^2) / (b0 + b1 p + b2 p^2)`` for the RLC, BWC
  (Butterworth-Chebyshev) and LRX (Linkwitz-Riley) families
  (Filter.cpp:722-1487);
* digitization via the bilinear transform with prewarp
  ``kf = 1/tan(pi f / sr)`` (Filter.cpp:2192-2267) or the matched-Z
  transform with pole/zero exp-mapping and amplitude renormalization at
  ``f/10`` (Filter.cpp:2269-2416);
* APO textbook biquads designed directly in the digital domain
  (Filter.cpp:1489-1647) and A/B/C/D/K weighting filters
  (Filter.cpp:1678-2185, ITU-R BS.1770 K-weighting at 2101-2185).

Output biquads use the framework convention of the biquad kernels
(feedback signs pre-negated).  Design is intentionally NOT tensor code —
it is control-path math executed once per parameter change, in float64,
exactly as the reference recomputes coefficients lazily on its dirty
flag (Filter.cpp:698-702).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np

FILTER_CHAINS_MAX = 128  # reference: filters/common.h:32
MIN_APO_Q = 0.1          # reference: Filter.cpp:28


class FilterType(enum.Enum):
    """Filter classes (reference: filters/common.h:38-135).

    ``BT_*`` = analog design + bilinear transform, ``MT_*`` = analog design
    + matched-Z transform, ``DR_APO_*`` = direct digital design,
    ``*_WEIGHTED`` = standard weighting curves.
    """
    NONE = "none"
    BT_AMPLIFIER = "bt_amplifier"
    MT_AMPLIFIER = "mt_amplifier"
    # RLC family
    BT_RLC_LOPASS = "bt_rlc_lopass"
    MT_RLC_LOPASS = "mt_rlc_lopass"
    BT_RLC_HIPASS = "bt_rlc_hipass"
    MT_RLC_HIPASS = "mt_rlc_hipass"
    BT_RLC_LOSHELF = "bt_rlc_loshelf"
    MT_RLC_LOSHELF = "mt_rlc_loshelf"
    BT_RLC_HISHELF = "bt_rlc_hishelf"
    MT_RLC_HISHELF = "mt_rlc_hishelf"
    BT_RLC_BELL = "bt_rlc_bell"
    MT_RLC_BELL = "mt_rlc_bell"
    BT_RLC_RESONANCE = "bt_rlc_resonance"
    MT_RLC_RESONANCE = "mt_rlc_resonance"
    BT_RLC_NOTCH = "bt_rlc_notch"
    MT_RLC_NOTCH = "mt_rlc_notch"
    BT_RLC_ALLPASS = "bt_rlc_allpass"
    MT_RLC_ALLPASS = "mt_rlc_allpass"
    BT_RLC_ALLPASS2 = "bt_rlc_allpass2"
    MT_RLC_ALLPASS2 = "mt_rlc_allpass2"
    BT_RLC_LADDERPASS = "bt_rlc_ladderpass"
    MT_RLC_LADDERPASS = "mt_rlc_ladderpass"
    BT_RLC_LADDERREJ = "bt_rlc_ladderrej"
    MT_RLC_LADDERREJ = "mt_rlc_ladderrej"
    BT_RLC_BANDPASS = "bt_rlc_bandpass"
    MT_RLC_BANDPASS = "mt_rlc_bandpass"
    BT_RLC_ENVELOPE = "bt_rlc_envelope"
    MT_RLC_ENVELOPE = "mt_rlc_envelope"
    # BWC family
    BT_BWC_LOPASS = "bt_bwc_lopass"
    MT_BWC_LOPASS = "mt_bwc_lopass"
    BT_BWC_HIPASS = "bt_bwc_hipass"
    MT_BWC_HIPASS = "mt_bwc_hipass"
    BT_BWC_LOSHELF = "bt_bwc_loshelf"
    MT_BWC_LOSHELF = "mt_bwc_loshelf"
    BT_BWC_HISHELF = "bt_bwc_hishelf"
    MT_BWC_HISHELF = "mt_bwc_hishelf"
    BT_BWC_BELL = "bt_bwc_bell"
    MT_BWC_BELL = "mt_bwc_bell"
    BT_BWC_LADDERPASS = "bt_bwc_ladderpass"
    MT_BWC_LADDERPASS = "mt_bwc_ladderpass"
    BT_BWC_LADDERREJ = "bt_bwc_ladderrej"
    MT_BWC_LADDERREJ = "mt_bwc_ladderrej"
    BT_BWC_BANDPASS = "bt_bwc_bandpass"
    MT_BWC_BANDPASS = "mt_bwc_bandpass"
    BT_BWC_ALLPASS = "bt_bwc_allpass"
    MT_BWC_ALLPASS = "mt_bwc_allpass"
    # LRX family
    BT_LRX_LOPASS = "bt_lrx_lopass"
    MT_LRX_LOPASS = "mt_lrx_lopass"
    BT_LRX_HIPASS = "bt_lrx_hipass"
    MT_LRX_HIPASS = "mt_lrx_hipass"
    BT_LRX_LOSHELF = "bt_lrx_loshelf"
    MT_LRX_LOSHELF = "mt_lrx_loshelf"
    BT_LRX_HISHELF = "bt_lrx_hishelf"
    MT_LRX_HISHELF = "mt_lrx_hishelf"
    BT_LRX_BELL = "bt_lrx_bell"
    MT_LRX_BELL = "mt_lrx_bell"
    BT_LRX_LADDERPASS = "bt_lrx_ladderpass"
    MT_LRX_LADDERPASS = "mt_lrx_ladderpass"
    BT_LRX_LADDERREJ = "bt_lrx_ladderrej"
    MT_LRX_LADDERREJ = "mt_lrx_ladderrej"
    BT_LRX_BANDPASS = "bt_lrx_bandpass"
    MT_LRX_BANDPASS = "mt_lrx_bandpass"
    BT_LRX_ALLPASS = "bt_lrx_allpass"
    MT_LRX_ALLPASS = "mt_lrx_allpass"
    # APO digital biquads
    DR_APO_LOPASS = "dr_apo_lopass"
    DR_APO_HIPASS = "dr_apo_hipass"
    DR_APO_BANDPASS = "dr_apo_bandpass"
    DR_APO_NOTCH = "dr_apo_notch"
    DR_APO_ALLPASS = "dr_apo_allpass"
    DR_APO_ALLPASS2 = "dr_apo_allpass2"
    DR_APO_PEAKING = "dr_apo_peaking"
    DR_APO_LOSHELF = "dr_apo_loshelf"
    DR_APO_HISHELF = "dr_apo_hishelf"
    DR_APO_LADDERPASS = "dr_apo_ladderpass"
    DR_APO_LADDERREJ = "dr_apo_ladderrej"
    # Weighting filters
    A_WEIGHTED = "a_weighted"
    B_WEIGHTED = "b_weighted"
    C_WEIGHTED = "c_weighted"
    D_WEIGHTED = "d_weighted"
    K_WEIGHTED = "k_weighted"


@dataclass(frozen=True)
class FilterParams:
    """Filter parameters (reference: filters/common.h:137-145)."""
    ftype: FilterType = FilterType.NONE
    slope: int = 1
    freq: float = 1000.0
    freq2: float = 1000.0
    gain: float = 1.0
    quality: float = 0.0


@dataclass(frozen=True)
class FilterDesign:
    """Design result: digital biquads + analog cascades for freq charts."""
    biquads: np.ndarray        # [K, 5] float64 (b0,b1,b2,a1,a2), a-negated
    cascades: np.ndarray       # [K, 8] float64 (t0..t3, b0..b3)
    mode: str                  # 'bilinear' | 'matched' | 'apo' | 'bypass'
    sample_rate: int
    freq: float                # design frequency used by the transforms


def limit_params(params: FilterParams, sample_rate: int) -> FilterParams:
    """Clamp parameters like the reference (Filter.cpp:161-167)."""
    max_freq = 0.49 * sample_rate
    return replace(
        params,
        slope=int(np.clip(params.slope, 1, FILTER_CHAINS_MAX)),
        freq=float(np.clip(params.freq, 0.0, max_freq)),
        freq2=float(np.clip(params.freq2, 0.0, max_freq)),
    )


class _CascadeList:
    """Accumulates analog cascades, capped at FILTER_CHAINS_MAX."""

    def __init__(self):
        self.items: List[np.ndarray] = []

    def add(self) -> np.ndarray:
        c = np.zeros(8, np.float64)
        if len(self.items) >= FILTER_CHAINS_MAX:
            self.items[-1] = c
        else:
            self.items.append(c)
        return c

    def array(self) -> np.ndarray:
        if not self.items:
            return np.zeros((0, 8), np.float64)
        return np.stack(self.items)


def _t(c):
    return c[0:4]


def _b(c):
    return c[4:8]


# ---------------------------------------------------------------------------
# RLC family (reference Filter.cpp:722-1082)
# ---------------------------------------------------------------------------

def _rlc_cascades(ftype: FilterType, fp: FilterParams, kf2: float,
                  cs: _CascadeList) -> None:
    """Analog prototypes of the RLC family. ``kf2`` is the normalized
    second frequency (already bilinear/matched relative)."""
    t = ftype.value.replace("bt_", "").replace("mt_", "")
    slope = fp.slope
    if t == "amplifier":
        c = cs.add()
        _t(c)[0] = fp.gain
        _b(c)[0] = 1.0
    elif t in ("rlc_lopass", "rlc_hipass"):
        k = 2.0 / (1.0 + fp.quality)
        i = slope & 1
        if i:
            c = cs.add()
            _b(c)[0] = 1.0
            _b(c)[1] = 1.0
            if t == "rlc_lopass":
                _t(c)[0] = fp.gain
            else:
                _t(c)[1] = fp.gain
        for j in range(i, slope, 2):
            c = cs.add()
            _b(c)[0] = 1.0
            _b(c)[1] = k
            _b(c)[2] = 1.0
            g = fp.gain if j == 0 else 1.0
            if t == "rlc_lopass":
                _t(c)[0] = g
            else:
                _t(c)[2] = g
    elif t in ("rlc_loshelf", "rlc_hishelf"):
        gain = np.sqrt(fp.gain)
        fg = np.exp(np.log(gain) / (slope * 2))
        for j in range(slope):
            c = cs.add()
            top, bot = (_t(c), _b(c)) if t == "rlc_loshelf" else (_b(c), _t(c))
            top[0] = fg
            top[1] = 2.0 / (1.0 + fp.quality)
            top[2] = 1.0 / fg
            bot[0] = 1.0 / fg
            bot[1] = 2.0 / (1.0 + fp.quality)
            bot[2] = fg
            if j == 0:
                _t(c)[0:3] *= gain
    elif t in ("rlc_ladderpass", "rlc_ladderrej"):
        slope2 = slope * 2
        rej = t == "rlc_ladderrej"
        gain1 = np.sqrt(1.0 / fp.gain) if rej else np.sqrt(fp.gain)
        gain2 = np.sqrt(fp.gain) if rej else np.sqrt(1.0 / fp.gain)
        fg1 = np.exp(np.log(gain1) / slope2)
        fg2 = np.exp(np.log(gain2) / slope2)
        kf = kf2
        for j in range(slope):
            # first shelf cascade: lo-shelf for LADDERREJ, hi-shelf otherwise
            c = cs.add()
            top, bot = (_t(c), _b(c)) if rej else (_b(c), _t(c))
            fg = fg2 if rej else fg1
            gain = gain2 if rej else gain1
            top[0] = fg
            top[1] = 2.0 / (1.0 + fp.quality)
            top[2] = 1.0 / fg
            bot[0] = 1.0 / fg
            bot[1] = 2.0 / (1.0 + fp.quality)
            bot[2] = fg
            if j == 0:
                _t(c)[0:3] *= gain
            # second cascade: hi-shelf at kf
            c = cs.add()
            top, bot = _b(c), _t(c)
            top[0] = fg2
            top[1] = 2.0 * kf / (1.0 + fp.quality)
            top[2] = kf * kf / fg2
            bot[0] = 1.0 / fg2
            bot[1] = 2.0 * kf / (1.0 + fp.quality)
            bot[2] = fg2 * kf * kf
            if j == 0:
                _t(c)[0:3] *= gain2
    elif t == "rlc_bandpass":
        kf = kf2
        kfsq = kf * kf
        k = 2.0 / (1.0 + fp.quality)
        i = slope & 1
        if i:
            c = cs.add()
            _t(c)[1] = fp.gain * fp.gain
            _b(c)[0] = 1.0
            _b(c)[1] = 1.0 + kf
            _b(c)[2] = kf
        for j in range(i, slope, 2):
            c = cs.add()
            _b(c)[0] = 1.0
            _b(c)[1] = k
            _b(c)[2] = 1.0
            _t(c)[0] = fp.gain if j == 0 else 1.0
            c = cs.add()
            _b(c)[0] = 1.0
            _b(c)[1] = k * kf
            _b(c)[2] = kfsq
            _t(c)[2] = fp.gain if j == 0 else 1.0
    elif t in ("rlc_bell", "rlc_resonance"):
        if t == "rlc_bell":
            fg = np.exp(np.log(fp.gain) / slope)
            k = 2.0 * (1.0 / fg + fg) / (1.0 + (2.0 * fp.quality) / slope)
        else:
            fg = np.exp(np.log(fp.gain) / slope)
            k = 2.0 / (1.0 + fp.quality)
        angle = np.arctan(fg)
        kt = k * np.sin(angle)
        kb = k * np.cos(angle)
        for _ in range(slope):
            c = cs.add()
            _t(c)[0] = 1.0
            _t(c)[1] = kt
            _t(c)[2] = 1.0
            _b(c)[0] = 1.0
            _b(c)[1] = kb
            _b(c)[2] = 1.0
    elif t == "rlc_notch":
        c = cs.add()
        _t(c)[0] = fp.gain
        _t(c)[2] = fp.gain
        _b(c)[0] = 1.0
        _b(c)[1] = 2.0 / (1.0 + fp.quality)
        _b(c)[2] = 1.0
    elif t == "rlc_allpass":
        k = 2.0 / (1.0 + fp.quality)
        c = None
        for _ in range(slope):
            c = cs.add()
            _t(c)[0] = 1.0
            _t(c)[1] = -k
            _t(c)[2] = 1.0
            _b(c)[0] = 1.0
            _b(c)[1] = k
            _b(c)[2] = 1.0
        if c is not None:
            _t(c)[0:3] *= fp.gain
    elif t == "rlc_allpass2":
        kf = kf2
        kfp1 = 1.0 + kf
        c = None
        for _ in range(slope):
            c = cs.add()
            _t(c)[0] = 1.0
            _t(c)[1] = -kfp1
            _t(c)[2] = kf
            _b(c)[0] = 1.0
            _b(c)[1] = kfp1
            _b(c)[2] = kf
        if c is not None:
            _t(c)[0:3] *= fp.gain
    elif t == "rlc_envelope":
        s = slope
        cj = 0
        if s & 1:
            k = 1.0
            for _ in range(3):
                c = cs.add()
                _t(c)[0] = 1.0
                _t(c)[1] = 1.25 * k
                _t(c)[2] = 0.25 * k * k
                _b(c)[0] = 1.0
                _b(c)[1] = 0.625 * k
                _b(c)[2] = 0.0625 * k * k
                k *= 0.0625
                if cj == 0:
                    _t(c)[0:3] *= fp.gain
                cj += 1
        s >>= 1
        for _ in range(s):
            c = cs.add()
            _t(c)[0] = fp.gain if cj == 0 else 1.0
            _t(c)[1] = fp.gain if cj == 0 else 1.0
            _b(c)[0] = 1.0
            _b(c)[1] = 0.0005
            cj += 1
    else:
        raise ValueError(f"not an RLC type: {ftype}")


# ---------------------------------------------------------------------------
# BWC family (reference Filter.cpp:1084-1395)
# ---------------------------------------------------------------------------

def _bwc_cascades(ftype_name: str, fp: FilterParams, kf2: float,
                  cs: _CascadeList) -> None:
    t = ftype_name
    slope = fp.slope
    if t in ("bwc_lopass", "bwc_hipass"):
        k = 1.0 / (1.0 + fp.quality)
        i = slope & 1
        if i:
            c = cs.add()
            _b(c)[0] = 1.0
            _b(c)[1] = 1.0
            if t == "bwc_lopass":
                _t(c)[0] = fp.gain
            else:
                _t(c)[1] = fp.gain
        for j in range(i, slope, 2):
            theta = ((j - i + 1) * np.pi / 2) / slope
            tsin = np.sin(theta)
            tcos = np.sqrt(1.0 - tsin * tsin)
            kf = tsin * tsin + k * k * tcos * tcos
            c = cs.add()
            if t == "bwc_hipass":
                _t(c)[2] = fp.gain if j == 0 else 1.0
                _b(c)[0] = 1.0 / kf
                _b(c)[1] = 2.0 * k * tcos / kf
                _b(c)[2] = 1.0
            else:
                _t(c)[0] = fp.gain if j == 0 else 1.0
                _b(c)[0] = 1.0
                _b(c)[1] = 2.0 * k * tcos / kf
                _b(c)[2] = 1.0 / kf
    elif t == "bwc_allpass":
        k = 1.0 / (1.0 + fp.quality)
        i = slope & 1
        if i:
            c = cs.add()
            _t(c)[0] = -fp.gain
            _t(c)[1] = fp.gain
            _b(c)[0] = 1.0
            _b(c)[1] = 1.0
        for j in range(i, slope, 2):
            theta = ((j - i + 1) * np.pi / 2) / slope
            tsin = np.sin(theta)
            tcos = np.sqrt(1.0 - tsin * tsin)
            kf = tsin * tsin + k * k * tcos * tcos
            c = cs.add()
            _t(c)[0] = 1.0
            _t(c)[1] = -2.0 * tcos
            _t(c)[2] = 1.0
            _b(c)[0] = 1.0 / kf
            _b(c)[1] = 2.0 * k * tcos / kf
            _b(c)[2] = 1.0
            if j == 0:
                _t(c)[0:3] *= fp.gain
    elif t in ("bwc_hishelf", "bwc_loshelf"):
        gain = np.sqrt(fp.gain)
        fg = np.exp(np.log(gain) / (2.0 * slope))
        k = 1.0 / (1.0 + fp.quality *
                   (1.0 - np.exp(2.0 - gain - 1.0 / gain)))
        for j in range(slope):
            theta = ((2 * j + 1) * np.pi / 2) / (2 * slope)
            tsin = np.sin(theta)
            tcos = np.sqrt(1.0 - tsin * tsin)
            kf = tsin * tsin + k * k * tcos * tcos
            c = cs.add()
            top, bot = (_t(c), _b(c)) if t == "bwc_hishelf" else (_b(c), _t(c))
            top[0] = kf / fg
            top[1] = 2.0 * k * tcos
            top[2] = fg
            bot[0] = fg
            bot[1] = 2.0 * k * tcos
            bot[2] = kf / fg
            if j == 0:
                _t(c)[0:3] *= gain
    elif t in ("bwc_ladderpass", "bwc_ladderrej"):
        slope2 = slope * 2
        lpass = t == "bwc_ladderpass"
        gain1 = np.sqrt(fp.gain) if lpass else np.sqrt(1.0 / fp.gain)
        gain2 = np.sqrt(1.0 / fp.gain) if lpass else np.sqrt(fp.gain)
        fg1 = np.exp(np.log(gain1) / (2.0 * slope))
        fg2 = np.exp(np.log(gain2) / (2.0 * slope))
        k1 = 1.0 / (1.0 + fp.quality * (1.0 - np.exp(2.0 - gain1 - 1.0 / gain1)))
        k2 = 1.0 / (1.0 + fp.quality * (1.0 - np.exp(2.0 - gain2 - 1.0 / gain2)))
        xf = kf2
        xf2 = xf * xf
        for j in range(slope):
            theta = ((2 * j + 1) * np.pi / 2) / slope2
            tsin = np.sin(theta)
            tcos = np.sqrt(1.0 - tsin * tsin)
            k = k1 if lpass else k2
            fg = fg1 if lpass else fg2
            gain = gain1 if lpass else gain2
            kf = tsin * tsin + k * k * tcos * tcos
            c = cs.add()
            # reference Filter.cpp:1247-1248: for LADDERPASS the first
            # shelf's transfer coefficients go into c->t (numerator),
            # for LADDERREJ into c->b — i.e. (t, b) NOT swapped for
            # lpass (the second cascade below is the always-swapped one)
            top, bot = (_t(c), _b(c)) if lpass else (_b(c), _t(c))
            top[0] = kf / fg
            top[1] = 2.0 * k * tcos
            top[2] = fg
            bot[0] = fg
            bot[1] = top[1]
            bot[2] = top[0]
            if j == 0:
                _t(c)[0:3] *= gain
            # second cascade: always hi-shelf at xf
            kf = tsin * tsin + k1 * k1 * tcos * tcos
            c = cs.add()
            top, bot = _b(c), _t(c)
            top[0] = kf / fg1
            top[1] = 2.0 * k1 * xf * tcos
            top[2] = fg1 * xf2
            bot[0] = fg1
            bot[1] = top[1]
            bot[2] = top[0] * xf2
            if j == 0:
                _t(c)[0:3] *= gain2
    elif t == "bwc_bell":
        fg = np.exp(np.log(fp.gain) / (2.0 * slope))
        k = 1.0 / (1.0 + fp.quality)
        for j in range(slope):
            theta = ((2 * j + 1) * np.pi / 2) / (2 * slope)
            tsin = np.sin(theta)
            tcos = np.sqrt(1.0 - tsin * tsin)
            kf = tsin * tsin + k * k * tcos * tcos
            if fp.gain >= 1.0:
                c = cs.add()
                _t(c)[0] = 1.0
                _t(c)[1] = 2.0 * k * tcos * fg / kf
                _t(c)[2] = fg * fg / kf
                _b(c)[0] = 1.0
                _b(c)[1] = 2.0 * k * tcos / kf
                _b(c)[2] = 1.0 / kf
                c = cs.add()
                _t(c)[0] = 1.0
                _t(c)[1] = 2.0 * k * tcos / fg
                _t(c)[2] = kf / (fg * fg)
                _b(c)[0] = 1.0
                _b(c)[1] = 2.0 * k * tcos
                _b(c)[2] = kf
            else:
                c = cs.add()
                _t(c)[0] = 1.0
                _t(c)[1] = 2.0 * k * tcos / kf
                _t(c)[2] = 1.0 / kf
                _b(c)[0] = 1.0
                _b(c)[1] = 2.0 * k * tcos / (fg * kf)
                _b(c)[2] = 1.0 / (fg * fg * kf)
                c = cs.add()
                _t(c)[0] = 1.0
                _t(c)[1] = 2.0 * k * tcos
                _t(c)[2] = kf
                _b(c)[0] = 1.0
                _b(c)[1] = 2.0 * k * tcos * fg
                _b(c)[2] = kf * fg * fg
    elif t == "bwc_bandpass":
        f2 = kf2
        k = 1.0 / (1.0 + fp.quality)
        for j in range(slope):
            theta = ((2 * j + 1) * np.pi / 2) / (2 * slope)
            tsin = np.sin(theta)
            tcos = np.sqrt(1.0 - tsin * tsin)
            kf = tsin * tsin + k * k * tcos * tcos
            c = cs.add()
            _t(c)[2] = fp.gain if j == 0 else 1.0
            _b(c)[0] = 1.0 / kf
            _b(c)[1] = 2.0 * k * tcos / kf
            _b(c)[2] = 1.0
            c = cs.add()
            _t(c)[0] = 1.0
            _b(c)[0] = 1.0
            _b(c)[1] = 2.0 * k * tcos * f2 / kf
            _b(c)[2] = f2 * f2 / kf
    else:
        raise ValueError(f"not a BWC type: {t}")


def _lrx_cascades(ftype_name: str, fp: FilterParams, kf2: float,
                  cs: _CascadeList) -> None:
    """LRX = BWC applied twice at doubled slope, sqrt gain
    (reference Filter.cpp:1397-1487)."""
    t = ftype_name
    if t == "lrx_allpass":
        k = 1.0 / (1.0 + fp.quality)
        n = fp.slope * 2
        for j in range(0, n, 2):
            theta = ((j + 1) * np.pi / 2) / n
            tsin = np.sin(theta)
            tcos = np.sqrt(1.0 - tsin * tsin)
            kf = tsin * tsin + k * k * tcos * tcos
            c1 = cs.add()
            c2 = cs.add()
            xeta = ((j + 0.5) * np.pi) / n
            _t(c1)[0] = 1.0
            _t(c1)[1] = -2.0 * np.cos(xeta)
            _t(c1)[2] = 1.0
            xeta = ((j + 1.5) * np.pi) / n
            _t(c2)[0] = 1.0
            _t(c2)[1] = -2.0 * np.cos(xeta)
            _t(c2)[2] = 1.0
            _b(c1)[0] = 1.0 / kf
            _b(c1)[1] = 2.0 * k * tcos / kf
            _b(c1)[2] = 1.0
            _b(c2)[0:3] = _b(c1)[0:3]
            if j == 0:
                _t(c1)[0:3] *= fp.gain
        return
    bwc_name = t.replace("lrx_", "bwc_")
    bfp = replace(fp, slope=fp.slope * 2, gain=np.sqrt(fp.gain))
    _bwc_cascades(bwc_name, bfp, kf2, cs)
    _bwc_cascades(bwc_name, bfp, kf2, cs)


# ---------------------------------------------------------------------------
# Digitization (reference Filter.cpp:2192-2416)
# ---------------------------------------------------------------------------

def bilinear_transform(cascades: np.ndarray, freq: float,
                       sample_rate: int) -> np.ndarray:
    """Bilinear transform with prewarp kf = 1/tan(pi f / sr)
    (reference Filter.cpp:2225-2267)."""
    kf = 1.0 / np.tan(freq * np.pi / sample_rate)
    kf2 = kf * kf
    out = np.zeros((cascades.shape[0], 5), np.float64)
    for i, c in enumerate(cascades):
        t = c[0:4]
        b = c[4:8]
        T = np.array([t[0], t[1] * kf, t[2] * kf2])
        B = np.array([b[0], b[1] * kf, b[2] * kf2])
        N = 1.0 / (B[0] + B[1] + B[2])
        out[i, 0] = (T[0] + T[1] + T[2]) * N
        out[i, 1] = 2.0 * (T[0] - T[2]) * N
        out[i, 2] = (T[0] - T[1] + T[2]) * N
        out[i, 3] = 2.0 * (B[2] - B[0]) * N          # sign negated
        out[i, 4] = (B[1] - B[2] - B[0]) * N         # sign negated
    return out


def _matched_poly(p: np.ndarray, f: float, td: float) -> np.ndarray:
    """Matched-Z transform of one polynomial t0 + t1 (s/f) + t2 (s/f)^2
    (reference Filter.cpp:2304-2367)."""
    P = np.zeros(3, np.float64)
    if p[2] == 0.0:
        if p[1] == 0.0:
            P[0] = p[0]
        else:
            k = p[1] / f
            R = -p[0] / k
            P[0] = k
            P[1] = -k * np.exp(R * td)
    else:
        k = p[2]
        a = 1.0 / (f * f)
        b = p[1] / (f * p[2])
        c = p[0] / p[2]
        D = b * b - 4.0 * a * c
        if D >= 0:
            D = np.sqrt(D)
            R0 = (-b - D) / (2.0 * a)
            R1 = (-b + D) / (2.0 * a)
            P[0] = k
            P[1] = -k * (np.exp(R0 * td) + np.exp(R1 * td))
            P[2] = k * np.exp((R0 + R1) * td)
        else:
            D = np.sqrt(-D)
            R = -b / (2.0 * a)
            K = D / (2.0 * a)
            P[0] = k
            P[1] = -2.0 * k * np.exp(R * td) * np.cos(K * td)
            P[2] = k * np.exp(2.0 * R * td)
    return P


def matched_transform(cascades: np.ndarray, freq: float,
                      sample_rate: int) -> np.ndarray:
    """Matched-Z transform with amplitude renormalization at f/10
    (reference Filter.cpp:2291-2416)."""
    td = 2.0 * np.pi / sample_rate
    out = np.zeros((cascades.shape[0], 5), np.float64)
    for i, c in enumerate(cascades):
        polys = (c[0:4], c[4:8])
        P = [None, None]
        A = np.zeros(2)
        I = np.zeros(2)
        for pi, p in enumerate(polys):
            P[pi] = _matched_poly(p, freq, td)
            # digital amplitude at w = pi*0.2*f/sr
            w = np.pi * 0.2 * freq / sample_rate
            re = P[pi][0] * np.cos(2 * w) + P[pi][1] * np.cos(w) + P[pi][2]
            im = P[pi][0] * np.sin(2 * w) + P[pi][1] * np.sin(w)
            A[pi] = np.sqrt(re * re + im * im)
            # analog amplitude at normalized w = 0.1
            w = 0.1
            re = p[0] - p[2] * w * w
            im = p[1] * w
            I[pi] = np.sqrt(re * re + im * im)
        T, B = P[0], P[1]
        AN = (A[1] * I[0]) / (A[0] * I[1])
        N = 1.0 / B[0]
        out[i, 0] = T[0] * N * AN
        out[i, 1] = T[1] * N * AN
        out[i, 2] = T[2] * N * AN
        out[i, 3] = -B[1] * N
        out[i, 4] = -B[2] * N
    return out


# ---------------------------------------------------------------------------
# APO digital biquads (reference Filter.cpp:1489-1647)
# ---------------------------------------------------------------------------

def _apo_biquad(tname: str, freq: float, gain: float, quality: float,
                sample_rate: int) -> np.ndarray:
    omega = 2.0 * np.pi * freq / sample_rate
    cs = np.sin(omega)
    cc = np.cos(omega)
    Q = max(quality, MIN_APO_Q)
    alpha = 0.5 * cs / Q

    if tname == "lopass":
        A = gain
        a0 = A * 0.5 * (1.0 - cc)
        a1 = A * (1.0 - cc)
        a2 = a0
        b0, b1, b2 = 1.0 + alpha, -2.0 * cc, 1.0 - alpha
    elif tname == "hipass":
        A = gain
        a0 = A * 0.5 * (1.0 + cc)
        a1 = A * (-1.0 - cc)
        a2 = a0
        b0, b1, b2 = 1.0 + alpha, -2.0 * cc, 1.0 - alpha
    elif tname == "bandpass":
        A = gain
        a0, a1, a2 = A * alpha, 0.0, -A * alpha
        b0, b1, b2 = 1.0 + alpha, -2.0 * cc, 1.0 - alpha
    elif tname == "notch":
        A = gain
        a0, a1, a2 = A, A * -2.0 * cc, A
        b0, b1, b2 = 1.0 + alpha, -2.0 * cc, 1.0 - alpha
    elif tname == "allpass":
        A = gain
        a0 = A * (1.0 - alpha)
        a1 = A * -2.0 * cc
        a2 = A * (1.0 + alpha)
        b0, b1, b2 = a2, a1, a0
    elif tname == "peaking":
        A = np.sqrt(gain)
        a0, a1, a2 = 1.0 + alpha * A, -2.0 * cc, 1.0 - alpha * A
        b0, b1, b2 = 1.0 + alpha / A, a1, 1.0 - alpha / A
    elif tname == "loshelf":
        A = np.sqrt(gain)
        beta = 2.0 * alpha * np.sqrt(A)
        a0 = A * ((A + 1.0) - (A - 1.0) * cc + beta)
        a1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cc)
        a2 = A * ((A + 1.0) - (A - 1.0) * cc - beta)
        b0 = (A + 1.0) + (A - 1.0) * cc + beta
        b1 = -2.0 * ((A - 1.0) + (A + 1.0) * cc)
        b2 = (A + 1.0) + (A - 1.0) * cc - beta
    elif tname == "hishelf":
        A = np.sqrt(gain)
        beta = 2.0 * alpha * np.sqrt(A)
        a0 = A * ((A + 1.0) + (A - 1.0) * cc + beta)
        a1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cc)
        a2 = A * ((A + 1.0) + (A - 1.0) * cc - beta)
        b0 = (A + 1.0) - (A - 1.0) * cc + beta
        b1 = 2.0 * ((A - 1.0) - (A + 1.0) * cc)
        b2 = (A + 1.0) - (A - 1.0) * cc - beta
    else:
        raise ValueError(tname)

    rb0 = 1.0 / b0
    return np.array([a0 * rb0, a1 * rb0, a2 * rb0, -b1 * rb0, -b2 * rb0],
                    np.float64)


# ---------------------------------------------------------------------------
# Weighting filters (reference Filter.cpp:1649-2185)
# ---------------------------------------------------------------------------

def _normalize_biquad(f: np.ndarray, frequency: float, gain: float,
                      sample_rate: int) -> np.ndarray:
    """Scale feed-forward coefficients so |H| at ``frequency`` equals
    ``gain`` (reference Filter.cpp:1649-1676)."""
    xf = 2.0 * np.pi * min(frequency, sample_rate * 0.5) / sample_rate
    cw, sw = np.cos(xf), np.sin(xf)
    c2w = cw * cw - sw * sw
    s2w = 2.0 * sw * cw
    alpha = f[0] + f[1] * cw + f[2] * c2w
    beta = f[1] * sw + f[2] * s2w
    gamma = 1.0 - f[3] * cw - f[4] * c2w
    delta = -f[3] * sw - f[4] * s2w
    mag = gamma * gamma + delta * delta
    w_re = alpha * gamma - beta * delta
    w_im = alpha * delta + beta * gamma
    egain = (gain * mag) / np.sqrt(w_re * w_re + w_im * w_im)
    out = f.copy()
    out[0:3] *= egain
    return out


def _onepole_hp_pair(p0: float, T: float) -> np.ndarray:
    """Biquad for a double real pole at -p0 with double zero at 0
    (reference A-weight first section, Filter.cpp:1694-1725)."""
    ww = p0 * T
    ws, wc = np.sin(ww), np.cos(ww)
    ka0 = 1.0 / (1.0 + ws)
    b0 = 0.5 * (1.0 + wc) * ka0
    return np.array([b0, (-1.0 - wc) * ka0, b0,
                     2.0 * wc * ka0, (ws - 1.0) * ka0], np.float64)


def _onepole_lp_pair(p0: float, T: float) -> np.ndarray:
    """Double real pole at -p0, no zeros (Filter.cpp:1773-1804)."""
    ww = p0 * T
    ws, wc = np.sin(ww), np.cos(ww)
    ka0 = 1.0 / (1.0 + ws)
    b0 = 0.5 * (1.0 - wc) * ka0
    return np.array([b0, (1.0 - wc) * ka0, b0,
                     -2.0 * wc * ka0, (1.0 - ws) * ka0], np.float64)


def _two_real_poles_hp(p0: float, p1: float, T: float) -> np.ndarray:
    """Poles at -p0,-p1 with double zero at 0 (Filter.cpp:1729-1769)."""
    ww0, ww1 = p0 * T, p1 * T
    ws0, wc0 = np.sin(ww0), np.cos(ww0)
    ws1, wc1 = np.sin(ww1), np.cos(ww1)
    kx0 = 1.0 / (1.0 + ws0 - wc0)
    kx1 = 1.0 / (1.0 + ws1 - wc1)
    ka0 = kx0 * kx1
    ky0 = 1.0 - wc0 - ws0
    ky1 = 1.0 - wc1 - ws1
    b0 = ws0 * ws1 * ka0
    return np.array([b0, -2.0 * b0, b0,
                     -(ky0 * kx0 + ky1 * kx1), -ky0 * ky1 * ka0], np.float64)


def _weighted_biquads(ftype: FilterType, sample_rate: int) -> np.ndarray:
    T = 1.0 / sample_rate
    out = []
    if ftype == FilterType.A_WEIGHTED:
        # Ha(p) = ka p^4 / ((p+129.4)^2 (p+676.7)(p+4636)(p+76655)^2)
        out.append(_normalize_biquad(_onepole_hp_pair(129.4, T), 1000.0, 1.0,
                                     sample_rate))
        out.append(_normalize_biquad(_two_real_poles_hp(676.7, 4636.0, T),
                                     1000.0, 1.0, sample_rate))
        out.append(_normalize_biquad(_onepole_lp_pair(76655.0, T), 1000.0,
                                     1.0, sample_rate))
    elif ftype == FilterType.B_WEIGHTED:
        # Hb(p) = kb p^3 / ((p+129.4)^2 (p+995.9)(p+76655)^2)
        out.append(_normalize_biquad(_onepole_hp_pair(129.4, T), 1000.0, 1.0,
                                     sample_rate))
        ww = 995.9 * T
        ws, wc = np.sin(ww), np.cos(ww)
        ka0 = 1.0 / (1.0 + ws - wc)
        f = np.array([ws * ka0, -ws * ka0, 0.0,
                      (ws + wc - 1.0) * ka0, 0.0], np.float64)
        out.append(_normalize_biquad(f, 1000.0, 1.0, sample_rate))
        out.append(_normalize_biquad(_onepole_lp_pair(76655.0, T), 1000.0,
                                     1.0, sample_rate))
    elif ftype == FilterType.C_WEIGHTED:
        # Hc(p) = p^2 / ((p+129.4)^2 (p+76655)^2)
        out.append(_normalize_biquad(_onepole_hp_pair(129.4, T), 1000.0, 1.0,
                                     sample_rate))
        out.append(_normalize_biquad(_onepole_lp_pair(76655.0, T), 1000.0,
                                     1.0, sample_rate))
    elif ftype == FilterType.D_WEIGHTED:
        # Hd(p) = p (p^2 + 6532 p + 4.0975e7) /
        #         ((p+1776.3)(p+7288.5)(p^2 + 21514 p + 3.8836e8))
        ww0, ww1 = 1776.3 * T, 7288.5 * T
        ws0, wc0 = np.sin(ww0), np.cos(ww0)
        ws1, wc1 = np.sin(ww1), np.cos(ww1)
        kx0 = 1.0 / (1.0 + ws0 - wc0)
        kx1 = 1.0 / (1.0 + ws1 - wc1)
        ka0 = kx0 * kx1
        ky0 = 1.0 - wc0 - ws0
        ky1 = 1.0 - wc1 - ws1
        b0 = ws0 * (1.0 - wc1) * ka0
        f = np.array([b0, 0.0, -b0,
                      -(ky0 * kx0 + ky1 * kx1), -ky0 * ky1 * ka0], np.float64)
        out.append(_normalize_biquad(f, 1000.0, 1.0, sample_rate))
        # complex zero pair at 6401.17 (R=1.02), pole pair at 19706.85
        # (R=1.092) via bilinear sections (Filter.cpp:2058-2096)
        wt0 = 1.0 / np.tan(6401.17 * T * 0.5)
        wt1 = 1.0 / np.tan(19706.85 * T * 0.5)
        r0, r1 = 1.02, 1.092
        ka0 = 1.0 / (1.0 + wt1 * (wt1 + r1))
        f = np.array([
            (1.0 + wt0 * (wt0 + r0)) * ka0,
            2.0 * (1.0 - wt0 * wt0) * ka0,
            (1.0 + wt0 * (wt0 - r0)) * ka0,
            -2.0 * (1.0 - wt1 * wt1) * ka0,
            -(1.0 + wt1 * (wt1 - r1)) * ka0], np.float64)
        out.append(_normalize_biquad(f, 1000.0, 1.0, sample_rate))
    elif ftype == FilterType.K_WEIGHTED:
        # ITU-R BS.1770 K-weighting, sample-rate adapted
        # (Filter.cpp:2101-2185): high shelf + high pass.
        Vh = 1.58486470113
        Vb = 1.25872093023
        f0 = 1681.974450955533
        Q = 0.7071752369554196
        K = np.tan(np.pi * f0 * T)
        K2 = K * K
        KQ = K / Q
        ka0 = 1.0 / (1.0 + KQ + K2)
        out.append(np.array([
            (Vh + Vb * KQ + K2) * ka0,
            2.0 * (K2 - Vh) * ka0,
            (Vh - Vb * KQ + K2) * ka0,
            -2.0 * (K2 - 1.0) * ka0,
            -(1.0 - KQ + K2) * ka0], np.float64))
        f0 = 38.13547087602444
        Q = 0.5003270373238773
        K = np.tan(np.pi * f0 * T)
        K2 = K * K
        KQ = K / Q
        ka0 = 1.0 / (1.0 + KQ + K2)
        out.append(np.array([
            1.0, -2.0, 1.0,
            -2.0 * (K2 - 1.0) * ka0,
            -(1.0 - KQ + K2) * ka0], np.float64))
    else:
        raise ValueError(ftype)
    return np.stack(out)


def _biquads_to_cascades(biquads: np.ndarray) -> np.ndarray:
    """Digital biquads as plotting cascades (reference Filter.cpp:1640-1646)."""
    cs = np.zeros((biquads.shape[0], 8), np.float64)
    cs[:, 0:3] = biquads[:, 0:3]
    cs[:, 4] = 1.0
    cs[:, 5] = -biquads[:, 3]
    cs[:, 6] = -biquads[:, 4]
    return cs


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def design_filter(params: FilterParams, sample_rate: int) -> FilterDesign:
    """Design a parametric filter: analog cascades + digital biquads.

    Mirrors the dispatch of the reference ``Filter::rebuild``
    (Filter.cpp:208-403).
    """
    fp = limit_params(params, sample_rate)
    name = fp.ftype.value
    cs = _CascadeList()

    def bilinear_rel(f1, f2):
        nf = np.pi / sample_rate
        return np.tan(f1 * nf) / np.tan(f2 * nf)

    if fp.ftype == FilterType.NONE:
        return FilterDesign(np.zeros((0, 5)), np.zeros((0, 8)), "bypass",
                            sample_rate, fp.freq)

    if name.startswith("bt_rlc") or name == "bt_amplifier":
        kf2 = bilinear_rel(fp.freq, fp.freq2) if fp.freq2 else 1.0
        _rlc_cascades(fp.ftype, fp, kf2, cs)
        casc = cs.array()
        return FilterDesign(bilinear_transform(casc, fp.freq, sample_rate),
                            casc, "bilinear", sample_rate, fp.freq)
    if name.startswith("mt_rlc") or name == "mt_amplifier":
        kf2 = fp.freq / fp.freq2 if fp.freq2 else 1.0
        bt_type = FilterType("bt" + name[2:])
        _rlc_cascades(bt_type, fp, kf2, cs)
        casc = cs.array()
        return FilterDesign(matched_transform(casc, fp.freq, sample_rate),
                            casc, "matched", sample_rate, fp.freq)
    if name.startswith("bt_bwc"):
        kf2 = bilinear_rel(fp.freq, fp.freq2) if fp.freq2 else 1.0
        _bwc_cascades(name[3:], fp, kf2, cs)
        casc = cs.array()
        return FilterDesign(bilinear_transform(casc, fp.freq, sample_rate),
                            casc, "bilinear", sample_rate, fp.freq)
    if name.startswith("mt_bwc"):
        kf2 = fp.freq / fp.freq2 if fp.freq2 else 1.0
        _bwc_cascades(name[3:], fp, kf2, cs)
        casc = cs.array()
        return FilterDesign(matched_transform(casc, fp.freq, sample_rate),
                            casc, "matched", sample_rate, fp.freq)
    if name.startswith("bt_lrx"):
        kf2 = bilinear_rel(fp.freq, fp.freq2) if fp.freq2 else 1.0
        _lrx_cascades(name[3:], fp, kf2, cs)
        casc = cs.array()
        return FilterDesign(bilinear_transform(casc, fp.freq, sample_rate),
                            casc, "bilinear", sample_rate, fp.freq)
    if name.startswith("mt_lrx"):
        kf2 = fp.freq / fp.freq2 if fp.freq2 else 1.0
        _lrx_cascades(name[3:], fp, kf2, cs)
        casc = cs.array()
        return FilterDesign(matched_transform(casc, fp.freq, sample_rate),
                            casc, "matched", sample_rate, fp.freq)
    if name.startswith("dr_apo"):
        tname = name[7:]
        if tname == "allpass2":
            # two all-pass sections at freq/freq2 (Filter.cpp:348-356)
            bqs = np.stack([
                _apo_biquad("allpass", fp.freq, fp.gain, fp.quality,
                            sample_rate),
                _apo_biquad("allpass", fp.freq2, 1.0, fp.quality,
                            sample_rate)])
        elif tname == "ladderpass":
            # hi-shelf at freq + inverse hi-shelf at freq2 (Filter.cpp:358-366)
            bqs = np.stack([
                _apo_biquad("hishelf", fp.freq, fp.gain, fp.quality,
                            sample_rate),
                _apo_biquad("hishelf", fp.freq2, 1.0 / fp.gain, fp.quality,
                            sample_rate)])
        elif tname == "ladderrej":
            # lo-shelf at freq + hi-shelf at freq2 (Filter.cpp:368-375)
            bqs = np.stack([
                _apo_biquad("loshelf", fp.freq, fp.gain, fp.quality,
                            sample_rate),
                _apo_biquad("hishelf", fp.freq2, fp.gain, fp.quality,
                            sample_rate)])
        else:
            bqs = _apo_biquad(tname, fp.freq, fp.gain, fp.quality,
                              sample_rate)[None]
        return FilterDesign(bqs, _biquads_to_cascades(bqs), "apo",
                            sample_rate, fp.freq)
    if name.endswith("_weighted"):
        bqs = _weighted_biquads(fp.ftype, sample_rate)
        return FilterDesign(bqs, _biquads_to_cascades(bqs), "apo",
                            sample_rate, fp.freq)
    raise ValueError(f"unsupported filter type: {fp.ftype}")


# ---------------------------------------------------------------------------
# Frequency charts (reference Filter.cpp:500-698)
# ---------------------------------------------------------------------------

def freq_chart(design: FilterDesign, freqs: np.ndarray) -> np.ndarray:
    """Complex transfer function at the given frequencies (Hz).

    For 'bilinear'/'matched' modes the chart is evaluated on the ANALOG
    cascades (with the appropriate frequency mapping), matching the
    reference's freq_chart (Filter.cpp:500-599); for 'apo' mode it is the
    digital response (Filter.cpp:405-450).
    """
    freqs = np.asarray(freqs, np.float64)
    sr = design.sample_rate
    if design.mode == "bypass" or design.cascades.shape[0] == 0:
        return np.ones_like(freqs, np.complex128)
    if design.mode == "bilinear":
        # prewarped relative frequency (reference uses
        # tan(pi f / sr) * kf, kf = 1/tan(pi f0/sr))
        kf = 1.0 / np.tan(design.freq * np.pi / sr)
        w = np.tan(freqs * np.pi / sr) * kf
    elif design.mode == "matched":
        w = freqs / design.freq
    else:  # apo: digital response of the biquads
        z = np.exp(-2j * np.pi * freqs / sr)
        h = np.ones_like(z, np.complex128)
        for b0, b1, b2, a1, a2 in design.biquads:
            h *= (b0 + b1 * z + b2 * z * z) / (1.0 - a1 * z - a2 * z * z)
        return h
    s = 1j * w
    h = np.ones_like(s, np.complex128)
    for c in design.cascades:
        t = c[0:4]
        b = c[4:8]
        h *= (t[0] + t[1] * s + t[2] * s * s) / (b[0] + b[1] * s + b[2] * s * s)
    return h


def digital_freq_response(biquads: np.ndarray, freqs: np.ndarray,
                          sample_rate: int) -> np.ndarray:
    """Exact digital response of a biquad cascade at given frequencies."""
    z = np.exp(-2j * np.pi * np.asarray(freqs, np.float64) / sample_rate)
    h = np.ones_like(z, np.complex128)
    for b0, b1, b2, a1, a2 in np.asarray(biquads, np.float64):
        h *= (b0 + b1 * z + b2 * z * z) / (1.0 - a1 * z - a2 * z * z)
    return h
