"""ITU-R BS.1770 / BS.2051 broadcast constants and channel weighting: the
port of models/misc/broadcast.py (plain Python, its own copy)
(reference: src/main/misc/broadcast.cpp, include/.../misc/broadcast.h).
"""

from __future__ import annotations

import enum

# Gain-domain and dB-domain shifts (reference broadcast.h:96-108)
DBFS_TO_LUFS_SHIFT_DB = -0.691
LUFS_TO_DBFS_SHIFT_DB = 0.691
LUFS_TO_LU_SHIFT_DB = 23.0
LO_TO_LUFS_SHIFT_DB = -23.0
DB_TO_LU_SHIFT_DB = 22.309
LU_TO_DB_SHIFT = -22.309

DBFS_TO_LUFS_SHIFT_GAIN = 0.923527857225
LUFS_TO_DBFS_SHIFT_GAIN = 1.08280437041
LUFS_TO_LU_SHIFT_GAIN = 14.1253754462
LO_TO_LUFS_SHIFT_GAIN = 0.0707945784385
DB_TO_LU_SHIFT_GAIN = 13.0451777184
LU_TO_DB_SHIFT_GAIN = 0.0766566789345

# Standard measuring periods (reference broadcast.h:110-124)
LUFS_MEASURE_PERIOD_MS = 400.0
LUFS_MOMENTARY_PERIOD = 400.0
LUFS_SHORT_TERM_PERIOD = 3000.0


class Channel(enum.Enum):
    """BS.2051-3 channel designations (reference broadcast.h:58-93)."""
    NONE = "none"
    CENTER = "center"                    # M+000
    LEFT_SCREEN = "left_screen"          # M+SC
    RIGHT_SCREEN = "right_screen"        # M-SC
    LEFT = "left"                        # M+030
    RIGHT = "right"                      # M-030
    FRONT_LEFT = "front_left"            # M+060
    FRONT_RIGHT = "front_right"          # M-060
    LEFT_SIDE = "left_side"              # M+090
    RIGHT_SIDE = "right_side"            # M-090
    LEFT_SURROUND = "left_surround"      # M+110
    RIGHT_SURROUND = "right_surround"    # M-110
    LEFT_BACK = "left_back"              # M+135
    RIGHT_BACK = "right_back"            # M-135
    BACK_CENTER = "back_center"          # M+180
    LFE1 = "lfe1"
    LFE2 = "lfe2"


_SURROUND = {
    Channel.FRONT_LEFT, Channel.FRONT_RIGHT,
    Channel.LEFT_SIDE, Channel.RIGHT_SIDE,
    Channel.LEFT_SURROUND, Channel.RIGHT_SURROUND,
}


def channel_weighting(designation: Channel) -> float:
    """BS.1770 channel weighting in the amplitude-gain domain
    (reference broadcast.cpp:32-53): ~+1.5 dB for surround positions,
    0 for LFE, 1 otherwise."""
    if designation in _SURROUND:
        return 1.41
    if designation in (Channel.LFE1, Channel.LFE2):
        return 0.0
    return 1.0
