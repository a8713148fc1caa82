"""The kernels of one call of a backward on the card, by torch.profiler:
each launch's short name, ms a launch, launches a call and the bytes
bound of those launches (each input of the function read once, each
output written once, over the H100's memory rate).  Used by
``chip_smoke.py``'s grad_ring phase and by ``tools/ab_kernels.py``'s
backward cases; the convolver's launches have their byte counts here
(:func:`launch_bytes`), other callers pass theirs; a launch without a
byte count (another build's) has no bound."""

from __future__ import annotations

import re
import time

import torch

HBM_BYTES_PER_S = 3.35e12            # the H100's memory rate (the bounds)

# host seconds between the warm-up calls of a profile and the counted
# ones, wider than any error of the device timestamps' conversion
GAP_S = 0.02
MARK = "launch_profile.counted"      # the counted calls' range


def launch_name(name: str) -> str:
    """A kernel's short name from the profiler's: the function's, with
    its template argument, or torch's element-wise add and copy."""
    if "CUDAFunctor_add" in name:
        return "torch add"
    if "copy" in name:
        return "torch copy"
    m = re.search(r"::(\w+(?:<[^<>()]*>)?)\(", name)
    return m.group(1) if m else name[:60]


def launch_bytes(name: str, c: int, b: int, p_n: int, k2: int):
    """The bytes one launch of the convolver backwards must move at C
    channels, B = N / 2 packed positions, P partitions and 2K = k2, by
    short name; None for any other.  The EQ adjoint's two launches
    together count its inputs and outputs once, not the scratch of sv's
    partial sums that passes between them."""
    f = 4
    plane, rows = c * b * f, k2 * b * f
    if name.startswith("eqfdl_bwd<"):
        # g (2 planes), xs (2), gu and x in, xs's (2) and x's cotangents
        # out; Heq in, its cotangent out; g_t and w_mat in, their
        # cotangents out; sv and gsv' in
        return 9 * plane + 4 * rows + 4 * b * f + 2 * c * k2 * f
    table = {
        # ring' and the ring's cotangent in, the incoming ring's out; g in,
        # S's cotangent out; H in, its cotangent out
        "fdl_bwd": (6 * p_n + 4) * plane + 4 * p_n * b * f,
        # m_mat in; sv's and m_mat's cotangents out
        "eqfdl_bwd_sums": (c * k2 + 2 * k2 * k2) * f,
        "rfft_packed_kernel": 3 * plane,      # half a frame in, spectra out
        "irfft_packed_kernel": 4 * plane,     # spectra in, the frame out
        # S's cotangent and u's in; hist's, g_ut and its spectra out
        "frame_bwd_kernel<true>": 7 * plane,
        # S's cotangent in; hist's and x's out
        "frame_bwd_kernel<false>": 4 * plane,
        "torch add": 3 * plane,
        "torch copy": 2 * plane,
    }
    return table.get(name)


def device_kernels(fn, calls: int = 10, warm: int = 30) -> dict:
    """Every kernel of ``fn()`` by torch.profiler, by the profiler's own
    name: (ms, launches) summed over ``calls`` calls.  On the H100
    machine a profile late in a long process lost the device records of
    its first launches, so ``warm`` calls run first inside the profile,
    and only the launches that start after a synchronisation and a GAP_S
    pause are counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        time.sleep(GAP_S)
        with record_function(MARK):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == MARK) - GAP_S * 1e6 / 2
    rows = {}
    for e in events:
        us = e.time_range.elapsed_us()
        if e.device_type != DeviceType.CUDA or us <= 0 \
                or e.time_range.start < start or e.name == MARK:
            continue
        ms, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + us / 1e3, n + 1)
    return rows


def launch_profile(fn, c: int, b: int, p_n: int, k2: int, calls: int = 10,
                   bytes_of=None, warm: int = 30):
    """The kernels of ``fn()`` (one backward call) by torch.profiler over
    ``calls`` calls after ``warm`` uncounted ones (:func:`device_kernels`):
    short name, ms a launch, launches a call, and the bytes bound of
    those launches (ms a call, None where ``bytes_of``, by default the
    convolver's launch_bytes at (c, b, p_n, k2), has no count), the most
    time first."""
    if bytes_of is None:
        def bytes_of(name):
            return launch_bytes(name, c, b, p_n, k2)
    rows = {}
    for raw, (ms, n) in device_kernels(fn, calls, warm).items():
        name = launch_name(raw)
        ms0, n0 = rows.get(name, (0.0, 0))
        rows[name] = (ms0 + ms, n0 + n)
    out = []
    for name, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0]):
        nbytes = bytes_of(name)
        per_call = round(n / calls)
        out.append(dict(name=name, ms=ms / n, launches=per_call,
                        bound_ms=None if nbytes is None
                        else per_call * nbytes / HBM_BYTES_PER_S * 1e3))
    return out
