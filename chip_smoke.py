"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check
them.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero; nothing is caught):

1. card   — CUDA must be available; prints nvidia-smi's name and power
            limit.
2. build  — compiles the six CUDA sources of lsp_dsp_units_tpu_torch/csrc
            (nvcc, sm_90a), one nvcc each, all started together, and
            prints the seconds.
3. parity — each kernel against its plain PyTorch version on the card, at
            the main paths' shapes (C=64, N=16384, P=6, N_sc=480):
            packed FFT >= 95 dB (and its launch shape: the forward's
            blocks resident at once, from the occupancy calculator,
            must cover all 2 x 64), EQ+FDL y and u >= 95 dB (ring and EQ
            state likewise; y and the ring slot identical to fdl_fused's
            on the frame [hist || u]; its launch shape: all 64 clusters
            of 2 blocks resident), dynamics y >= 110 dB with window,
            envelope and peak to rtol 1e-5 and hold exact; sliding RMS at
            T=16384 and T=300 (T < N): level >= 110 dB and >= 140 dB
            from the float64 ideal, window exact, and its launch shape
            (time tiles, blocks resident by the occupancy calculator);
            peak envelope in step's configuration (the chain's
            compressor, hold 0, from env_init) and with a hold of 24
            samples, each at T=16384 and 16383, release threshold on and
            off: envelope and state exact, the SASS stall cycles per
            step of its two batch bodies (cuobjdump) and the SM clock
            (the spin kernel's cycles over its time); gate envelope with
            a hold of 24 samples and with the gate's default hold of 0,
            each at T=16384 and 16383 from both curves: envelope, curve
            track (>= 64 switches), curve and state exact, and the SASS
            of its chain's batches (no more float compares or
            shared-memory stores than the peak envelope's, none of the
            curve switch's), and peak_envelope without a threshold timed
            on the gate's input (the same chain without the curve track).
            Each plain envelope is a per-sample Python loop, run (and
            timed) once.
4. main   — FilterConvChain(48000, 64, rank=14, ir_seconds=1.0): build ->
            init_ring_state -> 24 blocks of step_ring + quantize_i16
            with the input rotated every block.  The launch counters are
            zeroed just before and read just after; each must have
            advanced by at least the number of blocks.  Output finite and
            of the right shape; the chain on two fresh blocks >= 85 dB
            from the float64 ideal (benchmarks/chain_golden64.py); one
            block re-run with TF32 switched on gives identical output.
5. step   — the same chain: init_state -> 8 calls of step on [64, 2 x
            8192] inputs rotated every call; the counters of
            rfft_packed, rfft_packed_zeropad, irfft_packed, sliding_rms
            and peak_envelope, zeroed just before, must each have
            advanced by at least the number of calls.  Output finite; two
            fresh calls >= 85 dB from the float64 ideal; one call re-run
            with TF32 on gives identical output.
6. bulk   — build_bulk(65536) -> init_bulk_state -> 2 super-blocks of
            bulk_step; the first >= 85 dB from the float64 ideal over its
            8 blocks; its SNR against step on the same input is printed.
7. units  — [64, 8192] detector signals through Sidechain (each mode) ->
            Compressor (3 modes), Expander (2 modes) and Gate (a hold of
            24 samples, and its default of 0), on the card and on the
            CPU: envelope and gain >= 110 dB between the two; the
            gate_envelope counter, zeroed just before, advances.
8. ring   — the standalone ring convolver over the chain's 1 s IR at full
            width (C=64, B=8192, P=6): fdl_fused against its plain
            version (y and the written slot, unpacked, >= 95 dB; its
            launch shape: all 64 clusters of 2 blocks resident); 24
            blocks of fdl_ring_step on a packed ring, input rotated, the
            fdl_fused counter zeroed just before and read just after (>=
            24), 4 channels >= 85 dB from a float64 fftconvolve, and its
            ms per block; ring_mac
            against its plain version on natural (F = 8193) and packed
            rows (acc >= 110 dB, ring identical); the three-kernel step
            rfft_packed -> ring_mac -> irfft_packed against fdl_fused (y
            >= 95 dB; its three counters, zeroed just before, advance);
            Convolver(ir, rank=12) on [64, 8 x 2048] >= 85 dB from the
            float64 golden.
9. sampler — the device mixdown at 4096 voices, block 1024 (one 1 s noise
            sample; even voices DIRECT-loop 1000-40000; delays (v*7) %
            4800; volume 0.1): 64 blocks of mix_block_dma, the
            batched_slice counter zeroed just before (>= 128), identical
            to mix_block with identical playheads; the first 8 blocks >=
            85 dB from the host SamplePlayer playing the same voices;
            batched_slice against its plain version, exact, starts at 0,
            1023, 1024, the clamp limit and beyond, and its launch shape
            (one warp per window; blocks resident by the occupancy
            calculator); one block with TF32 on identical; the card's
            voice-samples/s.
10. timing — CUDA events behind a spin kernel: step_ring ms per block,
            step ms per call and per block, bulk_step ms per super-block;
            each kernel against its plain version at the same shapes, its
            bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s
            FP32, whichever is larger) and, where one PyTorch call
            computes the same function, that call's time; row #1 also
            times the inverse (irfft_packed, last half) beside
            torch.fft.irfft, row #3 gives its cycles per sample at the
            boost clock, row #5 is timed beside avg_pool1d over the
            prebuilt squared frame (the sliding mean alone), rows #6
            and #7 give their cycles per step without and with a hold
            of 24.  Host clock:
            the time to enqueue a block of step_ring, and the delivered
            samples/s over 32 blocks ending in a sync.

The last three lines of standard output are the kernel table (JSON,
all nine kernels), the card's name and power limit, and the contract
line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from benchmarks.chain_golden64 import golden_chain_f64  # noqa: E402
from lsp_dsp_units_tpu_torch import pipeline  # noqa: E402
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (  # noqa: E402
    Compressor, CompressorMode)
from lsp_dsp_units_tpu_torch.models.dynamics.expander import (  # noqa: E402
    Expander, ExpanderMode)
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate  # noqa: E402
from lsp_dsp_units_tpu_torch.models.sampling import (  # noqa: E402
    LoopMode, PlaySettings, Sample, SamplePlayer, device_mix as dm)
from lsp_dsp_units_tpu_torch.models.util.convolver import (  # noqa: E402
    Convolver)
from lsp_dsp_units_tpu_torch.models.util.sidechain import (  # noqa: E402
    Sidechain, SidechainMode)
from lsp_dsp_units_tpu_torch.ops import _build  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import env_units as eu  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import fftconv  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import slicedma  # noqa: E402
from lsp_dsp_units_tpu_torch.ops.env import (  # noqa: E402
    chain_dyn, chain_dyn_plain)
from lsp_dsp_units_tpu_torch.ops.fdl_fused import (  # noqa: E402
    eqfdl_fused, eqfdl_fused_plain, eqfdl_launch_shape, fdl_fused,
    fdl_fused_plain, fdl_launch_shape)
from lsp_dsp_units_tpu_torch.ops.ring_mac import (  # noqa: E402
    ring_mac, ring_mac_plain)
from lsp_dsp_units_tpu_torch.utils.delivery import (  # noqa: E402
    quantize_i16, tpdf_i16_table)

C, RANK, SR, IR_S = 64, 14, 48000, 1.0
B = 1 << (RANK - 1)
N = 2 * B
FFT_DB, LIN_DB, DYN_DB, CHAIN_DB = 95.0, 95.0, 110.0, 85.0
RMS_F64_DB = 140.0            # sliding RMS level from the float64 ideal
BLOCKS = 24
CALLS = 8                     # step calls of STEP_BLOCKS blocks each
STEP_BLOCKS = 2
T_SUPER = 65536               # bulk_step super-block (8 blocks)
T_UNITS = 8192
SPIN_CYCLES = 200_000_000     # ~0.1 s at the H100's 1.98 GHz SM clock
MAC_DB = 110.0
RING_BLOCKS = 24              # fdl_ring_step blocks on the ring path
GOLD_CH = 4                   # channels held against the float64 golden
CONV_RANK, CONV_BLOCKS = 12, 8
VOICES, VBLOCK, VBLOCKS = 4096, 1024, 64   # the sampler's configuration
HOST_BLOCKS = 8               # sampler blocks held against the host player

# the card's limits for the bound of each kernel (NVIDIA H100 SXM data
# sheet, at 700 W): HBM rate, FP32 rate outside the tensor cores, and the
# boost clock for the serial envelopes' dependent-chain bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SM_HZ = 1.98e9
F32 = 4


def fft_flops(n: int) -> float:
    """Operations of one real N-point FFT: the usual 2.5 N log2 N."""
    return 2.5 * n * np.log2(n)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of the bytes it must move (each input read once, each output written
    once) over the HBM rate and its operations over the FP32 rate, in ms,
    and which of the two it is."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations")


def chain_ms(t: int) -> float:
    """Dependent-chain bound of a serial envelope over t samples: at least
    one FMA (4 cycles) per sample, at the boost clock."""
    return t * 4 / SM_HZ * 1e3


# the nine TPU kernels of the JAX package and their ports: result key,
# name, CUDA source, the JAX function that reaches pl.pallas_call
KERNELS = (
    ("fft", "rfft_packed_zeropad", "fft_packed.cu", "pallas_fft.py:549"),
    ("eqfdl", "eqfdl_fused", "fdl_fused.cu", "pallas_fdl_fused.py:222"),
    ("dyn", "chain_dyn", "env.cu", "pallas_env.py:523"),
    ("fdl", "fdl_fused", "fdl_fused.cu", "pallas_fdl_fused.py:80"),
    ("rms", "sliding_rms", "env_units.cu", "pallas_env.py:294"),
    ("peak", "peak_envelope", "env_units.cu", "pallas_env.py:334"),
    ("gate", "gate_envelope", "env_units.cu", "pallas_env.py:183"),
    ("slice", "batched_slice", "slicedma.cu", "slicedma.py:77"),
    ("mac", "ring_mac", "ring_mac.cu", "pallas_fdl.py:85"),
)


# fields beyond the contract's in a kernel's record of the kernels line
EXTRA_KEYS = {
    "fft": ("inverse_ms", "inverse_plain_ms", "inverse_library_ms",
            "inverse_bound_ms", "blocks_resident"),
    "rms": ("blocks_resident", "db_vs_float64"),
    "slice": ("blocks_resident",),
    "eqfdl": ("blocks_resident",),
    "fdl": ("blocks_resident",),
    "gate": ("chain_ms", "cycles_per_step", "hold0_ms",
             "hold0_cycles_per_step", "peak_form_ms", "hold0_peak_form_ms"),
    "dyn": ("chain_ms", "cycles_per_sample"),
    "peak": ("chain_ms", "cycles_per_step", "hold24_ms",
             "hold24_cycles_per_step", "sass_free_cycles_per_step",
             "sass_ref_cycles_per_step", "sm_clock_hz"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def snr_db(ref: torch.Tensor, out: torch.Tensor) -> float:
    ref = ref.double()
    err = out.double() - ref
    return float(10 * torch.log10(torch.clamp(torch.sum(ref * ref), min=1e-30)
                                  / torch.clamp(torch.sum(err * err),
                                                min=1e-30)))


def max_abs(ref: torch.Tensor, out: torch.Tensor) -> float:
    return float(torch.max(torch.abs(out.double() - ref.double())))


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call: CUDA events around ``reps`` calls,
    after ``warmup`` calls.  A spin kernel holds the stream while the
    host enqueues the calls, so the card runs them back to back and the
    events time the card, not the host's launch cost.  Where the host
    needs longer than the spin to enqueue them (the plain versions'
    Python loops), its pace shows through."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def randn(gen, *shape, scale=1.0, dev="cuda"):
    return (torch.randn(*shape, generator=gen) * scale).to(dev)


def parity_fft(dev, res):
    gen = torch.Generator().manual_seed(1)
    x = randn(gen, C, N, dev=dev)
    xh = x[:, :B].contiguous()
    kz = fp.rfft_packed_zeropad(xh)
    pz = fp.rfft_packed_zeropad_plain(xh)
    kf = fp.rfft_packed(x)
    pf = fp.rfft_packed_plain(x)
    dbs = {"zeropad": min(snr_db(pz[0], kz[0]), snr_db(pz[1], kz[1])),
           "full": min(snr_db(pf[0], kf[0]), snr_db(pf[1], kf[1]))}
    for half in (False, "first", "last"):
        y = fp.irfft_packed(pf[0], pf[1], N, half)
        dbs[f"inverse_{half}"] = snr_db(
            fp.irfft_packed_plain(pf[0], pf[1], N, half), y)
    torch.cuda.synchronize()
    print(f"parity fft: " + ", ".join(f"{k} {v:.1f} dB"
                                      for k, v in dbs.items()))
    for k, v in dbs.items():
        check(v >= FFT_DB, f"fft {k} {v:.1f} dB < {FFT_DB}")
    res["fft"] = dict(db=dbs, max_abs_err=max(max_abs(pz[0], kz[0]),
                                              max_abs(pz[1], kz[1])))
    res["fft"]["ms"] = time_ms(lambda: fp.rfft_packed_zeropad(xh), 50)
    res["fft"]["plain_ms"] = time_ms(
        lambda: fp.rfft_packed_zeropad_plain(xh), 50)
    res["fft"]["library_ms"] = time_ms(lambda: torch.fft.rfft(xh, n=N), 50)
    res["fft"].update(bound(F32 * 3 * C * B, C * fft_flops(N)))
    # the inverse as the convolver uses it: packed [64, 8192] x 2 -> the
    # last half [64, 8192]; torch.fft.irfft of the natural spectrum
    # (whole frame) beside it
    spec = torch.fft.rfft(x)
    inv = bound(F32 * 3 * C * B, C * fft_flops(N))
    res["fft"].update(
        inverse_ms=time_ms(lambda: fp.irfft_packed(*pf, N, "last"), 50),
        inverse_plain_ms=time_ms(
            lambda: fp.irfft_packed_plain(*pf, N, "last"), 50),
        inverse_library_ms=time_ms(lambda: torch.fft.irfft(spec, n=N), 50),
        inverse_bound_ms=inv["bound_ms"])
    shape = fp.launch_shape(N)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = C * shape["blocks_per_row"]
    resident = min(blocks, shape["blocks_per_sm"] * sms)
    res["fft"].update(launch_shape=shape, blocks_resident=resident)
    print(f"fft launch: {blocks} blocks of {shape['threads']} threads, "
          f"{shape['smem_bytes']} B shared memory each, "
          f"{shape['blocks_per_sm']} per SM x {sms} SMs: {resident} resident")
    check(resident >= blocks, f"only {resident} of {blocks} FFT blocks "
                              f"resident")


def clusters_resident(name: str, shape: dict):
    """Print a cluster kernel's launch shape for the C channels and check
    that all its blocks are resident at once; returns the shape and the
    resident blocks."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = C * shape["blocks_per_channel"]
    resident = min(blocks, shape["blocks_per_sm"] * sms,
                   shape["clusters_resident"] * shape["blocks_per_channel"])
    print(f"{name} launch: {blocks} blocks in clusters of "
          f"{shape['blocks_per_channel']}, {shape['threads']} threads and "
          f"{shape['smem_bytes']} B shared memory each, "
          f"{shape['blocks_per_sm']} per SM x {sms} SMs, "
          f"{shape['clusters_resident']} clusters at once: {resident} "
          f"resident")
    check(shape["blocks_per_channel"] == 2 and resident >= blocks,
          f"only {resident} of {blocks} {name} blocks resident")
    return shape, resident


def parity_eqfdl(chain, params, dev, res):
    gen = torch.Generator().manual_seed(2)
    eqp = params.eq_block
    k2 = eqp.m_mat.shape[0]
    p_n = params.h_re.shape[0]
    ring_k = fftconv.init_ring_fdl(params.h_spectra, (C,), packed=True,
                                   device=dev)
    ring_p = fftconv.init_ring_fdl(params.h_spectra, (C,), packed=True,
                                   device=dev)
    sv_k = sv_p = torch.zeros(C, k2, device=dev)
    worst = dict(y=1e9, u=1e9, sv=1e9, ring=1e9)
    err = 0.0
    same = True
    for k in range(p_n + 2):
        x = randn(gen, C, B, scale=0.25, dev=dev)
        xs = fp.rfft_packed_zeropad_plain(x)
        w = (ring_k.pos + 1) % p_n
        common = (params.h_re, params.h_im, params.heq_re, params.heq_im,
                  *xs, x)
        mats = (eqp.g_t, eqp.m_mat, eqp.w_mat)
        ring_f = (ring_k.spec_re.clone(), ring_k.spec_im.clone())
        yk, uk, sv_k = eqfdl_fused(ring_k.spec_re, ring_k.spec_im, *common,
                                   sv_k, *mats, ring_k.history, w)
        # the cluster schedule's frame, MAC and inverse are fdl_fused's
        # one-block ones: same y and ring slot, bit for bit
        yf = fdl_fused(*ring_f, params.h_re, params.h_im, ring_k.history,
                       uk, w)
        same = (same and torch.equal(yf, yk)
                and torch.equal(ring_f[0], ring_k.spec_re)
                and torch.equal(ring_f[1], ring_k.spec_im))
        yp, up, sv_p = eqfdl_fused_plain(ring_p.spec_re, ring_p.spec_im,
                                         *common, sv_p, *mats,
                                         ring_p.history, w)
        ring_k = ring_k._replace(history=uk, pos=w)
        ring_p = ring_p._replace(history=up, pos=w)
        worst["y"] = min(worst["y"], snr_db(yp, yk))
        worst["u"] = min(worst["u"], snr_db(up, uk))
        worst["sv"] = min(worst["sv"], snr_db(sv_p, sv_k))
        worst["ring"] = min(worst["ring"],
                            snr_db(ring_p.spec_re[w], ring_k.spec_re[w]),
                            snr_db(ring_p.spec_im[w], ring_k.spec_im[w]))
        err = max(err, max_abs(yp, yk), max_abs(up, uk))
    torch.cuda.synchronize()
    print("parity eqfdl (worst of %d blocks): " % (p_n + 2)
          + ", ".join(f"{k} {v:.1f} dB" for k, v in worst.items())
          + f"; y and ring slot identical to fdl_fused on [hist || u] = "
          f"{same}")
    for k, v in worst.items():
        check(v >= LIN_DB, f"eqfdl {k} {v:.1f} dB < {LIN_DB}")
    check(same, "eqfdl y or ring slot differs from fdl_fused's")
    shape, resident = clusters_resident("eqfdl", eqfdl_launch_shape(N, C))
    w = (ring_k.pos + 1) % p_n
    res["eqfdl"] = dict(db=worst, max_abs_err=err, launch_shape=shape,
                        blocks_resident=resident)
    res["eqfdl"]["ms"] = time_ms(lambda: eqfdl_fused(
        ring_k.spec_re, ring_k.spec_im, *common, sv_k, *mats,
        ring_k.history, w), 50)
    res["eqfdl"]["plain_ms"] = time_ms(lambda: eqfdl_fused_plain(
        ring_p.spec_re, ring_p.spec_im, *common, sv_p, *mats,
        ring_p.history, w), 20)
    plane = C * B * F32
    res["eqfdl"].update(library_ms=None, **bound(
        # ring: P-1 slots read, one written; IR, EQ spectrum, xs, x, hist,
        # the EQ matrices and state; y and u
        2 * plane * p_n + F32 * (2 * p_n * B + 2 * B + 2 * k2 * B
                                 + k2 * k2 + 2 * C * k2) + 6 * plane,
        C * (3 * fft_flops(N) + 8 * p_n * B + 6 * B + 4 * k2 * B
             + 2 * k2 * k2)))


def parity_dyn(chain, params, dev, res):
    gen = torch.Generator().manual_seed(3)
    n = chain.sidechain.reactivity
    cp = params.comp
    args = (n, chain.sidechain.gain, cp.tau_attack, cp.tau_release,
            cp.release_thresh, cp.hold, cp.knees)
    wk = wp = torch.zeros(C, n, device=dev)
    ek = ep = dyn.env_init((C,), dev)
    worst, err = 1e9, 0.0
    for k in range(3):
        x = randn(gen, C, B, scale=0.25 * (k + 1), dev=dev)
        wk, ek, yk = chain_dyn(wk, ek, x, *args)
        wp, ep, yp = chain_dyn_plain(wp, ep, x, *args)
        worst = min(worst, snr_db(yp, yk))
        err = max(err, max_abs(yp, yk))
        torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(ek.envelope, ep.envelope, rtol=1e-5,
                                   atol=0.0)
        torch.testing.assert_close(ek.peak, ep.peak, rtol=1e-5, atol=0.0)
        check(torch.equal(ek.hold, ep.hold), "dyn hold counts differ")
    torch.cuda.synchronize()
    print(f"parity chain_dyn (worst of 3 blocks): y {worst:.1f} dB; "
          f"window/envelope/peak within rtol 1e-5, hold exact")
    check(worst >= DYN_DB, f"chain_dyn {worst:.1f} dB < {DYN_DB}")
    res["dyn"] = dict(db=worst, max_abs_err=err)
    res["dyn"]["ms"] = time_ms(lambda: chain_dyn(wk, ek, x, *args), 20)
    res["dyn"]["plain_ms"] = time_ms(lambda: chain_dyn_plain(
        wp, ep, x, *args), 2, warmup=1)
    res["dyn"].update(library_ms=None, chain_ms=chain_ms(B), **bound(
        F32 * (2 * C * B + 2 * C * n + 6 * C), 30 * C * B))
    res["dyn"]["cycles_per_sample"] = res["dyn"]["ms"] * 1e-3 * SM_HZ / B
    print(f"chain_dyn: {res['dyn']['ms']:.4f} ms = "
          f"{res['dyn']['cycles_per_sample']:.2f} cycles per sample at "
          f"{SM_HZ / 1e9:.2f} GHz")


def clone_state(st):
    f = st.fdl
    return st._replace(
        eq=st.eq.clone(),
        fdl=f._replace(spec_re=f.spec_re.clone(), spec_im=f.spec_im.clone(),
                       history=f.history.clone()),
        sc=st.sc._replace(window=st.sc.window.clone()),
        env=dyn.EnvState(*(t.clone() for t in st.env)))


def counters():
    return dict(fft=fp.rfft_packed_zeropad.launches,
                eqfdl=eqfdl_fused.launches, dyn=chain_dyn.launches)


def reset_counters():
    fp.rfft_packed_zeropad.launches = 0
    eqfdl_fused.launches = 0
    chain_dyn.launches = 0


def main_path(chain, params, dev, blocks, res):
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy((rng.standard_normal((C, B)) * 0.25).astype(
        np.float32)).to(dev)
    table = tpdf_i16_table(C, B, device=dev)
    st = chain.init_ring_state(params)
    torch.cuda.synchronize()
    reset_counters()
    outs = []
    for k in range(blocks):
        xk = torch.roll(x0, shifts=k, dims=-1)
        st, y = chain.step_ring(params, st, xk)
        outs.append(quantize_i16(y, table, k))
    torch.cuda.synchronize()
    launched = counters()
    print(f"main path: {blocks} blocks of step_ring + quantize_i16; "
          f"launches {launched}")
    for name, cnt in launched.items():
        check(cnt >= blocks, f"{name} launched {cnt} < {blocks} times")
    check(all(o.shape == (C, B) and o.dtype == torch.int16 for o in outs),
          "int16 output shape")
    check(bool(torch.isfinite(y).all()), "non-finite chain output")
    check(all(bool(torch.isfinite(s).all()) for s in
              (st.eq, st.fdl.spec_re, st.fdl.spec_im, st.env.envelope)),
          "non-finite chain state")
    res["launches"] = launched

    # TF32 on: the step has no library matmul, so the output is identical
    xk = torch.roll(x0, shifts=blocks, dims=-1)
    _, y_ref = chain.step_ring(params, clone_state(st), xk)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    _, y_tf32 = chain.step_ring(params, clone_state(st), xk)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    same = bool(torch.equal(y_ref, y_tf32))
    print(f"TF32 on: output identical = {same}")
    check(same, "output changed with TF32 switched on")

    # two fresh blocks against the float64 ideal
    xs = [(rng.standard_normal((C, B)) * 0.25).astype(np.float32)
          for _ in range(2)]
    st = chain.init_ring_state(params)
    ys = []
    for x in xs:
        st, y = chain.step_ring(params, st, torch.from_numpy(x).to(dev))
        ys.append(y.cpu())
    gold = golden_chain_f64(chain, params, xs)
    dbs = [snr_db(torch.from_numpy(g), y) for g, y in zip(gold, ys)]
    print("chain vs float64 ideal: "
          + ", ".join(f"block {i} {v:.2f} dB" for i, v in enumerate(dbs)))
    check(min(dbs) >= CHAIN_DB, f"chain {min(dbs):.2f} dB < {CHAIN_DB}")
    res["chain_vs_golden_db"] = dbs

    # timing: step_ring alone, then with the int16 delivery
    st = chain.init_ring_state(params)
    xr = [torch.roll(x0, shifts=k, dims=-1) for k in range(16)]
    state = [st]
    i = [0]

    def one(deliver):
        st2, y2 = chain.step_ring(params, state[0], xr[i[0] % 16])
        state[0] = st2
        if deliver:
            quantize_i16(y2, table, i[0])
        i[0] += 1

    ms = time_ms(lambda: one(False), 64, warmup=8)
    ms_q = time_ms(lambda: one(True), 64, warmup=4)
    # host clock: the enqueue alone (32 blocks x 7 launches stay within
    # the launch queue, so the host never waits on the card), then with
    # the final sync; enqueue >= event time means the host is the bound
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(32):
        one(True)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 32
    enqueue_ms = (t1 - t0) * 1e3 / 32
    res.update(step_ring_ms=ms, step_ring_quantize_ms=ms_q,
               samples_per_s=C * B / (host_ms * 1e-3), host_ms=host_ms,
               host_enqueue_ms=enqueue_ms)
    print(f"step_ring: {ms:.4f} ms/block on the card (CUDA events, 64 "
          f"blocks), {ms_q:.4f} with quantize_i16; host clock "
          f"{enqueue_ms:.4f} ms/block to enqueue, {host_ms:.4f} with sync "
          f"= {res['samples_per_s'] / 1e6:.2f} M samples/s delivered")


def time_once_ms(fn):
    """Device time of ONE call, by CUDA events around it, and its result:
    for the plain envelopes, per-sample Python loops whose host launches
    pace them, too slow to repeat."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def swell_levels(gen, c, t, dev, peak=0.6):
    """Detector levels: |noise| under a half-sine swell, so every knee
    and branch of the envelopes runs."""
    swell = torch.sin(torch.linspace(0.0, torch.pi, t))
    return (torch.randn(c, t, generator=gen).abs() * peak * swell).to(dev)


def rms_ideal(win, x, n):
    """Float64 sliding RMS of the same float32 squares."""
    sq = (x.abs() * x.abs()).double()
    cs = torch.cumsum(torch.cat([win.double(), sq], dim=-1), dim=-1)
    cs = torch.nn.functional.pad(cs, (1, 0))
    t = x.shape[-1]
    return torch.sqrt(torch.clamp((cs[:, n + 1:n + 1 + t] - cs[:, 1:1 + t])
                                  / n, min=0.0))


def sass_batches(lib: str, kernel: str) -> list:
    """The batch bodies of an envelope kernel in its SASS (cuobjdump
    beside nvcc): the basic blocks that hold a batch's 2 x 32 FFMAs, each
    as a dict: its FMNMX, FSETP (float compares) and STS (shared-memory
    stores) counts and its static stall cycles per step.  An
    instruction's stall count is bits 41-44 of its second 64-bit word;
    the count leaves out waits on variable-latency results."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", _build.build(lib)],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump: {out.stderr.strip()}")
    body = [f for f in out.stdout.split("Function : ")
            if kernel in f.split("\n", 1)[0]]
    check(len(body) == 1, f"{kernel}: {len(body)} functions in the SASS")
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?);\s*/\* 0x[0-9a-f]{16} \*/")
    hi = re.compile(r"^\s*/\* (0x[0-9a-f]{16}) \*/\s*$")
    blocks, cur, op = [], [], None
    for line in body[0].splitlines():
        m = ins.search(line)
        if m:
            op = m.group(1).strip()
            continue
        m = hi.match(line)
        if m and op is not None:
            cur.append((op, (int(m.group(1), 16) >> 41) & 0xF))
            if re.search(r"\b(BRA|EXIT|RET)\b", op):
                blocks.append(cur)
                cur = []
            op = None
        elif line.strip().startswith(".L"):
            blocks.append(cur)
            cur = []
    blocks.append(cur)

    def count(blk, name):
        return sum(1 for o, _ in blk if re.search(rf"\b{name}\b", o))

    return [dict(fmnmx=count(blk, "FMNMX"), fsetp=count(blk, "FSETP"),
                 sts=count(blk, "STS"), stalls=sum(s for _, s in blk) / 32)
            for blk in blocks if count(blk, "FFMA") == 64]


def free_batch(kernel: str, what: str) -> dict:
    """The predicate-free batch body of an envelope kernel that allows
    the free step: the one with a batch's FMNMXs."""
    free = [b for b in sass_batches("env_units", kernel) if b["fmnmx"] >= 32]
    check(len(free) == 1, f"SASS of {what}: {len(free)} free batch bodies")
    return free[0]


def reference_only(kernel: str, what: str) -> dict:
    """The one batch body of an envelope kernel without the free step."""
    ref = sass_batches("env_units", kernel)
    check(len(ref) == 1 and ref[0]["fmnmx"] == 0,
          f"SASS of {what}: {len(ref)} batch bodies")
    return ref[0]


def sass_peak_stalls() -> dict:
    """Static stall cycles per step of peak_envelope's batches with a
    release threshold: the predicate-free batch of the kernel that
    allows it, the reference batch of the one that does not."""
    free = free_batch("envelope_kernelILb1ELb0ELb1E", "peak_envelope, free")
    ref = reference_only("envelope_kernelILb1ELb0ELb0E", "peak_envelope")
    return dict(sass_free_cycles_per_step=free["stalls"],
                sass_ref_cycles_per_step=ref["stalls"])


def sass_gate_chain() -> dict:
    """The gate's chain in the SASS: its batch bodies hold no more float
    compares and shared-memory stores than the peak envelope's without a
    release threshold (the curve switch's two compares a step and the
    curve track's stores are gone from the chain thread's loop), and the
    free batch no float compare at all."""
    peak_free = free_batch("envelope_kernelILb0ELb0ELb1E",
                           "peak_envelope, no threshold, free")
    peak_ref = reference_only("envelope_kernelILb0ELb0ELb0E",
                              "peak_envelope, no threshold")
    free = free_batch("envelope_kernelILb0ELb1ELb1E", "gate_envelope, free")
    ref = reference_only("envelope_kernelILb0ELb1ELb0E", "gate_envelope")
    for name, got, want in (("reference", ref, peak_ref),
                            ("free", free, peak_free)):
        check(got["fsetp"] <= want["fsetp"] and got["sts"] <= want["sts"],
              f"gate_envelope's {name} batch: {got['fsetp']} FSETP and "
              f"{got['sts']} STS, peak_envelope's {want['fsetp']} and "
              f"{want['sts']}")
    check(free["fsetp"] == 0, f"gate free batch: {free['fsetp']} FSETP")
    return dict(sass_ref=ref, sass_free=free, sass_peak_ref=peak_ref)


def sm_clock_hz() -> float:
    """The SM clock now: the spin kernel's SPIN_CYCLES clock64 cycles
    over its CUDA-event time."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    stop.record()
    stop.synchronize()
    return SPIN_CYCLES / (start.elapsed_time(stop) * 1e-3)


def parity_env_units(chain, params, dev, res):
    """Kernels #5-#7 against their plain versions at the step's shapes."""
    gen = torch.Generator().manual_seed(5)
    n = chain.sidechain.reactivity
    cp = params.comp
    t = STEP_BLOCKS * B
    dbs, ideal, err = {}, {}, 0.0
    for tt in (t, 300):
        win = randn(gen, C, n, scale=0.25, dev=dev) ** 2
        x = randn(gen, C, tt, scale=0.25, dev=dev)
        wk, lk = eu.sliding_rms(win, x, n, 1.0)
        wp, lp = eu.sliding_rms_plain(win, x, n, 1.0)
        check(torch.equal(wk, wp), f"sliding_rms window differs at T={tt}")
        dbs[tt] = snr_db(lp, lk)
        ideal[tt] = dict(kernel=snr_db(rms_ideal(win, x, n), lk),
                         plain=snr_db(rms_ideal(win, x, n), lp))
        err = max(err, max_abs(lp, lk))
        if tt == t:
            timed = (win, x)
    torch.cuda.synchronize()
    print("parity sliding_rms: " + ", ".join(
        f"T={k} level {v:.1f} dB (vs float64: kernel {ideal[k]['kernel']:.1f}"
        f", plain {ideal[k]['plain']:.1f})" for k, v in dbs.items())
        + "; window exact")
    for k, v in dbs.items():
        check(v >= DYN_DB, f"sliding_rms T={k} {v:.1f} dB < {DYN_DB}")
        check(ideal[k]["kernel"] >= RMS_F64_DB,
              f"sliding_rms T={k} {ideal[k]['kernel']:.1f} dB from the "
              f"float64 ideal < {RMS_F64_DB}")
    res["rms"] = dict(db=dbs, db_vs_float64=ideal, max_abs_err=err)
    res["rms"]["ms"] = time_ms(lambda: eu.sliding_rms(*timed, n, 1.0), 50)
    res["rms"]["plain_ms"] = time_ms(
        lambda: eu.sliding_rms_plain(*timed, n, 1.0), 20)
    # the library's sliding mean over the prebuilt squared frame (no
    # squaring, no sqrt): a yardstick, not the same function
    frame = torch.cat([timed[0], timed[1] * timed[1]], dim=-1)[:, None]
    res["rms"].update(library_ms=time_ms(
        lambda: torch.nn.functional.avg_pool1d(frame, n, stride=1), 50),
        **bound(F32 * (2 * C * t + 2 * C * n), 4 * C * t))
    shape = eu.rms_launch_shape(C, t)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = min(shape["blocks"], shape["blocks_per_sm"] * sms)
    res["rms"].update(launch_shape=shape, blocks_resident=resident)
    print(f"sliding_rms launch at [{C}, {t}]: {shape['blocks']} blocks "
          f"(channel x time tile) of {shape['threads']} threads, "
          f"{shape['blocks_per_sm']} per SM x {sms} SMs: {resident} "
          f"resident; {res['rms']['ms']:.4f} ms against avg_pool1d's "
          f"{res['rms']['library_ms']:.4f} over the squared frame "
          f"{tuple(frame.shape)} (kernel {n}, stride 1): "
          + ("faster" if res["rms"]["ms"] < res["rms"]["library_ms"]
             else "slower"))

    # peak_envelope as step runs it (the chain's compressor: its taus and
    # threshold, its hold of 0 samples, from env_init), and a hold of 24
    # samples from a random state; each at T and T - 1, threshold on and
    # off, against the plain version bit for bit
    check(cp.hold == 0, f"the chain's compressor holds {cp.hold} samples")
    x = swell_levels(gen, C, t, dev)
    cases = dict(
        step=(dyn.env_init((C,), dev), cp.hold),
        hold24=(dyn.EnvState(torch.rand(C, generator=gen).to(dev),
                             torch.rand(C, generator=gen).to(dev),
                             torch.randint(0, 25, (C,), generator=gen,
                                           dtype=torch.int32).to(dev)), 24))
    res["peak"] = r = dict(library_ms=None, chain_ms=chain_ms(t), **bound(
        F32 * (2 * C * t + 6 * C), 6 * C * t))
    err = 0.0
    for name, (st0, hold) in cases.items():
        for tt in (t, t - 1):
            xx = x[:, :tt].contiguous()
            for rt in (None, cp.release_thresh):
                args = (xx, cp.tau_attack, cp.tau_release, hold, rt)
                sk, ek = eu.peak_envelope(st0, *args)
                plain_ms, (sp, ep) = time_once_ms(
                    lambda: eu.peak_envelope_plain(st0, *args))
                what = f"peak_envelope {name} T={tt} rt={rt}"
                check(torch.equal(ek, ep), what)
                check(all(torch.equal(a, b) for a, b in zip(sk, sp)),
                      f"{what}: state")
                err = max(err, max_abs(ep, ek))
                if name == "step" and tt == t and rt is not None:
                    r["plain_ms"] = plain_ms
        key = "" if name == "step" else f"{name}_"
        r[f"{key}ms"] = time_ms(lambda: eu.peak_envelope(
            st0, x, cp.tau_attack, cp.tau_release, hold, cp.release_thresh),
            20)
        r[f"{key}cycles_per_step"] = r[f"{key}ms"] * 1e-3 * SM_HZ / t
    r["max_abs_err"] = err
    r["sm_clock_hz"] = sm_clock_hz()
    r.update(sass_peak_stalls())
    print(f"parity peak_envelope: step's configuration (hold 0, env_init) "
          f"and hold 24, T={t} and {t - 1}, release threshold on and off: "
          f"envelope, peak and hold exact")
    print(f"peak_envelope [{C}, {t}]: step's configuration {r['ms']:.4f} ms "
          f"= {r['cycles_per_step']:.2f} cycles per step; hold 24 "
          f"{r['hold24_ms']:.4f} ms = {r['hold24_cycles_per_step']:.2f}; at "
          f"{SM_HZ / 1e9:.2f} GHz (the SM clock, measured by the spin "
          f"kernel: {r['sm_clock_hz'] / 1e9:.3f} GHz).  SASS stall cycles "
          f"per step of a batch: "
          f"free step {r['sass_free_cycles_per_step']:.2f}, reference step "
          f"{r['sass_ref_cycles_per_step']:.2f}")

    # gate_envelope with a hold of 24 samples (the reference step on the
    # chain) and with the gate's default hold of 0 (the free step), each
    # at T and T - 1 from both curves, against the plain version bit for
    # bit: envelope, curve track, curve and state
    xg = swell_levels(gen, C, t, dev)
    xg[:, t // 2:] *= 0.02                      # near silence: release
    cur0 = (torch.arange(C, dtype=torch.int32) % 2).to(dev)
    env0 = dyn.env_init((C,), dev)
    r = res["gate"] = dict(library_ms=None, chain_ms=chain_ms(t), **bound(
        F32 * (3 * C * t + 8 * C), 8 * C * t))
    err = 0.0
    for key, hold_ms in (("", 0.5), ("hold0_", 0.0)):
        gp = Gate(SR, threshold=0.2, zone=0.5, hyst_threshold=0.15,
                  attack_ms=2.0, release_ms=20.0, hold_ms=hold_ms).build()
        check(gp.hold == (24 if hold_ms else 0), f"gate hold {gp.hold}")
        for tt in (t, t - 1):
            gargs = (xg[:, :tt].contiguous(), gp.tau_attack, gp.tau_release,
                     gp.hold, gp.knees[0].end, gp.knees[1].start)
            sk, ck, ek, cvk = eu.gate_envelope(env0, cur0, *gargs)
            plain_ms, (sp, cp_, ep, cvp) = time_once_ms(
                lambda: eu.gate_envelope_plain(env0, cur0, *gargs))
            what = f"gate_envelope hold {gp.hold} T={tt}"
            check(torch.equal(ek, ep) and torch.equal(cvk, cvp)
                  and torch.equal(ck, cp_), f"{what} differs")
            check(all(torch.equal(a, b) for a, b in zip(sk, sp)),
                  f"{what}: state differs")
            switches = int((cvk[:, 1:] != cvk[:, :-1]).sum())
            check(switches >= C, f"{what}: curve track switched only "
                                 f"{switches} times")
            err = max(err, max_abs(ep, ek))
            if tt == t:
                r[f"{key}switches"] = switches
                if not key:
                    r["plain_ms"] = plain_ms
        gargs = (xg,) + gargs[1:]
        r[f"{key}ms"] = time_ms(lambda: eu.gate_envelope(env0, cur0, *gargs),
                                20)
        r[f"{key}cycles_per_step"] = r[f"{key}ms"] * 1e-3 * SM_HZ / t
        # the same chain without the curve track: peak_envelope without
        # a threshold on the same input
        r[f"{key}peak_form_ms"] = time_ms(lambda: eu.peak_envelope(
            env0, xg, gp.tau_attack, gp.tau_release, gp.hold, None), 20)
    r["max_abs_err"] = err
    r.update(sass_gate_chain())
    print(f"parity gate_envelope: hold 24 and hold 0, T={t} and {t - 1}, "
          f"from both curves: envelope, curve track ({r['switches']} and "
          f"{r['hold0_switches']} switches), curve and state exact")
    print(f"gate_envelope [{C}, {t}]: hold 24 {r['ms']:.4f} ms = "
          f"{r['cycles_per_step']:.2f} cycles per step; hold 0 "
          f"{r['hold0_ms']:.4f} ms = {r['hold0_cycles_per_step']:.2f}; at "
          f"{SM_HZ / 1e9:.2f} GHz; peak_envelope without a threshold on the "
          f"same input {r['peak_form_ms']:.4f} and "
          f"{r['hold0_peak_form_ms']:.4f} ms.  SASS of the chain's batches (FSETP, STS, "
          f"stall cycles per step): reference "
          f"{r['sass_ref']['fsetp']}, {r['sass_ref']['sts']}, "
          f"{r['sass_ref']['stalls']:.2f} (peak_envelope's without a "
          f"threshold: {r['sass_peak_ref']['fsetp']}, "
          f"{r['sass_peak_ref']['sts']}, {r['sass_peak_ref']['stalls']:.2f}); "
          f"free {r['sass_free']['fsetp']}, {r['sass_free']['sts']}, "
          f"{r['sass_free']['stalls']:.2f}")


STEP_COUNTERS = (fp.rfft_packed, fp.rfft_packed_zeropad, fp.irfft_packed,
                 eu.sliding_rms, eu.peak_envelope)


def step_phase(chain, params, dev, res):
    """``step``'s path: launches, finiteness, TF32, the float64 ideal."""
    rng = np.random.default_rng(6)
    t = STEP_BLOCKS * B
    x0 = torch.from_numpy((rng.standard_normal((C, t)) * 0.25).astype(
        np.float32)).to(dev)
    st = chain.init_state(params)
    torch.cuda.synchronize()
    for f in STEP_COUNTERS:
        f.launches = 0
    for k in range(CALLS):
        st, y = chain.step(params, st, torch.roll(x0, shifts=k, dims=-1))
    torch.cuda.synchronize()
    launched = {f.__name__: f.launches for f in STEP_COUNTERS}
    print(f"step: {CALLS} calls of [{C}, {t}]; launches {launched}")
    for name, cnt in launched.items():
        check(cnt >= CALLS, f"{name} launched {cnt} < {CALLS} times")
    check(y.shape == (C, t) and bool(torch.isfinite(y).all()),
          "step output not finite or of the wrong shape")
    check(all(bool(torch.isfinite(s).all()) for s in
              (st.eq, st.fdl.spec_re, st.fdl.spec_im, st.env.envelope)),
          "non-finite step state")
    res["step_launches"] = launched

    # TF32 on: no library matmul on the path, so the output is identical
    xk = torch.roll(x0, shifts=CALLS, dims=-1)
    _, y_ref = chain.step(params, st, xk)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    _, y_tf32 = chain.step(params, st, xk)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    same = bool(torch.equal(y_ref, y_tf32))
    print(f"step, TF32 on: output identical = {same}")
    check(same, "step output changed with TF32 switched on")

    xs = [(rng.standard_normal((C, t)) * 0.25).astype(np.float32)
          for _ in range(2)]
    st = chain.init_state(params)
    ys = []
    for x in xs:
        st, y = chain.step(params, st, torch.from_numpy(x).to(dev))
        ys.append(y.cpu())
    gold = golden_chain_f64(chain, params, [x[:, i * B:(i + 1) * B]
                                            for x in xs
                                            for i in range(STEP_BLOCKS)])
    dbs = [snr_db(torch.from_numpy(np.concatenate(
        gold[k * STEP_BLOCKS:(k + 1) * STEP_BLOCKS], axis=-1)), y)
        for k, y in enumerate(ys)]
    print("step vs float64 ideal: "
          + ", ".join(f"call {i} {v:.2f} dB" for i, v in enumerate(dbs)))
    check(min(dbs) >= CHAIN_DB, f"step {min(dbs):.2f} dB < {CHAIN_DB}")
    res["step_vs_golden_db"] = dbs


def bulk_phase(chain, params, dev, res):
    """``bulk_step``: two super-blocks, the first against the float64
    ideal and against ``step`` on the same input."""
    rng = np.random.default_rng(7)
    h = chain.build_bulk(T_SUPER)
    st = chain.init_bulk_state(params, T_SUPER)
    xs = [(rng.standard_normal((C, T_SUPER)) * 0.25).astype(np.float32)
          for _ in range(2)]
    ys = []
    for x in xs:
        st, y = chain.bulk_step(params, h, st, torch.from_numpy(x).to(dev))
        ys.append(y.cpu())
    check(all(bool(torch.isfinite(y).all()) for y in ys),
          "non-finite bulk_step output")
    gold = golden_chain_f64(chain, params, [xs[0][:, i * B:(i + 1) * B]
                                            for i in range(T_SUPER // B)])
    db = snr_db(torch.from_numpy(np.concatenate(gold, axis=-1)), ys[0])
    t = STEP_BLOCKS * B
    sst = chain.init_state(params)
    outs = []
    for k in range(T_SUPER // t):
        sst, y = chain.step(params, sst, torch.from_numpy(
            np.ascontiguousarray(xs[0][:, k * t:(k + 1) * t])).to(dev))
        outs.append(y.cpu())
    db_step = snr_db(torch.cat(outs, dim=-1), ys[0])
    print(f"bulk_step: 2 super-blocks of [{C}, {T_SUPER}]; the first vs "
          f"float64 ideal {db:.2f} dB, vs step on the same input "
          f"{db_step:.2f} dB")
    check(db >= CHAIN_DB, f"bulk_step {db:.2f} dB < {CHAIN_DB}")
    res.update(bulk_vs_golden_db=db, bulk_vs_step_db=db_step)


def units_phase(dev, res):
    """Sidechain (each mode) -> Compressor, Expander, Gate on the card
    and on the CPU; the gate's path drives gate_envelope."""
    gen = torch.Generator().manual_seed(8)
    swell = torch.sin(torch.linspace(0.0, torch.pi, T_UNITS))
    sig = torch.randn(C, T_UNITS, generator=gen) * 0.3 * swell
    sig_d = sig.to(dev)
    kw = dict(attack_ms=2.0, release_ms=20.0, hold_ms=0.5)
    units = ([Compressor(SR, mode=m, attack_thresh=0.1, release_thresh=0.05,
                         **kw) for m in CompressorMode]
             + [Expander(SR, mode=m, attack_thresh=0.1, release_thresh=0.05,
                         **kw) for m in ExpanderMode]
             + [Gate(SR, threshold=0.1, zone=0.5, hyst_threshold=0.08,
                     **dict(kw, hold_ms=h)) for h in (0.5, 0.0)])
    torch.cuda.synchronize()
    eu.gate_envelope.launches = 0
    worst = dict(level=1e9, envelope=1e9, gain=1e9)
    for mode in SidechainMode:
        side = Sidechain(SR, mode, reactivity_ms=10.0)
        _, lg = side.process(side.init_state((C,), dev), sig_d)
        _, lc = side.process(side.init_state((C,), "cpu"), sig)
        worst["level"] = min(worst["level"], snr_db(lc, lg.cpu()))
        for unit in units:
            p = unit.build()
            _, gg, eg = unit.process(p, unit.init_state((C,), dev), lg)
            _, gc, ec = unit.process(p, unit.init_state((C,), "cpu"), lc)
            worst["envelope"] = min(worst["envelope"], snr_db(ec, eg.cpu()))
            worst["gain"] = min(worst["gain"], snr_db(gc, gg.cpu()))
    torch.cuda.synchronize()
    gate_launches = eu.gate_envelope.launches
    print(f"units: {len(SidechainMode)} sidechain modes x {len(units)} "
          f"units on [{C}, {T_UNITS}], card vs CPU (worst): "
          + ", ".join(f"{k} {v:.1f} dB" for k, v in worst.items())
          + f"; gate_envelope launches {gate_launches}")
    for k in ("envelope", "gain"):
        check(worst[k] >= DYN_DB, f"units {k} {worst[k]:.1f} dB < {DYN_DB}")
    check(gate_launches >= 2 * len(SidechainMode),
          f"gate_envelope launched {gate_launches} times")
    res["units_db"] = worst
    res["gate"]["launches"] = gate_launches


def ring_phase(chain, params, dev, res):
    """The standalone ring convolver over the chain's 1 s IR at full
    width (C=64, B=8192, P=6): kernels #4 (fdl_fused) and #9 (ring_mac)
    against their plain versions; 24 blocks of fdl_ring_step on a packed
    ring against the float64 ideal; the three-kernel step (rfft_packed ->
    ring_mac -> irfft_packed) against the fused one; the Convolver
    unit."""
    from scipy.signal import fftconvolve

    gen = torch.Generator().manual_seed(10)
    h = params.h_spectra
    hp = (params.h_re, params.h_im)
    p_n = hp[0].shape[0]
    ir = np.asarray(chain.ir, np.float64)[None, :]

    # fdl_fused against its plain version; the written slot unpacked
    ring_k = fftconv.init_ring_fdl(h, (C,), packed=True, device=dev)
    ring_p = fftconv.init_ring_fdl(h, (C,), packed=True, device=dev)
    worst, err = dict(y=1e9, slot=1e9), 0.0
    for k in range(p_n + 2):
        x = randn(gen, C, B, scale=0.25, dev=dev)
        w = (ring_k.pos + 1) % p_n
        yk = fdl_fused(*ring_k[:2], *hp, ring_k.history, x, w)
        yp = fdl_fused_plain(*ring_p[:2], *hp, ring_p.history, x, w)
        ring_k = ring_k._replace(history=x, pos=w)
        ring_p = ring_p._replace(history=x, pos=w)
        sk = fp.unpack_spectra(ring_k.spec_re[w], ring_k.spec_im[w], N)
        sp = fp.unpack_spectra(ring_p.spec_re[w], ring_p.spec_im[w], N)
        worst["y"] = min(worst["y"], snr_db(yp, yk))
        worst["slot"] = min(worst["slot"], snr_db(sp[0], sk[0]),
                            snr_db(sp[1], sk[1]))
        err = max(err, max_abs(yp, yk))
    torch.cuda.synchronize()
    print(f"parity fdl_fused (worst of {p_n + 2} blocks): "
          + ", ".join(f"{k} {v:.1f} dB" for k, v in worst.items()))
    for k, v in worst.items():
        check(v >= LIN_DB, f"fdl_fused {k} {v:.1f} dB < {LIN_DB}")
    shape, resident = clusters_resident("fdl", fdl_launch_shape(N, C))
    w = (ring_k.pos + 1) % p_n
    plane = C * B * F32
    r = res["fdl"] = dict(db=worst, max_abs_err=err, library_ms=None,
                          launch_shape=shape, blocks_resident=resident)
    r["ms"] = time_ms(lambda: fdl_fused(*ring_k[:2], *hp, ring_k.history,
                                        x, w), 50)
    r["plain_ms"] = time_ms(lambda: fdl_fused_plain(
        *ring_p[:2], *hp, ring_p.history, x, w), 20)
    # ring: P-1 slots read, one written; IR; hist and x; y
    r.update(bound(2 * plane * p_n + F32 * 2 * p_n * B + 3 * plane,
                   C * (2 * fft_flops(N) + 8 * p_n * B)))

    # the ring path: fdl_ring_step on a packed ring, input rotated
    rng = np.random.default_rng(11)
    x0 = (rng.standard_normal((C, B)) * 0.25).astype(np.float32)
    x0d = torch.from_numpy(x0).to(dev)
    st = fftconv.init_ring_fdl(h, (C,), packed=True, device=dev)
    torch.cuda.synchronize()
    fdl_fused.launches = 0
    ys = []
    for k in range(RING_BLOCKS):
        st, y = fftconv.fdl_ring_step(h, st, torch.roll(x0d, shifts=k,
                                                        dims=-1))
        ys.append(y[:GOLD_CH])
    torch.cuda.synchronize()
    r["launches"] = fdl_fused.launches
    check(r["launches"] >= RING_BLOCKS,
          f"fdl_fused launched {r['launches']} < {RING_BLOCKS} times")
    check(y.shape == (C, B) and bool(torch.isfinite(y).all())
          and bool(torch.isfinite(st.spec_re).all()),
          "ring output or state not finite or of the wrong shape")
    xin = np.concatenate([np.roll(x0[:GOLD_CH], k, axis=-1)
                          for k in range(RING_BLOCKS)], axis=-1)
    gold = fftconvolve(xin.astype(np.float64), ir,
                       axes=-1)[:, :RING_BLOCKS * B]
    db = snr_db(torch.from_numpy(gold), torch.cat(ys, dim=-1).cpu())
    print(f"ring path: {RING_BLOCKS} blocks of fdl_ring_step (packed ring, "
          f"[{C}, {B}], P={p_n}); fdl_fused launches {r['launches']}; "
          f"{GOLD_CH} channels vs float64 fftconvolve {db:.2f} dB")
    check(db >= CHAIN_DB, f"ring path {db:.2f} dB < {CHAIN_DB}")
    res["ring_vs_golden_db"] = db
    xr = [torch.roll(x0d, shifts=k, dims=-1) for k in range(8)]
    ring_state, i = [st], [0]

    def one_ring():
        ring_state[0], _ = fftconv.fdl_ring_step(h, ring_state[0],
                                                 xr[i[0] % 8])
        i[0] += 1

    res["ring_step_ms"] = time_ms(one_ring, RING_BLOCKS)
    print(f"fdl_ring_step (packed ring): {res['ring_step_ms']:.4f} ms/block "
          f"on the card (CUDA events, {RING_BLOCKS} blocks)")

    # ring_mac against its plain version, natural and packed rows
    res["mac"] = dict(library_ms=None)
    for name, f_n, hh, packed in (("natural", B + 1, (h.re, h.im), False),
                                  ("packed", B, hp, True)):
        rk = [randn(gen, p_n, C, f_n, dev=dev) for _ in range(2)]
        rp = [t.clone() for t in rk]
        sv = [randn(gen, C, f_n, dev=dev) for _ in range(2)]
        ak = ring_mac(*rk, *hh, *sv, 2, packed_dc=packed)
        ap = ring_mac_plain(*rp, *hh, *sv, 2, packed_dc=packed)
        torch.cuda.synchronize()
        db = min(snr_db(ap[0], ak[0]), snr_db(ap[1], ak[1]))
        same = all(torch.equal(a, b) for a, b in zip(rk, rp))
        print(f"parity ring_mac {name} (F={f_n}): acc {db:.1f} dB, max abs "
              f"err {max(max_abs(ap[0], ak[0]), max_abs(ap[1], ak[1]))}; "
              f"ring identical = {same}")
        check(db >= MAC_DB, f"ring_mac {name} {db:.1f} dB < {MAC_DB}")
        check(same, f"ring_mac {name}: ring differs")
        res["mac"][name] = dict(
            db=db, max_abs_err=max(max_abs(ap[0], ak[0]),
                                   max_abs(ap[1], ak[1])),
            ms=time_ms(lambda: ring_mac(*rk, *hh, *sv, 2, packed), 50),
            plain_ms=time_ms(lambda: ring_mac_plain(*rp, *hh, *sv, 2,
                                                    packed), 20),
            # ring: P-1 slots read, one written; IR; S; acc
            **bound(F32 * (2 * C * f_n * (p_n + 2) + 2 * p_n * f_n),
                    8 * p_n * C * f_n))
    res["mac"].update({k: res["mac"]["packed"][k] for k in
                       ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by")})

    # the three-kernel step against the fused one
    ring_a = fftconv.init_ring_fdl(h, (C,), packed=True, device=dev)
    ring_b = fftconv.init_ring_fdl(h, (C,), packed=True, device=dev)
    staged = (fp.rfft_packed, ring_mac, fp.irfft_packed)
    torch.cuda.synchronize()
    for fn in staged:
        fn.launches = 0
    worst3 = 1e9
    for k in range(p_n + 2):
        x = randn(gen, C, B, scale=0.25, dev=dev)
        w = (ring_a.pos + 1) % p_n
        ya = fdl_fused(*ring_a[:2], *hp, ring_a.history, x, w)
        s_re, s_im = fp.rfft_packed(torch.cat([ring_b.history, x], dim=-1))
        acc = ring_mac(*ring_b[:2], *hp, s_re, s_im, w, packed_dc=True)
        yb = fp.irfft_packed(*acc, N, "last")
        ring_a = ring_a._replace(history=x, pos=w)
        ring_b = ring_b._replace(history=x, pos=w)
        worst3 = min(worst3, snr_db(ya, yb))
    torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches for fn in staged}
    res["mac"]["launches"] = launched["ring_mac"]
    print(f"three-kernel step ({p_n + 2} blocks) vs fdl_fused: y "
          f"{worst3:.1f} dB; launches {launched}")
    check(worst3 >= LIN_DB, f"three-kernel step {worst3:.1f} dB < {LIN_DB}")
    for name, cnt in launched.items():
        check(cnt >= p_n + 2, f"{name} launched {cnt} < {p_n + 2} times")
    res["three_kernel_db"] = worst3

    # the Convolver unit: one call of 8 blocks at rank 12
    conv = Convolver(chain.ir, rank=CONV_RANK, device=dev)
    xc = (rng.standard_normal((C, CONV_BLOCKS * conv.block)) * 0.25).astype(
        np.float32)
    _, yc = conv.process(conv.init_state((C,)), torch.from_numpy(xc).to(dev))
    gold = fftconvolve(xc.astype(np.float64), ir, axes=-1)[:, :xc.shape[-1]]
    db = snr_db(torch.from_numpy(gold), yc.cpu())
    print(f"Convolver(rank={CONV_RANK}, {conv.partitions} partitions) on "
          f"[{C}, {xc.shape[-1]}]: {db:.2f} dB from float64 fftconvolve")
    check(db >= CHAIN_DB, f"Convolver {db:.2f} dB < {CHAIN_DB}")
    res["convolver_vs_golden_db"] = db


def sampler_phase(dev, res):
    """The device sampler mixdown at benchmarks/polyphony.py's device
    configuration: 4096 voices, block 1024, one 1 s noise sample; even
    voices DIRECT-loop 1000-40000, delays (v * 7) % 4800, volume 0.1."""
    rng = np.random.default_rng(0)
    data = (rng.normal(size=SR) * 0.25).astype(np.float32)
    specs = [dict(sample_id=0, channel=0, volume=0.1, delay=(v * 7) % 4800,
                  loop=(v % 2 == 0), loop_start=1000, loop_end=40000)
             for v in range(VOICES)]
    bank, bank_len = dm.build_bank([data], device=dev)
    bank_p, _, pad = dm.build_bank_padded([data], VBLOCK, device=dev)
    voices, st0 = dm.build_voices(specs, 1, [SR], device=dev)

    torch.cuda.synchronize()
    slicedma.batched_slice.launches = 0
    st, outs = st0, []
    for _ in range(VBLOCKS):
        st, y = dm.mix_block_dma(bank_p, bank_len, pad, voices, st, VBLOCK)
        outs.append(y)
    torch.cuda.synchronize()
    launched = slicedma.batched_slice.launches
    check(launched >= 2 * VBLOCKS,
          f"batched_slice launched {launched} < {2 * VBLOCKS} times")
    st_g, same = st0, True
    for y in outs:
        st_g, yg = dm.mix_block(bank, bank_len, voices, st_g, VBLOCK)
        same = same and torch.equal(y, yg)
    same_pos = torch.equal(st.pos, st_g.pos)
    out = torch.cat(outs, dim=-1)
    print(f"sampler: {VBLOCKS} blocks of mix_block_dma, {VOICES} voices x "
          f"{VBLOCK}; batched_slice launches {launched}; identical to "
          f"mix_block = {same}, playheads identical = {same_pos}")
    check(same and same_pos, "mix_block_dma differs from mix_block")
    check(out.shape == (1, VBLOCKS * VBLOCK)
          and bool(torch.isfinite(out).all())
          and float(out.abs().max()) > 0, "sampler output")

    # the host SamplePlayer defines the semantics; it sums the voices in
    # float32 one by one, the card in float64 rounded once
    smp = Sample(1, SR, SR)
    smp.data = data[None].copy()
    player = SamplePlayer(max_samples=1, max_playbacks=VOICES)
    player.bind(0, smp)
    for sp in specs:
        player.play(PlaySettings(
            sample_id=0, channel=0, volume=sp["volume"], delay=sp["delay"],
            loop_mode=LoopMode.DIRECT if sp["loop"] else LoopMode.NONE,
            loop_start=sp["loop_start"], loop_end=sp["loop_end"]))
    host = np.concatenate([player.process(VBLOCK)
                           for _ in range(HOST_BLOCKS)])
    db = snr_db(torch.from_numpy(host), out[0, :HOST_BLOCKS * VBLOCK].cpu())
    print(f"sampler vs the host SamplePlayer, {HOST_BLOCKS} blocks: "
          f"{db:.2f} dB")
    check(db >= CHAIN_DB, f"sampler vs host player {db:.2f} dB < {CHAIN_DB}")
    res["sampler_vs_host_db"] = db

    # TF32 on: the routing product is float64, so the output is identical
    _, y_ref = dm.mix_block_dma(bank_p, bank_len, pad, voices, st, VBLOCK)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    _, y_tf32 = dm.mix_block_dma(bank_p, bank_len, pad, voices, st, VBLOCK)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    same = bool(torch.equal(y_ref, y_tf32))
    print(f"sampler, TF32 on: output identical = {same}")
    check(same, "sampler output changed with TF32 switched on")

    # batched_slice against its plain version: edges, the clamp limit and
    # beyond, random starts
    gen = torch.Generator().manual_seed(12)
    lim = bank_p.shape[0] - VBLOCK - slicedma.SLACK
    edge = [0, 1, 1023, 1024, lim - 1, lim, lim + 5, -7]
    starts = torch.cat([
        torch.tensor(edge, dtype=torch.int32),
        torch.randint(0, lim, (VOICES - len(edge),), generator=gen,
                      dtype=torch.int32)]).to(dev)
    got = slicedma.batched_slice(bank_p, starts, VBLOCK)
    want = slicedma.batched_slice_plain(bank_p, starts, VBLOCK)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "batched_slice differs from its plain "
                                  "version")
    print(f"parity batched_slice: {VOICES} windows of {VBLOCK} (starts 0, "
          f"1023, 1024, the clamp limit {lim} and beyond) exact")
    shape = slicedma.launch_shape(VOICES)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = min(shape["blocks"], shape["blocks_per_sm"] * sms)
    print(f"batched_slice launch: {VOICES} windows, one warp each: "
          f"{shape['blocks']} blocks of {shape['threads']} threads, "
          f"{shape['blocks_per_sm']} per SM x {sms} SMs: {resident} "
          f"resident")
    s64 = starts.long().clamp(0, lim)
    idx = torch.arange(VBLOCK, device=dev)
    res["slice"] = dict(
        launches=launched, max_abs_err=max_abs(want, got),
        ms=time_ms(lambda: slicedma.batched_slice(bank_p, starts, VBLOCK),
                   100),
        plain_ms=time_ms(lambda: slicedma.batched_slice_plain(
            bank_p, starts, VBLOCK), 50),
        library_ms=time_ms(lambda: bank_p[s64[:, None] + idx], 50),
        launch_shape=shape, blocks_resident=resident,
        # the windows written, the bank and the starts read once
        **bound(F32 * (VOICES * VBLOCK + bank_p.shape[0]) + 4 * VOICES, 0))

    state = [st]

    def one(dma):
        if dma:
            state[0], _ = dm.mix_block_dma(bank_p, bank_len, pad, voices,
                                           state[0], VBLOCK)
        else:
            state[0], _ = dm.mix_block(bank, bank_len, voices, state[0],
                                       VBLOCK)

    ms = time_ms(lambda: one(True), VBLOCKS)
    ms16 = time_ms(lambda: one(True), 16)
    ms_g = time_ms(lambda: one(False), VBLOCKS)
    res.update(sampler_ms_per_block=ms, sampler_ms_per_block_16=ms16,
               sampler_gather_ms_per_block=ms_g,
               voice_samples_per_s=VOICES * VBLOCK / (ms * 1e-3))
    print(f"sampler: mix_block_dma {ms:.4f} ms/block on the card (CUDA "
          f"events, {VBLOCKS} blocks; {ms16:.4f} over 16) = "
          f"{res['voice_samples_per_s'] / 1e9:.3f} G voice-samples/s; "
          f"mix_block (gather) {ms_g:.4f} ms/block")


def timing_phase(chain, params, dev, res):
    """Device time of ``step`` per call and of ``bulk_step`` per
    super-block (CUDA events behind the spin kernel), and the host's
    time to enqueue a call of ``step``."""
    gen = torch.Generator().manual_seed(9)
    t = STEP_BLOCKS * B
    x0 = randn(gen, C, t, scale=0.25, dev=dev)
    xr = [torch.roll(x0, shifts=k, dims=-1) for k in range(8)]
    state = [chain.init_state(params)]
    i = [0]

    def one():
        state[0], _ = chain.step(params, state[0], xr[i[0] % 8])
        i[0] += 1

    # 6 calls: ~130 launches each stay inside the card's queue of
    # pending launches, so the host never waits on the card while the
    # spin kernel holds it, and the events time the card alone
    ms = time_ms(one, 6, warmup=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        one()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 8
    torch.cuda.synchronize()
    h = chain.build_bulk(T_SUPER)
    xb = randn(gen, C, T_SUPER, scale=0.25, dev=dev)
    bstate = [chain.init_bulk_state(params, T_SUPER)]

    def one_bulk():
        bstate[0], _ = chain.bulk_step(params, h, bstate[0], xb)

    ms_b = time_ms(one_bulk, 4, warmup=1)
    res.update(step_ms=ms, step_ms_per_block=ms / STEP_BLOCKS,
               step_host_enqueue_ms=enqueue_ms, bulk_ms=ms_b,
               bulk_ms_per_block=ms_b / (T_SUPER // B))
    print(f"step: {ms:.4f} ms per call = {ms / STEP_BLOCKS:.4f} ms/block on "
          f"the card (CUDA events, 6 calls); host {enqueue_ms:.4f} ms to "
          f"enqueue a call; bulk_step {ms_b:.4f} ms per super-block = "
          f"{ms_b / (T_SUPER // B):.4f} ms/block")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    res = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    sources = ("fft_packed", "fdl_fused", "env", "env_units", "ring_mac",
               "slicedma")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    res["build_s"] = time.perf_counter() - t0
    print(f"build: {res['build_s']:.1f} s ({', '.join(sources)}, in "
          f"parallel)")

    chain = pipeline.FilterConvChain(SR, C, rank=RANK, ir_seconds=IR_S,
                                     device=dev)
    params = chain.build()
    check(params.h_re.shape == (6, B), f"IR partitions {params.h_re.shape}")

    parity_fft(dev, res)
    parity_eqfdl(chain, params, dev, res)
    parity_dyn(chain, params, dev, res)
    parity_env_units(chain, params, dev, res)
    main_path(chain, params, dev, BLOCKS, res)
    step_phase(chain, params, dev, res)
    bulk_phase(chain, params, dev, res)
    units_phase(dev, res)
    ring_phase(chain, params, dev, res)
    sampler_phase(dev, res)
    timing_phase(chain, params, dev, res)

    res["fft"]["launches"] = res["launches"]["fft"]
    res["eqfdl"]["launches"] = res["launches"]["eqfdl"]
    res["dyn"]["launches"] = res["launches"]["dyn"]
    res["rms"]["launches"] = res["step_launches"]["sliding_rms"]
    res["peak"]["launches"] = res["step_launches"]["peak_envelope"]
    kernels = []
    for key, name, src, replaces in KERNELS:
        r = res[key]
        print(f"kernel {name}: {r['ms']:.4f} ms vs plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library "
              + ("none" if r["library_ms"] is None
                 else f"{r['library_ms']:.4f} ms") + f" ({card})")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"lsp_dsp_units_tpu_torch/csrc/{src}",
            replaces=f"lsp_dsp_units_tpu/ops/{replaces}",
            **{k: r[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")
               + EXTRA_KEYS.get(key, ())}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
