"""Hold this checkout's packed FFT, EQ + convolver, dynamics tail,
envelope, sliding RMS, slice, biquad cascade, limiter, rider, biquad
scan and delay kernels against another checkout's on the card: outputs
bit for bit, device times in turns.

    python3 -m lsp_dsp_units_tpu_torch.tools.ab_kernels OTHER [--out F]
        [--cases NAME ...]

OTHER is the root of another checkout (for a redesign, its parent commit
unpacked with ``git archive``).  Its ``csrc/fft_packed.cu``,
``csrc/fdl_fused.cu``,
``csrc/env.cu``, ``csrc/env_units.cu``, ``csrc/slicedma.cu``, ``csrc/biquad.cu``,
``csrc/limiter.cu``, ``csrc/riders.cu``, ``csrc/biquad_scan.cu``,
``csrc/delay.cu`` and ``csrc/biquad_bwd.cu`` (those it has; the cases of a missing one, or of a step
functor its riders.cu lacks, are skipped) are built with this
checkout's nvcc flags into
``build/lsp_dsp_units_tpu_torch/ab/`` and stand in for this checkout's
libraries during its runs; wrappers, inputs and checks are this
checkout's, so the two builds' C interfaces must match (but for the
backwards' cases, last below).  At the main
paths' shapes (64 channels, N = 16384, P = 6, the chain's EQ and
compressor):

* kernel #1 at [C, N] (fft_rfft, fft_rfft_zeropad on [C, N / 2],
  fft_irfft, fft_irfft_first, fft_irfft_last): the spectra or the frame;
* eqfdl_fused over P + 2 blocks: y, u, EQ state and ring;
* fdl_fused over P + 2 blocks: y and ring;
* chain_dyn (kernel #3) at [64, 8192], N = 480, the chain's compressor,
  over P + 2 blocks from env_init with the window and state carried: y,
  window', envelope, peak and hold;
* peak_envelope at [64, 16384], threshold on, in step's configuration
  (hold 0 from env_init) and with a hold of 24 samples from a random
  state: envelope, peak and hold;
* gate_envelope at [64, 16384] with a hold of 24 samples and with the
  gate's default hold of 0: envelope, curve track and state;
* sliding_rms at [64, 16384], N = 480: window' and level;
* batched_slice at the sampler's configuration (4096 windows of 1024
  from the padded bank of one 1 s sample; edge, clamped and random
  starts);
* biquad_seq at [64, 16384] from a random state: the chain's 8-band EQ
  (K = 9, shared coefficients) and DynamicFilters' bell (BT_BWC_BELL,
  slope 2, K = 4) with per-sample coefficients on a -12..+12 dB swell:
  y and state.
* limiter_kernel at [64, 16384] on a rising noise sidechain from a
  random carry: HERM_THIN at 2 ms (the patch passes alone) and EXP_WIDE
  at 5 ms with ALR: gain, carry, ALR envelope and pass counts;
* rider_kernel at [64, 16384], each step functor: AutoGain (quick_amp
  and max_gain on; rider_autogain_default: both off), DynamicProcessor's
  envelope (4 attack and 4 release levels, a hold), SimpleAutoGain,
  SurgeProtector and PeakMeter: output and state, and each build's
  cycles a step at 1.98 GHz;
* biquad_scan (the time-parallel cascade) at [64, 16384] on the chain's
  8-band EQ (K = 9), at [64, 65536] on the Oversampler's 4x filter
  (K = 15), that filter's first 1, 9 and 15 stages at both lengths
  (biquad_scan_k<K>_<T>), per-row coefficients (biquad_scan_rows, K = 9)
  and the scan's backward route (biquad_scan_bwd, K = 9 at [64, 16384]),
  from random states, each build through its own ops/biquad.py (the C
  interfaces differ): y and state, every cotangent.
* the synth phase's machines (chip_smoke.py) at [64, 16384]: the
  dynamic delay (a ring of 4801 from a random state, each channel's
  delay swept by the LFO's quick sine, seeded feedback delays, a gain of
  0.5): y and ring (delay_save: its saving form, y, ring and each
  step's s); the trigger (rider_trigger: the advanced rising
  edge; rider_trigger_<type>: every other type; hold 24) and the
  depopper's forward machine (rider_depopper: CUBIC;
  rider_depopper_<mode>: every other mode; on gated levels) of
  rider_kernel: output and state, and cycles a step.
* the sequential cascade's backward (csrc/biquad_bwd.cu) at [64, 16384]
  on the saved signals of this checkout's saving forward: the chain's
  K = 9 with the coefficients' gradient (biquad_seq_bwd: its row sums
  too) and without (biquad_seq_bwd_x), DynamicFilters' bell per sample
  (biquad_seq_bwd_dyn); the DynamicDelay's (delay_bwd) on the delay
  case's bank: every cotangent;
* the convolver's backwards, eqfdl_fused_bwd and fdl_fused_bwd, on a
  seeded ring, the chain's IR and EQ spectra and matrices and seeded
  cotangents: each build's route through its own wrapper (the other
  checkout's ops/fdl_fused.py, loaded beside this one's, so that the two
  C interfaces may differ).  Their channel sums may round otherwise, so
  each output of this build must be >= 110 dB from the plain backward
  (identical where that is zero); which outputs equal the other build's
  is listed.  Beside the route times, each build's launches of one call
  (torch.profiler): short name, ms a launch, launches a call and the
  bytes bound of the launches (tools/launch_profile.py; none for
  the other build's launches that this tree lacks).
* #1's adjoints (fft_adjoint_rfft, _rfft_zeropad, _irfft, _irfft_first,
  _irfft_last at step's [2 C, N], fft_adjoint_ring_rfft_zeropad at
  step_ring's [C, N]), each build's route through its own
  ops/fft_packed.py (the C interfaces differ): every output bit for bit,
  the routes' times in turns and each build's launches of a call with
  their bytes bounds (torch.profiler after uncounted calls).
* the envelope backwards: peak_envelope_bwd at [64, 16384] in step's
  configuration (hold 0 from env_init) and with a hold of 24 from a
  random state, through this checkout's wrapper on either library;
  chain_dyn_bwd at [64, 8192], N = 480, the chain's compressor, from the
  window and state after three blocks (hold 0) and from the random state
  with a hold of 24, through each checkout's own ops/env.py (the C
  interfaces may differ: this tree's backward starts from the level and
  envelope its saving forward wrote, an older one replays them), replay
  outputs included.  Every output bit for bit (the knee fields may move by 1
  ulp); each build's ms, cycles a step at 1.98 GHz and launches (with
  their bytes bounds), the one remaining serial pass's bound (T x 12
  cycles: 3 dependent operations a step), and this tree's forward with and without saving.

Each case's outputs must be identical between the builds (the indices
of those that differ are listed: eqfdl_fused's are y, u, EQ state per
block, then the ring planes), with one rule of its own: sliding_rms's
level (a float64 sum rounded once, in another order) may differ by at
most 1 ulp; the count of differing samples, the largest difference in
ulps and each build's SNR against the float64 ideal are printed.
Times: CUDA events around back-to-back calls behind a spin kernel, in
the order other, this, this, other.  Prints one JSON object; exits
non-zero on a difference or without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

from lsp_dsp_units_tpu_torch import pipeline
from lsp_dsp_units_tpu_torch.models import filters as flt
from lsp_dsp_units_tpu_torch.models.filters import dynamic_filters as dynf
from lsp_dsp_units_tpu_torch.models.dynamics import (
    AutoGain, DynamicProcessor, Limiter, LimiterMode, SimpleAutoGain,
    SurgeProtector)
from lsp_dsp_units_tpu_torch.models.meters import PeakMeter
from lsp_dsp_units_tpu_torch.models.misc import lfo
from lsp_dsp_units_tpu_torch.models.util import (
    Depopper, DepopperMode, Trigger, TriggerMode, TriggerType)
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate
from lsp_dsp_units_tpu_torch.models.sampling import device_mix as dm
from lsp_dsp_units_tpu_torch.models.util.oversampler import Oversampler
from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import biquad as bq
from lsp_dsp_units_tpu_torch.ops import delay as delay_ops
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn
from lsp_dsp_units_tpu_torch.ops import env as env_ops
from lsp_dsp_units_tpu_torch.ops import env_units as eu
from lsp_dsp_units_tpu_torch.ops import fdl_fused as ff
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.ops import fftconv
from lsp_dsp_units_tpu_torch.ops import limiter as lim_ops
from lsp_dsp_units_tpu_torch.ops import riders
from lsp_dsp_units_tpu_torch.ops import slicedma
from lsp_dsp_units_tpu_torch.tools.launch_profile import launch_profile

C, RANK, SR = 64, 14, 48000
B = 1 << (RANK - 1)
T_ENV = 2 * B                        # step's envelope call: [64, 16384]
SIGS = {"fft_packed": fp._SIGS, "fdl_fused": ff._SIGS, "env": env_ops._SIGS,
        "env_units": eu._SIGS,
        "slicedma": slicedma._SIGS, "biquad": bq._SIGS,
        "limiter": lim_ops._SIGS, "riders": riders._SIGS,
        "biquad_scan": bq._SCAN_SIGS, "delay": delay_ops._SIGS,
        "biquad_bwd": bq._BWD_SIGS}
DELAY_MAX = 4800                     # the synth phase's delay bank
VOICES, VBLOCK = 4096, 1024          # the sampler's configuration
SPIN_CYCLES = 200_000_000
BWD_DB = 110.0                       # the backwards against their plain ones
SM_HZ = 1.98e9                       # the H100's boost clock (cycles a step)
F32 = 4


# kernel #1's forward cases ([C, N], N = 16384; the zero-pad form and the
# halves on [C, N / 2]) and its adjoints' (step's [2 C, N]; step_ring's
# zero-pad adjoint at [C, N])
FFT_MODES = ("rfft", "rfft_zeropad", "irfft", "irfft_first", "irfft_last")
ADJOINT_MODES = FFT_MODES + ("ring_rfft_zeropad",)


# the Trigger's and the Depopper's cases: every type and mode (the
# advanced rising edge and the cubic fade keep their first names)
TRIGGER_CASE = {tt: "rider_trigger" if tt.name == "ADVANCED_RISING_EDGE"
                else f"rider_trigger_{tt.name.lower()}" for tt in TriggerType}
DEPOPPER_CASE = {m: "rider_depopper" if m.name == "CUBIC"
                 else f"rider_depopper_{m.name.lower()}" for m in DepopperMode}
# each case's library (csrc/<name>.cu); env_units for the rest
LIB_OF = {**{f"fft_{m}": "fft_packed" for m in FFT_MODES},
          **{f"fft_adjoint_{m}": "fft_packed" for m in ADJOINT_MODES},
          "eqfdl_fused": "fdl_fused", "fdl_fused": "fdl_fused",
          "eqfdl_fused_bwd": "fdl_fused", "fdl_fused_bwd": "fdl_fused",
          "chain_dyn": "env", "chain_dyn_bwd": "env",
          "chain_dyn_bwd_hold24": "env",
          "sliding_rms": "env_units", "batched_slice": "slicedma",
          "biquad_seq": "biquad", "biquad_seq_dyn": "biquad",
          "limiter": "limiter", "limiter_alr": "limiter",
          "rider_autogain": "riders", "rider_dynproc": "riders",
          "rider_simple": "riders", "rider_surge": "riders",
          "rider_peak": "riders", "biquad_scan": "biquad_scan",
          "biquad_scan_k15": "biquad_scan", "biquad_scan_rows": "biquad_scan",
          "biquad_scan_bwd": "biquad_scan", "delay": "delay",
          "delay_save": "delay",
          **{f"biquad_scan_k{k}_{t}": "biquad_scan" for k in (1, 9, 15)
             for t in (T_ENV, 4 * T_ENV)},
          "biquad_seq_bwd": "biquad_bwd", "biquad_seq_bwd_x": "biquad_bwd",
          "biquad_seq_bwd_dyn": "biquad_bwd", "delay_bwd": "delay",
          "rider_autogain_default": "riders",
          **{k: "riders" for k in TRIGGER_CASE.values()},
          **{k: "riders" for k in DEPOPPER_CASE.values()}}


def share_structs(mod, this_mod) -> None:
    """Make the other checkout's module build and declare this checkout's
    ctypes structures (the same layouts), so that either checkout's
    wrappers may call either library."""
    swap = {}
    for name, obj in list(vars(mod).items()):
        if isinstance(obj, type) and issubclass(obj, ctypes.Structure) \
                and isinstance(getattr(this_mod, name, None), type):
            swap[obj] = getattr(this_mod, name)
            setattr(mod, name, swap[obj])
    if hasattr(mod, "_SIGS"):
        mod._SIGS = {fn: [swap.get(t, t) for t in types]
                     for fn, types in mod._SIGS.items()}


def build_other(root: str, name: str, sigs=None) -> ctypes.CDLL:
    """Compile ``<root>/lsp_dsp_units_tpu_torch/csrc/<name>.cu`` and load
    it with ``sigs`` (by default this checkout's signatures; those it
    has)."""
    csrc = os.path.join(root, "lsp_dsp_units_tpu_torch", "csrc")
    out = os.path.join(_build.BUILD_DIR, "ab", f"{name}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                           csrc, "-o", out, os.path.join(csrc, f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the other {name}.cu:\n"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(out)
    for fn, argtypes in (sigs or SIGS[name]).items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    if name == "delay" and not hasattr(lib, "lsp_delay_bwd_smem_bytes"):
        # an older delay.cu, whose adjoint kept lam in shared memory
        # wherever the forward kept its ring
        lib.lsp_delay_bwd_smem_bytes = lib.lsp_delay_smem_bytes
    return lib


@contextlib.contextmanager
def using(libs):
    """Route the wrappers to ``libs`` (name -> CDLL) inside the block."""
    saved = dict(_build._LIBS)
    _build._LIBS.update(libs)
    try:
        yield
    finally:
        _build._LIBS.clear()
        _build._LIBS.update(saved)


def time_ms(fn, reps: int) -> float:
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


def other_module(root: str, name: str):
    """The other checkout's ops/<name>.py as a module of its own (its
    wrappers, its C signatures), or None where it has none."""
    path = os.path.join(root, "lsp_dsp_units_tpu_torch", "ops",
                        f"{name}.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(f"ab_other_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def snr_or_same(ref: torch.Tensor, out: torch.Tensor) -> float:
    """snr_db of ``out`` against ``ref``; where ``ref`` is zero
    throughout, inf if ``out`` is too, else -inf."""
    if not bool(torch.any(ref != 0)):
        return float("inf") if torch.equal(ref, out) else float("-inf")
    return snr_db(ref.double(), out)


def bwd_inputs(params, gen):
    """The convolver backwards' arguments at the main path's shapes: a
    seeded written ring and cotangents, the chain's IR and EQ spectra
    and matrices, seeded EQ inputs (``eqfdl_fused_bwd``'s, then
    ``fdl_fused_bwd``'s)."""
    def r(*shape):
        return torch.randn(*shape, generator=gen).cuda()
    eqp = params.eq_block
    p_n, k2 = params.h_re.shape[0], eqp.m_mat.shape[0]
    ring = (r(p_n, C, B), r(p_n, C, B))
    cot = (r(C, B), r(C, B), r(C, k2), r(p_n, C, B), r(p_n, C, B))
    w = 4 % p_n
    eq = (*ring, params.h_re, params.h_im, params.heq_re, params.heq_im,
          r(C, B), r(C, B), r(C, B), r(C, k2), eqp.g_t, eqp.m_mat,
          eqp.w_mat, w, *cot)
    fdl = (*ring, params.h_re, params.h_im, w, cot[0], *cot[3:])
    return eq, fdl


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in float32 ulps, elementwise (monotone integer map)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def snr_db(ref: torch.Tensor, out: torch.Tensor) -> float:
    err = out.double() - ref
    return float(10 * torch.log10(torch.sum(ref * ref)
                                  / torch.clamp(torch.sum(err * err),
                                                min=1e-300)))


def rms_ideal(win, x, n, gain):
    """Float64 sliding RMS of the same float32 squares."""
    v = x.abs() * gain
    cs = torch.cumsum(torch.cat([win.double(), (v * v).double()], -1), -1)
    cs = torch.nn.functional.pad(cs, (1, 0))
    t = x.shape[-1]
    return torch.sqrt(torch.clamp((cs[:, n + 1:n + 1 + t] - cs[:, 1:1 + t])
                                  / n, min=0.0))


def eqfdl_run(params, blocks):
    """P + 2 blocks of eqfdl_fused from a fresh ring: every output."""
    eqp = params.eq_block
    ring = fftconv.init_ring_fdl(params.h_spectra, (C,), packed=True)
    sv = torch.zeros(C, eqp.m_mat.shape[0], device="cuda")
    outs = []
    for x, xs in blocks:
        w = (ring.pos + 1) % params.h_re.shape[0]
        y, u, sv, _, _ = ff.eqfdl_fused(
            ring.spec_re, ring.spec_im, params.h_re, params.h_im,
            params.heq_re, params.heq_im, *xs, x, sv, eqp.g_t, eqp.m_mat,
            eqp.w_mat, ring.history, w)
        ring = ring._replace(history=u, pos=w)
        outs += [y, u, sv]
    return outs + [ring.spec_re, ring.spec_im]


def dyn_run(chain, cp, blocks):
    """P + 2 blocks of chain_dyn from env_init and a zero window, window
    and state carried: every output."""
    n = chain.sidechain.reactivity
    win = torch.zeros(C, n, device="cuda")
    st = dyn.env_init((C,))
    outs = []
    for x, _ in blocks:
        win, st, y = env_ops.chain_dyn(
            win, st, x * 8.0, n, chain.sidechain.gain, cp.tau_attack,
            cp.tau_release, cp.release_thresh, cp.hold, cp.knees)
        outs += [y, win, *st]
    return outs


def fdl_run(params, blocks):
    hp = (params.h_re, params.h_im)
    ring = fftconv.init_ring_fdl(params.h_spectra, (C,), packed=True)
    outs = []
    for x, _ in blocks:
        w = (ring.pos + 1) % hp[0].shape[0]
        outs.append(ff.fdl_fused(ring.spec_re, ring.spec_im, *hp,
                                 ring.history, x, w)[0])
        ring = ring._replace(history=x, pos=w)
    return outs + [ring.spec_re, ring.spec_im]


def adjoint_args(mode: str, gen):
    """An adjoint case's arguments after the frame size: step's [2 C, N]
    (two blocks a call) or step_ring's [C, N]."""
    n = 2 * B
    rows = C if mode.startswith("ring") else 2 * C

    def r(*shape):
        return torch.randn(*shape, generator=gen).cuda()
    if mode.endswith("rfft_zeropad") or mode == "rfft":
        return (r(rows, B), r(rows, B), n, int(mode != "rfft"))
    half = {"irfft": False, "irfft_first": "first", "irfft_last": "last"}
    return (r(rows, n if mode == "irfft" else B), n, half[mode])


def adjoint_bytes(mode: str):
    """The bytes an adjoint must move (its cotangent read once, its
    gradient written once), for launch_profile's bounds."""
    rows = C if mode.startswith("ring") else 2 * C
    n = 2 * B
    floats = {"rfft": 2 * B + n, "irfft": n + 2 * B}.get(mode, 3 * B)

    def of(name):
        return rows * floats * F32 if "packed" in name else None
    return of


def scan_cases(args, this, other, other_bq, c9, s9, xr, res) -> bool:
    """biquad_scan (the chain's EQ, K = 9 at [C, T_ENV]; the Oversampler's
    4x filter, K = 15 at [C, 4 T_ENV]; its first 1 and 9 stages and all
    15 at both lengths; per-row coefficients, K = 9) and the scan's
    backward route (biquad_cascade_bwd, K = 9 at [C, T_ENV]), each build
    through its own ops/biquad.py (the C interfaces differ): every output
    bit for bit the other build's, the times in turns."""
    ok = True
    gen = torch.Generator().manual_seed(32)
    c15 = Oversampler(SR, 4, "x3", True).filter_coeffs
    x15 = (torch.randn(C, 4 * T_ENV, generator=gen) * 0.25).cuda()
    s15 = (torch.randn(C, c15.shape[0], 2, generator=gen) * 0.1).cuda()
    y9, _ = bq.biquad_cascade(c9, s9, xr)
    g_y = torch.randn(C, T_ENV, generator=gen).cuda()
    g_s = torch.randn(C, c9.shape[0], 2, generator=gen).cuda()
    # per-row gains on the numerators (the poles, and so the stability,
    # unchanged)
    gain = torch.ones(C, 1, 5, device="cuda")
    gain[..., :3] += 0.01 * torch.arange(C, device="cuda")[:, None, None] / C
    rows9 = (c9 * gain).contiguous()
    calls = {
        "biquad_scan": (lambda m: m.biquad_cascade(c9, s9, xr), 20),
        "biquad_scan_k15": (lambda m: m.biquad_cascade(c15, s15, x15), 10),
        "biquad_scan_rows": (lambda m: m.biquad_cascade(rows9, s9, xr), 20),
        "biquad_scan_bwd": (lambda m: m.biquad_cascade_bwd(
            c9, s9, xr, y9, g_y, g_s), 10)}
    for k in (1, 9, 15):
        for t, x, s in ((T_ENV, xr, s15[..., :k, :]), (4 * T_ENV, x15,
                                                       s15[..., :k, :])):
            calls[f"biquad_scan_k{k}_{t}"] = (
                (lambda c, s, x: lambda m: m.biquad_cascade(c, s, x))(
                    c15[:k], s.contiguous(), x), 10)
    for name, (fn, reps) in calls.items():
        if args.cases is not None and name not in args.cases:
            continue
        if other_bq is None or "biquad_scan" not in other:
            print(f"{name}: skipped (the other checkout has no biquad_scan)",
                  flush=True)
            continue
        fns = {"other": (other, (lambda f: lambda: f(other_bq))(fn)),
               "this": (this, (lambda f: lambda: f(bq))(fn))}
        outs = {}
        for who, (libs, f) in fns.items():
            with using(libs):
                outs[who] = [v for v in f() if v is not None]
        torch.cuda.synchronize()
        same = len(outs["this"]) == len(outs["other"]) and all(
            torch.equal(a, b) for a, b in zip(outs["this"], outs["other"]))
        ok = ok and same
        times = []
        for who in ("other", "this", "this", "other"):
            with using(fns[who][0]):
                times.append(time_ms(fns[who][1], reps))
        res[name] = dict(identical=same, other_ms=(times[0] + times[3]) / 2,
                         this_ms=(times[1] + times[2]) / 2, runs_ms=times)
        print(f"{name}: identical = {same}; other {res[name]['other_ms']:.4f}"
              f" ms, this {res[name]['this_ms']:.4f} ms (runs: "
              + ", ".join(f"{t:.4f}" for t in times) + ")", flush=True)
    return ok


def fft_adjoint_cases(args, this, other, other_fp, res) -> bool:
    """#1's adjoints at step's shapes and step_ring's zero-pad one, each
    build's route through its own ops/fft_packed.py (the C interfaces
    differ): every output bit for bit the other build's, the route's time
    in turns, and each build's launches of a call with their bytes
    bounds (torch.profiler after uncounted calls)."""
    ok = True
    gen = torch.Generator().manual_seed(34)
    for mode in ADJOINT_MODES:
        name = f"fft_adjoint_{mode}"
        if args.cases is not None and name not in args.cases:
            continue
        if other_fp is None or "fft_packed" not in other:
            print(f"{name}: skipped (the other checkout has no fft_packed)",
                  flush=True)
            continue
        a = adjoint_args(mode, gen)
        fn_name = ("irfft_packed_bwd" if mode.startswith("irfft")
                   else "rfft_packed_bwd")
        fns = {"other": (other, (lambda f: lambda: f(*a))(
                   getattr(other_fp, fn_name))),
               "this": (this, (lambda f: lambda: f(*a))(
                   getattr(fp, fn_name)))}
        outs, prof = {}, {}
        for who, (libs, fn) in fns.items():
            with using(libs):
                out = fn()
                outs[who] = out if isinstance(out, tuple) else (out,)
                prof[who] = launch_profile(fn, C, B, 1, 2,
                                           bytes_of=adjoint_bytes(mode))
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(outs["this"], outs["other"]))
        ok = ok and same
        times = []
        for who in ("other", "this", "this", "other"):
            with using(fns[who][0]):
                times.append(time_ms(fns[who][1], 50))
        res[name] = dict(identical=same, other_ms=(times[0] + times[3]) / 2,
                         this_ms=(times[1] + times[2]) / 2, runs_ms=times,
                         other_launches=prof["other"],
                         this_launches=prof["this"])
        print(f"{name}: identical = {same}; route other "
              f"{res[name]['other_ms']:.4f} ms, this "
              f"{res[name]['this_ms']:.4f} ms (runs: "
              + ", ".join(f"{t:.4f}" for t in times) + ")", flush=True)
        for who in ("other", "this"):
            print(f"  {who}: " + "; ".join(
                f"{r['name'][:48]} {r['ms']:.4f} ms x {r['launches']}"
                + ("" if r["bound_ms"] is None else
                   f" (bound {r['bound_ms']:.4f})") for r in prof[who]),
                flush=True)
    return ok


def env_bwd_bytes(t: int, n: int):
    """Bytes one launch of the envelope backwards must move at [C, t]
    (window n), by short name (tools/launch_profile.py): the functions'
    inputs read once and outputs written once.  An untemplated
    chain_dyn_bwd (an older build's) takes x and replays the level and
    envelope; this tree's, templated, takes the saved level and envelope
    too."""
    row, knee = F32 * C * t, 8 * 16 * C
    table = {
        # x, env, g_env in; g_x out; the state and its cotangents
        "peak_envelope_bwd_kernel": 4 * row + F32 * 8 * C,
        "tau_sums_kernel": F32 * (2 * C + 2),
        # x, g_y in, g_x out (+ level, env saved); the window's cotangents
        "chain_dyn_bwd": 3 * row + F32 * (2 * C * n + 8 * C) + knee,
        "chain_dyn_bwd<": 5 * row + F32 * (2 * C * n + 8 * C) + knee,
        "chain_dyn_sums": F32 * (2 * C + 18) + knee,
    }

    def of(name):
        key = name if name in table else name.split("<")[0] + "<"
        return table.get(key, table.get(name.split("<")[0]))
    return of


def env_bwd_cases(args, this, other, other_env, chain, cp, blocks, lev, st24,
                  res) -> bool:
    """The envelope backwards against the other build: peak_envelope_bwd
    at [C, T_ENV] in step's configuration (hold 0 from env_init) and with
    a hold of 24 from a random state, through this checkout's wrapper on
    either library (its C interface is unchanged); chain_dyn_bwd at [C,
    B], N = 480, the chain's compressor, from the window and state after
    three blocks (hold 0) and from the random state with a hold of 24,
    through each checkout's own ops/env.py, both given the level and
    envelope this tree's saving forward kernel wrote (a build whose
    kernel replays them ignores them).
    Every output bit for bit (the knee fields' float64 partial sums may
    move by 1 float32 ulp); times in turns; each build's launches; this
    tree's forward with and without saving."""
    gen = torch.Generator().manual_seed(34)

    def r(*shape):
        return torch.randn(*shape, generator=gen).cuda()
    n_sc, g_sc = chain.sidechain.reactivity, float(chain.sidechain.gain)
    knobs = (cp.tau_attack, cp.tau_release)
    cases = {}

    def wanted(name):
        return args.cases is None or name in args.cases
    for name, s0, hold in (("peak_envelope_bwd_step", dyn.env_init((C,)),
                            cp.hold),
                           ("peak_envelope_bwd_hold24", st24, 24)):
        if not wanted(name) or "env_units" not in other:
            continue
        _, env_l = eu.peak_envelope(s0, lev, *knobs, hold, cp.release_thresh)
        a = (lev, env_l, *s0, r(C, T_ENV), r(C), r(C), *knobs, hold,
             cp.release_thresh)
        fn = (lambda a: lambda: eu.peak_envelope_bwd(*a))(a)
        cases[name] = dict(t=T_ENV, other=(fn, fn), this=(fn, fn),
                           fwd=None)
    dyn_names = ("chain_dyn_bwd", "chain_dyn_bwd_hold24")
    if not any(wanted(n) for n in dyn_names) or "env" not in other \
            or other_env is None:
        dyn_names = ()
    win_c, st_c = torch.zeros(C, n_sc, device="cuda"), dyn.env_init((C,))
    for x_b, _ in blocks[:3 if dyn_names else 0]:
        win_c, st_c, _ = env_ops.chain_dyn(
            win_c, st_c, x_b * 8.0, n_sc, g_sc, *knobs, cp.release_thresh,
            cp.hold, cp.knees)
    x_c = blocks[3][0] * 8.0
    cot = (r(C, n_sc), r(C), r(C), r(C, B)) if dyn_names else ()
    for name, s0, hold in zip(dyn_names, (st_c, st24), (cp.hold, 24)):
        if not wanted(name):
            continue
        fa = (win_c, s0, x_c, n_sc, g_sc, *knobs, cp.release_thresh, hold,
              cp.knees)
        a = (win_c, s0, x_c, *cot, n_sc, g_sc, *knobs, cp.release_thresh,
             hold, cp.knees)
        with using(this):
            saved = env_ops._chain_dyn(*fa, save=True)[3:]
        ob = other_env.chain_dyn_bwd
        cases[name] = dict(
            t=B, other=((lambda a, s: lambda: ob(*a, saved=s, replay=True))(
                a, saved), (lambda a, s: lambda: ob(*a, saved=s))(a, saved)),
            this=((lambda a, s: lambda: env_ops.chain_dyn_bwd(
                *a, saved=s, replay=True))(a, saved),
                (lambda a, s: lambda: env_ops.chain_dyn_bwd(
                    *a, saved=s))(a, saved)),
            fwd=((lambda f: lambda: env_ops._chain_dyn(*f))(fa),
                 (lambda f: lambda: env_ops._chain_dyn(*f, save=True))(fa)))
    ok = True
    for name in ("peak_envelope_bwd_step", "peak_envelope_bwd_hold24",
                 "chain_dyn_bwd", "chain_dyn_bwd_hold24"):
        if wanted(name) and name not in cases:
            print(f"{name}: skipped (the other checkout has no "
                  f"{LIB_OF.get(name, 'env_units')})", flush=True)
    for name, cs in cases.items():
        t = cs["t"]
        outs, prof = {}, {}
        for who, libs in (("other", other), ("this", this)):
            with using(libs):
                outs[who] = [o for o in cs[who][0]()]
                prof[who] = launch_profile(cs[who][1], C, t, 0, 0,
                                           bytes_of=env_bwd_bytes(t, n_sc))
        torch.cuda.synchronize()
        diff = [i for i, (a, b) in enumerate(zip(outs["this"], outs["other"]))
                if not torch.equal(a.view(torch.int32), b.view(torch.int32))]
        knee_ulps = None
        if name.startswith("chain"):
            knee_ulps = int(ulps(outs["this"][5], outs["other"][5]).max())
        allowed = {5} if knee_ulps is not None and knee_ulps <= 1 else set()
        ok = ok and len(outs["this"]) == len(outs["other"]) \
            and set(diff) <= allowed
        times = []
        for who in ("other", "this", "this", "other"):
            with using(other if who == "other" else this):
                times.append(time_ms(cs[who][1], 20))
        rec = dict(identical=not diff, differing_outputs=diff,
                   knee_max_ulps=knee_ulps,
                   other_ms=(times[0] + times[3]) / 2,
                   this_ms=(times[1] + times[2]) / 2, runs_ms=times,
                   other_launches=prof["other"], this_launches=prof["this"],
                   chain_bound_ms=t * 12 / SM_HZ * 1e3)
        for who in ("other", "this"):
            rec[f"{who}_cycles_per_step"] = rec[f"{who}_ms"] * 1e-3 * SM_HZ / t
        if cs["fwd"]:
            ft = []
            with using(this):
                for k in (0, 1, 1, 0):
                    ft.append(time_ms(cs["fwd"][k], 20))
            rec.update(this_fwd_ms=(ft[0] + ft[3]) / 2,
                       this_fwd_save_ms=(ft[1] + ft[2]) / 2, fwd_runs_ms=ft)
        res[name] = rec
        print(f"{name}: identical = {not diff} (outputs differing: {diff}"
              + ("" if knee_ulps is None else
                 f", knee fields max {knee_ulps} ulp")
              + f"); other {rec['other_ms']:.4f} ms "
              f"({rec['other_cycles_per_step']:.1f} cycles a step), this "
              f"{rec['this_ms']:.4f} ms ({rec['this_cycles_per_step']:.1f});"
              f" chain bound {rec['chain_bound_ms']:.4f} ms (runs: "
              + ", ".join(f"{v:.4f}" for v in times) + ")"
              + ("" if not cs["fwd"] else
                 f"; this forward {rec['this_fwd_ms']:.4f} ms, saving "
                 f"{rec['this_fwd_save_ms']:.4f}"), flush=True)
        for who in ("other", "this"):
            print(f"  {who}: " + "; ".join(
                f"{x['name']} {x['ms']:.4f} ms x {x['launches']}"
                + ("" if x["bound_ms"] is None else
                   f" (bound {x['bound_ms']:.4f})") for x in prof[who]),
                flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="run only these cases (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    # the libraries the chosen cases need (with --cases), else all
    need = set(SIGS) if args.cases is None else {
        LIB_OF.get(n, "env_units") for n in args.cases}
    this = {n: _build.load(n, s) for n, s in SIGS.items() if n in need}
    csrc = os.path.join(args.other, "lsp_dsp_units_tpu_torch", "csrc")
    other_ff = other_module(args.other, "fdl_fused")
    other_env = other_module(args.other, "env")
    other_fp = other_module(args.other, "fft_packed")
    other_bq = other_module(args.other, "biquad")
    own_sigs = {"fdl_fused": other_ff, "env": other_env,
                "fft_packed": other_fp}
    scan_sigs = getattr(other_bq, "_SCAN_SIGS", None)
    if other_env is not None:
        share_structs(other_env, env_ops)
    other = {n: build_other(args.other, n, scan_sigs if n == "biquad_scan"
                            else own_sigs[n]._SIGS if own_sigs.get(n)
                            else None)
             for n in SIGS if n in need
             and os.path.exists(os.path.join(csrc, f"{n}.cu"))}

    chain = pipeline.FilterConvChain(SR, C, rank=RANK, ir_seconds=1.0)
    params = chain.build()
    cp = params.comp
    gen = torch.Generator().manual_seed(31)
    blocks = []
    for _ in range(params.h_re.shape[0] + 2):
        x = (torch.randn(C, B, generator=gen) * 0.25).cuda()
        blocks.append((x, fp.rfft_packed_zeropad_plain(x)))
    swell = torch.sin(torch.linspace(0.0, torch.pi, T_ENV))
    lev = (torch.randn(C, T_ENV, generator=gen).abs() * 0.6 * swell).cuda()
    st24 = dyn.EnvState(torch.rand(C, generator=gen).cuda(),
                        torch.rand(C, generator=gen).cuda(),
                        torch.randint(0, 25, (C,), generator=gen,
                                      dtype=torch.int32).cuda())
    gp = Gate(SR, threshold=0.2, zone=0.5, hyst_threshold=0.15,
              attack_ms=2.0, release_ms=20.0, hold_ms=0.5).build()
    gp0 = gp._replace(hold=0)
    glev = lev.clone()
    glev[:, T_ENV // 2:] *= 0.02
    cur0 = torch.zeros(C, dtype=torch.int32, device="cuda")
    ring_t = fftconv.init_ring_fdl(params.h_spectra, (C,), packed=True)
    eqp = params.eq_block
    sv0 = torch.zeros(C, eqp.m_mat.shape[0], device="cuda")
    x0, xs0 = blocks[0]
    n_sc, g_sc = chain.sidechain.reactivity, float(chain.sidechain.gain)
    win = ((torch.randn(C, n_sc, generator=gen) * 0.25) ** 2).cuda()
    win_d = torch.zeros(C, n_sc, device="cuda")
    xr = (torch.randn(C, T_ENV, generator=gen) * 0.25).cuda()
    sample = (torch.randn(SR, generator=gen) * 0.25).numpy()
    bank_p, _, _ = dm.build_bank_padded([sample], VBLOCK)
    lim = bank_p.shape[0] - VBLOCK - slicedma.SLACK
    edge = [0, 1, 2, 3, 1023, 1024, lim - 1, lim, lim + 5, -7]
    starts = torch.cat([torch.tensor(edge, dtype=torch.int32), torch.randint(
        0, lim, (VOICES - len(edge),), generator=gen,
        dtype=torch.int32)]).cuda()

    def flat(out):
        return [t for o in out for t in (o if isinstance(o, tuple) else (o,))]

    eq = flt.Equalizer(SR, filters=8, iir_block=None)
    for i, p in enumerate(pipeline.default_eq_params(SR)):
        eq.set_params(i, p)
    c9 = eq.build().coeffs
    bell = flt.FilterParams(ftype=flt.FilterType.BT_BWC_BELL, freq=1000.0,
                            slope=2, quality=0.7)
    cdyn = dynf._design_per_sample(
        bell, (10.0 ** ((-12.0 + 24.0 * swell) / 20.0)).cuda().expand(
            C, T_ENV), SR)
    s9 = (torch.randn(C, c9.shape[0], 2, generator=gen) * 0.1).cuda()
    s4 = (torch.randn(C, cdyn.shape[-2], 2, generator=gen) * 0.1).cuda()

    gen_s = torch.Generator().manual_seed(32)
    c15 = Oversampler(SR, 4, "x3", True).filter_coeffs
    x15 = (torch.randn(C, 4 * T_ENV, generator=gen_s) * 0.25).cuda()
    s15 = (torch.randn(C, c15.shape[0], 2, generator=gen_s) * 0.1).cuda()

    rise = torch.linspace(0.1, 1.5, T_ENV)
    sc = (torch.randn(C, T_ENV, generator=gen) * rise).abs().cuda()
    lims = {"limiter": Limiter(SR, LimiterMode.HERM_THIN, threshold=0.8,
                               lookahead_ms=2.0),
            "limiter_alr": Limiter(SR, LimiterMode.EXP_WIDE, threshold=0.8,
                                   lookahead_ms=5.0, alr=True)}
    lim_args = {k: (v.build(), (0.9 + 0.1 * torch.rand(
        C, 5 * v.lookahead, generator=gen)).cuda(),
        (torch.rand(C, generator=gen) * 0.5).cuda(), sc, v.lookahead, v.alr)
        for k, v in lims.items()}
    ag = AutoGain(SR, quick_amplifier=True, use_max_gain=True, max_gain=3.0)
    ag_st = ag.init_state((C,))
    ag0 = AutoGain(SR, long_grow_db_s=60.0, long_fall_db_s=60.0)
    ag_in = (lev, (lev * 1.3).contiguous(), torch.full((C, 1), 0.2,
                                                       device="cuda"))
    dp = DynamicProcessor(SR, out_ratio=2.0, hold_ms=1.0,
                          attack_time_ms=[5, 1, 2, 3, 4],
                          release_time_ms=[50, 20, 30, 40, 60])
    for i, lv in enumerate((0.05, 0.1, 0.3, 0.6)):
        dp.set_dot(i, lv, lv * 0.7, 0.8)
        dp.set_attack_level(i, lv)
        dp.set_release_level(i, lv * 0.8)
    dpp = dp.build()
    sag = SimpleAutoGain(SR, grow_db_s=120.0, deviation=1.5)
    surge = SurgeProtector(0.1, 0.01, 100, 2000)
    pm = PeakMeter(SR, hold_ms=2.0, release_ms=50.0)
    ph = ((torch.arange(T_ENV, dtype=torch.float64)[None, :] * (0.7 / SR)
           + torch.arange(C)[:, None] / C) % 1.0).float()
    dly = (lfo.sine(ph, quick=True) * DELAY_MAX).to(torch.int32).cuda()
    fdly = torch.randint(0, DELAY_MAX, (C, T_ENV), generator=gen,
                         dtype=torch.int32).cuda()
    dring = (torch.randn(C, DELAY_MAX + 1, generator=gen) * 0.25).cuda()
    g05 = torch.tensor(0.5, device="cuda")
    # the backwards' saved inputs, from this checkout's saving forwards
    gen_b = torch.Generator().manual_seed(34)
    g_y = torch.randn(C, T_ENV, generator=gen_b).cuda()
    gs9, gs4 = (torch.randn(C, k, 2, generator=gen_b).cuda() for k in (
        c9.shape[0], cdyn.shape[-2]))
    g_ring = torch.randn(C, DELAY_MAX + 1, generator=gen_b).cuda()
    sig9 = bq._seq_cuda(c9, s9, xr, False, save=True)[2]
    sig4 = bq._seq_cuda(cdyn, s4, xr, True, save=True)[2]
    s_dly = delay_ops._delay_cuda(dring, xr, dly, g05, fdly, DELAY_MAX,
                                  save=True)[2]
    seq_bwd = {
        "biquad_seq_bwd": lambda: bq.biquad_cascade_seq_bwd(
            c9, s9, xr, sig9, g_y, gs9),
        "biquad_seq_bwd_x": lambda: bq.biquad_cascade_seq_bwd(
            c9, s9, xr, None, g_y, gs9, False)[1:],
        "biquad_seq_bwd_dyn": lambda: bq.dyn_biquad_cascade_seq_bwd(
            cdyn, s4, xr, sig4, g_y, gs4),
        "delay_bwd": lambda: delay_ops.dynamic_delay_bwd(
            dring, xr, dly, g05, fdly, s_dly, g_y, g_ring, DELAY_MAX),
    }
    trgs = {tt: Trigger(tt, TriggerMode.REPEAT, threshold=0.3,
                        hysteresis=0.1, hold_samples=24)
            for tt in TriggerType}
    tst = trgs[TriggerType.NONE].init_state("cuda")
    tst = tst._make(torch.stack([f] * C) for f in tst)
    dpops = {m: Depopper(SR, fade_in_mode=m) for m in DepopperMode}
    dst = tuple(torch.zeros(C, dtype=torch.int32, device="cuda")
                for _ in range(3))
    light = {
        "rider_simple": (lambda: riders.simple_autogain(
            sag, sag.init_state((C,)), lev, ag_in[2])),
        "rider_surge": (lambda: riders.surge_protector(
            surge, surge.init_state((C,)), xr)),
        "rider_peak": (lambda: riders.peak_meter(pm, pm.init_state((C,)),
                                                 xr)),
    }

    n_fft = 2 * B
    x_fft = (torch.randn(C, n_fft, generator=gen) * 0.25).cuda()
    s_fft = fp.rfft_packed(x_fft)
    fft_calls = {
        "rfft": lambda: fp.rfft_packed(x_fft),
        "rfft_zeropad": lambda: fp.rfft_packed_zeropad(x0),
        "irfft": lambda: (fp.irfft_packed(*s_fft, n_fft),),
        "irfft_first": lambda: (fp.irfft_packed(*s_fft, n_fft, "first"),),
        "irfft_last": lambda: (fp.irfft_packed(*s_fft, n_fft, "last"),)}
    cases = {
        **{f"fft_{k}": (lambda f: (lambda: list(f()), f, 50))(f)
           for k, f in fft_calls.items()},
        **{k: (lambda a: (lambda: list(lim_ops.limiter(*a)),
                          lambda: lim_ops.limiter(*a), 10))(a)
           for k, a in lim_args.items()},
        "rider_autogain": (lambda: flat(riders.autogain(ag, ag_st, *ag_in)),
                           lambda: riders.autogain(ag, ag_st, *ag_in), 10),
        "rider_autogain_default": (
            lambda: flat(riders.autogain(ag0, ag_st, *ag_in)),
            lambda: riders.autogain(ag0, ag_st, *ag_in), 10),
        "rider_dynproc": (lambda: flat(riders.dynproc_envelope(
            dpp, st24, lev)), lambda: riders.dynproc_envelope(
            dpp, st24, lev), 10),
        **{k: (lambda f: (lambda: flat(f()), f, 10))(f)
           for k, f in light.items()},
        "eqfdl_fused": (lambda: eqfdl_run(params, blocks), lambda: (
            ff.eqfdl_fused(ring_t.spec_re, ring_t.spec_im, params.h_re,
                           params.h_im, params.heq_re, params.heq_im, *xs0,
                           x0, sv0, eqp.g_t, eqp.m_mat, eqp.w_mat,
                           ring_t.history, 1)), 50),
        "chain_dyn": (lambda: dyn_run(chain, cp, blocks), lambda: (
            env_ops.chain_dyn(win_d, dyn.env_init((C,)), x0 * 8.0, n_sc,
                              g_sc, cp.tau_attack, cp.tau_release,
                              cp.release_thresh, cp.hold, cp.knees)), 20),
        "fdl_fused": (lambda: fdl_run(params, blocks), lambda: ff.fdl_fused(
            ring_t.spec_re, ring_t.spec_im, params.h_re, params.h_im,
            ring_t.history, x0, 1), 50),
        "peak_envelope_step": (lambda: flat(eu.peak_envelope(
            dyn.env_init((C,)), lev, cp.tau_attack, cp.tau_release,
            cp.hold, cp.release_thresh)), lambda: eu.peak_envelope(
            dyn.env_init((C,)), lev, cp.tau_attack, cp.tau_release,
            cp.hold, cp.release_thresh), 20),
        "peak_envelope_hold24": (lambda: flat(eu.peak_envelope(
            st24, lev, cp.tau_attack, cp.tau_release, 24,
            cp.release_thresh)), lambda: eu.peak_envelope(
            st24, lev, cp.tau_attack, cp.tau_release, 24,
            cp.release_thresh), 20),
        "gate_envelope": (lambda: flat(eu.gate_envelope(
            dyn.env_init((C,)), cur0, glev, gp.tau_attack, gp.tau_release,
            gp.hold, gp.knees[0].end, gp.knees[1].start)), lambda: (
            eu.gate_envelope(dyn.env_init((C,)), cur0, glev, gp.tau_attack,
                             gp.tau_release, gp.hold, gp.knees[0].end,
                             gp.knees[1].start)), 20),
        "gate_envelope_hold0": (lambda: flat(eu.gate_envelope(
            dyn.env_init((C,)), cur0, glev, gp0.tau_attack, gp0.tau_release,
            gp0.hold, gp0.knees[0].end, gp0.knees[1].start)), lambda: (
            eu.gate_envelope(dyn.env_init((C,)), cur0, glev, gp0.tau_attack,
                             gp0.tau_release, gp0.hold, gp0.knees[0].end,
                             gp0.knees[1].start)), 20),
        "sliding_rms": (lambda: list(eu.sliding_rms(win, xr, n_sc, g_sc)),
                        lambda: eu.sliding_rms(win, xr, n_sc, g_sc), 50),
        "batched_slice": (lambda: [slicedma.batched_slice(bank_p, starts,
                                                          VBLOCK)],
                          lambda: slicedma.batched_slice(bank_p, starts,
                                                         VBLOCK), 100),
        "biquad_seq": (lambda: list(bq.biquad_cascade_seq(c9, s9, xr)),
                       lambda: bq.biquad_cascade_seq(c9, s9, xr), 20),
        "biquad_seq_dyn": (lambda: list(bq.dyn_biquad_cascade_seq(
            cdyn, s4, xr)), lambda: bq.dyn_biquad_cascade_seq(cdyn, s4, xr),
            20),
        "delay": (lambda: list(delay_ops.dynamic_delay(
            dring, xr, dly, g05, fdly, DELAY_MAX)), lambda: (
            delay_ops.dynamic_delay(dring, xr, dly, g05, fdly, DELAY_MAX)),
            10),
        "delay_save": (lambda: list(delay_ops._delay_cuda(
            dring, xr, dly, g05, fdly, DELAY_MAX, save=True)), lambda: (
            delay_ops._delay_cuda(dring, xr, dly, g05, fdly, DELAY_MAX,
                                  save=True)), 10),
        **{k: (lambda f: (lambda: list(f()), f, 10))(f)
           for k, f in seq_bwd.items()},
        **{TRIGGER_CASE[tt]: (lambda u: (
            lambda: flat(riders.trigger(u, tst, xr)),
            lambda: riders.trigger(u, tst, xr), 10))(u)
           for tt, u in trgs.items()},
        **{DEPOPPER_CASE[m]: (lambda u: (
            lambda: flat(riders.depopper_forward(u, dst, glev)),
            lambda: riders.depopper_forward(u, dst, glev), 10))(u)
           for m, u in dpops.items()},
    }
    lib_of = LIB_OF
    functor = {**{TRIGGER_CASE[tt]: riders.KIND["trigger"] + tt.value
                  for tt in TriggerType},
               **{k: riders.KIND["depopper"] for k in DEPOPPER_CASE.values()}}
    res, ok = {}, True
    for name, (run, call, reps) in cases.items():
        if args.cases is not None and name not in args.cases:
            continue
        if lib_of.get(name, "env_units") not in other:
            print(f"{name}: skipped (the other checkout has no "
                  f"{lib_of.get(name, 'env_units')}.cu)", flush=True)
            continue
        if name in functor and other["riders"].lsp_rider_chain_ops(
                functor[name]) < 0:
            print(f"{name}: skipped (the other riders.cu has no such step "
                  f"functor)", flush=True)
            continue
        with using(other):
            want = run()
        with using(this):
            got = run()
        torch.cuda.synchronize()
        diff = [i for i, (a, b) in enumerate(zip(got, want))
                if not torch.equal(a, b)]
        same = len(got) == len(want) and not diff
        extra, allowed = {}, set()
        if name == "sliding_rms":
            # the level, a float64 sum rounded once in another order, may
            # differ by at most 1 ulp
            d = ulps(got[1], want[1])
            ideal = rms_ideal(win, xr, n_sc, g_sc)
            extra = dict(differing_samples=int((d > 0).sum()),
                         max_ulps=int(d.max()),
                         this_db_vs_float64=snr_db(ideal, got[1]),
                         other_db_vs_float64=snr_db(ideal, want[1]))
            allowed = {1} if extra["max_ulps"] <= 1 else set()
        ok = ok and len(got) == len(want) and set(diff) <= allowed
        times = []
        for libs in (other, this, this, other):
            with using(libs):
                times.append(time_ms(call, reps))
        res[name] = dict(identical=same, differing_outputs=diff,
                         other_ms=(times[0] + times[3]) / 2,
                         this_ms=(times[1] + times[2]) / 2, runs_ms=times,
                         **extra)
        if name.startswith("rider_"):
            for who in ("other", "this"):
                res[name][f"{who}_cycles_per_step"] = (
                    res[name][f"{who}_ms"] * 1e-3 * SM_HZ / T_ENV)
            extra = {k: round(res[name][f"{k}_cycles_per_step"], 1)
                     for k in ("other", "this")}
            extra = dict(cycles_a_step=extra)
        print(f"{name}: identical = {same} (outputs differing: {diff}"
              + "".join(f", {k} {v}" for k, v in extra.items())
              + f"); other {res[name]['other_ms']:.4f}"
              f" ms, this {res[name]['this_ms']:.4f} ms (runs: "
              + ", ".join(f"{t:.4f}" for t in times) + ")", flush=True)
    eq_args, fdl_args = bwd_inputs(params, torch.Generator().manual_seed(33))
    k2 = params.eq_block.m_mat.shape[0]
    for name, a in (("eqfdl_fused_bwd", eq_args), ("fdl_fused_bwd", fdl_args)):
        if args.cases is not None and name not in args.cases:
            continue
        if other_ff is None or "fdl_fused" not in other:
            print(f"{name}: skipped (the other checkout has no "
                  f"fdl_fused)", flush=True)
            continue
        fns = {"other": (other, (lambda f, a: lambda: f(*a))(
                   getattr(other_ff, name), a)),
               "this": (this, (lambda f, a: lambda: f(*a))(
                   getattr(ff, name), a))}
        outs, times, prof = {}, [], {}
        for who, (libs, fn) in fns.items():
            with using(libs):
                outs[who] = fn()
                prof[who] = launch_profile(fn, C, B, params.h_re.shape[0],
                                           k2)
        plain = getattr(ff, f"{name}_plain")(*a)
        dbs = [snr_or_same(p, t) for p, t in zip(plain, outs["this"])]
        other_dbs = [snr_or_same(p, o) for p, o in zip(plain, outs["other"])]
        same = [i for i, (t, o) in enumerate(zip(outs["this"], outs["other"]))
                if torch.equal(t, o)]
        ok = ok and min(dbs) >= BWD_DB
        for who in ("other", "this", "this", "other"):
            with using(fns[who][0]):
                times.append(time_ms(fns[who][1], 20))
        res[name] = dict(db_vs_plain=min(dbs), other_db_vs_plain=min(
            other_dbs), identical_outputs=same,
            other_ms=(times[0] + times[3]) / 2,
            this_ms=(times[1] + times[2]) / 2, runs_ms=times,
            other_launches=prof["other"], this_launches=prof["this"])
        print(f"{name}: vs plain >= {min(dbs):.1f} dB (other build "
              f"{min(other_dbs):.1f}), outputs identical to the other "
              f"build's: {same}; other {res[name]['other_ms']:.4f} ms, this "
              f"{res[name]['this_ms']:.4f} ms (runs: "
              + ", ".join(f"{t:.4f}" for t in times) + ")", flush=True)
        for who in ("other", "this"):
            print(f"  {who}: " + "; ".join(
                f"{r['name']} {r['ms']:.4f} ms x {r['launches']}"
                + ("" if r["bound_ms"] is None else
                   f" (bound {r['bound_ms']:.4f})") for r in prof[who]),
                flush=True)
    ok = scan_cases(args, this, other, other_bq, c9, s9, xr, res) and ok
    ok = fft_adjoint_cases(args, this, other, other_fp, res) and ok
    ok = env_bwd_cases(args, this, other, other_env, chain, cp, blocks, lev,
                       st24, res) and ok
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = dict(card=card, other=os.path.abspath(args.other), cases=res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
