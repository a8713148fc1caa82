"""Hold this checkout's EQ + convolver, envelope, sliding RMS and slice
kernels against another checkout's on the card: outputs bit for bit,
device times in turns.

    python3 -m lsp_dsp_units_tpu_torch.tools.ab_kernels OTHER [--out F]

OTHER is the root of another checkout (for a redesign, its parent commit
unpacked with ``git archive``).  Its ``csrc/fdl_fused.cu``,
``csrc/env_units.cu`` and ``csrc/slicedma.cu`` are built with this
checkout's nvcc flags into
``build/lsp_dsp_units_tpu_torch/ab/`` and stand in for this checkout's
libraries during its runs; wrappers, inputs and checks are this
checkout's, so the two builds' C interfaces must match.  At the main
paths' shapes (64 channels, N = 16384, P = 6, the chain's EQ and
compressor):

* eqfdl_fused over P + 2 blocks: y, u, EQ state and ring;
* fdl_fused over P + 2 blocks: y and ring;
* peak_envelope at [64, 16384], threshold on, in step's configuration
  (hold 0 from env_init) and with a hold of 24 samples from a random
  state: envelope, peak and hold;
* gate_envelope at [64, 16384] with a hold of 24 samples and with the
  gate's default hold of 0: envelope, curve track and state;
* sliding_rms at [64, 16384], N = 480: window' and level;
* batched_slice at the sampler's configuration (4096 windows of 1024
  from the padded bank of one 1 s sample; edge, clamped and random
  starts).

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
import json
import os
import subprocess
import sys

import torch

from lsp_dsp_units_tpu_torch import pipeline
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate
from lsp_dsp_units_tpu_torch.models.sampling import device_mix as dm
from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn
from lsp_dsp_units_tpu_torch.ops import env_units as eu
from lsp_dsp_units_tpu_torch.ops import fdl_fused as ff
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.ops import fftconv
from lsp_dsp_units_tpu_torch.ops import slicedma

C, RANK, SR = 64, 14, 48000
B = 1 << (RANK - 1)
T_ENV = 2 * B                        # step's envelope call: [64, 16384]
SIGS = {"fdl_fused": ff._SIGS, "env_units": eu._SIGS,
        "slicedma": slicedma._SIGS}
VOICES, VBLOCK = 4096, 1024          # the sampler's configuration
SPIN_CYCLES = 200_000_000


def build_other(root: str, name: str) -> ctypes.CDLL:
    """Compile ``<root>/lsp_dsp_units_tpu_torch/csrc/<name>.cu`` and load
    it with this checkout's signatures (those it has)."""
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
    for fn, argtypes in SIGS[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
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
        y, u, sv = ff.eqfdl_fused(
            ring.spec_re, ring.spec_im, params.h_re, params.h_im,
            params.heq_re, params.heq_im, *xs, x, sv, eqp.g_t, eqp.m_mat,
            eqp.w_mat, ring.history, w)
        ring = ring._replace(history=u, pos=w)
        outs += [y, u, sv]
    return outs + [ring.spec_re, ring.spec_im]


def fdl_run(params, blocks):
    hp = (params.h_re, params.h_im)
    ring = fftconv.init_ring_fdl(params.h_spectra, (C,), packed=True)
    outs = []
    for x, _ in blocks:
        w = (ring.pos + 1) % hp[0].shape[0]
        outs.append(ff.fdl_fused(ring.spec_re, ring.spec_im, *hp,
                                 ring.history, x, w))
        ring = ring._replace(history=x, pos=w)
    return outs + [ring.spec_re, ring.spec_im]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    this = {n: _build.load(n, s) for n, s in SIGS.items()}
    other = {n: build_other(args.other, n) for n in SIGS}

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

    cases = {
        "eqfdl_fused": (lambda: eqfdl_run(params, blocks), lambda: (
            ff.eqfdl_fused(ring_t.spec_re, ring_t.spec_im, params.h_re,
                           params.h_im, params.heq_re, params.heq_im, *xs0,
                           x0, sv0, eqp.g_t, eqp.m_mat, eqp.w_mat,
                           ring_t.history, 1)), 50),
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
    }
    res, ok = {}, True
    for name, (run, call, reps) in cases.items():
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
        print(f"{name}: identical = {same} (outputs differing: {diff}"
              + "".join(f", {k} {v}" for k, v in extra.items())
              + f"); other {res[name]['other_ms']:.4f}"
              f" ms, this {res[name]['this_ms']:.4f} ms (runs: "
              + ", ".join(f"{t:.4f}" for t in times) + ")", flush=True)
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
