"""The sequential cascade's forward kernels, the dynamic delay's forward
(both forms) and adjoint and the limiter on the card: their time,
cycles a step and the shape of their inner loops in the SASS; and how
often the delay's steps, in either direction, read a slot that a step
shortly before them wrote.

    python3 -m lsp_dsp_units_tpu_torch.tools.serial_profile [--out F]
    python3 -m lsp_dsp_units_tpu_torch.tools.serial_profile --aliases-only

* biquad_seq (``ops/biquad.biquad_cascade_seq``) at [64, 16384] on the
  chain's 8-band EQ (K = 9, shared coefficients) and its per-sample form
  (``dyn_biquad_cascade_seq``) on DynamicFilters' bell (BT_BWC_BELL,
  slope 2, K = 4) over a -12..+12 dB swell, from random states;
* delay_kernel (``ops/delay.dynamic_delay``; ``delay_save``: its saving
  form, which also writes each step's s) and delay_bwd_kernel
  (``ops/delay.dynamic_delay_bwd``) at [64, 16384] on
  chip_smoke.py's synth drive (a ring of 4801, each channel's delay swept
  by the LFO's quick sine at 0.7 Hz, its phases spread over the period,
  the feedback delays uniform from its seed 21, a gain of 0.5), s from
  the saving forward, seeded cotangents;
* limiter_kernel (``ops/limiter.limiter``) at [64, 16384] on the rising
  noise sidechain of tools/ab_kernels.py from a random carry: HERM_THIN
  at 2 ms (``limiter``) and EXP_WIDE at 5 ms with ALR (``limiter_alr``),
  with the most and the mean of the rows' pass counts;
* each kernel's time by CUDA events behind a spin kernel, its cycles a
  step (ms x the SM clock that nvidia-smi reads after the run / T), and
  for each of its compiled functions the largest basic block of the SASS
  (cuobjdump beside nvcc): instructions, static stall cycles (bits 41-44
  of an instruction's second word) and the count of each opcode;
* the delay adjoint's alias counts on the same drive (index arithmetic
  alone, no card needed: ``--aliases-only``): the share of steps, taken
  in reverse time as the adjoint runs them, that read (tail, feed or
  head) a slot which one of the last 1, 2, 4, 8, 16, 32 or 128 steps
  before it wrote (its tail or its head); and delay_bwd_kernel's batches
  on it (``adjoint_rounds``): the share of reads that take a W or a zero
  from a step before in the batch, and the rounds a batch takes;
* the same for the forward, in forward time (``forward_alias_counts``):
  the share of steps whose tail or feed read meets a slot that one of
  the last n steps wrote, split by the write: a head write (x, known
  before the run) or a feed write (r, the chain); and delay_kernel's
  batches of 32 (``forward_rounds``): the share of reads that take an
  x or an r from a step before in the batch (or the step's own x), and
  the rounds a batch takes.

Prints one JSON object, with the card's name and power limit."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

C, SR, T = 64, 48000, 16384
MAX_DELAY = 4800                 # chip_smoke.py's SYN_MAX_DELAY
SPANS = (1, 2, 4, 8, 16, 32, 128)


def synth_drive(t: int = T):
    """chip_smoke.py's synth drive, its first ``t`` samples: the LFO
    delays and the seeded feedback delays, int32 numpy [C, t]."""
    from lsp_dsp_units_tpu_torch.models.misc import lfo
    n = torch.arange(2 * T, dtype=torch.float64)
    ph = ((n[None, :] * (0.7 / SR) + torch.arange(C)[:, None] / C)
          % 1.0).float()
    d = (lfo.sine(ph, quick=True) * MAX_DELAY).to(torch.int32).numpy()
    rng = np.random.default_rng(21)
    rng.standard_normal((C, 2 * T))
    fd = rng.integers(0, MAX_DELAY, (C, 2 * T)).astype(np.int32)
    return d[:, :t], fd[:, :t]


def alias_counts(delay, fdelay, max_delay: int, spans=SPANS) -> dict:
    """The share of the adjoint's steps whose reads (tail, feed, head)
    meet a slot that one of the ``span`` steps run before it (the next
    ``span`` samples in time) wrote (tail or head), for each span."""
    m = max_delay + 1
    t = delay.shape[-1]
    d = np.clip(delay, 0, max_delay)
    f = np.minimum(np.clip(fdelay, 0, None), d)
    head = np.broadcast_to(np.arange(t) % m, d.shape)
    tail = (head - d) % m
    feed = (tail + f) % m
    dist = np.full(d.shape, np.iinfo(np.int64).max)
    for s in range(max(spans), 0, -1):
        hit = np.zeros((d.shape[0], t - s), bool)
        for r in (tail, feed, head):
            for w in (tail, head):
                hit |= r[:, :t - s] == w[:, s:]
        dist[:, :t - s] = np.where(hit, s, dist[:, :t - s])
    return {str(s): float((dist <= s).mean()) for s in spans}


def adjoint_rounds(delay, fdelay, max_delay: int) -> dict:
    """delay_bwd_kernel's batches over a drive, as csrc/delay.cu runs
    them (32 steps a batch in reverse time): the share of the steps' tail
    and feed reads that take a W from a step before in the batch, the
    share that take a zero, and the rounds a batch runs (one, and one
    more for each step of its longest chain of such steps): their mean
    and most."""
    m = max_delay + 1
    rows, t_n = delay.shape
    nb = t_n // 32
    t = np.arange(t_n - 1, -1, -1)[:nb * 32]
    d = np.clip(delay[:, t], 0, max_delay).reshape(rows, nb, 32)
    f = np.minimum(np.clip(fdelay[:, t], 0, None).reshape(rows, nb, 32), d)
    head = np.broadcast_to((t % m).reshape(nb, 32), d.shape)
    tail = (head - d) % m
    feed = (tail + f) % m
    p = np.arange(32)

    def src(x):
        kw = np.full(x.shape, -1)
        for k in range(32):
            kw = np.where((k < p) & (tail[..., k:k + 1] == x), k, kw)
        u = (x - head) % m
        kz = p - np.where(u == 0, m, u)
        return np.where(np.maximum(kw, kz) < 0, -1,
                        np.where(kz >= kw, 32, kw))

    st, sf = src(tail), np.where(f == 0, -1, src(feed))
    depth = np.zeros(d.shape, int)
    for q in range(32):
        for s in (st, sf):
            lane = s[..., q]
            dep = (lane >= 0) & (lane < 32)
            src_depth = np.take_along_axis(depth, np.clip(lane, 0, 31)[
                ..., None], -1)[..., 0]
            depth[..., q] = np.maximum(depth[..., q],
                                       np.where(dep, src_depth + 1, 0))
    rounds = np.where(depth.max(-1) > 0, depth.max(-1) + 1, 1)
    reads = np.concatenate([st.ravel(), sf[f != 0].ravel()])
    return dict(from_w=float(((reads >= 0) & (reads < 32)).mean()),
                from_zero=float((reads == 32).mean()),
                mean_rounds=float(rounds.mean()), max_rounds=int(rounds.max()))


def forward_alias_counts(delay, fdelay, max_delay: int,
                         spans=SPANS) -> dict:
    """The share of the forward's steps whose reads (tail, feed) meet a
    slot that one of the ``span`` steps before it wrote, for each span:
    by a head write (``x_<span>``) and by a feed write (``r_<span>``)."""
    m = max_delay + 1
    t = delay.shape[-1]
    d = np.clip(delay, 0, max_delay)
    f = np.minimum(np.clip(fdelay, 0, None), d)
    head = np.broadcast_to(np.arange(t) % m, d.shape)
    tail = (head - d) % m
    feed = (tail + f) % m
    out = {}
    for name, w in (("x", head), ("r", feed)):
        dist = np.full(d.shape, np.iinfo(np.int64).max)
        for s in range(max(spans), 0, -1):
            hit = np.zeros((d.shape[0], t - s), bool)
            for r in (tail, feed):
                hit |= r[:, s:] == w[:, :t - s]
            dist[:, s:] = np.where(hit, s, dist[:, s:])
        out.update({f"{name}_{s}": float((dist <= s).mean()) for s in spans})
    return out


def forward_rounds(delay, fdelay, max_delay: int) -> dict:
    """delay_kernel's batches over a drive, as csrc/delay.cu runs them
    (32 steps a batch in forward time): the share of the steps' tail and
    feed reads that take the step's own x, an x of a step before in the
    batch, an r of one (the chain), and the rounds a batch runs (one, and
    one more for each step of its longest chain of r sources): their
    mean and most."""
    m = max_delay + 1
    rows, t_n = delay.shape
    nb = t_n // 32
    d = np.clip(delay[:, :nb * 32], 0, max_delay).reshape(rows, nb, 32)
    f = np.minimum(np.clip(fdelay[:, :nb * 32], 0, None).reshape(
        rows, nb, 32), d)
    head = np.broadcast_to((np.arange(nb * 32) % m).reshape(nb, 32),
                           d.shape)
    tail = (head - d) % m
    feed = (tail + f) % m
    p = np.arange(32)

    def src(x, back):
        # 0 load, 1 own x, 2 an x before, 3 an r before; and its lane
        kw = np.full(x.shape, -1)
        for k in range(32):
            kw = np.where((k < p) & (feed[..., k:k + 1] == x), k, kw)
        kx = np.where(back > 0, p - back, -1)
        kind = np.where((kw >= kx) & (kw >= 0), 3, np.where(kx >= 0, 2, 0))
        kind = np.where(x == head, 1, kind)
        return kind, np.where(kind == 3, kw, -1)

    kt, lt = src(tail, d)
    kf, lf = src(feed, d - f)
    depth = np.zeros(d.shape, int)
    for q in range(32):
        for lane in (lt, lf):
            ln = lane[..., q]
            sd = np.take_along_axis(depth, np.clip(ln, 0, 31)[..., None],
                                    -1)[..., 0]
            depth[..., q] = np.maximum(depth[..., q],
                                       np.where(ln >= 0, sd + 1, 0))
    rounds = depth.max(-1) + 1
    kinds = np.concatenate([kt.ravel(), kf.ravel()])
    return dict(own_x=float((kinds == 1).mean()),
                from_x=float((kinds == 2).mean()),
                from_r=float((kinds == 3).mean()),
                mean_rounds=float(rounds.mean()),
                max_rounds=int(rounds.max()))


def limiter_cases(gen):
    """tools/ab_kernels.py's two limiter cases: (name -> limiter's
    arguments) at [C, T] on the rising noise sidechain."""
    from lsp_dsp_units_tpu_torch.models.dynamics import Limiter, LimiterMode
    rise = torch.linspace(0.1, 1.5, T)
    sc = (torch.randn(C, T, generator=gen) * rise).abs().cuda()
    lims = {"limiter": Limiter(SR, LimiterMode.HERM_THIN, threshold=0.8,
                               lookahead_ms=2.0),
            "limiter_alr": Limiter(SR, LimiterMode.EXP_WIDE, threshold=0.8,
                                   lookahead_ms=5.0, alr=True)}
    return {k: (v.build(), (0.9 + 0.1 * torch.rand(
        C, 5 * v.lookahead, generator=gen)).cuda(),
        (torch.rand(C, generator=gen) * 0.5).cuda(), sc, v.lookahead, v.alr)
        for k, v in lims.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--aliases-only", action="store_true",
                    help="only the delay adjoint's alias counts (no card)")
    args = ap.parse_args(argv)
    d_np, fd_np = synth_drive()
    res = dict(delay_aliases=alias_counts(d_np, fd_np, MAX_DELAY),
               delay_rounds=adjoint_rounds(d_np, fd_np, MAX_DELAY),
               forward_aliases=forward_alias_counts(d_np, fd_np, MAX_DELAY),
               forward_rounds=forward_rounds(d_np, fd_np, MAX_DELAY))
    print("delay adjoint, steps reading a slot written within the last n "
          "steps: " + ", ".join(f"{k}: {v:.4f}" for k, v in
                                res["delay_aliases"].items()), flush=True)
    print("delay_bwd_kernel's batches on the drive: " + ", ".join(
        f"{k} {v}" for k, v in res["delay_rounds"].items()), flush=True)
    print("delay forward, steps whose tail or feed read meets a slot "
          "written within the last n steps (x: by a head write, r: by a "
          "feed write): " + ", ".join(f"{k}: {v:.4f}" for k, v in
                                      res["forward_aliases"].items()),
          flush=True)
    print("delay_kernel's batches on the drive: " + ", ".join(
        f"{k} {v}" for k, v in res["forward_rounds"].items()), flush=True)
    if args.aliases_only:
        print(json.dumps(res))
        return 0
    if not torch.cuda.is_available():
        print("serial_profile: no CUDA device", file=sys.stderr)
        return 1
    from lsp_dsp_units_tpu_torch import pipeline
    from lsp_dsp_units_tpu_torch.models import filters as flt
    from lsp_dsp_units_tpu_torch.models.filters import dynamic_filters as dynf
    from lsp_dsp_units_tpu_torch.ops import biquad as bq
    from lsp_dsp_units_tpu_torch.ops import delay as delay_ops
    from lsp_dsp_units_tpu_torch.ops import limiter as lim_ops
    from lsp_dsp_units_tpu_torch.tools.ab_kernels import time_ms
    from lsp_dsp_units_tpu_torch.tools.biquad_profile import sass_loops, smi

    res["card"] = smi("name,power.limit")
    gen = torch.Generator().manual_seed(36)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    eq = flt.Equalizer(SR, filters=8, iir_block=None)
    for i, p in enumerate(pipeline.default_eq_params(SR)):
        eq.set_params(i, p)
    c9 = eq.build().coeffs
    swell = torch.sin(torch.linspace(0.0, torch.pi, T))
    bell = flt.FilterParams(ftype=flt.FilterType.BT_BWC_BELL, freq=1000.0,
                            slope=2, quality=0.7)
    c4 = dynf._design_per_sample(
        bell, (10.0 ** ((-12.0 + 24.0 * swell) / 20.0)).cuda().expand(C, T),
        SR)
    x = r(C, T, scale=0.25)
    s9, s4 = r(C, 9, 2, scale=0.1), r(C, 4, 2, scale=0.1)
    d, fd = (torch.from_numpy(v).cuda() for v in (d_np, fd_np))
    buf = torch.zeros(C, MAX_DELAY + 1, device="cuda")
    g = torch.tensor(0.5, device="cuda")
    s = delay_ops._delay_cuda(buf, x, d, g, fd, MAX_DELAY, save=True)[2]
    g_y, g_buf = r(C, T), r(C, MAX_DELAY + 1)
    ring = r(C, MAX_DELAY + 1, scale=0.25)
    lims = limiter_cases(gen)
    cases = {
        "biquad_seq": lambda: bq.biquad_cascade_seq(c9, s9, x),
        "biquad_seq_dyn": lambda: bq.dyn_biquad_cascade_seq(c4, s4, x),
        "delay": lambda: delay_ops.dynamic_delay(ring, x, d, g, fd,
                                                 MAX_DELAY),
        "delay_save": lambda: delay_ops._delay_cuda(ring, x, d, g, fd,
                                                    MAX_DELAY, save=True),
        "delay_bwd": lambda: delay_ops.dynamic_delay_bwd(
            buf, x, d, g, fd, s, g_y, g_buf, MAX_DELAY),
        **{k: (lambda a: lambda: lim_ops.limiter(*a))(a)
           for k, a in lims.items()}}
    times = {}
    for name, fn in cases.items():
        ms = time_ms(fn, 20)
        sm = smi("clocks.sm")
        hz = float(sm.split()[0]) * 1e6
        times[name] = dict(ms=ms, sm_clock=sm,
                           cycles_per_step=ms * 1e-3 * hz / T)
        extra = ""
        if name in lims:
            passes = fn()[3].float()
            times[name].update(passes_max=int(passes.max()),
                               passes_mean=float(passes.mean()))
            extra = (f", passes: most {times[name]['passes_max']}, mean "
                     f"{times[name]['passes_mean']:.2f}")
        print(f"{name} [{C}, {T}]: {ms:.4f} ms, "
              f"{times[name]['cycles_per_step']:.1f} cycles a step at {sm}"
              + extra, flush=True)
    res["times"] = times
    res["sass"] = {**sass_loops("biquad", "static_kernel"),
                   **sass_loops("biquad", "dyn_kernel"),
                   **sass_loops("delay", "delay_kernel"),
                   **sass_loops("delay", "delay_bwd_kernel"),
                   **sass_loops("limiter", "limiter_kernel")}
    for name, v in res["sass"].items():
        print(f"SASS {name}: largest block {v['instructions']} "
              f"instructions, {v['stall_cycles']} static stall cycles; "
              + ", ".join(f"{k} {n}" for k, n in v["opcodes"].items()),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(dict(card=res["card"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
