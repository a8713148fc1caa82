"""The two biquad kernels of the time-parallel and the sequential
cascade's backward on the card: how their times scale and where the
scan's backward route spends its time.

    python3 -m lsp_dsp_units_tpu_torch.tools.biquad_profile [--out F]

* biquad_scan (``ops/biquad.biquad_cascade``) at [64, 16384] and
  [64, 65536] with K = 1, 9 and 15 stages of the Oversampler's 4x
  filter (shared coefficients), and the chain's 8-band EQ (K = 9) at
  [64, 16384]: each call's time by CUDA events, and each kernel's time
  a call and launches by torch.profiler;
* the scan's backward route (``biquad_cascade_bwd``, the EQ at [64,
  16384]): its time, the scan kernel's share and every other launch
  (the torch glue) by torch.profiler;
* biquad_seq_bwd (``biquad_cascade_seq_bwd``) at [64, 16384] on the
  EQ with the coefficients' gradient and without, and the per-sample
  form (DynamicFilters' bell, K = 4): time, cycles a step at the SM
  clock that nvidia-smi reads during the run, each launch; and the
  static stall cycles a step of each backward kernel's largest basic
  block (its unrolled tile loop) in the SASS (cuobjdump beside nvcc).

Prints one JSON object, with the card's name and power limit."""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter

import torch

from lsp_dsp_units_tpu_torch import pipeline
from lsp_dsp_units_tpu_torch.models import filters as flt
from lsp_dsp_units_tpu_torch.models.filters import dynamic_filters as dynf
from lsp_dsp_units_tpu_torch.models.util.oversampler import Oversampler
from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import biquad as bq
from lsp_dsp_units_tpu_torch.tools.ab_kernels import time_ms
from lsp_dsp_units_tpu_torch.tools.launch_profile import (
    device_kernels, launch_name)

C, SR = 64, 48000
SHORT, LONG = 16384, 65536
# the kernels of csrc/biquad_scan.cu, by short name (scan_kernel: before
# the table split)
SCAN_KERNELS = ("scan_kernel", "table_kernel", "shared_kernel",
                "per_row_kernel")


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def kernels(fn, calls: int = 10) -> list:
    """Each kernel of one call of ``fn``: short name, ms a launch,
    launches a call (torch.profiler)."""
    out = []
    for raw, (ms, n) in device_kernels(fn, calls, warm=5).items():
        out.append(dict(name=launch_name(raw), ms=ms / n,
                        launches=round(n / calls)))
    return sorted(out, key=lambda r: -r["ms"] * r["launches"])


def sass_loops(lib: str, kernel: str) -> dict:
    """Each function of ``lib`` whose name holds ``kernel``: its largest
    basic block's instructions, static stall cycles (bits 41-44 of an
    instruction's second word) and the count of each opcode, by mangled
    name."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", _build.build(lib)],
                          capture_output=True, text=True, timeout=120).stdout
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?);\s*/\* 0x[0-9a-f]{16} \*/")
    hi = re.compile(r"^\s*/\* (0x[0-9a-f]{16}) \*/\s*$")
    out = {}
    for body in text.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        blocks, cur, op = [], [], None
        for line in body.splitlines():
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
        big = max(blocks, key=len)
        ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0]
                      for o, _ in big)
        out[name] = dict(instructions=len(big),
                         stall_cycles=sum(s for _, s in big),
                         ffma=ops["FFMA"], dadd=ops["DADD"],
                         opcodes=dict(ops.most_common()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("biquad_profile: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator().manual_seed(35)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    res = dict(card=smi("name,power.limit"))
    c15 = Oversampler(SR, 4, "x3", True).filter_coeffs
    eq = flt.Equalizer(SR, filters=8, iir_block=None)
    for i, p in enumerate(pipeline.default_eq_params(SR)):
        eq.set_params(i, p)
    c9 = eq.build().coeffs
    scan = {}
    for t in (SHORT, LONG):
        x = r(C, t, scale=0.25)
        for name, c in (("k1", c15[:1]), ("k9", c15[:9]), ("k15", c15),
                        ("eq_k9", c9)):
            if name == "eq_k9" and t != SHORT:
                continue
            s0 = r(C, c.shape[0], 2, scale=0.1)
            fn = (lambda c, s0, x: lambda: bq.biquad_cascade(c, s0, x))(
                c, s0, x)
            key = f"{name}_{t}"
            scan[key] = dict(t=t, k=c.shape[0], ms=time_ms(fn, 20),
                             kernels=kernels(fn))
            print(f"biquad_scan [{C}, {t}] {name}: {scan[key]['ms']:.4f} ms; "
                  + "; ".join(f"{k['name']} {k['ms']:.4f} x {k['launches']}"
                              for k in scan[key]["kernels"]), flush=True)
    res["scan"] = scan

    x = r(C, SHORT, scale=0.25)
    s9 = r(C, c9.shape[0], 2, scale=0.1)
    y, _ = bq.biquad_cascade(c9, s9, x)
    g_y, g_s = r(C, SHORT), r(C, c9.shape[0], 2)
    route = {}
    for want in (True, False):
        fn = (lambda w: lambda: bq.biquad_cascade_bwd(
            c9, s9, x, y, g_y, g_s, w))(want)
        ks = kernels(fn)
        ms = time_ms(fn, 10)
        scan_ms = sum(k["ms"] * k["launches"] for k in ks
                      if k["name"] in SCAN_KERNELS)
        other_ms = sum(k["ms"] * k["launches"] for k in ks
                       if k["name"] not in SCAN_KERNELS)
        route["coeffs" if want else "x_only"] = dict(
            ms=ms, scan_kernels_ms=scan_ms, glue_kernels_ms=other_ms,
            gaps_ms=ms - scan_ms - other_ms, kernels=ks)
        print(f"biquad_cascade_bwd [{C}, {SHORT}] K = 9 (coefficients "
              f"{want}): {ms:.4f} ms, scan kernels {scan_ms:.4f}, other "
              f"kernels {other_ms:.4f}, the rest {ms - scan_ms - other_ms:.4f}"
              f"; " + "; ".join(f"{k['name']} {k['ms']:.4f} x "
                                f"{k['launches']}" for k in ks), flush=True)
    res["scan_bwd"] = route

    swell = torch.sin(torch.linspace(0.0, torch.pi, SHORT))
    bell = flt.FilterParams(ftype=flt.FilterType.BT_BWC_BELL, freq=1000.0,
                            slope=2, quality=0.7)
    cdyn = dynf._design_per_sample(
        bell, (10.0 ** ((-12.0 + 24.0 * swell) / 20.0)).cuda().expand(
            C, SHORT), SR)
    s4 = r(C, cdyn.shape[-2], 2, scale=0.1)
    gs4 = r(C, cdyn.shape[-2], 2)
    sig9 = bq._seq_cuda(c9, s9, x, False, save=True)[2]
    sig4 = bq._seq_cuda(cdyn, s4, x, True, save=True)[2]
    cases = {
        "coeffs": (lambda: bq.biquad_cascade_seq_bwd(c9, s9, x, sig9, g_y,
                                                     g_s), c9.shape[0]),
        "x_only": (lambda: bq.biquad_cascade_seq_bwd(c9, s9, x, None, g_y,
                                                     g_s, False),
                   c9.shape[0]),
        "per_sample": (lambda: bq.dyn_biquad_cascade_seq_bwd(
            cdyn, s4, x, sig4, g_y, gs4), cdyn.shape[-2])}
    clock = smi("clocks.sm")
    seq = {}
    for name, (fn, k) in cases.items():
        ms = time_ms(fn, 10)
        sm = smi("clocks.sm")
        hz = float(sm.split()[0]) * 1e6
        steps = SHORT + k - 1
        seq[name] = dict(ms=ms, k=k, sm_clock=sm,
                         cycles_per_step=ms * 1e-3 * hz / steps,
                         kernels=kernels(fn))
        print(f"biquad_seq_bwd {name} [{C}, {SHORT}] K = {k}: {ms:.4f} ms, "
              f"{seq[name]['cycles_per_step']:.1f} cycles a step at {sm}; "
              + "; ".join(f"{kk['name']} {kk['ms']:.4f} x {kk['launches']}"
                          for kk in seq[name]["kernels"]), flush=True)
    res["seq_bwd"] = seq
    res["seq_bwd_sass"] = sass_loops("biquad_bwd", "bwd_kernel")
    for name, v in res["seq_bwd_sass"].items():
        print(f"SASS {name}: largest block {v['instructions']} instructions, "
              f"{v['stall_cycles']} static stall cycles, {v['ffma']} FFMA, "
              f"{v['dadd']} DADD", flush=True)
    res["sm_clock_before"] = clock
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(dict(card=res["card"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
