"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check
them.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero; nothing is caught):

1. card   — CUDA must be available; prints nvidia-smi's name and power
            limit.
2. build  — compiles the twelve CUDA sources of
            lsp_dsp_units_tpu_torch/csrc (nvcc, sm_90a), one nvcc each,
            all started together, and prints the seconds.
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
10. filters — the biquad cascade and the filter units on it: kernel
            biquad_seq (csrc/biquad.cu) against its plain loop at the
            main path's [64, 16384] over its two calls, on its input,
            with the state carried, bit for bit: the chain's 8 bands
            (K = 9, shared coefficients, from a non-zero state) and
            DynamicFilters' BT_BWC_BELL (slope 2, per-sample coefficients
            on a -12..+12 dB gain swell).  Then, with the launch counters
            zeroed just before, 64 channels x 2 calls of 16384 samples
            with the state carried through: Equalizer with the chain's 8
            bands as fused IIR, IIR with iir_block=None (the kernel), FIR,
            FFT and SPM (fir_rank 12); SpectralTilt(order 16, 100 Hz-10
            kHz); DynamicFilters assoc and seq; Filter (a 1 kHz bell,
            assoc; an 80 Hz high-pass, seq); ButterworthFilter(order 8);
            the 4-band Crossover (120/1000/8000 Hz, LR2/LR8/LR28).  Every
            output finite and of its shape, biquad_seq launched at least 8
            times and each FFT kernel at least twice; one FIR
            process_xfade emits the old path's frame.  Each unit against
            float64 (scipy sosfilt on the same sections, the per-sample
            recurrence, the FIR's linear convolution, SPM's frames), at
            the JAX package's own bars, printed beside each dB: fused IIR
            85, sequential 70, assoc 95, per-sample 90, FFT modes 95,
            Butterworth 100, SpectralTilt 60, crossover bands 55/60/60/95
            and its band sum 55 (its float64 chart's |sum| = 1);
            BASELINE config 1 (the BWC hi-shelf, +6 dB at 1 kHz, slope
            2, tests/test_e2e_chain.py) on the phase's input, whole and
            in chunks of 127, 95.  Every
            unit's first call again with TF32 on: identical; the
            time-parallel units (Filter assoc, Butterworth, Crossover),
            which now run biquad_scan, identical on the plain scan.  The
            kernel's ms (static and per-sample) beside its plain loop's
            (the first parity call),
            its bytes bound and its dependent-chain bound (T x 4 ops x 4
            cycles at the measured SM clock), and the plain associative
            scan's launches per call (dispatched operations) and ms.
11. dynamics — the Limiter, the serial riders and the meters at full
            width (64 channels at 48 kHz, 2 calls of 16384, the state
            carried), the launch counters zeroed just before and read just
            after: BASELINE config 4 (Sidechain RMS 5 ms -> Compressor ->
            Gate on rising-level noise, tests/test_baseline_configs.py)
            into two limiters on |y| (HERM_THIN at 2 ms; EXP_WIDE at 5 ms
            with ALR), each gain applied to the delayed y: |out| <= 0.8 x
            1.002 and the loud half reduced; the riders (AutoGain with
            quick_amp off and on, max_gain on; SimpleAutoGain;
            SurgeProtector; PeakMeter; DynamicProcessor's envelope with a
            4-dot curve); the loudness leg (a stereo program through
            LoudnessMeter at 400 and 3000 ms into AutoGain; LoudnessMeter
            over the 64 channels; ILUFS over 4 quarters x 4800;
            TruePeakMeter on the 64 channels, Correlometer and Panometer,
            both laws, on 32 channel pairs).  limiter_kernel and
            rider_kernel against their plain versions on the drive's own
            inputs and states, both calls, output and state identical (the
            largest pass count of any row printed); the meters against
            float64 at the JAX package's bars (loudness 110 dB, true peak
            120, correlometer and panometer 100) and ILUFS within 0.05 dB
            of its block's float64 loudness; TF32 on: identical.  Each
            kernel's ms (CUDA events behind the spin kernel) beside its
            plain version's (the first call), its bytes bound, its chain
            bound (T x the step's dependent operations x 4 cycles at the
            measured SM clock) and, for the limiter, its pass bound
            (passes x the dependent operations on a pass's path x 4
            cycles) and the shared-memory bytes a pass moves; for
            each rider, cycles a step beside the chain bound's and the
            chain loop in the SASS (LDL / STL: none; BRA, BSSY, CALL;
            compares; static stall cycles a step).
12. spectral — the spectral units, the Oversampler and the measurement
            units at full width (64 channels, 2 calls of 16384 with the
            state carried; the Analyzer 2 calls of 16800, 7 periods of
            2400), the launch counters zeroed just before and read just
            after: SpectralProcessor(rank 12) with a split-complex 0.5
            hook and a complex hook; MultiSpectralProcessor(64, rank 12)
            mixing across channels; SpectralSplitter(rank 12, 2
            handlers, chunk_rank 10); config 3: Convolver(1 s IR, rank
            12) into FFTCrossover's 4 bands at rank 11 (band sum vs the
            delayed input > 100 dB); Analyzer(64, rank 12, 20 Hz);
            config 2: the fused 8-band EQ into Oversamplers at 2x, 4x
            and 8x with filtering and tanh at the high rate; config 5:
            SpectralProcessor(rank 10, 0.5 hook) on 64 sines into ILUFS
            (within 1 dB of the analytic level) and true peak (within
            0.01).  Each output against float64 (numpy FFTs over the
            same frames and windows, the same Lanczos taps, scipy sosfilt
            on the same sections): 110 dB for the FFT paths, the JAX
            package's bars elsewhere (fused EQ 85, the scan 95, the
            convolver 85).  Config 2's Oversamplers again on
            biquad_cascade_plain: outputs and filter states bit for bit
            the kernel's; TF32 on: identical.
            The LatencyDetector through a loop of 4321 samples with
            noise at -40 dB (exact); the ResponseTaker's capture through
            a known loop (exact); SyncChirpProcessor SIMPLE and
            BANDLIMITED 2 s sweeps through a known filter, the linear
            IR's magnitude within 0.1 dB (median) and 1 dB (max) of the
            filter's float64 IR from 100 Hz to 15 kHz.  Then kernel #1
            at the phase's shapes (forward and inverse against their
            plain versions and torch.fft, with times and bounds) and
            biquad_scan at [64, 16384], K = 9 and [64, 65536], K = 15
            beside its plain version, with its operations bound counted
            from the tree.
13. synth — the generators and the utility machines at full width (64
            channels at 48 kHz, 2 calls of 16384, the state carried), the
            launch counters zeroed just before and read just after: the
            14 Oscillator functions at the JAX oracle test's settings
            (mono; the band-limited ones through biquad_scan at 8 x
            16384), ADSR over the band-limited sawtooth, NoiseGenerator
            white, pink and -4.5 dB/oct (biquad_seq), a DynamicDelay bank
            (max delay 4800, each channel's delay swept by the LFO's
            quick sine at 0.7 Hz, feedback gain 0.5, seeded feedback
            delays: delay_kernel), the trigger in each of its five types
            on the bank's output (rider_kernel<TriggerStep>), the Trigger
            unit mono in SINGLE, MANUAL and REPEAT, the Depopper in all
            five modes on gated noise bursts (rider_kernel<DepopperStep>),
            Dither and dither_device.  The port's CPU run of the same
            (its plain loops, in a pool of spawned worker processes)
            against the card's: the naive oscillators >= 120 dB, the
            band-limited ones and ADSR >= 100, colored noise >= 120,
            white noise, the delay bank, every trigger, the mono units,
            the depoppers' envelopes, falls, patch lengths, states, raw
            and applied gains identical; dither within half an LSB.
            Each of the three kernels' ms at [64, 16384] beside its
            plain loop's (one call, host-paced), its bytes bound and its
            chain bound (T x the step's dependent operations x 4 cycles
            at the measured SM clock), one launch a call; then every
            trigger type and depopper mode timed on its first call's
            inputs, cycles a step beside the chain bound's, and its
            chain loop in the SASS as the riders'.
14. parallel — the sharded chain at world size 1: NCCL with an in-process
            store, a (1, 1) ('chan', 'time') mesh on the card,
            sharded_step for 2 calls of [64, 16384] with the state
            carried, the launch counters of rfft_packed,
            rfft_packed_zeropad, irfft_packed (#1), sliding_rms (#5) and
            peak_envelope (#6) zeroed just before and read just after
            (each >= 2); >= 95 dB from step on the same inputs and state
            (the JAX package's bar for its sharded chain); the second
            call again with TF32 on: identical; the time-sharded ILUFS
            gate over 64 channels x 16 quarters within 1e-5 relative of
            ILUFSMeter, the global mean square (rtol 1e-5), true peak
            (exact) and correlation (rtol 1e-4) against their local
            values; then dryrun_multichip(1) on the card (its own NCCL
            group); Bypass, Crossfade and QuantizedCounter (period 0, and
            a 1 s window in a ring of 65536, NaNs and values beyond int32
            indices) over 2 calls of [64, 16384] on the card against the
            CPU: every output and state identical; sharded_step's and
            step's device ms per call, in turns.  One card tests world
            size 1 only; gloo processes on the CPU prove the multi-rank
            behaviour (tests/test_torch_parallel.py).
15. threed — the room tracer (models/threed: plain torch, no kernel of
            its own) at two configurations: the room demo's
            (tools/room_demo.room_tracer: box_room 6 x 4 x 3 m,
            absorption 0.25, diffusion 3, 48 kHz, 0.7 s, 8192 rays, 40
            bounces, a cardioid capture) and
            benchmarks/raytrace_compare.py::ours_ir's defaults (its 4 x 3
            x 2.5 m box in 1 m cells, 16384 rays, 0.25 s, 40 bounces,
            energy floor 1e-4, no air absorption).  Each on the card and
            on the port's CPU: the direct arrival's bin identical and its
            amplitude within rtol 1e-5, the Schroeder decay within 0.2 dB
            down to -40 dB, RT60 (T30) within 1 %; the card's seconds per
            process(), ms, launches (dispatched operations) and host
            syncs per bounce, stats.  Then the room demo's
            Convolver(IR, rank=12) on 64 channels of noise (8 x 2048):
            kernel #1's counters, zeroed just before, advance; >= 85 dB
            from a float64 fftconvolve.
16. serve  — tools/serve.run at the bench graph's width
            (FilterConvChain(48000, 64, rank=14, ir_seconds=1.0), 8
            streams x 8 channels, rings of 8 blocks, one StreamEngine),
            24 pump iterations with the counters of #1, #5 and #6 zeroed
            just before and read just after (rfft_packed, sliding_rms and
            peak_envelope each >= 24); 24 of 24 served, 0 underruns;
            every frame read back from the output rings identical to
            step run directly on the same 24 gathered batches (the state
            carried from the same warm call); M samples/s and host ms
            per pump iteration.
17. grad   — gradients through the bench graph at full width: two
            calls of step on [64, 2 x 8192] with the state carried
            (inputs at amplitude 2.0, seeded; the share of the first
            call's envelope above the compressor's first knee printed and
            > 0), loss the sum of both outputs squared, d/d both inputs
            and the compressor's 20 leaves (0-d tensors that require
            grad).  The backward counters of #1's adjoints
            (rfft_packed, rfft_packed_zeropad, irfft_packed
            .bwd_launches), sliding_rms_bwd and peak_envelope_bwd, zeroed
            just before and read just after, each >= 2.  Card against the
            port's CPU run of the same: >= 100 dB per input and per
            non-zero leaf, zeros at the same leaves; again with TF32 on:
            identical.  Device ms of a call forward alone and forward +
            backward (x requires grad; CUDA events around one pair of
            calls behind the spin kernel), its host ms with a sync, and
            torch.profiler's kernel time of one forward + backward, with
            its largest kernels.  sliding_rms_bwd against its plain
            version at [64, 16384], N = 480 (>= 120 dB: both sum in
            float64, in other orders), beside avg_pool1d over a prebuilt
            frame; peak_envelope_bwd against its plain loop, bit for bit,
            in step's configuration at [64, 16384] (the plain loop on the
            card, timed once) and with a hold of 24 from a random state,
            threshold on and off, at [64, 4096] (the plain loop's time),
            its ms and cycles a step at [64, 16384] in both
            configurations beside the one serial pass's bound (3
            dependent operations, 12 cycles a step) and its bytes bound;
            biquad_cascade_bwd at [64, 16384], K = 9 (the chain's 8 bands)
            against its plain backward (the same adjoint on the plain
            scan), >= 120 dB, its scan launches a call (17 scans of two
            launches: the prefix table, the rows), its time split by
            torch.profiler into the scan kernels, torch's own launches
            and the rest (the host's gaps between them); #1's adjoints
            as step runs them at [128, N = 16384] (the zero-pad and whole
            forward's, the first, last and whole inverse's), against the
            same adjoints on torch.fft (>= 95 dB), each one launch of its
            kernel a call and nothing else (torch.profiler after
            uncounted calls), torch.fft.irfft / rfft at the same shape in
            natural order beside it.  Each timed, with its bound.
17b. grad_ring — gradients through step_ring at full width: 8 blocks
            of [64, 8192] from init_ring_state (inputs at amplitude 2.0,
            seeded), loss the sum of every output squared, d/d each
            block's x and the IR spectra, the EQ spectrum, g_mat, m_mat
            and w_mat (new leaves that require grad, packed in the
            graph), the loss over the channels whose envelope branches
            (from the level and envelope kernel #3 saves for
            chain_dyn_bwd) agree with the CPU run's (the others printed).
            The launch counters of eqfdl_fused_bwd, chain_dyn_bwd, the
            frame kernel (frame_bwd) and the zero-pad adjoint of #1
            (rfft_packed_zeropad.bwd_launches), zeroed just before and
            read just after, each >= 8.  Card
            against the port's CPU run: >= 100 dB each; again with TF32
            on: identical.  8 blocks of the packed
            fdl_ring_step under grad (x and the IR spectra): fdl_bwd
            launched >= 8 times, card vs CPU >= 100 dB.  On block 3's
            saved inputs with random cotangents: eqfdl_fused_bwd and
            fdl_fused_bwd against their plain backwards >= 110 dB per
            output, identical from run to run, each launch of one call
            of each (torch.profiler: name, ms, bytes bound; the EQ
            adjoint's eqfdl_bwd and eqfdl_bwd_sums, fdl_bwd and the
            frame kernel must be among them, and no torch add, copy or
            #1 inverse); the frame kernel alone in both forms against
            frame_bwd_plain (>= 95 dB), one launch a call (the
            profiler); chain_dyn_bwd from the level and envelope that
            kernel #3's saving form wrote: its y identical to kernel
            #3's, the saved envelope identical to the plain envelope on
            its level, its envelope adjoint identical to
            peak_envelope_bwd_plain on the saved values, and the whole
            >= 120 dB from chain_dyn_bwd_plain; its launches of a call
            (torch.profiler, printed as whole where it shows one
            chain_dyn_bwd and one chain_dyn_sums; a call counts one
            launch), its ms and cycles a sample beside the one
            serial pass's bound (12 cycles a sample), and the forward's
            ms with and without saving.  Each timed, with its
            bound; step_ring's ms a block forward and forward + backward
            (CUDA events behind the spin kernel) and torch.profiler's
            kernels of one forward + backward.
17c. grad_units — gradients through the sequential cascade, the Gate
            and the DynamicDelay, at [64, 2 x 16384] with the state
            carried: Filter seq with the chain's K = 9 passed as its
            coefficients (which take a gradient), the IIR Equalizer
            (iir_block=None), DynamicFilters seq (K = 4 per sample; the
            gain through the per-sample design), the LoudnessMeter, the
            Gate at a hold of 0 and of 24 (the taus), the synth phase's
            LFO-swept DynamicDelay (the buffer and the gain); the loss
            puts seeded weights on every output.  The counters of
            biquad_seq_bwd (static: 6, per sample: 2), the row sums (2),
            delay_bwd_kernel (2) and peak_envelope_bwd (4), zeroed just
            before and read just after, exact.  Card against the port's
            CPU run at [64, 2 x 1024]: >= 100 dB per gradient, the
            Gate's NaN positions equal; TF32 on: identical.  Each
            backward kernel against its plain adjoint on the CPU at [64,
            2048], bit for bit (the saving forward's signals too); each
            timed at [64, 16384] beside its plain adjoint's time at [64,
            2048] on the card (host-paced), its bytes / operations bound
            and its chain bound.
17d. demo  — every mode of tools/demo.py (filter, chain, loudness,
            sampler, stretch) through its main(), on the card (its
            default) and with --cpu, on WAVs written from fixed seeds:
            10 s of stereo at 48 kHz (three tones and noise, peaks at -12
            dBFS) and, for chain, 4 s of 64 channels.  The CPU runs go on
            in three spawned worker processes beside the card's.  Bars,
            card vs CPU: filter and chain >= 95 dB, the integrated
            loudness within 0.01 dB, sampler and stretch identical.  The
            counters of each mode's kernels, zeroed just before its card
            run, must advance: filter biquad_scan; chain #1's three
            wrappers, #5 and #6; loudness biquad_seq.  Seconds per mode
            and device printed.
17e. tour  — every block of lsp_dsp_units_tpu_torch/docs/API_TOUR.md on
            the card (tools/tour.run), every launch counter zeroed just
            before and read just after: #1 (any of its three wrappers),
            #5, #6, #8, biquad_scan, biquad_seq, limiter_kernel,
            delay_kernel, TriggerStep, and the backwards sliding_rms_bwd,
            peak_envelope_bwd (the sharded chain's gradient) and the
            scan's (the biquad fit) must advance; the counts printed.
18. timing — CUDA events behind a spin kernel: step_ring ms per block,
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

The last three lines of standard output are the kernel table (JSON:
the nine TPU kernels' ports, biquad_seq, limiter_kernel,
rider_kernel, biquad_scan, delay_kernel, rider_kernel<TriggerStep>,
rider_kernel<DepopperStep>, and the backward kernels sliding_rms_bwd,
peak_envelope_bwd and #1's adjoints rfft_packed_bwd_kernel and
irfft_packed_bwd_kernel (timed in their zero-pad and first-half forms,
every form under "modes"), whose launches are the grad phase's, and
eqfdl_bwd, fdl_bwd, chain_dyn_bwd and frame_bwd_kernel, whose launches
are the grad_ring phase's, and biquad_seq_bwd in both forms,
delay_bwd_kernel and peak_envelope_bwd<gate>, whose launches are the
grad_units phase's), the card's
name and power limit, and the
contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from benchmarks.chain_golden64 import golden_chain_f64  # noqa: E402
from lsp_dsp_units_tpu_torch import pipeline  # noqa: E402
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (  # noqa: E402
    Compressor, CompressorMode)
from lsp_dsp_units_tpu_torch.models.dynamics.expander import (  # noqa: E402
    Expander, ExpanderMode)
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate  # noqa: E402
from lsp_dsp_units_tpu_torch.models.dynamics import (  # noqa: E402
    AutoGain, DynamicProcessor, Limiter, LimiterMode, SimpleAutoGain,
    SurgeProtector)
from lsp_dsp_units_tpu_torch.models import meters as mtr  # noqa: E402
from lsp_dsp_units_tpu_torch.models import filters as flt  # noqa: E402
from lsp_dsp_units_tpu_torch.models.filters import (  # noqa: E402
    dynamic_filters as dynf)
from lsp_dsp_units_tpu_torch.models.misc import windows  # noqa: E402
from lsp_dsp_units_tpu_torch.models.sampling import (  # noqa: E402
    LoopMode, PlaySettings, Sample, SamplePlayer, device_mix as dm)
from lsp_dsp_units_tpu_torch.models.util.convolver import (  # noqa: E402
    Convolver)
from lsp_dsp_units_tpu_torch.models.misc import lfo  # noqa: E402
from lsp_dsp_units_tpu_torch.models.noise import (  # noqa: E402
    NoiseColor, NoiseCore, NoiseGenerator)
from lsp_dsp_units_tpu_torch.models.util import (  # noqa: E402
    ADSREnvelope, Depopper, DepopperMode, Dither, DynamicDelay,
    FunctionGenerator, Oscillator, Trigger, TriggerMode, TriggerType,
    dither_device)
from lsp_dsp_units_tpu_torch.models.util.crossover import (  # noqa: E402
    Crossover, CrossoverSlope)
from lsp_dsp_units_tpu_torch.models.util.sidechain import (  # noqa: E402
    Sidechain, SidechainMode)
from lsp_dsp_units_tpu_torch.entry import dryrun_multichip  # noqa: E402
from lsp_dsp_units_tpu_torch.models.ctl import (  # noqa: E402
    Bypass, Crossfade)
from lsp_dsp_units_tpu_torch.models.stat import QuantizedCounter  # noqa: E402
from lsp_dsp_units_tpu_torch.models.threed import (  # noqa: E402
    Capture, Material, Object3D, RayTrace3D, Scene3D, SourceSettings,
    SourceShape)
from lsp_dsp_units_tpu_torch.tools import room_demo, serve  # noqa: E402
from lsp_dsp_units_tpu_torch.tools.launch_profile import (  # noqa: E402
    device_kernels as profile_kernels, launch_name, launch_profile)
from lsp_dsp_units_tpu_torch.ops import _build  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import biquad_block  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import cplx  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import biquad as bq  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import delay as delay_ops  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import env_units as eu  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import fftconv  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import limiter as lim_ops  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import resample  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import riders  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import slicedma  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import env as env_ops  # noqa: E402
from lsp_dsp_units_tpu_torch.ops import fdl_fused as ff  # noqa: E402
from lsp_dsp_units_tpu_torch.ops.env import (  # noqa: E402
    chain_dyn, chain_dyn_plain)
from lsp_dsp_units_tpu_torch.ops.fdl_fused import (  # noqa: E402
    eqfdl_fused, eqfdl_fused_plain, eqfdl_launch_shape, fdl_fused,
    fdl_fused_plain, fdl_launch_shape)
from lsp_dsp_units_tpu_torch.ops.ring_mac import (  # noqa: E402
    ring_mac, ring_mac_plain)
from lsp_dsp_units_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from lsp_dsp_units_tpu_torch.parallel.meters import (  # noqa: E402
    global_correlation, global_mean_square, global_true_peak,
    ilufs_integrated_time_sharded)
from lsp_dsp_units_tpu_torch.utils import tree  # noqa: E402
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
FILT_T, FILT_CALLS = 16384, 2  # the filters phase: 64 ch x T, state carried
# the filters' bars against float64, from the JAX package's own tests
SEQ_FLOOR_DB = 70.0   # DF2T seq cascade, "the ~75-80 dB class" for the
#                       chain's bands (tests/test_equalizer.py), less 5 dB
FUSED_DB = 85.0       # fused IIR (tests/test_equalizer.py, > 85 dB)
ASSOC_DB = 95.0       # time-parallel scan (tests/test_biquad.py, > 95 dB)
DYNF_DB = 90.0        # per-sample cascades (tests/test_biquad.py, > 90 dB)
BW_DB = 100.0         # Butterworth (tests/test_reference_oracle_units.py)
TILT_DB = 60.0        # SpectralTilt (tests/test_reference_oracle_units.py)
CONFIG1_DB = 95.0     # BASELINE config 1 (tests/test_e2e_chain.py)
XOVER_FLOORS = (55.0, 60.0, 60.0, 95.0)   # crossover bands, low to high
#                       (tests/test_reference_oracle_meters.py, "3split")
DYN_T, DYN_CALLS = 16384, 2   # the dynamics phase: 64 ch x T, state carried
# the meters' bars against float64, from the JAX package's own tests
LOUD_DB = 110.0   # LoudnessMeter (tests/test_reference_oracle_meters.py)
TP_DB = 120.0     # Lanczos upsampling (tests/test_reference_oracle_wave3.py)
CORR_DB = 100.0   # Correlometer, Panometer (test_reference_oracle_meters.py)
CEILING = 0.8 * 1.002         # config 4's limiter ceiling
#                               (tests/test_baseline_configs.py)
# each rider case's step functor in csrc/riders.cu, whose dependent
# operations a step (riders.chain_ops) set its chain bound
RIDER_KIND = {"autogain": "autogain", "autogain_quick": "autogain",
              "simple": "simple_autogain", "surge": "surge",
              "peak": "peak_meter", "dynproc": "dynproc"}
# each rider case's rider_kernel instantiation in the SASS (a substring
# of its mangled name: AutoGainStep<quick_amp, use_max_gain>) and its
# step functor
RIDER_SASS = {"autogain": ("AutoGainStepILb0ELb0E", "AutoGainStep"),
              "autogain_quick": ("AutoGainStepILb1ELb1E", "AutoGainStep"),
              "simple": ("SimpleAutoGainStep", "SimpleAutoGainStep"),
              "surge": ("SurgeStep", "SurgeStep"),
              "peak": ("PeakMeterStep", "PeakMeterStep"),
              "dynproc": ("DynProcStep", "DynProcStep")}
ALR_CHAIN_OPS = 3             # compare-select, subtract, FMA

PAR_T, PAR_CALLS = 16384, 2   # the parallel phase: 64 ch x T, state carried
SHARD_DB = 95.0       # sharded_step vs step (tests/test_parallel.py:320)
METER_RTOL = 1e-5     # ILUFS sharded vs sequential (test_parallel.py:253)
PAR_COUNTERS = (fp.rfft_packed, fp.rfft_packed_zeropad, fp.irfft_packed,
                eu.sliding_rms, eu.peak_envelope)
# the threed phase: the card's IR against the port's CPU run
DECAY_DB = 0.2        # Schroeder decay, down to DECAY_FLOOR_DB
DECAY_FLOOR_DB = -40.0
RT60_REL = 0.01       # RT60 (T30 of the Schroeder decay, x 2)
DIRECT_RTOL = 1e-5    # the direct arrival's amplitude
# benchmarks/raytrace_compare.py's box (tests/test_reference_oracle_
# raytrace.py: 4 x 3 x 2.5 m tessellated into 1 m cells, absorption 0.3)
RTC_SIZE = (4.0, 3.0, 2.5)
RTC_SRC, RTC_CAP = (1.2, 1.0, 1.2), (2.8, 2.0, 1.3)
SERVE_BLOCKS, SERVE_STREAMS = 24, 8   # the serve phase: 8 streams x 8 ch

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


# dependent operations a step of the envelope backwards' one serial pass,
# the cotangent in reverse time, once the peak's cotangent is 0 (from the
# first step that sets the peak on; its + 0 is then taken into g off the
# chain, csrc/env_bwd.cuh): lam + g, * tau, lv - gx
REV_CHAIN_OPS = 3


# the nine TPU kernels of the JAX package and their ports: result key,
# name, CUDA source, the JAX function that reaches pl.pallas_call (under
# lsp_dsp_units_tpu/)
KERNELS = (
    ("fft", "rfft_packed_zeropad", "fft_packed.cu", "ops/pallas_fft.py:549"),
    ("eqfdl", "eqfdl_fused", "fdl_fused.cu", "ops/pallas_fdl_fused.py:222"),
    ("dyn", "chain_dyn", "env.cu", "ops/pallas_env.py:523"),
    ("fdl", "fdl_fused", "fdl_fused.cu", "ops/pallas_fdl_fused.py:80"),
    ("rms", "sliding_rms", "env_units.cu", "ops/pallas_env.py:294"),
    ("peak", "peak_envelope", "env_units.cu", "ops/pallas_env.py:334"),
    ("gate", "gate_envelope", "env_units.cu", "ops/pallas_env.py:183"),
    ("slice", "batched_slice", "slicedma.cu", "ops/slicedma.py:77"),
    ("mac", "ring_mac", "ring_mac.cu", "ops/pallas_fdl.py:85"),
    # not Pallas kernels: the card's counterparts of lax.scan and
    # lax.while_loop bodies, which XLA compiles into loops over samples
    ("bq", "biquad_seq", "biquad.cu", "ops/biquad.py:140"),
    ("lim", "limiter_kernel", "limiter.cu",
     "models/dynamics/limiter.py:200"),
    ("rider", "rider_kernel", "riders.cu",
     "models/dynamics/autogain.py:97"),
    ("scan", "biquad_scan", "biquad_scan.cu", "ops/biquad.py:114"),
    ("delay", "delay_kernel", "delay.cu", "models/util/delay.py:122"),
    ("trig", "rider_kernel<TriggerStep>", "riders.cu",
     "models/util/trigger.py:166"),
    ("depop", "rider_kernel<DepopperStep>", "riders.cu",
     "models/util/depopper.py:188"),
    # backward kernels: what jax.grad differentiates in the JAX package
    # (the RMS's cumsum form, the envelope's scan body)
    ("rms_bwd", "sliding_rms_bwd", "env_units.cu",
     "models/util/sidechain.py:121"),
    ("peak_bwd", "peak_envelope_bwd", "env_units.cu", "ops/dynamics.py:102"),
    # the backwards of step_ring's kernels and of the packed ring's: the
    # adjoints of the TPU kernels' contracts (JAX differentiates their
    # XLA forms, pipeline.py:194 on its CPU route)
    ("eqfdl_bwd", "eqfdl_bwd", "fdl_fused.cu", "ops/pallas_fdl_fused.py:222"),
    ("fdl_bwd", "fdl_bwd", "fdl_fused.cu", "ops/pallas_fdl_fused.py:80"),
    ("dyn_bwd", "chain_dyn_bwd", "env.cu", "ops/pallas_env.py:523"),
    # #1's adjoints, one launch each (the inverse with weighted loads, the
    # forward transform with weighted stores), and the convolver
    # backwards' frame transforms in one cluster kernel
    ("rfft_bwd", "rfft_packed_bwd_kernel", "fft_packed.cu",
     "ops/pallas_fft.py:549"),
    ("irfft_bwd", "irfft_packed_bwd_kernel", "fft_packed.cu",
     "ops/pallas_fft.py:549"),
    ("frame_bwd", "frame_bwd_kernel", "fdl_fused.cu",
     "ops/pallas_fdl_fused.py:222"),
    # the backwards of the sequential cascade (static and per-sample
    # coefficients), the DynamicDelay and the Gate (#7's route, on
    # peak_envelope_bwd without a release threshold): what jax.grad
    # differentiates of their lax.scan bodies and of the gate's scan
    ("bq_bwd", "biquad_seq_bwd", "biquad_bwd.cu", "ops/biquad.py:140"),
    ("bq_bwd_dyn", "biquad_seq_bwd<per-sample>", "biquad_bwd.cu",
     "ops/biquad.py:198"),
    ("delay_bwd", "delay_bwd_kernel", "delay.cu", "models/util/delay.py:122"),
    ("gate_bwd", "peak_envelope_bwd<gate>", "env_units.cu",
     "ops/pallas_env.py:183"),
)


# fields beyond the contract's in a kernel's record of the kernels line
EXTRA_KEYS = {
    "fft": ("inverse_ms", "inverse_plain_ms", "inverse_library_ms",
            "inverse_bound_ms", "blocks_resident", "spectral_shapes"),
    "rms": ("blocks_resident", "db_vs_float64"),
    "slice": ("blocks_resident",),
    "eqfdl": ("blocks_resident",),
    "fdl": ("blocks_resident",),
    "gate": ("chain_ms", "cycles_per_step", "hold0_ms",
             "hold0_cycles_per_step", "peak_form_ms", "hold0_peak_form_ms"),
    "dyn": ("chain_ms", "cycles_per_sample"),
    "bq": ("chain_ms", "cycles_per_step", "sm_clock_hz", "dyn_launches",
           "dyn_ms",
           "dyn_plain_ms", "dyn_bound_ms", "dyn_chain_ms",
           "dyn_cycles_per_step", "assoc_launches_per_call",
           "assoc_ms"),
    "lim": ("pass_chain_ms", "pass_bytes", "passes_max", "sm_clock_hz",
            "alr_ms", "alr_plain_ms", "alr_chain_ms", "alr_pass_chain_ms",
            "alr_pass_bytes",
            "alr_passes_max"),
    "rider": ("chain_ms", "cycles_per_step", "sm_clock_hz", "steps"),
    "scan": ("launches_per_call", "seq_ms", "bytes_bound_ms", "k15_ms",
             "k15_plain_ms", "k15_bound_ms", "k15_bound_by",
             "k15_bytes_bound_ms"),
    "delay": ("chain_ms", "chain_ops", "cycles_per_step", "sm_clock_hz",
              "launches_per_call"),
    "trig": ("chain_ms", "chain_ops", "cycles_per_step", "sm_clock_hz",
             "launches_per_call", "types"),
    "depop": ("chain_ms", "chain_ops", "cycles_per_step", "sm_clock_hz",
              "launches_per_call", "modes"),
    "rms_bwd": ("db", "identical_share"),
    "peak_bwd": ("chain_ms", "cycles_per_step", "hold24_ms",
                 "hold24_cycles_per_step"),
    "eqfdl_bwd": ("db", "fft_launches_per_call", "launch_profile"),
    "fdl_bwd": ("db", "card_vs_cpu_db", "launch_profile"),
    "dyn_bwd": ("db", "envelope_identical", "chain_ms", "cycles_per_sample",
                "fwd_ms", "fwd_save_ms", "launch_profile",
                "profile_whole"),
    "rfft_bwd": ("modes",),
    "irfft_bwd": ("modes",),
    "frame_bwd": ("db", "fdl_ms", "fdl_plain_ms", "fdl_bound_ms",
                  "launch_profile", "profile_whole"),
    "bq_bwd": ("chain_ms", "chain_ops", "cycles_per_step", "sm_clock_hz",
               "plain_t", "k", "db_vs_cpu", "loudness_vs_f64"),
    "bq_bwd_dyn": ("chain_ms", "chain_ops", "cycles_per_step",
                   "sm_clock_hz", "plain_t", "k"),
    "delay_bwd": ("chain_ms", "chain_ops", "cycles_per_step", "sm_clock_hz",
                  "plain_t"),
    "gate_bwd": ("chain_ms", "cycles_per_step", "sm_clock_hz", "plain_t",
                 "hold24_ms", "hold24_cycles_per_step", "hold24_plain_ms"),
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


def warm_cpu_pool() -> None:
    """One multi-threaded pass of PyTorch's vectorised transcendental
    kernels on the host before any CPU reference runs: in some processes
    the first such call on a tensor split over the intra-op pool comes
    out ~1.5e-4 off on one worker's share (ROADMAP.md §3, `lcg_device`),
    which would move a CPU reference run of the phases below."""
    v = torch.rand(1 << 20)
    for fn in (torch.exp, torch.log, torch.sin, torch.tanh, torch.sqrt):
        fn(v)


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
        yk, uk, sv_k, _, _ = eqfdl_fused(ring_k.spec_re, ring_k.spec_im,
                                         *common, sv_k, *mats,
                                         ring_k.history, w)
        # the cluster schedule's frame, MAC and inverse are fdl_fused's
        # one-block ones: same y and ring slot, bit for bit
        yf = fdl_fused(*ring_f, params.h_re, params.h_im, ring_k.history,
                       uk, w)[0]
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


@functools.lru_cache(maxsize=None)
def sass_text(lib: str) -> str:
    """A library's SASS by cuobjdump (beside nvcc), once a run."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", _build.build(lib)],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump: {out.stderr.strip()}")
    return out.stdout


def sass_blocks(lib: str, kernel: str) -> list:
    """The basic blocks of one kernel in a library's SASS (cuobjdump
    beside nvcc), in code order: each a list of (instruction, static
    stall cycles).  An instruction's stall count is bits 41-44 of its
    second 64-bit word; the count leaves out waits on variable-latency
    results.  ``kernel``: a substring of one function's mangled name."""
    body = [f for f in sass_text(lib).split("Function : ")
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
    return blocks


def sass_count(ins, name: str) -> int:
    """Instructions of ``ins`` ((op, stall) pairs) whose opcode is
    ``name`` (with or without a suffix: "STS" counts STS.128)."""
    return sum(1 for o, _ in ins if re.search(rf"\b{name}\b", o))


def sass_batches(lib: str, kernel: str) -> list:
    """The batch bodies of an envelope kernel in its SASS: the basic
    blocks that hold a batch's 2 x 32 FFMAs, each as a dict: its FMNMX,
    FSETP (float compares) and STS (shared-memory stores) counts and its
    static stall cycles per step."""
    return [dict(fmnmx=sass_count(blk, "FMNMX"),
                 fsetp=sass_count(blk, "FSETP"), sts=sass_count(blk, "STS"),
                 stalls=sum(s for _, s in blk) / 32)
            for blk in sass_blocks(lib, kernel)
            if sass_count(blk, "FFMA") == 64]


def sass_line(sass: dict) -> str:
    """sass_rider_chain's record as a line."""
    return (f"chain loop in the SASS: {sass['instructions']} instructions, "
            f"LDL {sass['ldl']}, STL {sass['stl']}, BRA {sass['bra']}, "
            f"BSSY {sass['bssy']}, CALL {sass['call']}, {sass['setp']} "
            f"compares, {sass['stall_cycles_per_step']:.1f} static stall "
            f"cycles a step")


def check_chain(sass: dict, what: str, divisions: bool = False) -> None:
    """A chain loop without local memory and, but for the slow-path calls
    of IEEE divisions (AutoGain's), without branches."""
    check(sass["ldl"] == 0 and sass["stl"] == 0,
          f"{what}: local memory in the chain loop")
    check(divisions or sass["bra"] == sass["bssy"] == sass["call"] == 0,
          f"{what}: branches in the chain loop")


def rider_batches() -> dict:
    """Each step functor's kBatch (steps a chain batch) in
    csrc/riders.cu, by struct name."""
    with open(os.path.join(_build.CSRC_DIR, "riders.cu")) as f:
        src = f.read()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"struct (\w+Step) : StepBase \{.*?kBatch = (\d+);", src, re.S)}


def sass_rider_chain(kernel: str, batch: int) -> dict:
    """rider_kernel's chain loop for one step functor in the SASS: the
    code from the batch's first 16-byte shared load of pre words
    (LDS.128; where the step reads none, from the start of the basic
    block of its first record store) to its last 16-byte record store
    (STS.128), the chain thread's alone (the producers and consumers
    move single words): its instructions, local-memory traffic (LDL,
    STL), branches (BRA, BSSY, CALL: an IEEE division's slow path is a
    call), predicate compares and static stall cycles per step over
    ``batch`` steps."""
    ins, first, last = [], None, None
    for blk in sass_blocks("riders", kernel):
        start = len(ins)
        for op, stall in blk:
            if "LDS.128" in op and first is None:
                first = len(ins)
            if "STS.128" in op:
                first = start if first is None else first
                last = len(ins)
            ins.append((op, stall))
    check(last is not None, f"{kernel}: no chain batch (STS.128) in the SASS")
    span = ins[first:last + 1]
    return dict(instructions=len(span), ldl=sass_count(span, "LDL"),
                stl=sass_count(span, "STL"), bra=sass_count(span, "BRA"),
                bssy=sass_count(span, "BSSY"),
                call=sass_count(span, "CALL"),
                setp=sass_count(span, "FSETP") + sass_count(span, "ISETP"),
                stall_cycles_per_step=sum(st for _, st in span) / batch)


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
        yk = fdl_fused(*ring_k[:2], *hp, ring_k.history, x, w)[0]
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
        ya = fdl_fused(*ring_a[:2], *hp, ring_a.history, x, w)[0]
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


def sos_f64(coeffs, x: np.ndarray) -> np.ndarray:
    """Float64 DF2T cascade of the same float32 sections over the last
    axis (scipy's sosfilt runs the same recurrence)."""
    from scipy.signal import sosfilt
    c = np.asarray(coeffs, np.float64)
    sos = np.concatenate([c[:, :3], np.ones((len(c), 1)), -c[:, 3:]], 1)
    return sosfilt(sos, np.asarray(x, np.float64), axis=-1)


def dyn_f64(coeffs, x: np.ndarray) -> np.ndarray:
    """Float64 per-sample cascade: coeffs [C, T, K, 5], x [C, T]."""
    c = np.asarray(coeffs, np.float64)
    s = np.zeros((x.shape[0], c.shape[2], 2))
    out = np.empty(x.shape)
    for n in range(x.shape[1]):
        v = x[:, n].astype(np.float64)
        for i in range(c.shape[2]):
            b0, b1, b2, a1, a2 = (c[:, n, i, j] for j in range(5))
            y = b0 * v + s[:, i, 0]
            s[:, i, 0] = b1 * v + a1 * y + s[:, i, 1]
            s[:, i, 1] = b2 * v + a2 * y
            v = y
        out[:, n] = v
    return out


def fir_f64(params, n: int, x: np.ndarray) -> np.ndarray:
    """The Equalizer's FIR/FFT mode in float64: the linear convolution
    with the mode's own FIR (the float32 spectrum, inverted), delayed by
    the frame of output buffering (latency N + N/2 with the FIR's
    centre)."""
    from scipy.signal import fftconvolve
    spec = (params.conv_re.cpu().numpy().astype(np.float64)
            + 1j * params.conv_im.cpu().numpy().astype(np.float64))
    h = np.fft.irfft(spec, 2 * n)[:n]
    t = x.shape[-1]
    y = fftconvolve(np.asarray(x, np.float64), h[None], axes=-1)[:, :t - n]
    return np.concatenate([np.zeros((x.shape[0], n)), y], axis=-1)


def spm_f64(params, n: int, x: np.ndarray) -> np.ndarray:
    """The Equalizer's SPM mode in float64: 50 %-overlap frames, the
    zero-phase bin gains, the squared-cosine window, overlap-add, one hop
    of output buffering."""
    half = n // 2
    c, t = x.shape
    hops = np.asarray(x, np.float64).reshape(c, t // half, half)
    prev = np.concatenate([np.zeros((c, 1, half)), hops[:, :-1]], axis=1)
    frames = np.concatenate([prev, hops], axis=-1)
    g = params.spm_gain.cpu().numpy().astype(np.float64)
    y = np.fft.irfft(np.fft.rfft(frames, axis=-1) * g, n, axis=-1)
    y = y * windows.sqr_cosine(n)
    tails = np.concatenate([np.zeros((c, 1, half)), y[:, :-1, half:]],
                           axis=1)
    computed = y[:, :, :half] + tails
    emitted = np.concatenate([np.zeros((c, 1, half)), computed[:, :-1]],
                             axis=1)
    return emitted.reshape(c, t)


class OpCount(TorchDispatchMode):
    """Counts the operations a call dispatches, views and allocations
    left out: on the card each is one kernel launch; and, in ``syncs``,
    the host round trips among them (copies from the card to the CPU and
    scalar reads)."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.syncs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default or (
                func is torch.ops.aten._to_copy.default
                and args[0].device.type == "cuda"
                and str(kwargs.get("device", "cuda")) == "cpu"):
            self.syncs += 1
        if not func.is_view and func not in (
                torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.new_empty.default):
            self.n += 1
        return func(*args, **kwargs)


def filters_phase(dev, res):
    """The filter units on the biquad cascade at full width (64 channels
    at 48 kHz, 2 calls of 16384 with the state carried); kernel
    biquad_seq against its plain version; every unit against float64."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(13)
    eq_bands = pipeline.default_eq_params(SR)

    def eq(mode, **kw):
        e = flt.Equalizer(SR, filters=8, mode=mode, **kw)
        for i, p in enumerate(eq_bands):
            e.set_params(i, p)
        return e

    eqs = {"iir_fused": eq(flt.EqMode.IIR),
           "iir_seq": eq(flt.EqMode.IIR, iir_block=None),
           "fir": eq(flt.EqMode.FIR, fir_rank=12),
           "fft": eq(flt.EqMode.FFT, fir_rank=12),
           "spm": eq(flt.EqMode.SPM, fir_rank=12)}
    eq_p = {k: e.build(device=dev) for k, e in eqs.items()}
    c9 = eq_p["iir_seq"].coeffs                     # the chain's K = 9
    k9 = c9.shape[0]
    t_all = FILT_CALLS * FILT_T
    swell = np.sin(np.linspace(0.0, np.pi, t_all))
    gain_all = torch.from_numpy((10.0 ** ((-12.0 + 24.0 * swell) / 20.0))
                                .astype(np.float32)).to(dev).expand(C, t_all)
    dynp = flt.FilterParams(ftype=flt.FilterType.BT_BWC_BELL, freq=1000.0,
                            slope=2, quality=0.7)

    # 1. biquad_seq against its plain version on the card at the main
    #    path's [64, 16384], two calls with the state carried, on the main
    #    path's input; static from a non-zero state
    x_np = (rng.standard_normal((C, t_all)) * 0.25).astype(np.float32)
    xd = torch.from_numpy(x_np).to(dev)
    s_k = (torch.from_numpy(rng.standard_normal((C, k9, 2)).astype(
        np.float32)) * 0.1).to(dev)
    s_p = s_k.clone()
    cd = dynf._design_per_sample(dynp, gain_all, SR)
    k4 = cd.shape[-2]
    d_k = torch.zeros(C, k4, 2, device=dev)
    d_p = d_k.clone()
    same, worst = True, 0.0
    plain_ms = {}
    for k in range(FILT_CALLS):
        sl = slice(k * FILT_T, (k + 1) * FILT_T)
        xk, ck = xd[:, sl], cd[:, sl]
        y_k, s_k = bq.biquad_cascade_seq(c9, s_k, xk)
        ms_p, (y_p, s_p) = time_once_ms(
            lambda: bq.biquad_cascade_seq_plain(c9, s_p, xk))
        dy_k, d_k = bq.dyn_biquad_cascade_seq(ck, d_k, xk)
        ms_d, (dy_p, d_p) = time_once_ms(
            lambda: bq.dyn_biquad_cascade_seq_plain(ck, d_p, xk))
        plain_ms.setdefault("static", ms_p)
        plain_ms.setdefault("dyn", ms_d)
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for a, b in (
            (y_k, y_p), (s_k, s_p), (dy_k, dy_p), (d_k, d_p)))
        worst = max(worst, max_abs(y_p, y_k), max_abs(dy_p, dy_k),
                    max_abs(s_p, s_k), max_abs(d_p, d_k))
    del cd
    print(f"parity biquad_seq: [{C}, {FILT_T}] x {FILT_CALLS} calls, the "
          f"main path's input, state carried: static K = {k9} (the chain's "
          f"8 bands, from a non-zero state) and per-sample K = {k4} "
          f"(DynamicFilters BT_BWC_BELL slope 2 on a -12..+12 dB swell), "
          f"y and state identical = {same}, max abs err {worst:.3g}")
    check(same, "biquad_seq differs from its plain version")

    # 2. the units at full width, the launch counters zeroed just before
    tilt = flt.SpectralTilt(SR, order=16, lower_freq=100.0,
                            upper_freq=10000.0)
    dyn = flt.DynamicFilters(SR, 1)
    dyn.set_params(0, dynp)
    fil_a = flt.Filter(SR, flt.FilterParams(
        ftype=flt.FilterType.BT_RLC_BELL, freq=1000.0, gain=2.0, slope=2,
        quality=1.0))
    fil_s = flt.Filter(SR, flt.FilterParams(
        ftype=flt.FilterType.MT_BWC_HIPASS, freq=80.0, slope=3))
    bw = flt.ButterworthFilter(SR, 8, 2000.0, flt.BWFilterType.LOWPASS,
                               device=dev)
    xo = Crossover(SR, [(120.0, CrossoverSlope.LR2),
                        (1000.0, CrossoverSlope.LR8),
                        (8000.0, CrossoverSlope.LR28)], device=dev)
    units = {
        **{k: (lambda k: lambda st, x, g: eqs[k].process(eq_p[k], st, x))(k)
           for k in eqs},
        "tilt": lambda st, x, g: tilt.process(st, x),
        "dyn_assoc": lambda st, x, g: dyn.process(0, st, x, g),
        "dyn_seq": lambda st, x, g: dyn.process(0, st, x, g, method="seq"),
        "filter_assoc": lambda st, x, g: fil_a.process(st, x),
        "filter_seq": lambda st, x, g: fil_s.process(st, x, method="seq"),
        "butterworth": lambda st, x, g: bw.process(st, x),
        "crossover": lambda st, x, g: xo.process(st, x),
    }

    def init_states():
        return {**{k: eqs[k].init_state(eq_p[k], (C,), device=dev)
                   for k in eqs},
                "tilt": tilt.init_state((C,), device=dev),
                "dyn_assoc": dyn.init_state(0, (C,), device=dev),
                "dyn_seq": dyn.init_state(0, (C,), device=dev),
                "filter_assoc": fil_a.init_state((C,), device=dev),
                "filter_seq": fil_s.init_state((C,), device=dev),
                "butterworth": bw.init_state((C,), device=dev),
                "crossover": xo.init_state((C,), device=dev)}

    counted = (bq.biquad_cascade_seq, bq.dyn_biquad_cascade_seq,
               bq.biquad_cascade, fp.rfft_packed, fp.rfft_packed_zeropad,
               fp.irfft_packed)
    states = init_states()
    outs = {k: [] for k in units}
    torch.cuda.synchronize()
    for f in counted:
        f.launches = 0
    t0 = time.perf_counter()
    for k in range(FILT_CALLS):
        sl = slice(k * FILT_T, (k + 1) * FILT_T)
        for name, fn in units.items():
            states[name], y = fn(states[name], xd[:, sl], gain_all[:, sl])
            outs[name].append(y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {f.__name__: f.launches for f in counted}
    print(f"filters: {len(units)} units x {FILT_CALLS} calls of [{C}, "
          f"{FILT_T}] in {wall:.2f} s (host clock); launches {launched}")
    check(launched["biquad_cascade_seq"] >= 4 * FILT_CALLS,
          f"biquad_seq launched {launched['biquad_cascade_seq']} times")
    for name, cnt in launched.items():
        check(cnt >= FILT_CALLS, f"{name} launched {cnt} < {FILT_CALLS}")
    ys = {k: torch.cat(v, dim=-1) for k, v in outs.items()}
    for name, y in ys.items():
        want = (xo.num_bands, C, t_all) if name == "crossover" else (C, t_all)
        check(tuple(y.shape) == want and bool(torch.isfinite(y).all()),
              f"{name} output not finite or of the wrong shape")

    # one process_xfade after the two FIR calls: it emits the frame the
    # old parameters' path emits, and the stream goes on finite
    n_fir = eqs["fir"].fir_size
    new_bands = list(eq_bands)
    new_bands[6] = flt.FilterParams(ftype=new_bands[6].ftype,
                                    freq=new_bands[6].freq, gain=0.25,
                                    slope=new_bands[6].slope,
                                    quality=new_bands[6].quality)
    eq_new = eq(flt.EqMode.FIR, fir_rank=12)
    eq_new.set_params(6, new_bands[6])
    p_new = eq_new.build(device=dev)
    frame = torch.roll(xd[:, :n_fir], 7, dims=-1)
    st_x, y_x = eqs["fir"].process_xfade(eq_p["fir"], p_new, states["fir"],
                                         frame)
    _, y_old = eqs["fir"].process(eq_p["fir"], states["fir"], frame)
    _, y_after = eqs["fir"].process(p_new, st_x, xd[:, :3 * n_fir])
    xf_ok = bool(torch.equal(y_x, y_old)) and bool(
        torch.isfinite(y_after).all())
    print(f"Equalizer FIR process_xfade: emitted frame identical to the old "
          f"path's, then 3 frames finite = {xf_ok}")
    check(xf_ok, "process_xfade")

    # 3. each unit against its float64 ideal (whole [64, 2 x 16384])
    c_np = c9.cpu().numpy()
    ideal = {
        "iir_fused": (sos_f64(c_np, x_np), FUSED_DB),
        "iir_seq": (sos_f64(c_np, x_np), SEQ_FLOOR_DB),
        "fir": (fir_f64(eq_p["fir"], n_fir, x_np), FFT_DB),
        "fft": (fir_f64(eq_p["fft"], n_fir, x_np), FFT_DB),
        "spm": (spm_f64(eq_p["spm"], n_fir, x_np), FFT_DB),
        "tilt": (sos_f64(tilt.coefficients(device="cpu"), x_np), TILT_DB),
        "filter_assoc": (sos_f64(fil_a.coefficients(device="cpu"), x_np),
                         ASSOC_DB),
        "filter_seq": (sos_f64(fil_s.coefficients(device="cpu"), x_np),
                       SEQ_FLOOR_DB),
        "butterworth": (sos_f64(bw.coefficients().cpu(), x_np), BW_DB),
    }
    dyn_ideal = dyn_f64(dynf._design_per_sample(dynp, gain_all, SR).cpu(),
                        x_np)
    ideal["dyn_assoc"] = (dyn_ideal, DYNF_DB)
    ideal["dyn_seq"] = (dyn_ideal, DYNF_DB)
    dbs = {}
    for name, (ref, bar) in ideal.items():
        dbs[name] = snr_db(torch.from_numpy(ref), ys[name].cpu())
        print(f"filters {name} vs float64: {dbs[name]:.2f} dB (bar {bar})")
        check(dbs[name] >= bar, f"{name} {dbs[name]:.2f} dB < {bar}")
    xo_y = ys["crossover"].cpu()
    band_ref = [sos_f64(xo._coeffs[b].cpu(), x_np)
                for b in range(xo.num_bands)]
    for b, (ref, bar) in enumerate(zip(band_ref, XOVER_FLOORS)):
        db = snr_db(torch.from_numpy(ref), xo_y[b])
        dbs[f"crossover_band{b}"] = db
        print(f"filters crossover band {b} vs float64: {db:.2f} dB (bar "
              f"{bar})")
        check(db >= bar, f"crossover band {b} {db:.2f} dB < {bar}")
    # the band sum is allpass: against the float64 bands' sum, and the
    # float64 charts' sum has magnitude 1
    db = snr_db(torch.from_numpy(sum(band_ref)), xo_y.sum(0))
    freqs = np.geomspace(20.0, 20000.0, 64)
    mag = np.abs(sum(xo.freq_chart(b, freqs) for b in range(xo.num_bands)))
    dbs["crossover_sum"] = db
    print(f"filters crossover band sum vs float64: {db:.2f} dB (bar "
          f"{XOVER_FLOORS[0]}); float64 chart |sum| within "
          f"{np.abs(mag - 1.0).max():.1e} of 1")
    check(db >= XOVER_FLOORS[0] and np.abs(mag - 1.0).max() < 1e-9,
          "crossover band sum not allpass")
    # BASELINE config 1 (tests/test_e2e_chain.py): the BWC hi-shelf, +6
    # dB at 1 kHz, slope 2, on the phase's input, whole and streamed in
    # odd chunks of 127 (the time-parallel scan on the card)
    c1 = flt.Filter(SR, flt.FilterParams(
        ftype=flt.FilterType.BT_BWC_HISHELF, slope=2, freq=1000.0, gain=2.0))
    ref1 = torch.from_numpy(sos_f64(c1.coefficients(device="cpu"), x_np))
    _, y1 = c1.process(c1.init_state((C,), device=dev), xd)
    st1, parts = c1.init_state((C,), device=dev), []
    for i in range(0, xd.shape[-1], 127):
        st1, y = c1.process(st1, xd[:, i:i + 127])
        parts.append(y)
    for key, y in (("config1", y1), ("config1_chunks127",
                                     torch.cat(parts, -1))):
        dbs[key] = snr_db(ref1, y.cpu())
        print(f"filters BASELINE config 1 ({key}) vs float64: "
              f"{dbs[key]:.2f} dB (bar {CONFIG1_DB})")
        check(dbs[key] >= CONFIG1_DB,
              f"{key} {dbs[key]:.2f} dB < {CONFIG1_DB}")
    res["filters_vs_float64_db"] = dbs

    # TF32 on: the first call of every unit again, identical
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    states = init_states()
    same = True
    for name, fn in units.items():
        _, y = fn(states[name], xd[:, :FILT_T], gain_all[:, :FILT_T])
        same = same and bool(torch.equal(y, outs[name][0]))
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    print(f"filters, TF32 on: every unit's output identical = {same}")
    check(same, "filters output changed with TF32 switched on")

    # the time-parallel units now run biquad_scan: their first call again
    # on the plain scan (the path of their PR 8 readings) is identical,
    # so their dB against float64 are PR 8's
    kernel = bq.biquad_cascade
    bq.biquad_cascade = bq.biquad_cascade_plain
    try:
        states = init_states()
        same = all(torch.equal(units[k](states[k], xd[:, :FILT_T],
                                        gain_all[:, :FILT_T])[1],
                               outs[k][0])
                   for k in ("filter_assoc", "butterworth", "crossover"))
    finally:
        bq.biquad_cascade = kernel
    print(f"filters on biquad_scan (Filter assoc, Butterworth, Crossover): "
          f"first call identical on the plain scan = {same}")
    check(same, "a time-parallel unit differs between biquad_scan and the "
                "plain scan")

    # 4. timings at [64, 16384]: the kernel (static K = 9 and per-sample
    #    K = 4) and its plain loop; the plain associative scan
    x16 = xd[:, :FILT_T].contiguous()
    s0 = torch.zeros(C, k9, 2, device=dev)
    d0 = torch.zeros(C, k4, 2, device=dev)
    cd16 = dynf._design_per_sample(dynp, gain_all[:, :FILT_T], SR)
    ms = time_ms(lambda: bq.biquad_cascade_seq(c9, s0, x16), 20)
    ms_dyn = time_ms(lambda: bq.dyn_biquad_cascade_seq(cd16, d0, x16), 20)
    with OpCount() as ops:
        bq.biquad_cascade_plain(c9, s0, x16)
    assoc_ms, _ = time_once_ms(lambda: bq.biquad_cascade_plain(c9, s0, x16))
    clock = sm_clock_hz()
    steps = FILT_T + k9 - 1
    flops = 9.0 * C * FILT_T          # 5 products + 4 sums a stage-sample
    res["bq"] = dict(
        launches=launched["biquad_cascade_seq"],
        dyn_launches=launched["dyn_biquad_cascade_seq"], max_abs_err=worst,
        ms=ms,
        plain_ms=plain_ms["static"], library_ms=None,
        # x read and y written once, the coefficients and the state in/out
        **bound(F32 * (2 * C * FILT_T + 5 * k9 + 4 * C * k9), flops * k9),
        chain_ms=FILT_T * 4 * 4 / clock * 1e3,
        cycles_per_step=ms * 1e-3 * clock / steps, sm_clock_hz=clock,
        dyn_ms=ms_dyn, dyn_plain_ms=plain_ms["dyn"],
        dyn_bound_ms=bound(F32 * (2 * C * FILT_T + 5 * C * FILT_T * k4
                                  + 4 * C * k4), flops * k4)["bound_ms"],
        dyn_chain_ms=FILT_T * 4 * 4 / clock * 1e3,
        dyn_cycles_per_step=ms_dyn * 1e-3 * clock / (FILT_T + k4 - 1),
        assoc_launches_per_call=ops.n, assoc_ms=assoc_ms)
    r = res["bq"]
    print(f"biquad_seq: [{C}, {FILT_T}] K = {k9}: {ms:.4f} ms "
          f"({r['cycles_per_step']:.2f} cycles a step at "
          f"{clock / 1e9:.3f} GHz), plain {plain_ms['static']:.1f} ms; bounds: "
          f"bytes {r['bound_ms']:.4f} ms, chain {r['chain_ms']:.4f} ms "
          f"(T x 4 dependent ops x 4 cycles); per-sample K = {k4}: "
          f"{ms_dyn:.4f} ms ({r['dyn_cycles_per_step']:.2f} cycles a step), "
          f"plain {plain_ms['dyn']:.1f} ms, bytes bound "
          f"{r['dyn_bound_ms']:.4f} ms; launches on the drive "
          f"{r['launches']}, {r['dyn_launches']} of them per-sample "
          f"({card_line()})")
    print(f"plain associative scan (biquad_cascade_plain) at [{C}, "
          f"{FILT_T}] K = {k9}: {ops.n} launches per call, {assoc_ms:.1f} ms "
          f"on the card (one call, host-paced)")
    print(f"filters phase: {time.perf_counter() - t_start:.1f} s")


def f64_sliding_mean(sq: np.ndarray, n: int) -> np.ndarray:
    """Float64 trailing mean over n samples from zero history."""
    cs = np.concatenate([np.zeros(sq.shape[:-1] + (1,)),
                         np.cumsum(sq, axis=-1)], axis=-1)
    t = sq.shape[-1]
    lo = np.clip(np.arange(t) + 1 - n, 0, None)
    return (cs[..., 1:] - cs[..., lo]) / n


def loudness_f64(meter, x: np.ndarray) -> np.ndarray:
    """LoudnessMeter's output in float64: scipy sosfilt on the same
    weighting sections, squares, the trailing mean, the channel mix."""
    y = sos_f64(meter._coeffs.cpu(), x)
    ms = f64_sliding_mean(y * y, meter.period)
    w = meter.weights.cpu().double().numpy()[:, None]
    return np.sqrt(np.sum(w * ms, axis=0))


def true_peak_f64(meter, x: np.ndarray) -> np.ndarray:
    """TruePeakMeter in float64: the same Lanczos polyphase taps."""
    m = resample._phase_matrix(meter.ratio, meter.lobes)
    a = meter.lobes
    fr = np.concatenate([np.zeros(x.shape[:-1] + (2 * a,)),
                         x.astype(np.float64)], axis=-1)
    t = x.shape[-1]
    out = np.empty(x.shape)
    for j0 in range(0, t, 4096):
        idx = np.arange(j0, min(t, j0 + 4096))[:, None] + np.arange(
            2 * a + 1)[None, :]
        out[..., j0:j0 + idx.shape[0]] = np.abs(
            np.einsum("...tj,jp->...tp", fr[..., idx], m)).max(-1)
    return out


def dynamics_phase(dev, res):
    """The Limiter, the serial riders and the meters at full width (64
    channels at 48 kHz, 2 calls of 16384 with the state carried):
    BASELINE config 4 with two limiters, the riders, the loudness leg;
    kernels limiter_kernel and rider_kernel against their plain versions
    on the drive's own inputs; the meters against float64."""
    t_start = time.perf_counter()
    t_n, calls = DYN_T, DYN_CALLS
    t_all = t_n * calls
    rng = np.random.default_rng(2)
    # config 4's rising-level noise (tests/test_baseline_configs.py),
    # stretched to the phase's length
    x_np = (rng.standard_normal((C, t_all))
            * np.linspace(0.1, 1.5, t_all)).astype(np.float32)
    xd = torch.from_numpy(x_np).to(dev)
    side = Sidechain(SR, SidechainMode.RMS, reactivity_ms=5.0)
    comp = Compressor(SR, attack_thresh=0.3, release_thresh=0.15,
                      attack_ms=5.0, release_ms=50.0, ratio=4.0,
                      knee=0.7071)
    gate = Gate(SR, threshold=0.05, zone=0.5, reduction=0.05,
                attack_ms=1.0, release_ms=20.0)
    cp, gp = comp.build(), gate.build()
    lims = {"thin_2ms": Limiter(SR, LimiterMode.HERM_THIN, threshold=0.8,
                                lookahead_ms=2.0),
            "exp_wide_alr_5ms": Limiter(SR, LimiterMode.EXP_WIDE,
                                        threshold=0.8, lookahead_ms=5.0,
                                        alr=True)}
    lps = {k: v.build(device=dev) for k, v in lims.items()}

    # the riders' inputs: levels over 100 dB, rising; a bursty detector
    lvl_np = np.abs(rng.standard_normal((C, t_all))
                    * np.geomspace(1e-5, 2.0, t_all)).astype(np.float32)
    lvl = torch.from_numpy(lvl_np).to(dev)
    short = (lvl * torch.from_numpy(np.clip(
        1.0 + 0.3 * rng.standard_normal((C, t_all)), 0.1, None).astype(
        np.float32)).to(dev)).contiguous()
    burst = torch.from_numpy((rng.standard_normal((C, t_all)) * np.where(
        np.arange(t_all) % 9000 < 4000, 0.5, 1e-3)).astype(
        np.float32)).to(dev)
    target = torch.full((C, 1), 0.2, device=dev)
    dp = DynamicProcessor(SR, in_ratio=1.0, out_ratio=2.0, hold_ms=1.0,
                          attack_time_ms=[5, 1, 2, 3, 4],
                          release_time_ms=[50, 20, 30, 40, 60])
    for i, dot in enumerate([(0.01, 0.02, 0.5), (0.1, 0.08, 0.7),
                             (0.5, 0.3, 0.8), (0.9, 0.5, 0.9)]):
        dp.set_dot(i, *dot)       # tests/test_dynamics2.py's curve, 4 dots
    for i, lv in enumerate((0.05, 0.1, 0.3, 0.6)):
        dp.set_attack_level(i, lv)
        dp.set_release_level(i, lv * 0.8)
    dpp = dp.build(device=dev)
    ag = {"autogain": AutoGain(SR, long_grow_db_s=60.0, long_fall_db_s=60.0),
          "autogain_quick": AutoGain(SR, quick_amplifier=True,
                                     use_max_gain=True, max_gain=3.0)}
    sag = SimpleAutoGain(SR, grow_db_s=120.0, deviation=1.5)
    surge = SurgeProtector(0.1, 0.01, 100, 2000)
    pm = mtr.PeakMeter(SR, hold_ms=2.0, release_ms=50.0)
    # name -> (wrapper, plain, unit state factory, inputs of call k)
    def sl(v, k):
        return v[..., k * t_n:(k + 1) * t_n]

    rider_cases = {
        **{k: (lambda u: (
            lambda st, *a: riders.autogain(u, st, *a),
            lambda st, *a: riders.autogain_plain(u, st, *a),
            lambda: u.init_state((C,), device=dev),
            lambda k: (sl(lvl, k), sl(short, k), target)))(u)
           for k, u in ag.items()},
        "simple": (lambda st, *a: riders.simple_autogain(sag, st, *a),
                   lambda st, *a: riders.simple_autogain_plain(sag, st, *a),
                   lambda: sag.init_state((C,), device=dev),
                   lambda k: (sl(lvl, k), target)),
        "surge": (lambda st, *a: riders.surge_protector(surge, st, *a),
                  lambda st, *a: riders.surge_protector_plain(surge, st, *a),
                  lambda: surge.init_state((C,), device=dev),
                  lambda k: (sl(burst, k),)),
        "peak": (lambda st, *a: riders.peak_meter(pm, st, *a),
                 lambda st, *a: riders.peak_meter_plain(pm, st, *a),
                 lambda: pm.init_state((C,), device=dev),
                 lambda k: (sl(burst, k),)),
        "dynproc": (lambda st, *a: riders.dynproc_envelope(dpp, st, *a),
                    lambda st, *a: riders.dynproc_envelope_plain(
                        dpp, st, *a),
                    lambda: dp.init_state((C,), device=dev),
                    lambda k: (sl(lvl, k),)),
    }

    # the loudness leg: a stereo program with a slow level swell, the
    # 64 channels, and 32 channel pairs
    swell = (0.05 + 0.3 * np.sin(np.linspace(0.0, np.pi, t_all)) ** 2)
    prog_np = (rng.standard_normal((2, t_all)) * swell).astype(np.float32)
    prog = torch.from_numpy(prog_np).to(dev)
    lm_s = mtr.LoudnessMeter(SR, 2, 400.0, device=dev)
    lm_l = mtr.LoudnessMeter(SR, 2, 3000.0, device=dev)
    lm_64 = mtr.LoudnessMeter(SR, C, 400.0, device=dev)
    ilufs = mtr.ILUFSMeter(SR, C, device=dev)
    t_ilufs = 4 * ilufs.block
    tpm = mtr.TruePeakMeter(SR)
    corr = mtr.Correlometer(window=4800)
    pans = {law: mtr.Panometer(4800, law) for law in mtr.PanLaw}
    lo_gain = AutoGain(SR, quick_amplifier=True)
    l_exp = torch.tensor(10.0 ** (-20.0 / 20.0), device=dev)
    pair_a, pair_b = xd[0::2], (0.6 * xd[0::2] + 0.4 * xd[1::2])

    counted = (lim_ops.limiter, *riders.RIDERS, bq.biquad_cascade_seq)

    def drive(n_calls):
        """Every unit over n_calls calls; returns their outputs, and for
        the limiters and riders each call's (state in, inputs, state out,
        output)."""
        st = dict(side=side.init_state((C,), dev),
                  comp=comp.init_state((C,), dev),
                  gate=gate.init_state((C,), dev),
                  **{k: v.init_state((C,), device=dev)
                     for k, v in lims.items()},
                  **{k: c[2]() for k, c in rider_cases.items()},
                  lm_s=lm_s.init_state(), lm_l=lm_l.init_state(),
                  lm_64=lm_64.init_state(),
                  lo_gain=lo_gain.init_state(device=dev),
                  tp=tpm.init_state((C,), device=dev),
                  corr=corr.init_state((C // 2,), device=dev),
                  **{f"pan_{law.value}": p.init_state((C // 2,), device=dev)
                     for law, p in pans.items()})
        hist = {k: torch.zeros(C, v.lookahead, device=dev)
                for k, v in lims.items()}
        out = {k: [] for k in ("y", *(f"out_{n}" for n in lims),
                               "lo_vca", "lm_64", "tp", "corr",
                               *(f"pan_{w.value}" for w in mtr.PanLaw))}
        trace = {k: [] for k in (*lims, *rider_cases)}
        for k in range(n_calls):
            xk = sl(xd, k)
            st["side"], level = side.process(st["side"], xk)
            st["comp"], cg, _ = comp.process(cp, st["comp"], level)
            st["gate"], gg, _ = gate.process(gp, st["gate"], level)
            y = xk * cg * gg
            out["y"].append(y)
            ay = torch.abs(y)
            for name, lim in lims.items():
                st0 = st[name]
                st[name], g = lim.process(lps[name], st0, ay)
                trace[name].append((st0, (ay,), st[name], g))
                frame = torch.cat([hist[name], y], dim=-1)
                hist[name] = frame[:, -lim.lookahead:]
                out[f"out_{name}"].append(frame[:, :t_n] * g)
            for name, (fn, _, _, ins) in rider_cases.items():
                st0 = st[name]
                st[name], o = fn(st0, *ins(k))
                trace[name].append((st0, ins(k), st[name], o))
            pk = sl(prog, k)
            st["lm_s"], l_short = lm_s.process(st["lm_s"], pk)
            st["lm_l"], l_long = lm_l.process(st["lm_l"], pk)
            st["lo_gain"], vca = lo_gain.process(st["lo_gain"], l_long,
                                                 l_short, l_exp)
            out["lo_vca"].append(vca)
            st["lm_64"], o = lm_64.process(st["lm_64"], xk)
            out["lm_64"].append(o)
            st["tp"], o = tpm.process(st["tp"], xk)
            out["tp"].append(o)
            st["corr"], o = corr.process(st["corr"], sl(pair_a, k),
                                         sl(pair_b, k))
            out["corr"].append(o)
            for law, p in pans.items():
                key = f"pan_{law.value}"
                st[key], o = p.process(st[key], sl(pair_a, k),
                                       sl(pair_b, k))
                out[key].append(o)
        ist, o = ilufs.process(ilufs.init_state(), xd[:, :t_ilufs])
        out["ilufs"] = [o]
        for name, tr in trace.items():
            out[name] = [o for (_, _, _, o) in tr]
        return out, trace, ist

    torch.cuda.synchronize()
    for f in counted:
        f.launches = 0
    t0 = time.perf_counter()
    outs, trace, ilufs_state = drive(calls)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {f.__name__: f.launches for f in counted}
    print(f"dynamics: config 4 + 2 limiters, {len(rider_cases)} riders, "
          f"the loudness leg over {calls} calls of [{C}, {t_n}] in "
          f"{wall:.2f} s (host clock); launches {launched}")
    check(launched["limiter"] >= len(lims) * calls,
          f"limiter_kernel launched {launched['limiter']} times")
    for f in riders.RIDERS:
        check(launched[f.__name__] >= calls,
              f"rider_kernel ({f.__name__}) launched "
              f"{launched[f.__name__]} times")
    # three LoudnessMeters a call, and ILUFS once
    check(launched["biquad_cascade_seq"] >= 3 * calls + 1,
          f"biquad_seq launched {launched['biquad_cascade_seq']} times")
    ys = {k: torch.cat(v, dim=-1) for k, v in outs.items()}
    for k, v in ys.items():
        check(bool(torch.isfinite(v).all()), f"{k} output not finite")

    # config 4's checks: the ceiling on each limiter's output, and the
    # compressor reduced the loud half
    y = ys["y"].cpu().numpy()
    half = t_all // 2
    reduced = float(np.abs(y[:, half:]).max()) < float(
        np.abs(x_np[:, half:]).max())
    peaks = {k: float(ys[f"out_{k}"].abs().max()) for k in lims}
    print(f"config 4: |y| max {np.abs(y).max():.4f} (loud half "
          f"{np.abs(y[:, half:]).max():.4f} < input's "
          f"{np.abs(x_np[:, half:]).max():.4f}: {reduced}); limited |out| "
          f"max " + ", ".join(f"{k} {v:.6f}" for k, v in peaks.items())
          + f" (ceiling {CEILING:.4f})")
    check(reduced, "the compressor did not reduce the loud half")
    for k, v in peaks.items():
        check(v <= CEILING, f"limiter {k}: |out| {v} above {CEILING}")

    # kernels against their plain versions on the drive's own inputs and
    # states, both calls, output and state
    def lim_plain(name):
        lim, p = lims[name], lps[name]

        def run(st0, ay):
            g_c, e_c, gain, pss = lim_ops.limiter_plain(
                p, *st0, ay, lim.lookahead, lim.alr)
            return pss, type(st0)(g_c, e_c), gain
        return run

    plain = {name: lim_plain(name) for name in lims}
    plain.update({k: (lambda f: lambda st0, *a: (None, *f(st0, *a)))(c[1])
                  for k, c in rider_cases.items()})
    plain_ms, passes = {}, {}
    same = {"lim": True, "rider": True}
    worst = {"lim": 0.0, "rider": 0.0}
    for name, tr in trace.items():
        kind = "lim" if name in lims else "rider"
        for st0, args, st1, o in tr:
            ms_p, (pss, st_p, o_p) = time_once_ms(
                lambda: plain[name](st0, *args))
            plain_ms.setdefault(name, ms_p)
            if pss is not None:
                passes.setdefault(name, []).append(pss)
            pairs = [(o_p, o), *zip(st_p, st1)]
            torch.cuda.synchronize()
            same[kind] = same[kind] and all(torch.equal(a, b)
                                            for a, b in pairs)
            worst[kind] = max(worst[kind], *(max_abs(a, b)
                                             for a, b in pairs))
    n_pass = {k: [int(p.max()) for p in v] for k, v in passes.items()}
    print(f"parity limiter_kernel: [{C}, {t_n}] x {calls} calls, config 4's "
          f"|y|, state carried, HERM_THIN 2 ms and EXP_WIDE 5 ms with ALR: "
          f"gain and state identical = {same['lim']}, max abs err "
          f"{worst['lim']:.3g}; largest pass count of any row, by call: "
          + ", ".join(f"{k} {v}" for k, v in n_pass.items()))
    print(f"parity rider_kernel: [{C}, {t_n}] x {calls} calls, state "
          f"carried, {', '.join(rider_cases)}: output and state identical "
          f"= {same['rider']}, max abs err {worst['rider']:.3g}")
    check(same["lim"], "limiter_kernel differs from its plain version")
    check(same["rider"], "rider_kernel differs from its plain version")

    # the meters against float64 (whole [.., 2 x 16384])
    dbs = {}
    loud_ref = loudness_f64(lm_64, x_np)
    dbs["loudness_64ch_400ms"] = snr_db(torch.from_numpy(loud_ref),
                                        ys["lm_64"].cpu())
    tp_ref = true_peak_f64(tpm, x_np)
    dbs["true_peak"] = snr_db(torch.from_numpy(tp_ref), ys["tp"].cpu())
    a64 = pair_a.cpu().double().numpy()
    b64 = pair_b.cpu().double().numpy()
    sxy = f64_sliding_mean(a64 * b64, corr.window)
    sxx = f64_sliding_mean(a64 * a64, corr.window)
    syy = f64_sliding_mean(b64 * b64, corr.window)
    dbs["correlometer"] = snr_db(torch.from_numpy(
        sxy / np.sqrt(sxx * syy)), ys["corr"].cpu())
    for law in mtr.PanLaw:
        va, vb = sxx, syy
        if law == mtr.PanLaw.LINEAR:
            va, vb = np.sqrt(va), np.sqrt(vb)
        dbs[f"panometer_{law.value}"] = snr_db(
            torch.from_numpy(vb / (va + vb)), ys[f"pan_{law.value}"].cpu())
    bars = {"loudness_64ch_400ms": LOUD_DB, "true_peak": TP_DB,
            "correlometer": CORR_DB, "panometer_linear": CORR_DB,
            "panometer_equal_power": CORR_DB}
    for name, bar in bars.items():
        print(f"dynamics {name} vs float64: {dbs[name]:.2f} dB (bar {bar})")
        check(dbs[name] >= bar, f"{name} {dbs[name]:.2f} dB < {bar}")
    il = ys["ilufs"].cpu().numpy()
    lufs = 20 * np.log10(float(ilufs.loudness_lufs_gain(ilufs_state)))
    want = 10 * np.log10(np.mean(loudness_f64(
        lm_64, x_np[:, :t_ilufs])[-1:] ** 2)) - 0.691
    print(f"ILUFS over 4 quarters x {ilufs.block} at [{C}, {t_ilufs}]: "
          f"{lufs:.3f} LUFS, the float64 momentary loudness of the block "
          f"{want:.3f} (output steps: {np.unique(il).size})")
    check(abs(lufs - want) < 0.05, "ILUFS far from its block's loudness")
    vca = ys["lo_vca"].cpu()
    print(f"loudness leg: AutoGain on the stereo program's 400 ms / 3000 "
          f"ms loudness, vca {float(vca.min()):.4f}..{float(vca.max()):.4f}")
    res["dynamics_vs_float64_db"] = dbs
    res["config4_peaks"] = peaks

    # TF32 on: the first call of every unit again, identical
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    outs_tf, _, _ = drive(1)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    same_tf = all(torch.equal(outs_tf[k][0], outs[k][0]) for k in outs_tf)
    print(f"dynamics, TF32 on: every unit's first call identical = "
          f"{same_tf}")
    check(same_tf, "dynamics output changed with TF32 switched on")

    # timings at [64, 16384], the first call's inputs and states
    clock = sm_clock_hz()
    lim_ms, lim_passes = {}, {}
    for name, lim in lims.items():
        st0, (ay,), _, _ = trace[name][0]
        lim_ms[name] = time_ms(lambda: lim_ops.limiter(
            lps[name], *st0, ay, lim.lookahead, lim.alr), 5)
        pk = lim_ops.limiter(lps[name], *st0, ay, lim.lookahead,
                             lim.alr)[3]
        check(torch.equal(pk, passes[name][0]),
              f"{name}: the kernel's pass counts differ from the plain's")
        lim_passes[name] = int(pk.max())
    la_b = {k: v.lookahead for k, v in lims.items()}

    def lim_bytes(name):
        p_n = lps[name].patch.shape[0]
        return F32 * (2 * C * t_n + 2 * C * 5 * la_b[name] + p_n + 2 * C) \
            + 4 * C

    def pass_ms(name):
        # the passes of the row that runs most, each its dependent
        # operations at 4 cycles
        return (lim_passes[name] * lim_ops.pass_chain_ops() * 4 / clock
                * 1e3)

    def pass_bytes(name):
        return lim_ops.pass_bytes(t_n, lps[name].patch.shape[0])

    a, b = "thin_2ms", "exp_wide_alr_5ms"
    res["lim"] = dict(
        launches=launched["limiter"], max_abs_err=worst["lim"],
        ms=lim_ms[a], plain_ms=plain_ms[a], library_ms=None,
        # what the function needs: a multiply and a compare a sample for
        # the first scan, the same for the P samples each pass patches,
        # over the passes each row ran, and the clamp's four a sample
        **bound(lim_bytes(a), 2.0 * (3 * C * t_n + lps[a].patch.shape[0]
                                     * int(passes[a][0].sum()))),
        pass_chain_ms=pass_ms(a), pass_bytes=pass_bytes(a),
        passes_max=lim_passes[a], sm_clock_hz=clock, alr_ms=lim_ms[b],
        alr_plain_ms=plain_ms[b],
        alr_chain_ms=t_n * ALR_CHAIN_OPS * 4 / clock * 1e3,
        alr_pass_chain_ms=pass_ms(b), alr_pass_bytes=pass_bytes(b),
        alr_passes_max=lim_passes[b])
    r = res["lim"]
    print(f"limiter_kernel: [{C}, {t_n}] HERM_THIN 2 ms: {r['ms']:.4f} ms "
          f"({lim_passes[a]} passes at most), plain {r['plain_ms']:.1f} ms; "
          f"bounds: {r['bound_ms']:.4f} ms ({r['bound_by']}), passes "
          f"{r['pass_chain_ms']:.4f} ms (passes x "
          f"{lim_ops.pass_chain_ops()} dependent ops x 4 cycles; a pass "
          f"moves {r['pass_bytes']} B of shared memory); EXP_WIDE 5 ms "
          f"with ALR: {r['alr_ms']:.4f} ms ({lim_passes[b]} passes), plain "
          f"{r['alr_plain_ms']:.1f} ms, ALR chain bound "
          f"{r['alr_chain_ms']:.4f} ms, passes {r['alr_pass_chain_ms']:.4f} "
          f"ms ({r['alr_pass_bytes']} B a pass) ({card_line()})")
    steps = {}
    batches = rider_batches()
    for name, (fn, _, _, _) in rider_cases.items():
        st0, args, _, _ = trace[name][0]
        ms = time_ms(lambda: fn(st0, *args), 5)
        n_in = len(args) if args[-1].shape[-1] == t_n else len(args) - 1
        ops = riders.chain_ops(RIDER_KIND[name])
        kernel, functor = RIDER_SASS[name]
        sass = sass_rider_chain(kernel, batches[functor])
        steps[name] = dict(
            ms=ms, plain_ms=plain_ms[name],
            bound_ms=bound(F32 * C * t_n * (n_in + 1), 0.0)["bound_ms"],
            chain_ms=t_n * ops * 4 / clock * 1e3, chain_ops=ops,
            cycles_per_step=ms * 1e-3 * clock / t_n,
            chain_cycles_per_step=ops * 4, sass=sass)
        print(f"rider_kernel {name}: {ms:.4f} ms "
              f"({steps[name]['cycles_per_step']:.1f} cycles a step against "
              f"a chain bound of {ops * 4}), plain "
              f"{plain_ms[name]:.1f} ms, chain bound "
              f"{steps[name]['chain_ms']:.4f} ms "
              f"({ops} dependent ops), bytes bound "
              f"{steps[name]['bound_ms']:.4f} ms; " + sass_line(sass))
        check_chain(sass, f"rider_kernel {name}",
                    divisions=name.startswith("autogain"))
    main = steps["autogain"]
    res["rider"] = dict(
        launches=sum(launched[f.__name__] for f in riders.RIDERS),
        max_abs_err=worst["rider"], ms=main["ms"],
        plain_ms=main["plain_ms"], library_ms=None,
        bound_ms=main["bound_ms"], bound_by="bytes",
        chain_ms=main["chain_ms"],
        cycles_per_step=main["cycles_per_step"], sm_clock_hz=clock,
        steps=steps)
    print(f"dynamics phase: {time.perf_counter() - t_start:.1f} s")


# --- the spectral phase: the spectral units, the Oversampler and the
#     measurement units (BASELINE configs 2, 3 and 5) ------------------------

SPEC_T, SPEC_CALLS = 16384, 2   # the spectral phase: 64 ch x T, state carried
ANA_T = 16800                   # the Analyzer's calls: 7 periods of 2400
OS_RATIOS = (2, 4, 8)           # config 2's Oversamplers
CONFIG3_BANDS = (               # tests/test_baseline_configs.py:90-96
    (True, None, 250.0, -48.0, 0.0, 1.0),
    (True, 250.0, 1500.0, -48.0, 0.0, 1.0),
    (True, 1500.0, 6000.0, -48.0, 0.0, 1.0),
    (True, 6000.0, None, -48.0, 0.0, 1.0))
XO_SUM_DB = 100.0      # config 3's band sum against the delayed input
#                        (tests/test_baseline_configs.py, > 100 dB)
LUFS_TOL, PEAK_TOL = 1.0, 0.01   # config 5 (tests/test_baseline_configs.py)
SPEC_DB = 110.0        # FFT-path units against float64 (the CPU rehearsal
#                        at 4 channels: >= 132 dB; the card's FFT kernel
#                        sits at ~131 dB, PERF.md)
LD_DELAY = 4321        # the LatencyDetector's loop delay, samples
CHIRP_MED_DB, CHIRP_MAX_DB = 0.1, 1.0   # the sweep's measured response in
#                        band (tests/test_measurement.py's bars)


def ola_f64(y2: np.ndarray, h: int) -> np.ndarray:
    """Windowed frames' second halves [C, M, 2h] overlap-added by hops of
    h and emitted one hop late, from zero state: [C, M h]."""
    c, m, _ = y2.shape
    z = np.zeros((c, 1, h))
    tails = np.concatenate([z, y2[:, :-1, h:]], axis=1)
    computed = y2[:, :, :h] + tails
    return np.concatenate([z, computed[:, :-1]], axis=1).reshape(c, m * h)


def spectral_f64(x: np.ndarray, rank: int, hook) -> np.ndarray:
    """SpectralProcessor in float64 from zero state: cosine-windowed 50 %
    frames, numpy FFTs, the hook on the complex spectra [C, M, F]."""
    n = 1 << rank
    h = n // 2
    c, t = x.shape
    hops = x.reshape(c, t // h, h)
    prev = np.concatenate([np.zeros((c, 1, h)), hops[:, :-1]], axis=1)
    w = windows.cosine(n)
    spec = np.fft.rfft(np.concatenate([prev, hops], axis=-1) * w, axis=-1)
    return ola_f64(np.fft.irfft(hook(spec), n, axis=-1) * w, h)


def splitter_f64(x: np.ndarray, rank: int, chunk_rank: int,
                 hooks) -> np.ndarray:
    """SpectralSplitter in float64 from zero state: [H, C, T]."""
    from numpy.lib.stride_tricks import sliding_window_view
    n, h = 1 << rank, 1 << (chunk_rank - 1)
    c, t = x.shape
    full = np.concatenate([np.zeros((c, n - h)), x], axis=-1)
    frames = sliding_window_view(full, n, axis=-1)[:, ::h]
    spec = np.fft.rfft(frames, axis=-1)
    w = windows.sqr_cosine(2 * h)
    outs = []
    for hook in hooks:
        y = frames if hook is None else np.fft.irfft(hook(spec), n, axis=-1)
        outs.append(ola_f64(y[..., -2 * h:] * w, h))
    return np.stack(outs)


def analyzer_f64(an, x: np.ndarray):
    """The Analyzer in float64 from zero state: (amp, data) [C, F]."""
    from numpy.lib.stride_tricks import sliding_window_view
    c, t = x.shape
    full = np.concatenate([np.zeros((c, an.n)), x], axis=-1)
    m = t // an.period
    frames = sliding_window_view(full, an.n, axis=-1)[:, ::an.period][:, :m]
    w = an._window.double().cpu().numpy()
    mags = np.abs(np.fft.rfft(frames * w, axis=-1))
    amp = data = np.zeros((c, an.f))
    for k in range(m):
        data = amp
        amp = amp * (1.0 - an.tau) + mags[:, k] * an.tau
    return amp, data


def oversampler_f64(ovs, x: np.ndarray, fn) -> np.ndarray:
    """The Oversampler in float64 from zero state: the same Lanczos taps,
    fn at the high rate, scipy sosfilt on the same float32 sections,
    decimation."""
    from numpy.lib.stride_tricks import sliding_window_view
    m = resample._phase_matrix(ovs.ratio, ovs.lobes)
    a = ovs.lobes
    c, t = x.shape
    fr = np.concatenate([np.zeros((c, 2 * a)), x], axis=-1)
    hi = np.einsum("ctj,jp->ctp", sliding_window_view(fr, 2 * a + 1, axis=-1)
                   [:, :t], m).reshape(c, t * ovs.ratio)
    return sos_f64(ovs.filter_coeffs.cpu(), fn(hi))[:, ::ovs.ratio]


# the kernels of csrc/biquad_scan.cu, by short name
SCAN_KERNELS = ("table_kernel", "shared_kernel", "per_row_kernel")


def scan_route_split(fn, ms: float, calls: int = 5) -> dict:
    """One call of the scan's backward route ``fn`` (``ms`` by events)
    split by torch.profiler: the scan kernels' ms and launches, torch's
    own launches (the adjoint's glue), and the rest, the host's gaps."""
    rows = profile_kernels(fn, calls, warm=5)
    scan = [v for k, v in rows.items() if launch_name(k) in SCAN_KERNELS]
    glue = [v for k, v in rows.items() if launch_name(k) not in SCAN_KERNELS]
    scan_ms = sum(v[0] for v in scan) / calls
    glue_ms = sum(v[0] for v in glue) / calls
    return dict(scan_kernels_ms=scan_ms,
                scan_launches=round(sum(v[1] for v in scan) / calls),
                glue_kernels_ms=glue_ms,
                glue_launches=round(sum(v[1] for v in glue) / calls),
                host_gaps_ms=ms - scan_ms - glue_ms)


def scan_flops(t: int, k: int, rows: int) -> float:
    """Operations the associative scan needs over T samples and K stages
    with coefficients shared by the rows, counted from its tree.  A
    combine is 12 operations for its 2 x 2 product and 8 for its vector.
    Up the tree every node of a level has the same matrix M_L: per row,
    8 a node (floor(n/2) at each level of n >= 2 nodes), and 12 a level
    a stage for M_L.  Down the tree ((n - 1) // 2 combines a level) the
    prefix matrices depend only on the position and the coefficients:
    per row 8 a combine, and 12 a combine once a stage.  A sample's leaf
    (u x, 2), s1 (4) and y (2) are per row."""
    up = down = levels = 0
    n = t
    while n >= 2:
        up += n // 2
        down += (n - 1) // 2
        levels += 1
        n //= 2
    per_row = 8.0 * (up + down) + 8.0 * t
    return float(k) * (rows * per_row + 12.0 * (levels + down))


def drive_latency_detector(dev, rng) -> tuple:
    """The LatencyDetector through a loop of LD_DELAY samples at gain 0.5
    with noise at -40 dB (rms 0.01), 4096 samples a block: (latency,
    blocks)."""
    from lsp_dsp_units_tpu_torch.models.util import LatencyDetector
    ld = LatencyDetector(SR, device=dev)
    ld.start_capture()
    blk, played = 4096, []
    noise = (rng.standard_normal(64 * blk) * 0.01).astype(np.float32)
    for k in range(64):
        played.append(ld.process_out(blk))
        full = np.concatenate(played)
        loop = np.concatenate([np.zeros(LD_DELAY, np.float32), full])
        ld.process_in(loop[full.size - blk:full.size] * 0.5
                      + noise[k * blk:(k + 1) * blk])
        if ld.latency_detected():
            return ld.get_latency(), k + 1
    return ld.get_latency(), 64


def drive_response_taker() -> tuple:
    """The ResponseTaker through a loop of 300 samples at gain 0.5, 256
    samples a block (tests/test_measurement.py): (capture, expected)."""
    from lsp_dsp_units_tpu_torch.models.util import ResponseTaker
    rt = ResponseTaker(SR, pause_s=288.0 / SR, tail_s=0.05)
    test = Sample(1, 1000, SR)
    test.data[0, 0], test.data[0, 500] = 1.0, -0.5
    test.data[0, 700:710] = np.linspace(0.1, 0.9, 10, dtype=np.float32)
    rt.reconfigure(test)
    rt.start_capture()
    latency, blk = 300, 256
    dline = np.zeros(latency, np.float32)
    out = np.zeros(blk, np.float32)
    for _ in range(SR // blk):
        inbuf = np.empty(blk, np.float32)
        for i in range(blk):
            inbuf[i] = dline[0] * np.float32(0.5)
            dline = np.roll(dline, -1)
            dline[-1] = out[i]
        out = rt.process(inbuf)
        if rt.cycle_complete:
            break
    want = np.zeros_like(rt.get_capture())
    want[latency + blk:latency + blk + 1000] = test.data[0] * np.float32(0.5)
    return rt.get_capture(), want


def chirp_response_db(dev, method) -> dict:
    """A 2 s sweep (20 Hz - 20 kHz) through a known filter (a +6 dB bell
    at 1 kHz and a 60 Hz high-pass, float64 sections), deconvolved on the
    card: the measured linear IR's magnitude against the filter's float64
    IR from 100 Hz to 15 kHz, in dB."""
    from scipy.signal import sosfilt
    from lsp_dsp_units_tpu_torch.models.util import SyncChirpProcessor
    from lsp_dsp_units_tpu_torch.models.util.sync_chirp import ChirpMethod
    scp = SyncChirpProcessor(SR, duration_s=2.0, f_start=20.0,
                             f_end=20000.0, method=ChirpMethod(method),
                             device=dev)
    sec = np.concatenate([flt.design_filter(p, SR).biquads for p in (
        flt.FilterParams(ftype=flt.FilterType.BT_RLC_BELL, freq=1000.0,
                         gain=2.0, slope=2, quality=1.0),
        flt.FilterParams(ftype=flt.FilterType.BT_BWC_HIPASS, freq=60.0,
                         slope=2))])
    sos = np.concatenate([sec[:, :3], np.ones((len(sec), 1)), -sec[:, 3:]],
                         axis=1)
    ir_len = 8192
    sweep = scp.sweep()
    resp = sosfilt(sos, np.concatenate([sweep.astype(np.float64),
                                        np.zeros(ir_len)])).astype(np.float32)
    ir = scp.linear_ir(resp, length=ir_len, pre=8)
    imp = np.zeros(ir_len)
    imp[0] = 1.0
    h = sosfilt(sos, imp)
    nfft = 1 << 15
    freqs = np.fft.rfftfreq(nfft, 1.0 / SR)
    band = (freqs > 100.0) & (freqs < 15000.0)
    err = 20 * np.log10(np.abs(np.fft.rfft(ir, nfft))[band]
                        / np.abs(np.fft.rfft(h, nfft))[band])
    return dict(n=scp.n, deconv_origin=scp.deconv_origin,
                median_db=float(np.abs(np.median(err))),
                max_db=float(np.abs(err).max()))


def spectral_phase(dev, res):
    """The spectral units, the Oversampler and the measurement units at
    full width (64 channels at 48 kHz, 2 calls of 16384 with the state
    carried; the Analyzer 2 calls of 16800): BASELINE configs 2, 3 and 5
    (unsharded) on one card; each output against float64; config 2's
    Oversamplers again on the plain scan, identical; the launch counters
    zeroed just before the drive and read just after."""
    from scipy.signal import fftconvolve
    from lsp_dsp_units_tpu_torch.models.util import (
        Analyzer, FFTCrossover, FFTCrossoverBand, MultiSpectralProcessor,
        Oversampler, SpectralProcessor, SpectralSplitter)
    t_start = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rng = np.random.default_rng(10)
    t_all = SPEC_T * SPEC_CALLS
    x_np = (rng.standard_normal((C, t_all)) * 0.25).astype(np.float32)
    xd = torch.from_numpy(x_np).to(dev)
    mix_w = 0.5

    sp = SpectralProcessor(12, device=dev)
    msp = MultiSpectralProcessor(C, 12, device=dev)
    spl = SpectralSplitter(12, 2, 10, device=dev)
    f12 = sp.frame // 2 + 1
    tilt_np = np.linspace(1.0, 0.25, f12) * np.exp(
        1j * np.linspace(0.0, 3.0, f12))
    tilt = torch.from_numpy(tilt_np.astype(np.complex64)).to(dev)
    spl_mask_np = np.linspace(0.0, 1.0, f12).astype(np.float32)
    spl_mask = torch.from_numpy(spl_mask_np).to(dev)
    # config 3: the ring convolver over config 3's 1 s IR, into the bands
    ir = (np.random.default_rng(1).standard_normal(SR)
          * np.exp(-4.0 * np.arange(SR) / SR)).astype(np.float32)
    ir[0] = 1.0
    conv = Convolver(ir, rank=12, device=dev)
    xo = FFTCrossover(SR, 11, [FFTCrossoverBand(*b) for b in CONFIG3_BANDS],
                      device=dev)
    an = Analyzer(SR, C, 12, rate=20.0, device=dev)
    check(an.period == 2400 and ANA_T % an.period == 0,
          f"Analyzer period {an.period}")
    xa_np = (rng.standard_normal((C, SPEC_CALLS * ANA_T)) * 0.25).astype(
        np.float32)
    xa = torch.from_numpy(xa_np).to(dev)
    # config 2: the chain's 8 bands as the fused IIR Equalizer into the
    # Oversamplers, tanh at the high rate
    eq = flt.Equalizer(SR, filters=8, mode=flt.EqMode.IIR)
    for i, p in enumerate(pipeline.default_eq_params(SR)):
        eq.set_params(i, p)
    eq_p = eq.build(device=dev)
    ovs = {r: Oversampler(SR, r, "x3", True, device=dev) for r in OS_RATIOS}
    # config 5: 64 sines through SpectralProcessor(rank 10) with a 0.5
    # hook into ILUFS and true peak
    n = np.arange(t_all)
    sines_np = np.stack([0.25 * np.sin(2 * np.pi * (440 + 10 * c) * n / SR)
                         for c in range(C)]).astype(np.float32)
    sines = torch.from_numpy(sines_np).to(dev)
    sp10 = SpectralProcessor(10, device=dev)
    meter = mtr.ILUFSMeter(SR, channels=C, weighting=mtr.Weighting.K,
                           device=dev)
    tpm = mtr.TruePeakMeter(SR)

    units = {
        "spectral_sc": (lambda: sp.init_state((C,), device=dev),
                        lambda st, k: sp.process(st, xd[:, k], fn_sc=lambda
                                                 q: (q[0] * 0.5, q[1] * 0.5))),
        "spectral_complex": (lambda: sp.init_state((C,), device=dev),
                             lambda st, k: sp.process(st, xd[:, k],
                                                      fn=lambda z: z * tilt)),
        "multi": (lambda: msp.init_state(device=dev),
                  lambda st, k: msp.process(
                      st, xd[:, k], fn=lambda z: z + mix_w * torch.roll(
                          z, 1, dims=-3))),
        "splitter": (lambda: spl.init_state((C,), device=dev),
                     lambda st, k: spl.process(st, xd[:, k], fns_sc=[
                         lambda q: (q[0] * spl_mask, q[1] * spl_mask),
                         None])),
        "convolver": (lambda: conv.init_state((C,)),
                      lambda st, k: conv.process(st, xd[:, k])),
        "analyzer": (lambda: an.init_state(device=dev),
                     lambda st, k: (an.process(st, xa[:, k]), None)),
        "eq": (lambda: eq.init_state(eq_p, (C,), device=dev),
               lambda st, k: eq.process(eq_p, st, xd[:, k])),
        "config5_spectral": (lambda: sp10.init_state((C,), device=dev),
                             lambda st, k: sp10.process(
                                 st, sines[:, k], lambda z: z * 0.5)),
    }

    def oversample(y_eq, n_calls):
        """Config 2's Oversamplers over n_calls calls of the EQ's output,
        the state carried: their outputs, and their last states' filter
        sections."""
        out = {}
        for r, ov in ovs.items():
            ost, parts = ov.init_state((C,), device=dev), []
            for k in range(n_calls):
                ost, yo = ov.process(ost, y_eq[:, k * SPEC_T:
                                               (k + 1) * SPEC_T], torch.tanh)
                parts.append(yo)
            out[f"oversampler_{r}x"] = torch.cat(parts, dim=-1)
            out[f"oversampler_{r}x_flt"] = ost.flt
        return out

    def drive(n_calls):
        """Every unit over n_calls calls, the state carried: the outputs
        by unit, then config 3's bands, config 2's Oversamplers and
        config 5's meters on the units' outputs."""
        outs = {k: [] for k in units}
        states = {k: init() for k, (init, _) in units.items()}
        for k in range(n_calls):
            sl = slice(k * SPEC_T, (k + 1) * SPEC_T)
            for name, (_, fn) in units.items():
                kk = slice(k * ANA_T, (k + 1) * ANA_T) \
                    if name == "analyzer" else sl
                states[name], y = fn(states[name], kk)
                outs[name].append(y if y is not None else states[name])
        ys = {k: v if k == "analyzer" else torch.cat(v, dim=-1)
              for k, v in outs.items()}
        xst = xo.init_state((C,), device=dev)
        bands = []
        for k in range(n_calls):
            xst, yb = xo.process(xst, ys["convolver"][:, k * SPEC_T:
                                                      (k + 1) * SPEC_T])
            bands.append(yb)
        ys["crossover"] = torch.cat(bands, dim=-1)
        ys.update(oversample(ys["eq"], n_calls))
        y5 = ys["config5_spectral"]
        tm = (y5.shape[-1] // meter.block) * meter.block
        mst, _ = meter.process(meter.init_state(), y5[:, :tm])
        ys["lufs"] = meter.loudness_lufs_gain(mst)
        _, ys["true_peak"] = tpm.process_max(tpm.init_state((C,), device=dev),
                                             y5)
        return ys

    counted = (fp.rfft_packed, fp.rfft_packed_zeropad, fp.irfft_packed,
               bq.biquad_cascade, bq.biquad_cascade_seq)
    sync()
    for f in counted:
        f.launches = 0
    t0 = time.perf_counter()
    ys = drive(SPEC_CALLS)
    sync()
    wall = time.perf_counter() - t0
    launched = {f.__name__: f.launches for f in counted}
    print(f"spectral: {len(units)} units, config 3's bands and config 2's "
          f"{len(ovs)} Oversamplers x {SPEC_CALLS} calls of [{C}, {SPEC_T}] "
          f"in {wall:.2f} s (host clock); launches {launched}")
    for name in ("rfft_packed", "irfft_packed", "biquad_cascade"):
        check(launched[name] >= SPEC_CALLS or not cuda,
              f"{name} launched {launched[name]} < {SPEC_CALLS}")
    # config 2's Oversamplers again on the plain scan, on the same EQ
    # output: their outputs and filter states must be identical
    kernel = bq.biquad_cascade
    bq.biquad_cascade = bq.biquad_cascade_plain
    try:
        ys_plain = oversample(ys["eq"], SPEC_CALLS)
    finally:
        bq.biquad_cascade = kernel
    scan = dict(calls=len(ovs) * SPEC_CALLS,
                same=all(torch.equal(v, ys[k]) for k, v in ys_plain.items()),
                worst=max(max_abs(v, ys[k]) for k, v in ys_plain.items()))
    print(f"parity biquad_scan: config 2's {len(ovs)} Oversamplers x "
          f"{SPEC_CALLS} calls ([{C}, {SPEC_T} x ratio], K = "
          f"{ovs[2].filter_coeffs.shape[0]}, state carried) again on "
          f"biquad_cascade_plain: outputs and filter states identical = "
          f"{scan['same']}, max abs err {scan['worst']:.3g}")
    check(scan["same"], "biquad_scan differs from its plain version")
    for name, y in ys.items():
        if name == "analyzer":
            continue
        check(bool(torch.isfinite(y).all()), f"{name} output not finite")

    # against float64
    x64 = x_np.astype(np.float64)
    dbs = {}

    def held(name, ref, out, bar):
        dbs[name] = snr_db(torch.from_numpy(np.ascontiguousarray(ref)),
                           out.cpu())
        print(f"spectral {name} vs float64: {dbs[name]:.2f} dB (bar {bar})")
        check(dbs[name] >= bar, f"{name} {dbs[name]:.2f} dB < {bar}")

    held("spectral_sc", spectral_f64(x64, 12, lambda s: s * 0.5),
         ys["spectral_sc"], SPEC_DB)
    held("spectral_complex", spectral_f64(
        x64, 12, lambda s: s * tilt.cpu().numpy().astype(np.complex128)),
        ys["spectral_complex"], SPEC_DB)
    held("multi", spectral_f64(
        x64, 12, lambda s: s + mix_w * np.roll(s, 1, axis=-3)),
        ys["multi"], SPEC_DB)
    spl_ref = splitter_f64(x64, 12, 10, [lambda s: s * spl_mask_np, None])
    for hi in range(2):
        held(f"splitter_{hi}", spl_ref[hi], ys["splitter"][:, hi], SPEC_DB)
    y_conv = ys["convolver"].cpu().double().numpy()
    held("convolver", fftconvolve(x64, ir[None].astype(np.float64),
                                  axes=-1)[:, :t_all], ys["convolver"],
         CHAIN_DB)
    masks = xo.masks.cpu().double().numpy()
    xo_ref = splitter_f64(y_conv, 11, 11, [(lambda s, m=m: s * m)
                                           for m in masks])
    for b in range(xo.num_bands):
        held(f"crossover_band{b}", xo_ref[b], ys["crossover"][b], SPEC_DB)
    lat = xo.latency()
    xo_sum = snr_db(torch.from_numpy(y_conv[:, :t_all - lat]),
                    ys["crossover"].sum(0).cpu()[:, lat:])
    dbs["crossover_sum_vs_input"] = xo_sum
    print(f"config 3: band sum vs the convolver's output delayed by {lat}: "
          f"{xo_sum:.2f} dB (bar {XO_SUM_DB})")
    check(xo_sum > XO_SUM_DB, f"config 3 band sum {xo_sum:.2f} dB")
    amp, data = analyzer_f64(an, xa_np.astype(np.float64))
    st_a = ys["analyzer"][-1]
    held("analyzer_amp", amp, st_a.amp, SPEC_DB)
    held("analyzer_data", data, st_a.data, SPEC_DB)
    y_eq = ys["eq"].cpu().double().numpy()
    held("config2_eq", sos_f64(eq_p.coeffs.cpu(), x_np), ys["eq"], FUSED_DB)
    for r, ov in ovs.items():
        held(f"config2_oversampler_{r}x", oversampler_f64(ov, y_eq, np.tanh),
             ys[f"oversampler_{r}x"], ASSOC_DB)
    # config 5
    y5 = ys["config5_spectral"]
    held("config5_spectral", spectral_f64(sines_np.astype(np.float64), 10,
                                          lambda s: s * 0.5), y5, SPEC_DB)
    lufs = 20 * np.log10(float(ys["lufs"]))
    want = 20 * np.log10(np.sqrt(C * 0.125 ** 2 / 2.0))
    peak_err = float((ys["true_peak"] - 0.125).abs().max())
    print(f"config 5: ILUFS {lufs:.3f} LUFS against the analytic "
          f"{want:.3f} (tolerance {LUFS_TOL} dB); true peaks within "
          f"{peak_err:.4f} of 0.125 (tolerance {PEAK_TOL})")
    check(abs(lufs - want) < LUFS_TOL, "config 5 loudness")
    check(peak_err < PEAK_TOL, "config 5 true peak")
    res["config5"] = dict(lufs=lufs, analytic_lufs=want, peak_err=peak_err)

    # TF32 on: the first call of every unit again, identical
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    ys_tf = drive(1)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    same_tf = all(torch.equal(ys_tf[k], ys[k][..., :ys_tf[k].shape[-1]])
                  for k in ys_tf if k not in ("analyzer", "lufs", "true_peak")
                  and not k.endswith("_flt"))
    same_tf &= torch.equal(ys_tf["analyzer"][0].amp, ys["analyzer"][0].amp)
    print(f"spectral, TF32 on: every unit's first call identical = "
          f"{same_tf}")
    check(same_tf, "spectral output changed with TF32 switched on")

    # the measurement units
    lat_found, blocks = drive_latency_detector(dev, rng)
    print(f"LatencyDetector: a loop of {LD_DELAY} samples with noise at "
          f"-40 dB: {lat_found} after {blocks} blocks of 4096")
    check(lat_found == LD_DELAY, f"latency {lat_found} != {LD_DELAY}")
    cap, want_cap = drive_response_taker()
    same_cap = bool(np.array_equal(cap, want_cap))
    print(f"ResponseTaker: capture of {cap.size} samples through a loop of "
          f"300 + 256 identical to the delayed test signal = {same_cap}")
    check(same_cap, "ResponseTaker capture")
    chirp = {}
    for method in ("simple", "bandlimited"):
        chirp[method] = r = chirp_response_db(dev, method)
        print(f"SyncChirpProcessor {method}: a {r['n']}-sample sweep, origin "
              f"{r['deconv_origin']}; linear IR vs the filter's float64 IR, "
              f"100 Hz-15 kHz: median {r['median_db']:.4f} dB, max "
              f"{r['max_db']:.4f} dB (bars {CHIRP_MED_DB}, {CHIRP_MAX_DB})")
        check(r["median_db"] < CHIRP_MED_DB and r["max_db"] < CHIRP_MAX_DB,
              f"SyncChirpProcessor {method} response")
    res["spectral_vs_float64_db"] = dbs
    res["spectral_launches"] = launched
    res["chirp"] = chirp
    res["scan_parity"] = scan
    print(f"spectral phase: {time.perf_counter() - t_start:.1f} s")


def spectral_timings(dev, res):
    """Kernel #1 at the spectral units' own shapes, and biquad_scan at the
    filters phase's [64, 16384], K = 9, and config 2's [64, 65536],
    K = 15, each beside its plain version."""
    from lsp_dsp_units_tpu_torch.models.util import Oversampler
    shapes = {"spectral_12": (4096, C * SPEC_T // 2048),
              "splitter_12_10": (4096, C * SPEC_T // 512),
              "crossover_11": (2048, C * SPEC_T // 1024),
              "config5_10": (1024, C * SPEC_T // 512),
              "analyzer_12": (4096, C * ANA_T // 2400)}
    gen = torch.Generator().manual_seed(12)
    rows_out = {}
    for key, (n, rows) in shapes.items():
        x = randn(gen, rows, n, dev=dev)
        kre, kim = fp.rfft_packed(x)
        pre, pim = fp.rfft_packed_plain(x)
        spec = torch.fft.rfft(x)
        nre, nim = fp.unpack_spectra(kre, kim, n)
        y = fp.irfft_packed(kre, kim, n)
        r = dict(n=n, rows=rows,
                 db_vs_plain=min(snr_db(pre, kre), snr_db(pim, kim)),
                 db_vs_torch=min(snr_db(spec.real, nre),
                                 snr_db(spec.imag, nim)),
                 inverse_db_vs_plain=snr_db(
                     fp.irfft_packed_plain(kre, kim, n), y),
                 inverse_db_vs_torch=snr_db(torch.fft.irfft(spec, n=n), y),
                 ms=time_ms(lambda: fp.rfft_packed(x), 20),
                 plain_ms=time_ms(lambda: fp.rfft_packed_plain(x), 20),
                 library_ms=time_ms(lambda: torch.fft.rfft(x), 20),
                 inverse_ms=time_ms(lambda: fp.irfft_packed(kre, kim, n), 20),
                 inverse_plain_ms=time_ms(
                     lambda: fp.irfft_packed_plain(kre, kim, n), 20),
                 inverse_library_ms=time_ms(
                     lambda: torch.fft.irfft(spec, n=n), 20),
                 bound_ms=bound(F32 * 2 * rows * n,
                                rows * fft_flops(n))["bound_ms"],
                 launches=res["spectral_launches"]["rfft_packed"])
        rows_out[key] = r
        print(f"fft at {key}: [{rows}, {n}] forward {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, torch.fft {r['library_ms']:.4f}), "
              f"inverse {r['inverse_ms']:.4f} ms (plain "
              f"{r['inverse_plain_ms']:.4f}, torch.fft "
              f"{r['inverse_library_ms']:.4f}), bound {r['bound_ms']:.4f} ms; "
              f"{r['db_vs_plain']:.1f} / {r['db_vs_torch']:.1f} dB vs plain / "
              f"torch.fft, inverse {r['inverse_db_vs_plain']:.1f} / "
              f"{r['inverse_db_vs_torch']:.1f} dB")
        for k in ("db_vs_plain", "db_vs_torch", "inverse_db_vs_plain",
                  "inverse_db_vs_torch"):
            check(r[k] >= FFT_DB, f"fft {key} {k} {r[k]:.1f} dB < {FFT_DB}")
    res["fft"]["spectral_shapes"] = rows_out

    rng = np.random.default_rng(14)
    eq = flt.Equalizer(SR, filters=8, iir_block=None)
    for i, p in enumerate(pipeline.default_eq_params(SR)):
        eq.set_params(i, p)
    c9 = eq.build(device=dev).coeffs
    c15 = Oversampler(SR, 4, "x3", True, device=dev).filter_coeffs
    cases = {}
    for key, coeffs, t in (("k9", c9, FILT_T), ("k15", c15, 4 * SPEC_T)):
        k = coeffs.shape[0]
        x = torch.from_numpy((rng.standard_normal((C, t)) * 0.25).astype(
            np.float32)).to(dev)
        s0 = torch.from_numpy((rng.standard_normal((C, k, 2)) * 0.1).astype(
            np.float32)).to(dev)
        before = bq.biquad_cascade.launches
        y, s = bq.biquad_cascade(coeffs, s0, x)
        per_call = bq.biquad_cascade.launches - before
        plain_ms, (y_p, s_p) = time_once_ms(
            lambda: bq.biquad_cascade_plain(coeffs, s0, x))
        same = bool(torch.equal(y, y_p) and torch.equal(s, s_p))
        check(same, f"biquad_scan {key} differs from its plain version")
        nbytes = F32 * (2 * C * t + 5 * k + 4 * C * k)
        cases[key] = dict(
            t=t, k=k, launches_per_call=per_call,
            max_abs_err=max(max_abs(y_p, y), max_abs(s_p, s)),
            ms=time_ms(lambda: bq.biquad_cascade(coeffs, s0, x), 20),
            plain_ms=plain_ms, bytes_bound_ms=bound(nbytes, 0.0)["bound_ms"],
            **bound(nbytes, scan_flops(t, k, C)))
        r = cases[key]
        print(f"biquad_scan [{C}, {t}] K = {k}: {r['ms']:.4f} ms, plain "
              f"{plain_ms:.1f} ms (one call, host-paced), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; bytes "
              f"{r['bytes_bound_ms']:.4f}), "
              f"{per_call} launches a call (the prefix table, the rows), "
              f"identical to plain = {same} "
              f"({card_line()})")
    a, b = cases["k9"], cases["k15"]
    res["scan"] = dict(
        launches=res["spectral_launches"]["biquad_cascade"],
        max_abs_err=max(res["scan_parity"]["worst"], a["max_abs_err"],
                        b["max_abs_err"]),
        ms=a["ms"], plain_ms=a["plain_ms"], library_ms=None,
        bound_ms=a["bound_ms"], bound_by=a["bound_by"],
        bytes_bound_ms=a["bytes_bound_ms"],
        launches_per_call=a["launches_per_call"], seq_ms=res["bq"]["ms"],
        k15_ms=b["ms"], k15_plain_ms=b["plain_ms"],
        k15_bound_ms=b["bound_ms"], k15_bound_by=b["bound_by"],
        k15_bytes_bound_ms=b["bytes_bound_ms"])


# --- the synth phase: the generators and the utility machines --------------

SYN_T, SYN_CALLS = 16384, 2   # the synth phase: 64 ch x T, state carried
SYN_MAX_DELAY = 4800          # DynamicDelay's ring: a chorus / flanger bank
# the JAX oracle test's oscillator (tests/test_reference_oracle_wave3.py)
OSC_KW = dict(frequency=441.7, amplitude=0.8, dc_offset=0.1,
              initial_phase=0.7, duty_ratio=0.3, width=0.65, raise_ratio=0.2,
              fall_ratio=0.35, pos_width_ratio=0.3, neg_width_ratio=0.45,
              parabolic_width=0.6, oversampling=8, quality="16bit")
OSC_DB, OSC_BL_DB = 120.0, 100.0    # the card's run against the CPU's
TRIG_KW = dict(threshold=0.3, hysteresis=0.1, hold_samples=24)
NOISES = {"white": (NoiseColor.WHITE, 0.0), "pink": (NoiseColor.PINK, 0.0),
          "arbitrary_-4.5": (NoiseColor.ARBITRARY, -4.5)}


def gated_bursts(rng, c: int, t: int) -> np.ndarray:
    """Noise bursts per channel: 0.3 on, 1e-4 off, gates of 3000-9000
    samples at per-channel offsets, so each depopper opens, fades in,
    falls and waits many times, some falls inside the fade-in."""
    idx = np.arange(t)
    period = rng.integers(3000, 9000, (c, 1))
    on = ((idx[None, :] + rng.integers(0, 9000, (c, 1))) % period
          < period // 2)
    return (rng.standard_normal((c, t)) * np.where(on, 0.3, 1e-4)).astype(
        np.float32)


class Recorder:
    """Wraps ``riders.depopper_forward`` while a Depopper runs, keeping
    each call's (state in, env, state out, outputs) for the kernel's
    parity run; the wrapped function still counts its launches."""

    def __init__(self):
        self.fn = riders.depopper_forward
        self.calls = []

    def __call__(self, unit, state, env):
        out = self.fn(unit, state, env)
        self.calls.append((tuple(state), env, *out))
        return out

    @property
    def launches(self):
        """The wrapped function's count, which it keeps by its module
        name: while the recorder stands in, the name is the recorder."""
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __enter__(self):
        riders.depopper_forward = self
        return self

    def __exit__(self, *exc):
        riders.depopper_forward = self.fn


def synth_inputs():
    """The synth phase's inputs from its seed: the delay bank's input
    [C, 2T], the feedback delays, the gated bursts of the depoppers."""
    rng = np.random.default_rng(21)
    t_all = SYN_T * SYN_CALLS
    x = (rng.standard_normal((C, t_all)) * 0.25).astype(np.float32)
    fdel = rng.integers(0, SYN_MAX_DELAY, (C, t_all)).astype(np.int32)
    return x, fdel, gated_bursts(rng, C, t_all)


def lfo_delays(d) -> torch.Tensor:
    """Each channel's delay, swept by the LFO's quick sine over
    0..SYN_MAX_DELAY samples at 0.7 Hz, the channels' phases spread over
    the period: int32 [C, 2T] on device d."""
    n = torch.arange(SYN_T * SYN_CALLS, device=d, dtype=torch.float64)
    ph = ((n[None, :] * (0.7 / SR) + torch.arange(C, device=d)[:, None]
           / C) % 1.0).float()
    return (lfo.sine(ph, quick=True) * SYN_MAX_DELAY).to(torch.int32)


def synth_units(d):
    return dict(
        osc={fg: Oscillator(SR, fg, device=d, **OSC_KW)
             for fg in FunctionGenerator},
        adsr=ADSREnvelope(attack=0.1, decay=0.3, sustain_level=0.6,
                          release=0.8),
        noise={k: NoiseGenerator(SR, NoiseCore.LCG, c, slope_db_oct=sl,
                                 lcg_seed=5, device=d)
               for k, (c, sl) in NOISES.items()},
        dd=DynamicDelay(SYN_MAX_DELAY),
        trig={tt: Trigger(tt, TriggerMode.REPEAT, **TRIG_KW)
              for tt in TriggerType},
        mono={m: Trigger(TriggerType.ADVANCED_RISING_EDGE, m, **TRIG_KW)
              for m in TriggerMode},
        depop={m: Depopper(SR, fade_in_mode=m, fade_out_mode=m)
               for m in DepopperMode})


def synth_sources(u, d, outs):
    """The oscillators (the BL sawtooth through ADSR) and the noise
    colors over the calls on device d, into ``outs`` by name."""
    st = {fg: o.init_state() for fg, o in u["osc"].items()}
    nst = {k: g.init_state() for k, g in u["noise"].items()}
    ramp = torch.arange(SYN_T * SYN_CALLS, dtype=torch.float32,
                        device=d) / (SYN_T * SYN_CALLS)
    for k in range(SYN_CALLS):
        sl = slice(k * SYN_T, (k + 1) * SYN_T)
        for fg, o in u["osc"].items():
            st[fg], y = o.process(st[fg], SYN_T)
            outs.setdefault(fg.name, []).append(y)
            if fg == FunctionGenerator.BL_SAWTOOTH:
                outs.setdefault("adsr", []).append(
                    u["adsr"].process_mul(ramp[sl], y))
        for key, g in u["noise"].items():
            nst[key], y = g.process(nst[key], SYN_T)
            outs.setdefault(key, []).append(y)


def synth_depopper(p, bursts, outs, key):
    """One Depopper over the calls: gains and envelopes into ``outs``."""
    st = p.init_state((bursts.shape[0],), device=bursts.device)
    for k in range(SYN_CALLS):
        st, g, e = p.process(st, bursts[:, k * SYN_T:(k + 1) * SYN_T])
        outs.setdefault(f"gain_{key}", []).append(g)
        outs.setdefault(f"env_{key}", []).append(e)


def synth_mono(u, ys, outs):
    """The mono Trigger units on channel 0 of each call's delay output."""
    mst = {m: t.init_state(ys[0].device) for m, t in u["mono"].items()}
    u["mono"][TriggerMode.MANUAL].activate_manual_trigger()
    for y in ys:
        for m, t in u["mono"].items():
            mst[m], o = t.process(mst[m], y[0])
            outs.setdefault(f"mono_{m.name}", []).append(o)


def synth_reference(task: str, *args):
    """One piece of the synth phase's CPU run (the port's plain loops on
    CPU tensors), in a worker process: by task name, its outputs."""
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    u = synth_units(cpu)
    outs = {}
    if task == "sources":
        synth_sources(u, cpu, outs)
    elif task == "delay":
        x, dl, fdel = args
        st = u["dd"].init_state((C,), device=cpu)
        trace = []
        for k in range(SYN_CALLS):
            sl = slice(k * SYN_T, (k + 1) * SYN_T)
            st, y = u["dd"].process(st, x[:, sl], dl[:, sl],
                                    torch.tensor(0.5), fdel[:, sl])
            trace.append((y, st.buffer))
        return trace
    elif task == "trigger":
        tt, calls = args
        return [riders.trigger_plain(u["trig"][tt], s0, y)
                for s0, y in calls]
    elif task == "mono":
        synth_mono(u, args[0], outs)
    elif task == "depop":
        m, bursts = args
        with Recorder() as rec:
            synth_depopper(u["depop"][m], bursts, outs, m.name)
        return {k: torch.cat(v, dim=-1) for k, v in outs.items()}, rec.calls
    return {k: torch.cat(v, dim=-1) for k, v in outs.items()}


def synth_phase(dev, res):
    """The generators and the utility machines at full width (64 channels
    at 48 kHz, 2 calls of 16384 with the state carried), the launch
    counters zeroed just before and read just after: the 14 oscillator
    functions (the band-limited ones through biquad_scan at 8 x 16384),
    ADSR over one, three noise colors (biquad_seq), a 64-channel
    DynamicDelay bank swept by the LFO (delay_kernel), the trigger in
    every type on its output (rider_kernel<TriggerStep>), the Trigger
    unit mono in three modes, the Depopper in all five modes on gated
    bursts (rider_kernel<DepopperStep>), Dither and dither_device.  Each
    against the port's CPU run on the same inputs (its plain loops, in a
    pool of worker processes); kernels A-C against their plain versions,
    timed with their bounds."""
    t_start = time.perf_counter()
    t_n, calls = SYN_T, SYN_CALLS
    x_np, fdel_np, burst_np = synth_inputs()
    x = torch.from_numpy(x_np).to(dev)
    fdel = torch.from_numpy(fdel_np).to(dev)
    bursts = torch.from_numpy(burst_np).to(dev)
    delay_d = lfo_delays(dev)
    modes, kinds = list(DepopperMode), list(FunctionGenerator)
    workers = min(8, os.cpu_count() or 1)
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    with pool:
        # the CPU run's pieces that need nothing of the card's, started
        # first so they overlap the card's drive
        refs = {"sources": pool.submit(synth_reference, "sources"),
                "delay": pool.submit(synth_reference, "delay",
                                     torch.from_numpy(x_np), delay_d.cpu(),
                                     torch.from_numpy(fdel_np))}
        for m in modes:
            refs[m] = pool.submit(synth_reference, "depop", m,
                                  torch.from_numpy(burst_np))
        counted = (delay_ops.dynamic_delay, riders.trigger,
                   riders.depopper_forward, bq.biquad_cascade,
                   bq.biquad_cascade_seq)
        ud = synth_units(dev)
        outs, dtrace, ttrace = {}, [], {tt: [] for tt in TriggerType}
        rec = Recorder()
        torch.cuda.synchronize()
        for f in counted:
            f.launches = 0
        t0 = time.perf_counter()
        synth_sources(ud, dev, outs)
        dst = ud["dd"].init_state((C,), device=dev)
        tst = {tt: t.init_state(dev)._make(
            torch.stack([f] * C) for f in t.init_state(dev))
            for tt, t in ud["trig"].items()}
        gen = torch.Generator(device=dev).manual_seed(7)
        for k in range(calls):
            sl = slice(k * t_n, (k + 1) * t_n)
            s0 = dst
            dst, y = ud["dd"].process(dst, x[:, sl], delay_d[:, sl],
                                      torch.tensor(0.5, device=dev),
                                      fdel[:, sl])
            dtrace.append((s0, y, dst))
            for tt, t in ud["trig"].items():
                s0 = tst[tt]
                tst[tt], o = riders.trigger(t, s0, y)
                ttrace[tt].append((s0, y, o, tst[tt]))
            outs.setdefault("dither_dev", []).append(
                dither_device(gen, y, 16))
        synth_mono(ud, [y for _, y, _ in dtrace], outs)
        with rec:
            for m in modes:
                synth_depopper(ud["depop"][m], bursts, outs, m.name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {f.__name__: f.launches for f in counted}
        outs = {k: torch.cat(v, dim=-1) for k, v in outs.items()}
        print(f"synth: 14 oscillators, ADSR, {len(NOISES)} noise colors, "
              f"the [{C}, {t_n}] delay bank, {len(TriggerType)} trigger "
              f"types, 3 mono triggers, {len(modes)} depoppers over {calls} "
              f"calls in {wall:.2f} s (host clock); launches {launched}")
        check(launched["dynamic_delay"] == calls,
              f"delay_kernel launched {launched['dynamic_delay']} times")
        check(launched["trigger"] == (len(TriggerType) + len(TriggerMode))
              * calls, f"TriggerStep launched {launched['trigger']} times")
        check(launched["depopper_forward"] == len(modes) * calls,
              f"DepopperStep launched {launched['depopper_forward']} times")
        n_bl = sum(fg.value.startswith("bl_") for fg in kinds)
        check(launched["biquad_cascade"] >= n_bl * calls,
              f"biquad_scan launched {launched['biquad_cascade']} times")
        check(launched["biquad_cascade_seq"] >= 2 * calls,
              f"biquad_seq launched {launched['biquad_cascade_seq']} times")
        for k, v in outs.items():
            check(bool(torch.isfinite(v.float()).all()),
                  f"synth {k} not finite")
        check(all(y.shape == (C, t_n) for _, y, _ in dtrace),
              "delay output shape")
        # the pieces that run on the card's own inputs and states
        for tt in TriggerType:
            refs[tt] = pool.submit(synth_reference, "trigger", tt, [
                (type(s0)(*(f.cpu() for f in s0)), y.cpu())
                for s0, y, _, _ in ttrace[tt]])
        refs["mono"] = pool.submit(synth_reference, "mono",
                                   [y.cpu() for _, y, _ in dtrace])
        t1 = time.perf_counter()
        ref = {k: f.result() for k, f in refs.items()}
    print(f"synth: the CPU run ({len(refs)} pieces, {workers} "
          f"worker processes) done {time.perf_counter() - t1:.1f} s after "
          f"the card's")

    dbs = {}
    src = ref["sources"]
    for fg in kinds:
        db = snr_db(src[fg.name], outs[fg.name].cpu())
        bar = OSC_BL_DB if fg.value.startswith("bl_") else OSC_DB
        dbs[fg.name] = db
        check(db >= bar, f"oscillator {fg.name}: {db:.2f} dB < {bar}")
    dbs["adsr"] = snr_db(src["adsr"], outs["adsr"].cpu())
    check(dbs["adsr"] >= OSC_BL_DB, f"ADSR {dbs['adsr']:.2f} dB")
    check(torch.equal(src["white"], outs["white"].cpu()),
          "white noise differs between the card and the CPU")
    for key in ("pink", "arbitrary_-4.5"):
        dbs[key] = snr_db(src[key], outs[key].cpu())
        check(dbs[key] >= OSC_DB, f"noise {key}: {dbs[key]:.2f} dB")
    print("synth, card vs the CPU run (dB): " + ", ".join(
        f"{k} {v:.2f}" for k, v in dbs.items()))
    res["synth_vs_cpu_db"] = dbs

    # kernel A: output and ring bit for bit, both calls, from zero
    for (_, y, s1), (yc, bc) in zip(dtrace, ref["delay"]):
        check(torch.equal(y.cpu(), yc) and torch.equal(s1.buffer.cpu(), bc),
              "delay_kernel differs from its plain version")
    # kernel B: every type, both calls, on the card's inputs and states
    for tt in TriggerType:
        for (_, _, o, s1), (c1, oc) in zip(ttrace[tt], ref[tt]):
            check(torch.equal(o.cpu(), oc) and all(
                torch.equal(a.cpu(), b) for a, b in zip(s1, c1)),
                f"TriggerStep {tt.name} differs from its plain version")
        fired = int(sum((o == 2).sum() for _, _, o, _ in ttrace[tt]))
        print(f"parity rider_kernel<TriggerStep> {tt.name}: [{C}, {t_n}] x "
              f"{calls} calls identical; {fired} fired samples")
    for m in TriggerMode:
        key = f"mono_{m.name}"
        check(torch.equal(outs[key].cpu(), ref["mono"][key]),
              f"Trigger unit {m.name} differs between the card and the CPU")
    # kernel C: falls, patch lengths, state and raw gain bit for bit (the
    # sine and gaussian fade-ins take sin and exp in double on both
    # sides); the envelopes and gains identical to the CPU run's
    falls, worst = {}, 0.0
    for i, m in enumerate(modes):
        outs_c, calls_c = ref[m]
        calls_d = rec.calls[i * calls:(i + 1) * calls]
        for (s0, env, s1, (raw, fall, patch)), (
                s0c, envc, s1c, (rawc, fallc, patchc)) in zip(calls_d,
                                                              calls_c):
            check(all(torch.equal(a.cpu(), b) for a, b in zip(s0, s0c)),
                  f"depopper {m.name}: state in differs from the CPU's")
            check(torch.equal(env.cpu(), envc),
                  f"depopper {m.name}: envelope differs from the CPU's")
            check(torch.equal(fall.cpu(), fallc)
                  and torch.equal(patch.cpu(), patchc)
                  and all(torch.equal(a.cpu(), b) for a, b in zip(s1, s1c)),
                  f"DepopperStep {m.name}: falls, patches or state differ")
            worst = max(worst, max_abs(rawc, raw.cpu()))
            check(torch.equal(raw.cpu(), rawc),
                  f"DepopperStep {m.name}: raw gain differs")
            falls[m.name] = falls.get(m.name, 0) + int(fall.sum())
        check(torch.equal(outs[f"gain_{m.name}"].cpu(),
                          outs_c[f"gain_{m.name}"]),
              f"Depopper {m.name} gain differs from the CPU run's")
    check(min(falls.values()) > 0, "no depopper fell")
    print(f"parity rider_kernel<DepopperStep>: [{C}, {t_n}] x {calls} "
          f"calls, falls, patches, state and raw gains identical; falls by "
          f"mode {falls}; envelopes and gains identical to the CPU run's")
    d = (outs["dither_dev"] - torch.cat([y for _, y, _ in dtrace], -1))
    check(float(d.abs().max()) <= 0.5 / (1 << 15), "dither_device range")
    y0 = dtrace[0][1][0].cpu().numpy()
    check(float(np.abs(Dither(16, seed=7).process(y0) - y0).max())
          <= 0.5 / (1 << 15), "Dither host path range")

    # timings at [64, 16384], the first call's inputs and states
    clock = sm_clock_hz()
    s0, y, _ = dtrace[0]
    g1 = torch.tensor(0.5, device=dev)
    args = (x[:, :t_n], delay_d[:, :t_n], g1, fdel[:, :t_n])
    tt0 = TriggerType.ADVANCED_RISING_EDGE
    ts0 = ttrace[tt0][0][0]
    m0 = DepopperMode.CUBIC
    ps0, env0 = rec.calls[modes.index(m0) * calls][:2]
    ut, up = ud["trig"][tt0], ud["depop"][m0]
    cases = {
        "delay": (lambda: delay_ops.dynamic_delay(
            s0.buffer, *args, SYN_MAX_DELAY),
            lambda: delay_ops.dynamic_delay_plain(
                s0.buffer, *args, SYN_MAX_DELAY),
            F32 * (4 * C * t_n + C * t_n + 2 * C * (SYN_MAX_DELAY + 1)),
            delay_ops.chain_ops(), launched["dynamic_delay"], 0.0),
        "trig": (lambda: riders.trigger(ut, ts0, y),
                 lambda: riders.trigger_plain(ut, ts0, y),
                 F32 * 2 * C * t_n, riders.chain_ops(
                     "trigger", riders.KIND["trigger"] + tt0.value),
                 launched["trigger"], 0.0),
        "depop": (lambda: riders.depopper_forward(up, ps0, env0),
                  lambda: riders.depopper_forward_plain(up, ps0, env0),
                  (3 * F32 + 1) * C * t_n, riders.chain_ops("depopper"),
                  launched["depopper_forward"], worst),
    }
    for key, (fn, plain, nbytes, ops, n_launch, err) in cases.items():
        ms = time_ms(fn, 5)
        plain_ms, _ = time_once_ms(plain)
        r = dict(launches=n_launch, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, library_ms=None, **bound(nbytes, 0.0),
                 chain_ms=t_n * ops * 4 / clock * 1e3, chain_ops=ops,
                 cycles_per_step=ms * 1e-3 * clock / t_n, sm_clock_hz=clock,
                 launches_per_call=1)
        res[key] = r
        # delay_kernel runs its batches' steps at once: the serial order's
        # chain no longer bounds it
        chain = "the serial order's chain" if key == "delay" else \
            "chain bound"
        print(f"{key} kernel: [{C}, {t_n}] {ms:.4f} ms "
              f"({r['cycles_per_step']:.1f} cycles a step), plain "
              f"{plain_ms:.1f} ms (one call, host-paced), bytes bound "
              f"{r['bound_ms']:.4f} ms, {chain} {r['chain_ms']:.4f} ms "
              f"({ops} dependent ops), 1 launch a call ({card_line()})")
    # every trigger type and depopper mode, on the first call's inputs
    batches = rider_batches()
    every = {
        "trig": {tt.name: (functools.partial(
            riders.trigger, ut, ttrace[tt][0][0], y),
            f"TriggerStepILi{tt.value}E", "TriggerStep",
            riders.chain_ops("trigger", riders.KIND["trigger"] + tt.value))
            for tt, ut in ud["trig"].items()},
        "depop": {m.name: (functools.partial(
            riders.depopper_forward, ud["depop"][m],
            *rec.calls[i * calls][:2]), "DepopperStep", "DepopperStep",
            riders.chain_ops("depopper"))
            for i, m in enumerate(modes)}}
    for key, fns in every.items():
        rows = {}
        for name, (fn, kernel, functor, ops) in fns.items():
            ms = time_ms(fn, 5)
            sass = sass_rider_chain(kernel, batches[functor])
            rows[name] = dict(ms=ms, cycles_per_step=ms * 1e-3 * clock / t_n,
                              chain_ms=t_n * ops * 4 / clock * 1e3,
                              chain_ops=ops, chain_cycles_per_step=ops * 4,
                              sass=sass)
            print(f"{key} kernel {name}: [{C}, {t_n}] {ms:.4f} ms "
                  f"({rows[name]['cycles_per_step']:.1f} cycles a step "
                  f"against a chain bound of {ops * 4}: "
                  f"{rows[name]['chain_ms']:.4f} ms); " + sass_line(sass))
            check_chain(sass, f"{key} {name}")
        res[key]["types" if key == "trig" else "modes"] = rows
    print(f"synth phase: {time.perf_counter() - t_start:.1f} s")


def small_units_run(dev, sig, qx) -> dict:
    """Bypass, Crossfade and QuantizedCounter (period 0 and a 1 s window
    in a ring of 65536) over 2 calls of [64, 16384] on ``dev``: every
    output and state, on the host."""
    out = {}
    byp = Bypass(SR, 5.0)
    bst = byp.init_state((C,), device=dev)
    mask = torch.arange(C, device=dev) % 3 == 0
    xf = Crossfade(SR, 0.005)
    xst = xf.toggle(xf.reset(xf.init_state(device=dev)))
    qcs = [QuantizedCounter(-1.0, 1.0, 256),
           QuantizedCounter(-0.7, 1.3, 1000, period=SR, capacity=65536)]
    qst = [q.init_state(device=dev) for q in qcs]
    for k in range(PAR_CALLS):
        dry, wet = (sig[j][:, k * PAR_T:(k + 1) * PAR_T].to(dev)
                    for j in (0, 1))
        bst = byp.set_bypass(bst, mask if k == 0 else ~mask)
        bst, out[f"bypass{k}"] = byp.process(bst, dry, wet)
        xst, out[f"crossfade{k}"] = xf.process(xst, dry, wet, PAR_T)
        out[f"bypass_state{k}"] = torch.stack(list(bst))
        out[f"crossfade_state{k}"] = torch.stack(
            [xst.counter.float(), xst.gain])
        for i, q in enumerate(qcs):
            qst[i] = q.process(qst[i], qx[:, k * PAR_T:(k + 1) * PAR_T]
                               .to(dev))
            for f, v in zip(qst[i]._fields, qst[i]):
                out[f"qc{i}_{f}{k}"] = v
    return {k: v.cpu() for k, v in out.items()}


def parallel_phase(chain, params, dev, res):
    """The sharded chain at world size 1 on the card: NCCL, a (1, 1) mesh,
    ``sharded_step`` for 2 calls of [64, 16384] with the state carried
    against ``step`` on the same inputs and state; the TF32 identity; the
    launches of kernels #1, #5 and #6 in the sharded run; the
    time-sharded ILUFS gate and the global meters; ``dryrun_multichip(1)``;
    Bypass, Crossfade and QuantizedCounter on the card against the CPU;
    the sharded step's device ms beside step's."""
    t_start = time.perf_counter()
    r = res["parallel"] = {}
    rng = np.random.default_rng(12)
    xs = [torch.from_numpy((rng.standard_normal((C, PAR_T)) * 0.25).astype(
        np.float32)).to(dev) for _ in range(PAR_CALLS)]
    pmesh.init_distributed(num_processes=1, process_id=0,
                           platform=dev.type)
    try:
        mesh = pmesh.make_mesh(1, 1, dev.type)
        tg = mesh.get_group(pmesh.TIME_AXIS)
        step = chain.sharded_step(mesh, params)
        st = pmesh.chan_sharding(mesh, chain.init_state(params))
        torch.cuda.synchronize()
        for f in PAR_COUNTERS:
            f.launches = 0
        ys, states = [], []
        for x in xs:
            states.append(clone_state(st))
            st, y = step(st, pmesh.chan_time_sharding(mesh, x))
            ys.append(y)
        torch.cuda.synchronize()
        launched = {f.__name__: f.launches for f in PAR_COUNTERS}
        print(f"parallel: {torch.distributed.get_backend()} world size 1, "
              f"mesh (1, 1); {PAR_CALLS} "
              f"calls of sharded_step on [{C}, {PAR_T}]; launches "
              f"{launched}")
        for name, cnt in launched.items():
            check(cnt >= PAR_CALLS, f"{name} launched {cnt} < {PAR_CALLS} "
                  f"times by sharded_step")
        check(all(y.shape == (C, PAR_T) and bool(torch.isfinite(y).all())
                  for y in ys), "sharded_step output")

        sst = chain.init_state(params)
        dbs = []
        for x, y in zip(xs, ys):
            sst, yr = chain.step(params, sst, x)
            dbs.append(snr_db(yr, y))
        state_db = min(snr_db(a, b) for a, b in zip(
            (sst.eq, sst.fdl.spec_re, sst.fdl.spec_im, sst.env.envelope),
            (st.eq, st.fdl.spec_re, st.fdl.spec_im, st.env.envelope)))
        print("sharded_step vs step: " + ", ".join(
            f"call {i} {v:.2f} dB" for i, v in enumerate(dbs))
            + f"; carried state (worst leaf) {state_db:.2f} dB")
        check(min(dbs) >= SHARD_DB, f"sharded_step {min(dbs):.2f} dB from "
              f"step < {SHARD_DB}")

        # TF32 on: no library matmul on the path, so the output is identical
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        _, y_tf32 = step(clone_state(states[-1]), xs[-1])
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
        same = bool(torch.equal(ys[-1], y_tf32))
        print(f"sharded_step, TF32 on: output identical = {same}")
        check(same, "sharded_step output changed with TF32 switched on")

        # the reductions: 1.6 s at 48 kHz (16 quarters), a quiet stretch
        meter = mtr.ILUFSMeter(SR, C, max_int_time_s=10.0, device=dev)
        blk = meter.blk_size
        xm_np = (rng.standard_normal((C, 16 * blk)) * 0.2).astype(np.float32)
        xm_np[:, 8 * blk:11 * blk] *= 1e-5
        xm = torch.from_numpy(xm_np).to(dev)
        mst, _ = meter.process(meter.init_state(), xm)
        loud_ref = float(mst.loudness)
        fpm = biquad_block.precompute_fused(meter._coeffs.cpu().numpy(), blk,
                                            device=dev)
        loud = float(ilufs_integrated_time_sharded(meter, fpm, xm, tg))
        rel = abs(loud - loud_ref) / loud_ref
        ms = global_mean_square(xm, tg)
        tp = global_true_peak(xm, tg)
        cor = global_correlation(xm, torch.roll(xm, 1, dims=0), tg)
        x64 = xm.double()
        cor_ref = (x64 * torch.roll(x64, 1, 0)).sum(-1) / torch.sqrt(
            (x64 ** 2).sum(-1) * (torch.roll(x64, 1, 0) ** 2).sum(-1))
        print(f"ILUFS sharded {loud:.9g} vs ILUFSMeter {loud_ref:.9g} "
              f"(relative {rel:.3g}); global meters vs local: mean square "
              f"{max_abs((x64 ** 2).mean(-1), ms):.3g}, true peak "
              f"{max_abs(x64.abs().amax(-1), tp):.3g}, correlation "
              f"{max_abs(cor_ref, cor):.3g} max abs")
        check(rel <= METER_RTOL, f"sharded ILUFS {rel:.3g} relative from "
              f"the meter > {METER_RTOL}")
        check(torch.allclose(ms.double(), (x64 ** 2).mean(-1), rtol=1e-5),
              "global mean square")
        check(torch.equal(tp.double(), x64.abs().amax(-1)),
              "global true peak")
        check(torch.allclose(cor.double(), cor_ref, rtol=1e-4, atol=1e-6),
              "global correlation")

        # device time per call: the sharded step against step, the same
        # input, the state carried (CUDA events behind the spin kernel)
        carry = [clone_state(states[0]), clone_state(states[0])]

        def one_sharded():
            carry[0], _ = step(carry[0], xs[0])

        def one_step():
            carry[1], _ = chain.step(params, carry[1], xs[0])

        ms_sh = time_ms(one_sharded, 4, warmup=2)
        ms_st = time_ms(one_step, 4, warmup=2)
        ms_sh2 = time_ms(one_sharded, 4, warmup=1)
        ms_st2 = time_ms(one_step, 4, warmup=1)
    finally:
        torch.distributed.destroy_process_group()
    print(f"sharded_step {ms_sh:.4f} / {ms_sh2:.4f} ms per call, step "
          f"{ms_st:.4f} / {ms_st2:.4f} (in turns, [{C}, {PAR_T}], CUDA "
          f"events, 4 calls; {card_line()})")

    dr = dryrun_multichip(1, device=dev.type)
    print(f"dryrun_multichip(1): mesh {dr['mesh']}, vs step "
          + ", ".join(f"{v:.2f}" for v in dr["snr_db"]) + " dB, ILUFS "
          f"{dr['ilufs_sharded']:.9g} vs {dr['ilufs_sequential']:.9g}")

    sig = [torch.from_numpy((rng.standard_normal((C, PAR_CALLS * PAR_T))
                             * 0.5).astype(np.float32)) for _ in range(2)]
    qx_np = (rng.standard_normal((C, PAR_CALLS * PAR_T)) * 0.6).astype(
        np.float32)
    qx_np.flat[::997] = np.nan
    qx_np.flat[5::1009] = 3e9
    qx = torch.from_numpy(qx_np)
    card = small_units_run(dev, sig, qx)
    host = small_units_run(torch.device("cpu"), sig, qx)
    # NaNs in the ring are the input's own, compared as such
    differ = [k for k in host if not (
        torch.equal(card[k].isnan(), host[k].isnan())
        and torch.equal(card[k].nan_to_num(0.0), host[k].nan_to_num(0.0)))]
    print(f"Bypass, Crossfade, QuantizedCounter on [{C}, {PAR_T}] x "
          f"{PAR_CALLS}, card vs CPU: {len(host) - len(differ)} of "
          f"{len(host)} outputs and states identical")
    check(not differ, f"small units differ from the CPU: {differ}")
    r.update(launches=launched, vs_step_db=dbs, state_db=state_db,
             tf32_identical=same, ilufs=loud, ilufs_meter=loud_ref,
             ilufs_rel=rel, sharded_ms=[ms_sh, ms_sh2],
             step_ms=[ms_st, ms_st2], dryrun=dr, units_identical=True)
    print(f"parallel phase: {time.perf_counter() - t_start:.1f} s")


def tessellated_box(size, cell=1.0):
    """A shoebox tessellated into ~cell-sized wall quads, normals inward
    (a copy of tests/test_reference_oracle_raytrace.py::_box, the mesh of
    benchmarks/raytrace_compare.py)."""
    lx, ly, lz = size
    verts, faces = {}, []

    def vid(p):
        key = (round(p[0], 6), round(p[1], 6), round(p[2], 6))
        if key not in verts:
            verts[key] = len(verts)
        return verts[key]

    def wall(origin, du, dv, nu, nv):
        o = np.array(origin, float)
        u = np.array(du, float) / nu
        v = np.array(dv, float) / nv
        for i in range(nu):
            for j in range(nv):
                a = vid(o + u * i + v * j)
                b = vid(o + u * (i + 1) + v * j)
                c = vid(o + u * (i + 1) + v * (j + 1))
                d = vid(o + u * i + v * (j + 1))
                faces.append((a, b, c))
                faces.append((a, c, d))

    def n(length):
        return max(1, int(np.ceil(length / cell)))

    wall((0, 0, 0), (lx, 0, 0), (0, ly, 0), n(lx), n(ly))
    wall((0, 0, lz), (0, ly, 0), (lx, 0, 0), n(ly), n(lx))
    wall((0, 0, 0), (0, 0, lz), (lx, 0, 0), n(lz), n(lx))
    wall((0, ly, 0), (lx, 0, 0), (0, 0, lz), n(lx), n(lz))
    wall((0, 0, 0), (0, ly, 0), (0, 0, lz), n(ly), n(lz))
    wall((lx, 0, 0), (0, 0, lz), (0, ly, 0), n(lz), n(ly))
    v = np.zeros((len(verts), 3), np.float32)
    for k, i in verts.items():
        v[i] = k
    return v, np.asarray(faces, np.int32)


def compare_tracer(dev):
    """``benchmarks/raytrace_compare.py::ours_ir`` at its defaults: 16384
    rays, a 0.25 s IR, 40 bounces, energy floor 1e-4, no air absorption,
    an ICOSPHERE source of 1 cm and an omni capture."""
    v, f = tessellated_box(RTC_SIZE)
    scene = Scene3D()
    scene.add_object(Object3D("room", v, f, Material(
        absorption=0.3, transparency=0.0, permeability=1.0)))
    rt = RayTrace3D(scene, sample_rate=SR, ir_length_s=0.25, rays=16384,
                    max_bounces=40, energy_floor=1e-4, air_absorption=0.0,
                    seed=0, device=dev)
    rt.add_source(SourceSettings(shape=SourceShape.ICOSPHERE, size=0.01,
                                 amplitude=1.0, position=np.array(RTC_SRC)))
    rt.add_capture(Capture(position=np.array(RTC_CAP)))
    return rt


def device_ms(fn):
    """Kernel time on the card while ``fn()`` runs (torch.profiler's CUDA
    activity, summed over kernels), or None where the profiler records
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages())
    return total / 1e3 if total > 0 else None


def device_kernels(fn, top: int = 10):
    """Kernel time on the card while ``fn()`` runs, by kernel
    (torch.profiler's CUDA activity): the total ms and the ``top``
    kernels as (name, ms, launches), or (None, []) where the profiler
    records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return (total or None), rows[:top]


def schroeder_db(ir: np.ndarray) -> np.ndarray:
    """Backward-integrated energy decay in dB (0 at the start)."""
    e = np.cumsum((ir.astype(np.float64) ** 2)[::-1])[::-1]
    return 10 * np.log10(np.maximum(e / max(e[0], 1e-300), 1e-30))


def rt60_s(sdb: np.ndarray) -> float:
    """T30: the least-squares slope of the decay from -5 to -35 dB,
    extrapolated to 60 dB."""
    idx = np.nonzero((sdb <= -5.0) & (sdb >= -35.0))[0]
    slope = np.polyfit(idx / SR, sdb[idx], 1)[0]
    return -60.0 / slope


def threed_phase(dev, res):
    """The room tracer on the card at the room demo's configuration and
    at raytrace_compare's, each against the port's CPU run of the same;
    then the room demo's convolution of the card's IR (kernel #1)."""
    from scipy.signal import fftconvolve

    t_start = time.perf_counter()
    r = res["threed"] = {}
    irs = {}
    for name, make in (("room_demo",
                        lambda d: room_demo.room_tracer(SR, d)),
                       ("raytrace_compare", compare_tracer)):
        make(dev).process()                      # first call: set-up
        rt = make(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ir = rt.process().data[0]
        sec = time.perf_counter() - t0
        bounces = rt.stats["bounces"]
        tally = OpCount()
        rt_n = make(dev)
        with tally:
            rt_n.process()
        busy = device_ms(make(dev).process)
        idle = None if busy is None else 1.0 - busy / (sec * 1e3)
        rt_h = make("cpu")
        t0 = time.perf_counter()
        ir_h = rt_h.process().data[0]
        sec_h = time.perf_counter() - t0
        check(np.isfinite(ir).all() and ir.shape == (rt.ir_len,),
              f"{name}: card IR not finite or of the wrong shape")
        nz, nz_h = np.nonzero(ir)[0], np.nonzero(ir_h)[0]
        check(nz.size > 0 and nz_h.size > 0, f"{name}: an empty IR")
        first, first_h = int(nz[0]), int(nz_h[0])
        check(first == first_h,
              f"{name}: direct arrival at bin {first}, CPU {first_h}")
        rel = abs(float(ir[first]) - float(ir_h[first])) / abs(
            float(ir_h[first]))
        check(rel <= DIRECT_RTOL, f"{name}: direct amplitude off by {rel}")
        sd, sd_h = schroeder_db(ir), schroeder_db(ir_h)
        upto = sd_h >= DECAY_FLOOR_DB
        decay = float(np.max(np.abs(sd[upto] - sd_h[upto])))
        check(decay <= DECAY_DB, f"{name}: Schroeder decay {decay:.4f} dB "
              f"from the CPU run > {DECAY_DB}")
        t60, t60_h = rt60_s(sd), rt60_s(sd_h)
        check(abs(t60 / t60_h - 1) <= RT60_REL,
              f"{name}: RT60 {t60:.4f} s vs CPU {t60_h:.4f} s")
        n_diff = int(np.count_nonzero(ir != ir_h))
        r[name] = dict(
            seconds=sec, cpu_seconds=sec_h, bounces=bounces,
            ms_per_bounce=sec * 1e3 / bounces,
            launches_per_bounce=tally.n / rt_n.stats["bounces"],
            syncs_per_bounce=tally.syncs / rt_n.stats["bounces"],
            device_ms_per_bounce=None if busy is None else busy / bounces,
            idle_share=idle,
            stats=dict(rt.stats), cpu_stats=dict(rt_h.stats),
            rays=rt.stats["rays_traced"], direct_bin=first,
            direct_rel=rel, decay_db=decay, rt60_s=t60, cpu_rt60_s=t60_h,
            bins_differing=n_diff, identical=n_diff == 0)
        print(f"threed {name}: {sec:.3f} s per process() on the card "
              f"({bounces} bounces: {sec * 1e3 / bounces:.2f} ms, "
              f"{tally.n / rt_n.stats['bounces']:.1f} launches and "
              f"{tally.syncs / rt_n.stats['bounces']:.1f} host syncs a "
              f"bounce; kernels "
              + ("not measured" if busy is None else
                 f"{busy / bounces:.3f} ms a bounce, the card idle "
                 f"{100 * idle:.1f} %")
              + f"), CPU {sec_h:.3f} s; stats {rt.stats}; vs the CPU "
              f"run: direct bin {first} (rel {rel:.2e}), Schroeder within "
              f"{decay:.2e} dB to {DECAY_FLOOR_DB:.0f} dB, RT60 {t60:.4f} "
              f"s vs {t60_h:.4f} s, {n_diff} bins differ")
        irs[name] = ir

    # the room demo's convolution of the card's IR (its peak at 0.5)
    ir = irs["room_demo"] * (0.5 / np.abs(irs["room_demo"]).max())
    conv = Convolver(ir, rank=CONV_RANK, device=dev)
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(C, CONV_BLOCKS * conv.block, generator=gen) * 0.25
    fft_counters = (fp.rfft_packed, fp.rfft_packed_zeropad, fp.irfft_packed)
    torch.cuda.synchronize()
    for f in fft_counters:
        f.launches = 0
    _, y = conv.process(conv.init_state((C,)), x.to(dev))
    torch.cuda.synchronize()
    launched = {f.__name__: f.launches for f in fft_counters}
    check(launched["rfft_packed"] + launched["rfft_packed_zeropad"] > 0
          and launched["irfft_packed"] > 0,
          f"the room convolver launched kernel #1 {launched}")
    gold = fftconvolve(x.double().numpy(), ir[None].astype(np.float64),
                       axes=-1)[:, :x.shape[-1]]
    db = snr_db(torch.from_numpy(gold), y.cpu())
    print(f"threed: Convolver(the card's IR, rank={CONV_RANK}, "
          f"{conv.partitions} partitions) on [{C}, {x.shape[-1]}]: "
          f"{db:.2f} dB from float64 fftconvolve; launches {launched}")
    check(db >= CHAIN_DB, f"room Convolver {db:.2f} dB < {CHAIN_DB}")
    r.update(convolver_db=db, convolver_launches=launched)
    print(f"threed phase: {time.perf_counter() - t_start:.1f} s")


def sanitized(a: np.ndarray) -> np.ndarray:
    """What a shared-memory ring delivers of ``a``: non-finite values and
    subnormals as 0 (csrc/shm_runtime.cpp's sanitize)."""
    a = np.where(np.isfinite(a), a, 0.0).astype(np.float32)
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, 0.0,
                    a).astype(np.float32)


def serve_phase(dev, res):
    """The streaming server at the bench graph's width: 8 streams x 8
    channels through the port's StreamEngine into ``step``, 24 pump
    iterations; every frame read back from the output rings against
    ``step`` run directly on the same gathered batches."""
    t_start = time.perf_counter()
    torch.cuda.synchronize()
    for f in PAR_COUNTERS:
        f.launches = 0
    out = serve.run(blocks=SERVE_BLOCKS, rank=RANK, channels=C,
                    streams=SERVE_STREAMS, ir_seconds=IR_S, device=dev,
                    keep_batches=True)
    torch.cuda.synchronize()
    launched = {f.__name__: f.launches for f in PAR_COUNTERS}
    print(f"serve: launches {launched}")
    check(out["served"] == SERVE_BLOCKS and out["waited"] == 0,
          f"served {out['served']} of {SERVE_BLOCKS}, {out['waited']} waits")
    check(out["underruns"] == 0 and
          out["gathered"] == SERVE_BLOCKS * SERVE_STREAMS,
          f"gathered {out['gathered']}, underruns {out['underruns']}")
    for name in ("rfft_packed", "sliding_rms", "peak_envelope"):
        check(launched[name] >= SERVE_BLOCKS,
              f"serve: {name} launched {launched[name]} < {SERVE_BLOCKS}")

    chain = pipeline.FilterConvChain(SR, C, rank=RANK, ir_seconds=IR_S,
                                     device=dev)
    params = chain.build()
    st = chain.init_state(params)
    st, _ = chain.step(params, st, torch.zeros(C, B, device=dev))
    ys = []
    for batch in out["batches"]:
        st, y = chain.step(params, st, batch.to(dev))
        ys.append(y.cpu())
    ref = sanitized(torch.cat(ys, dim=-1).numpy())
    per = C // SERVE_STREAMS
    same = all(np.array_equal(o, ref[i * per:(i + 1) * per])
               for i, o in enumerate(out["outputs"]))
    check(all(o.shape == (per, SERVE_BLOCKS * B) for o in out["outputs"]),
          "serve: output rings' frames of the wrong shape")
    check(same, "serve: frames read back differ from step on the same "
          "batches")
    busy = device_ms(lambda: serve.run(
        blocks=8, rank=RANK, channels=C, streams=SERVE_STREAMS,
        ir_seconds=IR_S, device=dev))
    idle = (None if busy is None
            else 1.0 - busy / 9 / out["host_ms_per_pump"])
    res["serve"] = dict(launches=launched, msps=out["msps"],
                        device_ms_per_pump=None if busy is None
                        else busy / 9, idle_share=idle,
                        host_ms_per_pump=out["host_ms_per_pump"],
                        served=out["served"], gathered=out["gathered"],
                        underruns=out["underruns"], identical=True)
    print(f"serve: {out['served']}/{SERVE_BLOCKS} served, 0 underruns, "
          f"every frame of the {SERVE_STREAMS} output rings identical to "
          f"step on the same batches; {out['msps']:.2f} M samples/s, "
          f"{out['host_ms_per_pump']:.4f} ms per pump iteration (host "
          f"clock); kernels "
          + ("not measured" if busy is None else
             f"{busy / 9:.4f} ms a pump (8 pumps and the warm call, "
             f"profiled), the card idle {100 * idle:.1f} %")
          + f"; phase {time.perf_counter() - t_start:.1f} s")


# --- the grad phase: gradients through step on the card --------------------

GRAD_AMP = 2.0        # step's inputs: loud enough that the compressor works
GRAD_DB = 100.0       # the card's step gradients vs the port's CPU run
RMS_BWD_DB = 120.0    # sliding_rms_bwd vs its plain version (float64 sums
#                       of the window in another order)
SCAN_BWD_DB = 120.0   # the scan's backward vs its plain backward
FFT_BWD_DB = FFT_DB   # #1's adjoints on the kernel vs on torch.fft
# calls a launch_profile makes (its default warm and counted calls, and
# the one before the profile)
LAUNCH_PROFILE_CALLS = 1 + 30 + 10
ENV_BWD_T = 4096      # the plain envelope backward's length off step's case
GRAD_COUNTERS = ((fp.rfft_packed, "bwd_launches"),
                 (fp.rfft_packed_zeropad, "bwd_launches"),
                 (fp.irfft_packed, "bwd_launches"),
                 (eu.sliding_rms_bwd, "launches"),
                 (eu.peak_envelope_bwd, "launches"))


@contextlib.contextmanager
def f64_ffts():
    """The CPU route's FFTs (ops/cplx) taken in float64 and rounded to
    float32: another rounding of the same function."""
    mods = (cplx, biquad_block, fftconv)
    saved = [(m.rfft_sc, m.irfft_sc) for m in mods]
    rfft, irfft = saved[0]

    def rfft64(x, n=None, dim=-1):
        re, im = rfft(x.double(), n, dim)
        return re.float(), im.float()

    def irfft64(sc, n=None, dim=-1, half=False):
        return irfft((sc[0].double(), sc[1].double()), n, dim, half).float()

    for m in mods:
        m.rfft_sc, m.irfft_sc = rfft64, irfft64
    try:
        yield
    finally:
        for m, (r, i) in zip(mods, saved):
            m.rfft_sc, m.irfft_sc = r, i


def grad_run(chain, params, xs, device):
    """Two calls of ``step`` with the state carried, loss the sum of both
    outputs squared, the compressor's 20 leaves 0-d tensors that require
    grad: the gradients of both inputs and of the leaves (the hold's is
    None: the envelope casts it to int)."""
    leaves = [torch.tensor(float(v), device=device, requires_grad=True)
              for v in tree.tree_flatten(params.comp)[0]]
    skel = tree.tree_flatten(params.comp)[1]
    p = params._replace(comp=tree.tree_unflatten(skel, leaves))
    x0, x1 = (torch.from_numpy(x).to(device).requires_grad_(True)
              for x in xs)
    st, y0 = chain.step(p, chain.init_state(p), x0)
    _, y1 = chain.step(p, st, x1)
    (torch.sum(y0 * y0) + torch.sum(y1 * y1)).backward()
    return [x0.grad, x1.grad] + [v.grad for v in leaves]


def envelope_codes(chain, params, xs, device):
    """``step``'s stages run one by one over the calls (no grad): each
    call's envelope branch codes (ops/env_units.peak_envelope_codes, on
    the CPU), the first call's share of envelope samples above the
    compressor's first knee (where its gain leaves 1), and the last
    output, which must be step's own."""
    cp = params.comp
    st = chain.init_state(params)
    codes = []
    with torch.no_grad():
        for x in xs:
            x = torch.from_numpy(x).to(device)
            y, eq = biquad_block.cascade_block_fused(params.eq_block, st.eq,
                                                     x)
            fdl, y = fftconv.fdl_process(params.h_spectra, st.fdl, y)
            sc, level = chain.sidechain.process(st.sc, y)
            env_st, gain, env = chain.compressor.process(cp, st.env, level)
            codes.append(eu.peak_envelope_codes(
                level.cpu(), env.cpu(), *(v.cpu() for v in st.env), cp.hold,
                cp.release_thresh))
            if not codes[1:]:
                share = float(torch.mean((env > cp.knees[0].start).float()))
            st = pipeline.ChainState(eq=eq, fdl=fdl, sc=sc, env=env_st)
    return codes, share, y * gain


def adjoint_timings(gen, dev) -> dict:
    """#1's adjoint routes at step's shapes ([2 C, N]: step's two blocks a
    call): each against its plain version (>= FFT_BWD_DB), its kernels
    of a call by torch.profiler after uncounted calls (one launch, its
    kernel's, and nothing else), the route's time (CUDA events behind
    the spin kernel), the plain route's and torch.fft's at the same shape
    in natural order (irfft of the [2 C, M + 1] spectrum for the inverse
    adjoints, rfft of the cotangent, zero-padded to N for a half, for
    the forward ones), and the bound."""
    rows = C * STEP_BLOCKS
    gre, gim = randn(gen, rows, B, dev=dev), randn(gen, rows, B, dev=dev)
    g_half = randn(gen, rows, B, dev=dev)
    g_full = randn(gen, rows, N, dev=dev)
    spec = torch.complex(randn(gen, rows, B + 1, dev=dev),
                         randn(gen, rows, B + 1, dev=dev))
    adj = dict(
        rfft_zeropad=(fp.rfft_packed_bwd, fp.rfft_packed_bwd_plain,
                      (gre, gim, N, 1), 2 * rows * B + rows * B,
                      lambda: torch.fft.irfft(spec, n=N)),
        rfft=(fp.rfft_packed_bwd, fp.rfft_packed_bwd_plain,
              (gre, gim, N, 0), 2 * rows * B + rows * N,
              lambda: torch.fft.irfft(spec, n=N)),
        irfft_first=(fp.irfft_packed_bwd, fp.irfft_packed_bwd_plain,
                     (g_half, N, "first"), rows * B + 2 * rows * B,
                     lambda: torch.fft.rfft(g_half, n=N)),
        irfft_last=(fp.irfft_packed_bwd, fp.irfft_packed_bwd_plain,
                    (g_half, N, "last"), rows * B + 2 * rows * B,
                    lambda: torch.fft.rfft(g_half, n=N)),
        irfft=(fp.irfft_packed_bwd, fp.irfft_packed_bwd_plain,
               (g_full, N, False), rows * N + 2 * rows * B,
               lambda: torch.fft.rfft(g_full)))
    out = {}
    for name, (fn, plain, args, floats, lib) in adj.items():
        out_k, out_p = fn(*args), plain(*args)
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        db = min(snr_db(a, b) for a, b in zip(out_p, out_k))
        check(db >= FFT_BWD_DB, f"#1 adjoint {name} {db:.1f} dB")
        kernel = ("rfft_packed_bwd_kernel" if name.startswith("rfft")
                  else "irfft_packed_bwd_kernel")
        counter = {"rfft": fp.rfft_packed, "rfft_zeropad":
                   fp.rfft_packed_zeropad}.get(name, fp.irfft_packed)
        before = counter.bwd_launches
        prof = launch_profile((lambda a: lambda: fn(*a))(args), rows, B, 1,
                              2, bytes_of=lambda k, f=floats: (
                                  F32 * f if k == kernel else None))
        calls = counter.bwd_launches - before
        # one launch a call by the wrapper's counter (the profiler can
        # lose records late in a long process, never add them): no other
        # kernel in the profile, and whether it is whole
        check(calls == LAUNCH_PROFILE_CALLS and all(
            r["name"] == kernel for r in prof),
            f"#1 adjoint {name}: {calls} launches over "
            f"{LAUNCH_PROFILE_CALLS} calls, profile {prof}")
        out[name] = dict(
            profile_whole=[(r["name"], r["launches"]) for r in prof]
            == [(kernel, 1)],
            db=db, max_abs_err=max(max_abs(a, b)
                                   for a, b in zip(out_p, out_k)),
            ms=time_ms(lambda: fn(*args), 50),
            kernel_ms=prof[0]["ms"] if prof else None,
            launches_per_call=1,
            plain_ms=time_ms(lambda: plain(*args), 20),
            library_ms=time_ms(lib, 50),
            **bound(F32 * floats, rows * fft_flops(N)))
    print("#1's adjoints at step's shapes ([" + f"{rows}, N = {N}], one "
          "launch a call each): " + "; ".join(
              f"{k} {v['ms']:.4f} ms (kernel "
              + ("not in the profile" if v["kernel_ms"] is None
                 else f"{v['kernel_ms']:.4f} by the profiler")
              + f", plain {v['plain_ms']:.4f} (host-paced: a pageable "
              f"copy a call), torch.fft {v['library_ms']:.4f}, bound "
              f"{v['bound_ms']:.4f}) {v['db']:.1f} dB"
              for k, v in out.items()))
    return out


def grad_phase(chain, params, dev, res):
    """Gradients through two calls of ``step`` at the bench graph's width
    on the card against the port's CPU run; the backward kernels against
    their plain versions; TF32; device times."""
    t_start = time.perf_counter()
    t = STEP_BLOCKS * B
    rng = np.random.default_rng(14)
    xs = [(rng.standard_normal((C, t)) * GRAD_AMP).astype(np.float32)
          for _ in range(2)]
    codes, share, y_st = envelope_codes(chain, params, xs, dev)
    with torch.no_grad():
        st, _ = chain.step(params, chain.init_state(params),
                           torch.from_numpy(xs[0]).to(dev))
        _, y_ref = chain.step(params, st, torch.from_numpy(xs[1]).to(dev))
    check(torch.equal(y_st, y_ref), "grad: step's stages one by one are not "
          "step")
    check(share > 0.0, "grad: the compressor never engages")

    torch.cuda.synchronize()
    for f, attr in GRAD_COUNTERS:
        setattr(f, attr, 0)
    g_card = grad_run(chain, params, xs, dev)
    torch.cuda.synchronize()
    launched = {f"{f.__name__}.{attr}": getattr(f, attr)
                for f, attr in GRAD_COUNTERS}
    print(f"grad: 2 calls of step on [{C}, {t}] at amplitude {GRAD_AMP} "
          f"({100 * share:.1f} % of the envelope above the first knee); "
          f"backward launches {launched}")
    for name, cnt in launched.items():
        check(cnt >= 2, f"grad: {name} {cnt} < 2")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    g_tf32 = grad_run(chain, params, xs, dev)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    tf32_same = all((a is None and b is None) or torch.equal(a, b)
                    for a, b in zip(g_card, g_tf32))
    check(tf32_same, "grad: gradients changed with TF32 switched on")

    t0 = time.perf_counter()
    cpu_chain = pipeline.FilterConvChain(SR, C, rank=RANK, ir_seconds=IR_S,
                                         device="cpu")
    cpu_params = tree.tree_map(
        lambda v: v.cpu() if torch.is_tensor(v) else v, params)
    g_cpu = grad_run(cpu_chain, cpu_params, xs, "cpu")
    cpu_s = time.perf_counter() - t0
    # the envelope's gradient jumps where a step's branch changes; where
    # a level sits within float32 rounding of a comparison (e at the
    # release threshold), the two devices' roundings (kernel #1 against
    # torch.fft) take different branches.  Channels whose envelope took
    # the same branches on both are held to the bar; the others are
    # printed, beside a control: the CPU run against itself with its
    # FFTs taken in float64 (another rounding of the same function)
    codes_cpu = envelope_codes(cpu_chain, cpu_params, xs, "cpu")[0]
    flips = sum((a != b).sum(dim=-1) for a, b in zip(codes_cpu, codes))
    agree = torch.nonzero(flips == 0)[:, 0]
    zero = torch.zeros(())
    dbs, flipped_dbs = {}, {}
    for i, (a, b) in enumerate(zip(g_cpu, g_card)):
        a = zero if a is None else a
        b = zero if b is None else b.cpu()
        name = ("x0", "x1")[i] if i < 2 else f"leaf{i - 2}"
        check(bool(torch.equal(a == 0, b == 0)),
              f"grad {name}: zeros differ from the CPU run's")
        if i < 2:
            flipped_dbs[name] = snr_db(a, b)
            a, b = a[agree], b[agree]
        if bool(torch.any(a != 0)):
            dbs[name] = snr_db(a, b)
    worst = min(dbs.values())
    t0 = time.perf_counter()
    with f64_ffts():
        g_64 = grad_run(cpu_chain, cpu_params, xs, "cpu")[:2]
        codes_64 = envelope_codes(cpu_chain, cpu_params, xs, "cpu")[0]
    control = dict(flipped_samples=int(sum((a != b).sum() for a, b in zip(
        codes_cpu, codes_64))), x0_db=snr_db(g_cpu[0], g_64[0]),
        x1_db=snr_db(g_cpu[1], g_64[1]))
    print(f"grad: card vs the port's CPU run ({cpu_s:.1f} s): "
          f"{len(agree)} of {C} channels took the same envelope branches on "
          f"both: x0 {dbs['x0']:.2f} dB, x1 {dbs['x1']:.2f} dB there; "
          f"{int(flips.sum())} samples of the other {C - len(agree)} took "
          f"another branch (all channels: x0 {flipped_dbs['x0']:.2f}, x1 "
          f"{flipped_dbs['x1']:.2f} dB; the CPU against itself with float64 "
          f"FFTs: {control['flipped_samples']} samples, x0 "
          f"{control['x0_db']:.2f}, x1 {control['x1_db']:.2f} dB, "
          f"{time.perf_counter() - t0:.1f} s); the {len(dbs) - 2} non-zero "
          f"compressor leaves >= "
          f"{min(v for k, v in dbs.items() if k.startswith('leaf')):.2f} "
          f"dB, zeros at the same leaves ({20 - len(dbs) + 2} of 20); TF32 "
          f"on: identical = {tf32_same}")
    check(worst >= GRAD_DB, f"grad: {worst:.2f} dB < {GRAD_DB}")

    # device time of a call, forward alone and forward + backward (x
    # requires grad; the parameters host numbers)
    xg = [torch.from_numpy(x).to(dev) for x in xs]
    st0 = chain.init_state(params)

    def fwd():
        with torch.no_grad():
            s, _ = chain.step(params, st0, xg[0])
            chain.step(params, s, xg[1])

    def fwd_bwd():
        x0, x1 = (x.detach().requires_grad_(True) for x in xg)
        s, y0 = chain.step(params, st0, x0)
        _, y1 = chain.step(params, s, x1)
        (torch.sum(y0 * y0) + torch.sum(y1 * y1)).backward()

    # one pair of calls a timing: forward + backward makes ~500 launches,
    # which stay inside the card's queue of pending launches behind the
    # spin kernel (more would let the host's pace show through)
    fwd_ms = time_ms(fwd, 1, warmup=3) / 2
    fwd_bwd_ms = time_ms(fwd_bwd, 1, warmup=3) / 2
    t0 = time.perf_counter()
    fwd_bwd()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 2
    busy, top = device_kernels(fwd_bwd)
    print(f"grad: step {fwd_ms:.4f} ms a call forward, {fwd_bwd_ms:.4f} "
          f"ms forward + backward (CUDA events behind the spin kernel, one "
          f"pair of calls); {host_ms:.4f} ms a call of host time with a "
          f"sync; kernels of one forward + backward of the 2 calls "
          + ("not measured" if busy is None else
             f"{busy:.4f} ms, the most: " + "; ".join(
                 f"{name[:60]} {ms:.4f} ms x {n}" for name, ms, n in top)))

    gen = torch.Generator().manual_seed(15)
    sm_hz = res.get("peak", {}).get("sm_clock_hz", SM_HZ)
    n = chain.sidechain.reactivity
    # sliding_rms_bwd at step's shape, on step's |y| and a carried window
    y = randn(gen, C, t, scale=GRAD_AMP, dev=dev).abs()
    win = randn(gen, C, n, scale=0.5, dev=dev) ** 2
    _, level = eu.sliding_rms(win, y, n, 1.0)
    rms_args = (win, y, level, randn(gen, C, t, dev=dev),
                randn(gen, C, n, dev=dev), n, 1.0)
    gw_k, gx_k = eu.sliding_rms_bwd(*rms_args)
    gw_p, gx_p = eu.sliding_rms_bwd_plain(*rms_args)
    rms_db = min(snr_db(gx_p, gx_k), snr_db(gw_p, gw_k))
    rms_same = float(torch.mean((gx_p == gx_k).float()))
    check(rms_db >= RMS_BWD_DB,
          f"sliding_rms_bwd {rms_db:.1f} dB < {RMS_BWD_DB}")
    a_frame = randn(gen, C, 1, t + 2 * n, dev=dev)
    res["rms_bwd"] = dict(
        db=rms_db, identical_share=rms_same,
        max_abs_err=max(max_abs(gx_p, gx_k), max_abs(gw_p, gw_k)),
        ms=time_ms(lambda: eu.sliding_rms_bwd(*rms_args), 50),
        plain_ms=time_ms(lambda: eu.sliding_rms_bwd_plain(*rms_args), 20),
        library_ms=time_ms(lambda: torch.nn.functional.avg_pool1d(
            a_frame, n, stride=1), 50),
        **bound(F32 * (4 * C * t + 2 * C * n), 8 * C * (t + n)))
    r = res["rms_bwd"]
    print(f"sliding_rms_bwd [{C}, {t}], N = {n}: {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']})"
          f", avg_pool1d over a prebuilt frame {r['library_ms']:.4f}; vs "
          f"plain {rms_db:.1f} dB, {100 * rms_same:.2f} % of g_x identical")

    # peak_envelope_bwd in step's configuration at step's shape (the plain
    # loop on the card, timed once), then a hold of 24 from a random state
    # at [C, ENV_BWD_T], threshold on and off: bit for bit
    cp = params.comp
    cases = [("step", level, dyn.env_init((C,), dev), cp.hold,
              cp.release_thresh)]
    xh = swell_levels(gen, C, ENV_BWD_T, dev)
    sth = dyn.EnvState(torch.rand(C, generator=gen).to(dev),
                       torch.rand(C, generator=gen).to(dev),
                       torch.randint(0, 25, (C,), generator=gen,
                                     dtype=torch.int32).to(dev))
    cases += [("hold24", xh, sth, 24, rt) for rt in (cp.release_thresh,
                                                     None)]
    err, peak_args = 0.0, None
    for name, xx, s0, hold, rt in cases:
        _, env = eu.peak_envelope(s0, xx, cp.tau_attack, cp.tau_release,
                                  hold, rt)
        lead = xx.shape[:-1]
        args = (xx, env, *s0, randn(gen, *xx.shape, dev=dev),
                randn(gen, *lead, dev=dev), randn(gen, *lead, dev=dev),
                cp.tau_attack, cp.tau_release, hold, rt)
        k_out = eu.peak_envelope_bwd(*args)
        p_ms, p_out = time_once_ms(lambda: eu.peak_envelope_bwd_plain(*args))
        same = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
        check(same, f"peak_envelope_bwd {name} rt={rt} differs from its "
              f"plain version")
        err = max(err, max(max_abs(a, b) for a, b in zip(p_out, k_out)))
        if name == "step":
            peak_args, peak_plain_ms = args, p_ms
    ms = time_ms(lambda: eu.peak_envelope_bwd(*peak_args), 20)
    # a hold of 24 from the random state at step's shape: the kernel alone
    _, env24 = eu.peak_envelope(sth, level, cp.tau_attack, cp.tau_release,
                                24, cp.release_thresh)
    args24 = (level, env24, *sth, *peak_args[5:8], cp.tau_attack,
              cp.tau_release, 24, cp.release_thresh)
    ms24 = time_ms(lambda: eu.peak_envelope_bwd(*args24), 20)
    res["peak_bwd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=peak_plain_ms, library_ms=None,
        chain_ms=chain_ms(REV_CHAIN_OPS * t),
        cycles_per_step=ms * 1e-3 * sm_hz / t, hold24_ms=ms24,
        hold24_cycles_per_step=ms24 * 1e-3 * sm_hz / t,
        **bound(F32 * (4 * C * t + 8 * C), 8 * C * t))
    r = res["peak_bwd"]
    print(f"peak_envelope_bwd [{C}, {t}] (step's configuration): "
          f"{ms:.4f} ms ({r['cycles_per_step']:.1f} cycles a step), with a "
          f"hold of 24 {ms24:.4f} ms ({r['hold24_cycles_per_step']:.1f}), "
          f"plain {peak_plain_ms:.1f} ms (one call, host-paced), bound "
          f"{r['bound_ms']:.4f} ({r['bound_by']}), the reverse pass's chain "
          f"{r['chain_ms']:.4f}; identical to plain in step's case and with "
          f"a hold of 24 at [{C}, {ENV_BWD_T}], threshold on and off")

    # the scan's backward: the chain's 8 bands (K = 9) at [C, t]
    coeffs = torch.from_numpy(np.asarray(params.eq_coeffs)).to(dev)
    k = coeffs.shape[0]
    s0 = randn(gen, C, k, 2, scale=0.1, dev=dev)
    xq = randn(gen, C, t, scale=0.25, dev=dev)
    yq, _ = bq.biquad_cascade(coeffs, s0, xq)
    scan_args = (coeffs, s0, xq, yq, randn(gen, C, t, dev=dev),
                 randn(gen, C, k, 2, dev=dev))
    before = bq.biquad_cascade.bwd_launches
    k_out = bq.biquad_cascade_bwd(*scan_args)
    per_call = bq.biquad_cascade.bwd_launches - before
    p_ms, p_out = time_once_ms(lambda: bq.biquad_cascade_bwd_plain(
        *scan_args))
    scan_same = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
    scan_db = min(snr_db(a, b) for a, b in zip(p_out, k_out))
    check(scan_db >= SCAN_BWD_DB,
          f"biquad_cascade_bwd {scan_db:.1f} dB < {SCAN_BWD_DB}")
    route_ms = time_ms(lambda: bq.biquad_cascade_bwd(*scan_args), 10)
    res["scan_bwd"] = dict(
        launches_per_call=per_call, db=scan_db, identical=scan_same,
        max_abs_err=max(max_abs(a, b) for a, b in zip(p_out, k_out)),
        ms=route_ms, plain_ms=p_ms, library_ms=None,
        **scan_route_split(lambda: bq.biquad_cascade_bwd(*scan_args),
                           route_ms),
        **bound(F32 * (4 * C * t + 10 * k + 4 * C * k),
                (2 * k - 1) * scan_flops(t, 1, C) + 16 * C * t * k))
    r = res["scan_bwd"]
    print(f"biquad_cascade_bwd [{C}, {t}] K = {k}: {r['ms']:.4f} ms "
          f"({per_call} scan launches), plain {p_ms:.1f} ms (one call, "
          f"host-paced), bound {r['bound_ms']:.4f} ({r['bound_by']}); vs "
          f"plain {scan_db:.1f} dB, identical = {scan_same}; of a call: "
          f"the scan kernels {r['scan_kernels_ms']:.4f} ms "
          f"({r['scan_launches']} launches), torch's "
          f"{r['glue_kernels_ms']:.4f} ({r['glue_launches']} launches), the "
          f"rest {r['host_gaps_ms']:.4f} ({card_line()})")

    # #1's adjoints as step runs them, at step's shapes (and the whole
    # frame's inverse adjoint): one launch each, its weights inside the
    # kernel; the route against its plain version (the weights by torch's
    # multiplies around torch.fft), torch.fft in natural order beside it
    res["fft_bwd"] = adjoint_timings(gen, dev)
    for key, modes in (("rfft_bwd", ("rfft_zeropad", "rfft")),
                       ("irfft_bwd", ("irfft_first", "irfft_last",
                                      "irfft"))):
        first = res["fft_bwd"][modes[0]]
        res[key] = dict(
            {k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")},
            max_abs_err=max(res["fft_bwd"][m]["max_abs_err"]
                            for m in modes),
            modes={m: res["fft_bwd"][m] for m in modes})
    res["rfft_bwd"]["launches"] = (launched["rfft_packed.bwd_launches"]
                                   + launched["rfft_packed_zeropad"
                                              ".bwd_launches"])
    res["irfft_bwd"]["launches"] = launched["irfft_packed.bwd_launches"]
    res["grad"] = dict(
        knee_share=share, launches=launched, db=dbs,
        all_channels_db=flipped_dbs,
        same_branch_channels=len(agree), flipped_samples=int(flips.sum()),
        f64_fft_control=control, tf32_identical=tf32_same, cpu_s=cpu_s,
        fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms, fwd_bwd_host_ms=host_ms,
        fwd_bwd_kernels_ms=busy,
        fwd_bwd_top_kernels=top)
    res["rms_bwd"]["launches"] = launched["sliding_rms_bwd.launches"]
    res["peak_bwd"]["launches"] = launched["peak_envelope_bwd.launches"]
    print(f"grad phase: {time.perf_counter() - t_start:.1f} s")


# --- the grad_ring phase: gradients through step_ring and the ring ------

RING_GRAD_BLOCKS = 8  # step_ring blocks carried under one loss
FDL_BWD_DB = 110.0    # eqfdl_bwd's and fdl_bwd's routes vs their plain
#                       backwards (kernel #1 against torch.fft, channel
#                       sums in another order)
DYN_BWD_DB = 120.0    # chain_dyn_bwd vs its plain backward (the float64
#                       level against the plain float32 prefix sums)
RING_COUNTERS = (ff.eqfdl_fused_bwd, ff.fdl_fused_bwd, env_ops.chain_dyn_bwd,
                 ff.frame_bwd)


def dbs_of(names, refs, outs) -> dict:
    """snr_db of each output against its reference; an output that is
    zero wherever its reference is (a cotangent that vanishes, such as
    the peak's at a hold of 0) must be identical to it and is left
    out."""
    out = {}
    for name, a, b in zip(names, refs, outs):
        if not bool(torch.any(a != 0)):
            check(torch.equal(a.cpu(), b.cpu()), f"{name}: zero against "
                  f"non-zero")
            continue
        out[name] = snr_db(a.cpu(), b.cpu())
    return out


def ring_params(params, device):
    """``params`` on ``device`` with the IR spectra, the EQ spectrum and
    g_mat, m_mat, w_mat as new leaves that require grad (step_ring packs
    them in its graph), and those leaves."""
    eqb = params.eq_block
    leaf = [v.detach().to(device).clone().requires_grad_(True) for v in (
        params.h_spectra.re, params.h_spectra.im, eqb.h_re, eqb.h_im,
        eqb.g_mat, eqb.m_mat, eqb.w_mat)]
    p = tree.tree_map(lambda v: v.to(device) if torch.is_tensor(v) else v,
                      params)
    p = p._replace(h_spectra=fftconv.Spectra(leaf[0], leaf[1]),
                   eq_block=p.eq_block._replace(
                       h_re=leaf[2], h_im=leaf[3], g_mat=leaf[4],
                       m_mat=leaf[5], w_mat=leaf[6]))
    return p, leaf


def ring_grad_run(chain, params, xs, device, keep):
    """RING_GRAD_BLOCKS blocks of step_ring from init_ring_state, loss
    the sum of the outputs squared over the channels ``keep`` (a
    channel's output depends on the shared parameters and its own input
    alone, so the parameters' gradients are then the sum of those
    channels' shares): the gradients of each block's x and of the IR
    spectra, the EQ spectrum, g_mat, m_mat and w_mat."""
    p, leaf = ring_params(params, device)
    xt = [torch.from_numpy(x).to(device).requires_grad_(True) for x in xs]
    wc = torch.zeros(C, 1, device=device)
    wc[keep.to(device)] = 1.0
    st = chain.init_ring_state(p)
    total = 0.0
    for x in xt:
        st, y = chain.step_ring(p, st, x)
        total = total + torch.sum(y * y * wc)
    total.backward()
    return [x.grad for x in xt] + [v.grad for v in leaf]


def ring_codes(chain, params, xs, device):
    """step_ring's stages run block by block (no grad): each block's
    envelope branch codes (on the CPU), from kernel #3's level and
    envelope as chain_dyn_bwd replays them on the card, from
    chain_dyn_plain's on the CPU; and the share of envelope samples above
    the first knee."""
    cp = params.comp
    st = chain.init_ring_state(params)
    eqp = params.eq_block
    codes, above = [], 0.0
    with torch.no_grad():
        for x in xs:
            x = torch.from_numpy(x).to(device)
            w = (st.fdl.pos + 1) % params.h_re.shape[0]
            y, u, sv2, rr, ri = ff.eqfdl_fused(
                st.fdl.spec_re, st.fdl.spec_im, params.h_re, params.h_im,
                params.heq_re, params.heq_im, *fp.rfft_packed_zeropad(x), x,
                st.eq.reshape(C, -1), eqp.g_t, eqp.m_mat, eqp.w_mat,
                st.fdl.history, w)
            args = (chain.sidechain.reactivity, chain.sidechain.gain,
                    cp.tau_attack, cp.tau_release, cp.release_thresh,
                    cp.hold, cp.knees)
            if device == "cpu":
                win, env_st, _, level, env = env_ops._chain_dyn_plain(
                    st.sc.window, st.env, y, *args)
            else:
                z = torch.zeros_like
                level, env = env_ops.chain_dyn_bwd(
                    st.sc.window, st.env, y, z(st.sc.window),
                    z(st.env.envelope), z(st.env.peak), z(y), *args,
                    replay=True)[6:8]
                win, env_st, _ = chain_dyn(st.sc.window, st.env, y, *args)
            codes.append(eu.peak_envelope_codes(
                level.cpu(), env.cpu(), *(v.cpu() for v in st.env), cp.hold,
                cp.release_thresh))
            above += float(torch.mean((env > cp.knees[0].start).float()))
            st = pipeline.ChainRingState(
                eq=sv2.reshape(st.eq.shape),
                fdl=fftconv.RingFDLState(rr, ri, u, w),
                sc=st.sc._replace(window=win), env=env_st)
    return torch.stack(codes), above / len(xs)


def grad_ring_phase(chain, params, dev, res):
    """Gradients through RING_GRAD_BLOCKS blocks of step_ring and P + 2
    blocks of the packed fdl_ring_step at full width on the card, against
    the port's CPU run; the three backward kernels against their plain
    backwards on the same saved inputs; TF32; device times."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(15)
    xs = [(rng.standard_normal((C, B)) * GRAD_AMP).astype(np.float32)
          for _ in range(RING_GRAD_BLOCKS)]
    # the envelope's gradient jumps where a step's branch changes, and
    # the two devices' roundings can put a level on either side of the
    # release threshold: the channels whose branches agree carry the loss
    # (the others are printed)
    cpu_chain = pipeline.FilterConvChain(SR, C, rank=RANK, ir_seconds=IR_S,
                                         device="cpu")
    cpu_params = tree.tree_map(
        lambda v: v.cpu() if torch.is_tensor(v) else v, params)
    codes_card, share = ring_codes(chain, params, xs, dev)
    codes_cpu = ring_codes(cpu_chain, cpu_params, xs, "cpu")[0]
    flips = (codes_card != codes_cpu).sum(dim=(0, 2))
    agree = torch.nonzero(flips == 0)[:, 0]
    torch.cuda.synchronize()
    for f in RING_COUNTERS:
        f.launches = 0
    fp.rfft_packed_zeropad.bwd_launches = 0
    g_card = ring_grad_run(chain, params, xs, dev, agree)
    torch.cuda.synchronize()
    launched = {f.__name__: f.launches for f in RING_COUNTERS}
    launched["rfft_packed_zeropad.bwd_launches"] = \
        fp.rfft_packed_zeropad.bwd_launches
    check(all(launched[k] >= RING_GRAD_BLOCKS for k in (
        "eqfdl_fused_bwd", "chain_dyn_bwd", "frame_bwd",
        "rfft_packed_zeropad.bwd_launches")),
        f"grad_ring: backward launches {launched}")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    g_tf32 = ring_grad_run(chain, params, xs, dev, agree)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    tf32_same = all(torch.equal(a, b) for a, b in zip(g_card, g_tf32))
    check(tf32_same, "grad_ring: gradients changed with TF32 switched on")

    t0 = time.perf_counter()
    g_cpu = ring_grad_run(cpu_chain, cpu_params, xs, "cpu", agree)
    cpu_s = time.perf_counter() - t0
    names = [f"x{k}" for k in range(RING_GRAD_BLOCKS)] + [
        "h_re", "h_im", "heq_re", "heq_im", "g_mat", "m_mat", "w_mat"]
    dbs = dbs_of(names, g_cpu, g_card)
    worst = min(dbs.values())
    print(f"grad_ring: {RING_GRAD_BLOCKS} blocks of step_ring on [{C}, {B}] "
          f"at amplitude {GRAD_AMP} ({100 * share:.1f} % of the envelope "
          f"above the first knee); backward launches {launched}; card vs "
          f"the port's CPU run ({cpu_s:.1f} s): {len(agree)} of {C} "
          f"channels took the same envelope branches on both ("
          f"{int(flips.sum())} samples of the other {C - len(agree)}, "
          f"channels {torch.nonzero(flips)[:, 0].tolist()}), which carry "
          f"the loss: "
          + ", ".join(f"{k} {v:.2f}" for k, v in dbs.items())
          + f" dB; TF32 on: identical = {tf32_same}")
    check(worst >= GRAD_DB, f"grad_ring: {worst:.2f} dB < {GRAD_DB}")

    # the packed fdl_ring_step (#4) under grad: x and the IR spectra
    p_n = params.h_re.shape[0]
    fx = [torch.from_numpy(x) for x in xs[:2]] * ((p_n + 3) // 2)

    def fdl_run(device):
        h = [v.detach().to(device).clone().requires_grad_(True)
             for v in params.h_spectra]
        st = fftconv.init_ring_fdl(fftconv.Spectra(*h), (C,), packed=True,
                                   device=device)
        xt = [torch.roll(x, shifts=k, dims=-1).to(device).requires_grad_(True)
              for k, x in enumerate(fx[:p_n + 2])]
        total = 0.0
        for x in xt:
            st, y = fftconv.fdl_ring_step(fftconv.Spectra(*h), st, x)
            total = total + torch.sum(y * y)
        total.backward()
        return [x.grad for x in xt] + [v.grad for v in h]

    ff.fdl_fused_bwd.launches = 0
    gf_card = fdl_run(dev)
    torch.cuda.synchronize()
    fdl_launches = ff.fdl_fused_bwd.launches
    check(fdl_launches >= p_n + 2, f"fdl_bwd launches {fdl_launches}")
    gf_cpu = fdl_run("cpu")
    fdl_db = min(dbs_of([f"x{k}" for k in range(p_n + 2)] + ["h_re", "h_im"],
                        gf_cpu, gf_card).values())
    check(fdl_db >= GRAD_DB, f"fdl_ring_step grad {fdl_db:.2f} dB")
    print(f"grad_ring: {p_n + 2} blocks of the packed fdl_ring_step under "
          f"grad: {fdl_launches} fdl_bwd launches, card vs CPU >= "
          f"{fdl_db:.2f} dB (x and the IR spectra)")

    # each backward against its plain backward on the same saved inputs:
    # block 3 of the drive (the ring partly filled), random cotangents
    gen = torch.Generator().manual_seed(16)
    cp, eqp = params.comp, params.eq_block
    st = chain.init_ring_state(params)
    with torch.no_grad():
        for x in xs[:3]:
            st, _ = chain.step_ring(params, st, torch.from_numpy(x).to(dev))
        x = torch.from_numpy(xs[3]).to(dev)
        w = (st.fdl.pos + 1) % p_n
        xs_re, xs_im = fp.rfft_packed_zeropad(x)
        sv = st.eq.reshape(C, -1).contiguous()
        rr, ri = st.fdl.spec_re.clone(), st.fdl.spec_im.clone()
        y_lin, u, _, rr, ri = ff.eqfdl_fused(
            rr, ri, params.h_re, params.h_im, params.heq_re, params.heq_im,
            xs_re, xs_im, x, sv, eqp.g_t, eqp.m_mat, eqp.w_mat,
            st.fdl.history, w)
    k2 = sv.shape[1]
    cot = [randn(gen, C, B, dev=dev), randn(gen, C, B, dev=dev),
           randn(gen, C, k2, dev=dev), randn(gen, p_n, C, B, dev=dev),
           randn(gen, p_n, C, B, dev=dev)]
    eq_args = (rr, ri, params.h_re, params.h_im, params.heq_re,
               params.heq_im, xs_re, xs_im, x, sv, eqp.g_t, eqp.m_mat,
               eqp.w_mat, w, *cot)
    before = ff.eqfdl_fused_bwd.fft_launches
    k_out = ff.eqfdl_fused_bwd(*eq_args)
    fft_per_call = ff.eqfdl_fused_bwd.fft_launches - before
    check(all(torch.equal(a, b) for a, b in zip(
        k_out, ff.eqfdl_fused_bwd(*eq_args))),
        "eqfdl_fused_bwd differs from run to run")
    p_ms, p_out = time_once_ms(lambda: ff.eqfdl_fused_bwd_plain(*eq_args))
    eq_dbs = dbs_of(("ring_re", "ring_im", "h_re", "h_im", "heq_re",
                     "heq_im", "xs_re", "xs_im", "x", "sv", "g_t", "m_mat",
                     "w_mat", "hist"), p_out, k_out)
    check(min(eq_dbs.values()) >= FDL_BWD_DB,
          f"eqfdl_bwd {eq_dbs} < {FDL_BWD_DB}")
    # each launch of one call of either route: name, ms, bytes bound
    profiles = {
        "eqfdl_bwd": launch_profile(lambda: ff.eqfdl_fused_bwd(*eq_args),
                                    C, B, p_n, k2),
        "fdl_bwd": launch_profile(lambda: ff.fdl_fused_bwd(
            rr, ri, params.h_re, params.h_im, w, cot[0], cot[3], cot[4]),
            C, B, p_n, k2)}
    names = {k: [r["name"] for r in v] for k, v in profiles.items()}
    check(sum(n.startswith("eqfdl_bwd<") for n in names["eqfdl_bwd"]) == 1
          and "eqfdl_bwd_sums" in names["eqfdl_bwd"]
          and "fdl_bwd" in names["eqfdl_bwd"]
          and "fdl_bwd" in names["fdl_bwd"]
          and not any(n in ("torch add", "torch copy", "irfft_packed_kernel")
                      for v in names.values() for n in v),
          f"grad_ring: the backwards' launches {names}")
    plane = C * B * F32
    k2b = k2 * B * F32
    res["eqfdl_bwd"] = dict(
        db=min(eq_dbs.values()), fft_launches_per_call=fft_per_call,
        max_abs_err=max(max_abs(a, b) for a, b in zip(p_out, k_out)),
        ms=time_ms(lambda: ff.eqfdl_fused_bwd(*eq_args), 20),
        plain_ms=time_ms(lambda: ff.eqfdl_fused_bwd_plain(*eq_args), 5),
        library_ms=None, launches=launched["eqfdl_fused_bwd"],
        launch_profile=profiles["eqfdl_bwd"],
        **bound(6 * p_n * plane + 4 * p_n * B * F32 + 10 * plane + 4 * k2b,
                C * (3 * fft_flops(N) + 16 * p_n * B + 8 * k2 * B)))
    fdl_args = (rr, ri, params.h_re, params.h_im, w, cot[0], cot[3], cot[4])
    k_out = ff.fdl_fused_bwd(*fdl_args)
    check(all(torch.equal(a, b) for a, b in zip(
        k_out, ff.fdl_fused_bwd(*fdl_args))),
        "fdl_fused_bwd differs from run to run")
    p_out = ff.fdl_fused_bwd_plain(*fdl_args)
    fdl_dbs = dbs_of(("ring_re", "ring_im", "h_re", "h_im", "hist", "x"),
                     p_out, k_out)
    check(min(fdl_dbs.values()) >= FDL_BWD_DB,
          f"fdl_bwd {fdl_dbs} < {FDL_BWD_DB}")
    res["fdl_bwd"] = dict(
        db=min(fdl_dbs.values()), card_vs_cpu_db=fdl_db,
        max_abs_err=max(max_abs(a, b) for a, b in zip(p_out, k_out)),
        ms=time_ms(lambda: ff.fdl_fused_bwd(*fdl_args), 20),
        plain_ms=time_ms(lambda: ff.fdl_fused_bwd_plain(*fdl_args), 5),
        library_ms=None, launches=fdl_launches,
        launch_profile=profiles["fdl_bwd"],
        **bound(6 * p_n * plane + 4 * p_n * B * F32 + 3 * plane,
                C * (2 * fft_flops(N) + 16 * p_n * B)))

    # the frame kernel alone: eqfdl_fused_bwd's form (the inverse, the sum
    # with u's cotangent, its zero-pad transform) and fdl_fused_bwd's (the
    # inverse's two halves) against frame_bwd_plain on the card
    gs = (randn(gen, C, B, dev=dev), randn(gen, C, B, dev=dev))
    fr_k = ff.frame_bwd(*gs, N, cot[1])
    fr_p = ff.frame_bwd_plain(*gs, N, cot[1])
    fr_db = min(snr_db(a, b) for a, b in zip(fr_p, fr_k))
    fdl_k, fdl_p = ff.frame_bwd(*gs, N), ff.frame_bwd_plain(*gs, N)
    fr_db = min([fr_db] + [snr_db(a, b) for a, b in zip(fdl_p, fdl_k)])
    check(fr_db >= FFT_BWD_DB, f"frame_bwd {fr_db:.1f} dB < {FFT_BWD_DB}")
    before = ff.frame_bwd.launches
    fr_prof = launch_profile(lambda: ff.frame_bwd(*gs, N, cot[1]), C, B, p_n,
                             k2)
    fr_calls = ff.frame_bwd.launches - before
    check(fr_calls == LAUNCH_PROFILE_CALLS and all(
        r["name"] == "frame_bwd_kernel<true>" for r in fr_prof),
        f"frame_bwd: {fr_calls} launches over {LAUNCH_PROFILE_CALLS} "
        f"calls, profile {fr_prof}")
    res["frame_bwd"] = dict(
        db=fr_db, launches=launched["frame_bwd"],
        profile_whole=[(r["name"], r["launches"]) for r in fr_prof]
        == [("frame_bwd_kernel<true>", 1)],
        max_abs_err=max(max_abs(a, b) for a, b in zip(
            fr_p + fdl_p, fr_k + fdl_k)),
        ms=time_ms(lambda: ff.frame_bwd(*gs, N, cot[1]), 50),
        plain_ms=time_ms(lambda: ff.frame_bwd_plain(*gs, N, cot[1]), 20),
        library_ms=None, launch_profile=fr_prof,
        fdl_ms=time_ms(lambda: ff.frame_bwd(*gs, N), 50),
        fdl_plain_ms=time_ms(lambda: ff.frame_bwd_plain(*gs, N), 20),
        fdl_bound_ms=bound(4 * plane, C * fft_flops(N))["bound_ms"],
        **bound(7 * plane, 2 * C * fft_flops(N)))

    # chain_dyn_bwd on the block's y and state, from the level and
    # envelope of kernel #3's saving form: y against kernel #3, the
    # envelope's adjoint bit for bit against the plain one on the saved
    # values, the whole against the plain backward
    n_sc = chain.sidechain.reactivity
    dargs = (n_sc, chain.sidechain.gain, cp.tau_attack, cp.tau_release,
             cp.release_thresh, cp.hold, cp.knees)
    dcot = [randn(gen, C, n_sc, dev=dev), randn(gen, C, dev=dev),
            randn(gen, C, dev=dev), randn(gen, C, B, dev=dev)]
    k_out = env_ops.chain_dyn_bwd(st.sc.window, st.env, y_lin, *dcot, *dargs,
                                  replay=True)
    level_k, env_k, genv_k, glev_k, y_k = k_out[6:]
    _, _, y_fwd = chain_dyn(st.sc.window, st.env, y_lin, *dargs)
    check(torch.equal(y_k, y_fwd), "chain_dyn_bwd's y is not kernel #3's")
    env_ms, (_, _, _, env_p) = time_once_ms(lambda: eu._envelope_plain(
        level_k, *st.env, cp.tau_attack, cp.tau_release, cp.hold,
        cp.release_thresh))
    check(torch.equal(env_p, env_k), "kernel #3's saved envelope differs "
          "from the plain envelope on its level")
    pe = eu.peak_envelope_bwd_plain(level_k, env_k, *st.env, genv_k, dcot[1],
                                    dcot[2], cp.tau_attack, cp.tau_release,
                                    cp.hold, cp.release_thresh)
    env_same = (torch.equal(pe[0], glev_k) and torch.equal(pe[1], k_out[1])
                and torch.equal(pe[2], k_out[2])
                and torch.equal(pe[3], k_out[4]))
    check(env_same, "chain_dyn_bwd's envelope adjoint differs from "
          "peak_envelope_bwd_plain on the saved values")
    # on the same saved inputs: the plain backward fed the level and
    # envelope the forward kernel computed (its own float32 prefix sums
    # round the level otherwise, which the taus' sums over x - e feel)
    d_ms, d_out = time_once_ms(lambda: env_ops.chain_dyn_bwd_plain(
        st.sc.window, st.env, y_lin, *dcot, *dargs, saved=(level_k, env_k)))
    dyn_names = ("window", "envelope", "peak", "x", "taus", "knees")
    dyn_dbs = dbs_of(dyn_names, d_out, k_out)
    own_dbs = dbs_of(dyn_names, env_ops.chain_dyn_bwd_plain(
        st.sc.window, st.env, y_lin, *dcot, *dargs), k_out)
    check(min(dyn_dbs.values()) >= DYN_BWD_DB,
          f"chain_dyn_bwd {dyn_dbs} < {DYN_BWD_DB}")
    sm_hz = res.get("peak", {}).get("sm_clock_hz", SM_HZ)
    saved = (level_k, env_k)

    def dyn_bwd():
        return env_ops.chain_dyn_bwd(st.sc.window, st.env, y_lin, *dcot,
                                     *dargs, saved=saved)
    check(all(torch.equal(a, b) for a, b in zip(dyn_bwd(), dyn_bwd())),
          "chain_dyn_bwd differs from run to run")
    ms = time_ms(dyn_bwd, 20)
    fwd_args = (st.sc.window, st.env, y_lin, *dargs)
    dyn_fwd_ms = time_ms(lambda: env_ops._chain_dyn(*fwd_args), 20)
    dyn_save_ms = time_ms(lambda: env_ops._chain_dyn(*fwd_args, save=True),
                          20)
    # x, the saved level and envelope, g_y in, g_x out; the window's and
    # the state's cotangents; the knee partials (float64) out
    knee_b = 8 * env_ops.N_KNEE * C
    dyn_b = F32 * (5 * C * B + 2 * C * n_sc + 8 * C) + knee_b
    dyn_bytes = {"chain_dyn_bwd<": dyn_b,
                 "chain_dyn_sums": F32 * (2 * C + 2 + env_ops.N_KNEE)
                 + knee_b}
    profiles["dyn_bwd"] = launch_profile(
        dyn_bwd, C, B, p_n, k2, bytes_of=lambda name: dyn_bytes.get(
            name if name in dyn_bytes else name.split("<")[0] + "<"))
    before = env_ops.chain_dyn_bwd.launches
    dyn_bwd()
    check(env_ops.chain_dyn_bwd.launches - before == 1,
          "grad_ring: a chain_dyn_bwd call from the saved level and "
          "envelope did not count one launch")
    dyn_whole = sorted((x["name"].split("<")[0], x["launches"])
                       for x in profiles["dyn_bwd"]) == [
        ("chain_dyn_bwd", 1), ("chain_dyn_sums", 1)]
    res["dyn_bwd"] = dict(
        db=min(dyn_dbs.values()), dbs=dyn_dbs, own_level_dbs=own_dbs,
        envelope_identical=env_same,
        max_abs_err=max(max_abs(a, b) for a, b in zip(d_out, k_out[:6])),
        ms=ms, plain_ms=d_ms, library_ms=None,
        launches=launched["chain_dyn_bwd"],
        chain_ms=chain_ms(REV_CHAIN_OPS * B),
        cycles_per_sample=ms * 1e-3 * sm_hz / B, fwd_ms=dyn_fwd_ms,
        fwd_save_ms=dyn_save_ms, launch_profile=profiles["dyn_bwd"],
        profile_whole=dyn_whole,
        **bound(dyn_b, 60 * C * B))

    # step_ring per block: forward alone, forward + backward
    xg = [torch.from_numpy(x).to(dev) for x in xs]
    pg, _ = ring_params(params, dev)

    def fwd():
        with torch.no_grad():
            s = chain.init_ring_state(params)
            for x in xg:
                s, _ = chain.step_ring(params, s, x)

    def fwd_bwd():
        s = chain.init_ring_state(pg)
        total = 0.0
        for x in xg:
            s, y = chain.step_ring(pg, s, x.detach().requires_grad_(True))
            total = total + torch.sum(y * y)
        total.backward()

    fwd_ms = time_ms(fwd, 1, warmup=2) / RING_GRAD_BLOCKS
    fwd_bwd_ms = time_ms(fwd_bwd, 1, warmup=2) / RING_GRAD_BLOCKS
    busy, top = device_kernels(fwd_bwd)
    res["grad_ring"] = dict(
        launches=launched, db=dbs, same_branch_channels=len(agree),
        flipped_channels=torch.nonzero(flips)[:, 0].tolist(),
        flipped_samples=int(flips.sum()),
        knee_share=share, tf32_identical=tf32_same, cpu_s=cpu_s,
        fdl_ring_step_db=fdl_db, fwd_ms_per_block=fwd_ms,
        fwd_bwd_ms_per_block=fwd_bwd_ms, fwd_bwd_kernels_ms=busy,
        fwd_bwd_top_kernels=top)
    for key, name in (("eqfdl_bwd", "eqfdl_fused_bwd"),
                      ("fdl_bwd", "fdl_fused_bwd"),
                      ("frame_bwd", "frame_bwd"),
                      ("dyn_bwd", "chain_dyn_bwd")):
        r = res[key]
        print(f"{name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}); vs plain "
              f"{r['db']:.1f} dB" + ("" if key not in profiles else
                                     "; launches of a call (ms a launch, "
                                     "bytes bound): " + "; ".join(
                f"{x['name']} {x['ms']:.4f} x {x['launches']}"
                + ("" if x["bound_ms"] is None
                   else f" ({x['bound_ms']:.4f})")
                for x in profiles[key]))
              + ("" if key != "frame_bwd" else
                 "; the kernel " + (f"{fr_prof[0]['ms']:.4f} ms by the "
                                    "profiler" if fr_prof else
                                    "not in the profile") + "; "
                 f"fdl_fused_bwd's form {r['fdl_ms']:.4f}, plain "
                 f"{r['fdl_plain_ms']:.4f}, bound {r['fdl_bound_ms']:.4f}"))
    print(f"chain_dyn_bwd [{C}, {B}]: {res['dyn_bwd']['cycles_per_sample']:.1f}"
          f" cycles a sample, the reverse pass's chain bound "
          f"{res['dyn_bwd']['chain_ms']:.4f} ms; kernel #3 {dyn_fwd_ms:.4f} "
          f"ms, saving the level and envelope {dyn_save_ms:.4f}; its "
          f"profile {'whole' if dyn_whole else 'NOT whole'} (one launch "
          f"of each kernel a call); y identical to "
          f"kernel #3's, the saved envelope identical to "
          f"the plain one on its level ({env_ms:.0f} ms), its adjoint "
          f"identical to peak_envelope_bwd_plain; dB {dyn_dbs} (the plain "
          f"backward on its own plain level: {own_dbs}); eqfdl_bwd "
          f"{fft_per_call} FFT launches a call; dB {eq_dbs}")
    print(f"grad_ring: step_ring {fwd_ms:.4f} ms a block forward, "
          f"{fwd_bwd_ms:.4f} ms forward + backward (CUDA events behind the "
          f"spin kernel, {RING_GRAD_BLOCKS} blocks); kernels of one forward "
          f"+ backward " + ("not measured" if busy is None else
                           f"{busy:.4f} ms, the most: " + "; ".join(
                               f"{name[:50]} {ms:.4f} ms x {n}"
                               for name, ms, n in top))
          + f"; phase {time.perf_counter() - t_start:.1f} s")


# --- the grad_units phase: gradients through the sequential cascade, the
# Gate and the DynamicDelay ------------------------------------------------

GU_T, GU_CALLS = 16384, 2     # [64, 2 x 16384], the state carried
GU_CPU_T = 1024               # the CPU run: [64, 2 x 1024], the inputs' start
GU_PLAIN_T = 2048             # the plain adjoints' length against the kernels
GU_DB = 100.0                 # the card's gradients vs the port's CPU run
GU_F64_RULE_DB = 1.0          # the loudness: the card within this of the
#                               CPU's distance from its float64 run
GU_HOLDS = (0, 24)            # the Gate's hold times, samples
GU_GATE_KW = dict(threshold=0.2, zone=0.5, hyst_threshold=0.15,
                  attack_ms=2.0, release_ms=20.0)
GU_COUNTERS = (bq.biquad_cascade_seq_bwd, bq.dyn_biquad_cascade_seq_bwd,
               delay_ops.dynamic_delay_bwd, eu.peak_envelope_bwd)


def gu_inputs():
    """The phase's inputs from its seed, [C, 2 T] each: the filters'
    input, the gate's detector level, the DynamicFilters' gain (a swell
    of +-12 dB, per channel), the loss weights."""
    rng = np.random.default_rng(31)
    t_all = GU_T * GU_CALLS
    n = np.arange(t_all)[None]
    swell = np.sin(np.pi * n / t_all)
    gain = 10.0 ** ((-12.0 + 24.0 * swell
                     * rng.uniform(0.5, 1.0, (C, 1))) / 20.0)
    # the gate's level crosses its knees every 4096 samples (the phases
    # spread over the channels), quiet over the last quarter
    beat = np.abs(np.sin(np.pi * (n / 4096.0 + rng.uniform(0, 1, (C, 1)))))
    level = np.abs(rng.standard_normal((C, t_all))) * 0.4 * beat
    level[:, 3 * t_all // 4:] *= 0.02
    return dict(
        x=(rng.standard_normal((C, t_all)) * 0.25).astype(np.float32),
        level=level.astype(np.float32), gain=gain.astype(np.float32),
        w=rng.standard_normal((C, t_all)).astype(np.float32),
        w_loud=rng.standard_normal(t_all).astype(np.float32))


def gu_units(dev, dtype=torch.float32):
    """The phase's units on device ``dev``: name -> (leaves(), step(state,
    x_call, k, t) -> (state, y)), the leaves a list of new tensors that
    require grad: the incoming state's, then the unit's parameters.
    ``dtype`` float64 gives the LoudnessMeter its float64 run (its
    weighting and channel weights in float64)."""
    eq = flt.Equalizer(SR, filters=8, mode=flt.EqMode.IIR, iir_block=None)
    for i, p in enumerate(pipeline.default_eq_params(SR)):
        eq.set_params(i, p)
    eqp = eq.build(device=dev)
    c9 = eqp.coeffs                                  # the chain's K = 9
    fil = flt.Filter(SR, flt.FilterParams(ftype=flt.FilterType.BT_RLC_BELL,
                                          freq=1000.0, gain=2.0))
    dynf = flt.DynamicFilters(SR, 1)
    dynf.set_params(0, flt.FilterParams(ftype=flt.FilterType.BT_BWC_BELL,
                                        freq=1000.0, slope=2, quality=0.7))
    loud = mtr.LoudnessMeter(SR, C, device=dev)
    loud._coeffs, loud.weights = loud._coeffs.to(dtype), loud.weights.to(dtype)
    dd = DynamicDelay(SYN_MAX_DELAY)
    gen = torch.Generator().manual_seed(33)

    def leaf(v):
        return v.detach().to(dev, dtype).clone().requires_grad_(True)

    def rnd(*shape, scale=0.1):
        return (torch.randn(*shape, generator=gen) * scale)

    s9, s4 = rnd(C, c9.shape[0], 2), rnd(C, 4, 2)
    fl0, win0 = rnd(C, 2, 2), rnd(C, loud.period).abs()
    buf0 = rnd(C, SYN_MAX_DELAY + 1, scale=0.25)
    eq_st = eq.init_state(eqp, (C,), device=dev)

    def eq_step(lv, st, x, g, k):
        st, y = eq.process(eqp, eq_st._replace(iir=st), x)
        return st.iir, y

    units = {
        "filter_seq": (lambda: [leaf(s9), leaf(c9)],
                       lambda lv, st, x, g, k: fil.process(
                           st, x, coeffs=lv[1], method="seq")),
        "eq_iir": (lambda: [leaf(s9)], eq_step),
        "dyn_seq": (lambda: [leaf(s4)],
                    lambda lv, st, x, g, k: dynf.process(0, st, x, g,
                                                         method="seq")),
        "loudness": (lambda: [leaf(fl0), leaf(win0)],
                     lambda lv, st, x, g, k: loud.process(st, x)),
        "delay": (lambda: [leaf(buf0), leaf(torch.tensor(0.5))],
                  lambda lv, st, x, g, k: dd.process(st, x, k[0], lv[1],
                                                     k[1])),
    }
    for hold in GU_HOLDS:
        gt = Gate(SR, hold_ms=hold * 1000.0 / SR, **GU_GATE_KW)
        p = gt.build()
        units[f"gate{hold}"] = (
            (lambda p: lambda: [leaf(torch.tensor(p.tau_attack)),
                                leaf(torch.tensor(p.tau_release))])(p),
            (lambda gt, p: lambda lv, st, x, g, k: gt.process(
                p._replace(tau_attack=lv[0], tau_release=lv[1]), st, x)[:2])(
                gt, p))
    return units


def gu_run(name, dev, inp, t, calls, delays=None, dtype=torch.float32):
    """Forward and backward of one unit over ``calls`` calls of [C, t]
    from the start of the phase's inputs, the state carried; the loss
    puts the phase's weights on every output (and on the outgoing state's
    first leaf).  Returns the gradients, on the CPU: the leaves', then x
    (each call's, concatenated) and, for dyn_seq, the gain's."""
    step_leaves, step = gu_units(dev, dtype)[name]
    lv = step_leaves()
    gate = name.startswith("gate")
    src = inp["level"] if gate else inp["x"]
    xs = [torch.from_numpy(src[:, k * t:(k + 1) * t]).to(dev, dtype)
          .requires_grad_(True) for k in range(calls)]
    gs = [torch.from_numpy(inp["gain"][:, k * t:(k + 1) * t]).to(dev, dtype)
          .requires_grad_(True) for k in range(calls)]
    if name == "loudness":
        st = type(mtr.LoudnessMeter(SR, C, device=dev).init_state())(
            flt=lv[0], window=lv[1])
    elif name == "delay":
        st = DynamicDelay(SYN_MAX_DELAY).init_state((C,), device=dev)
        st = st._replace(buffer=lv[0])
    elif gate:
        st = Gate(SR).init_state((C,), device=dev)
    else:
        st = lv[0]
    total = 0.0
    for k in range(calls):
        sl = slice(k * t, (k + 1) * t)
        dk = None if delays is None else (delays[0][:, sl], delays[1][:, sl])
        st, y = step(lv, st, xs[k], gs[k], dk)
        w = inp["w_loud"][sl] if name == "loudness" else inp["w"][:, sl]
        total = total + torch.sum(y * torch.from_numpy(w).to(dev, dtype))
    last = {"loudness": lambda s: s.flt, "delay": lambda s: s.buffer}.get(
        name, lambda s: s.env.envelope if gate else s)(st)
    total = total + torch.sum(last * 0.5)
    total.backward()
    out = [v.grad for v in lv] + [torch.cat([v.grad for v in xs], -1)]
    if name == "dyn_seq":
        out.append(torch.cat([v.grad for v in gs], -1))
    return [v.detach().cpu() for v in out]


def gu_compare(ref, out, gate):
    """min dB over the gradients, the Gate's with equal NaN masks and
    over their finite entries; raises on a NaN mask that differs."""
    dbs = []
    for a, b in zip(ref, out):
        na, nb = torch.isnan(a), torch.isnan(b)
        check(torch.equal(na, nb), "NaN positions differ between the card "
              "and the CPU")
        check(gate or not na.any(), "a NaN gradient")
        if (~na).any() and bool(torch.any(a[~na] != 0)):
            dbs.append(snr_db(a[~na], b[~nb]))
        else:
            check(torch.equal(a[~na], b[~nb]), "a zero gradient moved")
    return min(dbs, default=float("inf"))


def gu_kernel_parity(dev, inp, t):
    """Each backward kernel against its plain adjoint (on the CPU, the same
    inputs) at [C, t], bit for bit: biquad_seq_bwd static (the chain's K =
    9, shared coefficients: their row sums), per sample (K = 4 per row),
    delay_bwd_kernel (the LFO-swept bank), and the Gate's route
    (peak_envelope_bwd without a threshold, on the gate's forward)."""
    gen = torch.Generator().manual_seed(35)
    eq = flt.Equalizer(SR, filters=8, mode=flt.EqMode.IIR, iir_block=None)
    for i, p in enumerate(pipeline.default_eq_params(SR)):
        eq.set_params(i, p)
    c9 = eq.build(device="cpu").coeffs
    x = torch.from_numpy(inp["x"][:, :t])
    g_y = torch.randn(C, t, generator=gen)
    same = {}
    for key, (coeffs, k_n) in {
            "bq_bwd": (c9, c9.shape[0]),
            "bq_bwd_dyn": (dynf._design_per_sample(
                flt.FilterParams(ftype=flt.FilterType.BT_BWC_BELL,
                                 freq=1000.0, slope=2, quality=0.7),
                torch.from_numpy(inp["gain"][:, :t]), SR), 4)}.items():
        dyn_form = key == "bq_bwd_dyn"
        st = torch.randn(C, k_n, 2, generator=gen) * 0.1
        gs = torch.randn(C, k_n, 2, generator=gen)
        y_c, s_c, sig = bq._seq_plain_run(coeffs, st, x, dyn_form, save=True)
        y_d, s_d, sig_d = bq._seq_cuda(coeffs.to(dev), st.to(dev),
                                       x.to(dev), dyn_form, save=True)
        bwd, plain = ((bq.dyn_biquad_cascade_seq_bwd,
                       bq.dyn_biquad_cascade_seq_bwd_plain) if dyn_form else
                      (bq.biquad_cascade_seq_bwd,
                       bq.biquad_cascade_seq_bwd_plain))
        ref = plain(coeffs, st, x, sig, g_y, gs)
        out = bwd(*(v.to(dev) for v in (coeffs, st, x, sig, g_y, gs)))
        torch.cuda.synchronize()
        same[key] = (all(torch.equal(a, b.cpu()) for a, b in zip(ref, out))
                     and torch.equal(sig, sig_d.cpu())
                     and torch.equal(y_c, y_d.cpu())
                     and torch.equal(s_c, s_d.cpu()))
    d = lfo_delays(dev)[:, :t].cpu()
    fd = torch.from_numpy(synth_inputs()[1][:, :t])
    buf = torch.randn(C, SYN_MAX_DELAY + 1, generator=gen) * 0.25
    g = torch.tensor(0.5)
    gb = torch.randn(C, SYN_MAX_DELAY + 1, generator=gen)
    _, _, s = delay_ops._delay_plain(buf, x, d, g, fd, SYN_MAX_DELAY, True)
    ref = delay_ops.dynamic_delay_bwd_plain(buf, x, d, g, fd, s, g_y, gb,
                                            SYN_MAX_DELAY)
    out = delay_ops.dynamic_delay_bwd(*(v.to(dev) for v in (
        buf, x, d, g, fd, s, g_y, gb)), SYN_MAX_DELAY)
    torch.cuda.synchronize()
    same["delay_bwd"] = all(torch.equal(a, b.cpu()) for a, b in zip(ref, out))
    lev = torch.from_numpy(inp["level"][:, :t])
    for hold in GU_HOLDS:
        p = Gate(SR, hold_ms=hold * 1000.0 / SR, **GU_GATE_KW).build()
        e0 = dyn.env_init((C,), "cpu")
        _, _, env, _ = eu.gate_envelope(
            e0, torch.zeros(C, dtype=torch.int32), lev, p.tau_attack,
            p.tau_release, p.hold, p.knees[0].end, p.knees[1].start)
        args = (lev, env, *e0, g_y, torch.randn(C, generator=gen),
                torch.randn(C, generator=gen))
        ref = eu.peak_envelope_bwd_plain(*args, p.tau_attack, p.tau_release,
                                         p.hold, None)
        out = eu.peak_envelope_bwd(*(v.to(dev) for v in args),
                                   p.tau_attack, p.tau_release, p.hold, None)
        torch.cuda.synchronize()
        same[f"gate{hold}"] = all(torch.equal(a, b.cpu())
                                  for a, b in zip(ref, out))
    return same


def gu_timings(dev, inp, clock):
    """Each backward kernel at one call of the phase's [C, 16384] (CUDA
    events behind the spin kernel), its plain adjoint on the card at [C,
    2048] (one call, host-paced), the bytes / operations bound at [C,
    16384] and the chain bound (T x the step's dependent operations x 4
    cycles at the SM clock)."""
    t, tp = GU_T, GU_PLAIN_T
    gen = torch.Generator().manual_seed(37)
    eq = flt.Equalizer(SR, filters=8, mode=flt.EqMode.IIR, iir_block=None)
    for i, p in enumerate(pipeline.default_eq_params(SR)):
        eq.set_params(i, p)
    c9 = eq.build(device=dev).coeffs
    x = torch.from_numpy(inp["x"][:, :t]).to(dev)
    g_y = torch.randn(C, t, generator=gen).to(dev)
    c4 = dynf._design_per_sample(
        flt.FilterParams(ftype=flt.FilterType.BT_BWC_BELL, freq=1000.0,
                         slope=2, quality=0.7),
        torch.from_numpy(inp["gain"][:, :t]).to(dev), SR)
    bq_ops = bq.seq_bwd_chain_ops()
    out = {}
    for key, (coeffs, dyn_form) in {"bq_bwd": (c9, False),
                                    "bq_bwd_dyn": (c4, True)}.items():
        k_n = coeffs.shape[-2]
        st = torch.zeros(C, k_n, 2, device=dev)
        gs = torch.randn(C, k_n, 2, generator=gen).to(dev)
        _, _, sig = bq._seq_cuda(coeffs, st, x, dyn_form, save=True)
        bwd, plain = ((bq.dyn_biquad_cascade_seq_bwd,
                       bq.dyn_biquad_cascade_seq_bwd_plain) if dyn_form else
                      (bq.biquad_cascade_seq_bwd,
                       bq.biquad_cascade_seq_bwd_plain))
        ms = time_ms(lambda: bwd(coeffs, st, x, sig, g_y, gs), 5)
        plain_ms, _ = time_once_ms(lambda: plain(
            coeffs[:, :tp] if dyn_form else coeffs, st, x[:, :tp],
            sig[:, :, :tp].contiguous(), g_y[:, :tp], gs))
        # bytes: the K + 1 signals, g_y and (per sample) the coefficients
        # in, g_x and (per sample) the coefficients' terms out;
        # operations: 4 FMA, 6 products and 5 sums a stage and sample
        floats = (k_n + 3) * C * t + (2 * C * t * k_n * 5 if dyn_form else 0)
        out[key] = dict(ms=ms, plain_ms=plain_ms, plain_t=tp,
                        library_ms=None,
                        **bound(F32 * floats, 19.0 * C * t * k_n),
                        chain_ms=t * bq_ops * 4 / clock * 1e3,
                        chain_ops=bq_ops,
                        cycles_per_step=ms * 1e-3 * clock / t,
                        sm_clock_hz=clock, k=k_n)
    d = lfo_delays(dev)[:, :t]
    fd = torch.from_numpy(synth_inputs()[1][:, :t]).to(dev)
    buf = torch.zeros(C, SYN_MAX_DELAY + 1, device=dev)
    g = torch.tensor(0.5, device=dev)
    gb = torch.randn(C, SYN_MAX_DELAY + 1, generator=gen).to(dev)
    _, _, s = delay_ops._delay_cuda(buf, x, d, g, fd, SYN_MAX_DELAY, True)
    ms = time_ms(lambda: delay_ops.dynamic_delay_bwd(
        buf, x, d, g, fd, s, g_y, gb, SYN_MAX_DELAY), 5)
    plain_ms, _ = time_once_ms(lambda: delay_ops.dynamic_delay_bwd_plain(
        buf, x[:, :tp], d[:, :tp], g, fd[:, :tp], s[:, :tp].contiguous(),
        g_y[:, :tp], gb, SYN_MAX_DELAY))
    d_ops = delay_ops.bwd_chain_ops()
    out["delay_bwd"] = dict(
        ms=ms, plain_ms=plain_ms, plain_t=tp, library_ms=None,
        **bound(F32 * (6 * C * t + 2 * C * (SYN_MAX_DELAY + 1)), 0.0),
        chain_ms=t * d_ops * 4 / clock * 1e3, chain_ops=d_ops,
        cycles_per_step=ms * 1e-3 * clock / t, sm_clock_hz=clock)
    lev = torch.from_numpy(inp["level"][:, :t]).to(dev)
    for hold in GU_HOLDS:
        p = Gate(SR, hold_ms=hold * 1000.0 / SR, **GU_GATE_KW).build()
        e0 = dyn.env_init((C,), dev)
        _, _, env, _ = eu.gate_envelope(
            e0, torch.zeros(C, dtype=torch.int32, device=dev), lev,
            p.tau_attack, p.tau_release, p.hold, p.knees[0].end,
            p.knees[1].start)
        z = torch.zeros(C, device=dev)
        args = (lev, env, *e0, g_y, z, z)
        ms = time_ms(lambda: eu.peak_envelope_bwd(
            *args, p.tau_attack, p.tau_release, p.hold, None), 5)
        plain_ms, _ = time_once_ms(lambda: eu.peak_envelope_bwd_plain(
            lev[:, :tp], env[:, :tp], *e0, g_y[:, :tp], z, z, p.tau_attack,
            p.tau_release, p.hold, None))
        out[f"gate{hold}"] = dict(
            ms=ms, plain_ms=plain_ms, plain_t=tp, library_ms=None,
            **bound(F32 * 4 * C * t, 4.0 * C * t),
            chain_ms=t * REV_CHAIN_OPS * 4 / clock * 1e3,
            cycles_per_step=ms * 1e-3 * clock / t, sm_clock_hz=clock)
    return out


def grad_units_phase(dev, res):
    """Gradients through the routes on the sequential cascade, the Gate
    and the DynamicDelay, which jax.grad differentiates in the JAX
    package: Filter seq (K = 9, the coefficients too), the IIR
    Equalizer, DynamicFilters seq (K = 4 per sample, the gain too), the
    LoudnessMeter, the Gate at a hold of 0 and of 24 (the taus too) and
    the synth phase's LFO-swept DynamicDelay (the buffer and the gain
    too), at [64, 2 x 16384] with the state carried; the backward
    counters zeroed just before and read just after.  The card against
    the port's CPU run at [64, 2 x 1024], each kernel against its plain
    adjoint, TF32, timings."""
    t_start = time.perf_counter()
    inp = gu_inputs()
    names = list(gu_units("cpu"))
    dl = lfo_delays(dev)
    fd = torch.from_numpy(synth_inputs()[1]).to(dev)
    delays = {"delay": (dl, fd)}
    torch.cuda.synchronize()
    for f in GU_COUNTERS:
        f.launches = 0
        if hasattr(f, "sum_launches"):
            f.sum_launches = 0
    t0 = time.perf_counter()
    full = {n: gu_run(n, dev, inp, GU_T, GU_CALLS, delays.get(n))
            for n in names}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {f.__name__: f.launches for f in GU_COUNTERS}
    sums = {f.__name__: f.sum_launches for f in GU_COUNTERS[:2]}
    print(f"grad_units: {len(names)} units x {GU_CALLS} calls of [{C}, "
          f"{GU_T}] forward and backward in {wall:.2f} s (host clock); "
          f"backward launches {launched}, row sums {sums}")
    # filter_seq and eq_iir and the loudness: 3 units x 2 calls of K <= 32
    check(launched["biquad_cascade_seq_bwd"] == 3 * GU_CALLS,
          f"biquad_seq_bwd launched {launched['biquad_cascade_seq_bwd']}")
    check(sums["biquad_cascade_seq_bwd"] == GU_CALLS,
          "the row sums of the shared coefficients")
    check(launched["dyn_biquad_cascade_seq_bwd"] == GU_CALLS,
          "biquad_seq_bwd (per sample) launches")
    check(launched["dynamic_delay_bwd"] == GU_CALLS, "delay_bwd launches")
    check(launched["peak_envelope_bwd"] == len(GU_HOLDS) * GU_CALLS,
          "the Gate's backward launches")
    for n, gs in full.items():
        check(gs[-2 if n == "dyn_seq" else -1].shape == (C, GU_T * GU_CALLS),
              f"{n}: x's gradient shape")
        for g in gs:
            check(bool(torch.isfinite(g).all()) or n.startswith("gate"),
                  f"{n}: a gradient not finite")
    # the card against the port's CPU run, at [64, 2 x 1024]
    cpu_delays = {"delay": (dl.cpu(), fd.cpu())}
    dbs, loud_f64 = {}, {}
    for n in names:
        ref = gu_run(n, "cpu", inp, GU_CPU_T, GU_CALLS, cpu_delays.get(n))
        out = gu_run(n, dev, inp, GU_CPU_T, GU_CALLS, delays.get(n))
        dbs[n] = gu_compare(ref, out, n.startswith("gate"))
        if n != "loudness":
            check(dbs[n] >= GU_DB, f"grad_units {n}: {dbs[n]:.2f} dB card "
                  f"vs CPU")
            continue
        # the meter's sliding sums (cumsum differences, as the JAX
        # package's) leave its float32 gradient tens of dB from float64
        # on either device: both held to the CPU's float64 run instead
        f64 = gu_run(n, "cpu", inp, GU_CPU_T, GU_CALLS,
                     dtype=torch.float64)
        for i, (a, b, r) in enumerate(zip(ref, out, f64)):
            loud_f64[i] = (snr_db(r, a), snr_db(r, b))
            check(loud_f64[i][1] >= loud_f64[i][0] - GU_F64_RULE_DB,
                  f"grad_units loudness, gradient {i}: the card "
                  f"{loud_f64[i][1]:.2f} dB from float64, the CPU "
                  f"{loud_f64[i][0]:.2f}")
    print(f"grad_units loudness against its float64 CPU run (dB; the CPU's "
          f"float32, the card's), per gradient (flt, window, x): {loud_f64}")
    print(f"grad_units, card vs the CPU run at [{C}, {GU_CALLS} x "
          f"{GU_CPU_T}] (dB, the worst gradient): " + ", ".join(
              f"{k} {v:.2f}" for k, v in dbs.items()))
    # TF32 on: no library matmul on these routes
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = gu_run("filter_seq", dev, inp, GU_CPU_T, GU_CALLS)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    base = gu_run("filter_seq", dev, inp, GU_CPU_T, GU_CALLS)
    same_tf32 = all(torch.equal(a, b) for a, b in zip(base, tf32))
    check(same_tf32, "grad_units: gradients changed with TF32 on")
    same = gu_kernel_parity(dev, inp, GU_PLAIN_T)
    print(f"grad_units: each backward kernel against its plain adjoint at "
          f"[{C}, {GU_PLAIN_T}], identical: {same}; TF32 on identical: "
          f"{same_tf32}")
    check(all(same.values()), f"a backward kernel differs from its plain "
          f"adjoint: {same}")
    clock = sm_clock_hz()
    tim = gu_timings(dev, inp, clock)
    card = card_line()
    for key, r in tim.items():
        print(f"grad_units {key}: [{C}, {GU_T}] {r['ms']:.4f} ms "
              f"({r['cycles_per_step']:.1f} cycles a step), plain "
              f"{r['plain_ms']:.1f} ms at [{C}, {r['plain_t']}] (one call, "
              f"host-paced), bound {r['bound_ms']:.4f} ms ({r['bound_by']}),"
              f" chain bound {r['chain_ms']:.4f} ms ({card})")
    res["bq_bwd"] = dict(tim["bq_bwd"], launches=launched[
        "biquad_cascade_seq_bwd"], max_abs_err=0.0, db_vs_cpu=dbs,
        loudness_vs_f64=loud_f64)
    res["bq_bwd_dyn"] = dict(tim["bq_bwd_dyn"], launches=launched[
        "dyn_biquad_cascade_seq_bwd"], max_abs_err=0.0)
    res["delay_bwd"] = dict(tim["delay_bwd"], launches=launched[
        "dynamic_delay_bwd"], max_abs_err=0.0)
    g24 = tim["gate24"]
    res["gate_bwd"] = dict(tim["gate0"], launches=launched[
        "peak_envelope_bwd"], max_abs_err=0.0, hold24_ms=g24["ms"],
        hold24_cycles_per_step=g24["cycles_per_step"],
        hold24_plain_ms=g24["plain_ms"])
    print(f"grad_units phase: {time.perf_counter() - t_start:.1f} s")


# --- the demo and the tour: the port's user-facing entry points ------------

DEMO_S, DEMO_CHAIN_S = 10, 4  # the demo's WAVs: 10 s stereo, 4 s of C ch
DEMO_DB = 95.0        # filter (the scan's bar) and chain (the FFT's)
LUFS_DB = 0.01        # the integrated loudness, card vs CPU
# the kernels each demo mode must launch on the card (tools/demo.py)
DEMO_KERNELS = {
    "filter": (bq.biquad_cascade,),
    "chain": (fp.rfft_packed_zeropad, fp.rfft_packed, fp.irfft_packed,
              eu.sliding_rms, eu.peak_envelope),
    "loudness": (bq.biquad_cascade_seq,),
    "sampler": (), "stretch": ()}
# every launch counter the tour could advance: (name, wrapper, attribute)
TOUR_COUNTERS = (
    ("#1 rfft_packed", fp.rfft_packed, "launches"),
    ("#1 rfft_packed_zeropad", fp.rfft_packed_zeropad, "launches"),
    ("#1 irfft_packed", fp.irfft_packed, "launches"),
    ("#2 eqfdl_fused", eqfdl_fused, "launches"),
    ("#3 chain_dyn", chain_dyn, "launches"),
    ("#4 fdl_fused", fdl_fused, "launches"),
    ("#5 sliding_rms", eu.sliding_rms, "launches"),
    ("#6 peak_envelope", eu.peak_envelope, "launches"),
    ("#7 gate_envelope", eu.gate_envelope, "launches"),
    ("#8 batched_slice", slicedma.batched_slice, "launches"),
    ("#9 ring_mac", ring_mac, "launches"),
    ("biquad_scan", bq.biquad_cascade, "launches"),
    ("biquad_seq", bq.biquad_cascade_seq, "launches"),
    ("biquad_seq dyn", bq.dyn_biquad_cascade_seq, "launches"),
    ("limiter_kernel", lim_ops.limiter, "launches"),
    ("delay_kernel", delay_ops.dynamic_delay, "launches"),
    ("TriggerStep", riders.trigger, "launches"),
    ("DepopperStep", riders.depopper_forward, "launches"),
    ("#1 rfft_packed bwd", fp.rfft_packed, "bwd_launches"),
    ("#1 rfft_packed_zeropad bwd", fp.rfft_packed_zeropad, "bwd_launches"),
    ("#1 irfft_packed bwd", fp.irfft_packed, "bwd_launches"),
    ("sliding_rms_bwd", eu.sliding_rms_bwd, "launches"),
    ("peak_envelope_bwd", eu.peak_envelope_bwd, "launches"),
    ("biquad_scan bwd", bq.biquad_cascade, "bwd_launches"))
# what the tour's units route to on the card: each must advance (#1 as
# the sum of its three wrappers)
TOUR_EXPECTED = ("#5 sliding_rms", "#6 peak_envelope", "#8 batched_slice",
                 "biquad_scan", "biquad_seq", "limiter_kernel",
                 "delay_kernel", "TriggerStep", "sliding_rms_bwd",
                 "peak_envelope_bwd", "biquad_scan bwd")


def demo_wavs(folder: str) -> dict:
    """The demo's inputs, from fixed seeds: 10 s of stereo at 48 kHz
    (three tones and noise, peaks at -12 dBFS) and, for ``chain``, 4 s
    of C channels (the bench's channel count) of tones and noise."""
    from lsp_dsp_units_tpu_torch.utils.wavio import write_wav

    def program(seed, c, secs):
        rng = np.random.default_rng(seed)
        t = np.arange(secs * SR) / SR
        f = rng.uniform(60.0, 8000.0, (c, 3))
        x = sum(np.sin(2 * np.pi * f[:, k:k + 1] * t) for k in range(3))
        x = x + 0.5 * rng.standard_normal(x.shape)
        return (x * 10 ** (-12 / 20) / np.abs(x).max()).astype(np.float32)

    paths = dict(stereo=os.path.join(folder, "stereo.wav"),
                 wide=os.path.join(folder, "wide.wav"))
    write_wav(paths["stereo"], program(31, 2, DEMO_S), SR)
    write_wav(paths["wide"], program(32, C, DEMO_CHAIN_S), SR)
    return paths


def run_demo(argv) -> tuple:
    """``tools/demo.main(argv)``: (its stdout, its seconds; the demo
    reads its output back to the host before it returns)."""
    import io
    from lsp_dsp_units_tpu_torch.tools import demo
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        demo.main(argv)
    return out.getvalue(), time.perf_counter() - t0


def demo_reference(src: str, dst: str, mode: str) -> tuple:
    """One mode's CPU run (``--cpu``) in a worker process."""
    return run_demo([src, dst, mode, "--cpu"])


def demo_phase(dev, res):
    """Every mode of ``tools/demo.py`` through its ``main``, on the card
    (its default) and with ``--cpu``: the outputs card vs CPU at the
    modes' bars, and the kernels each mode must launch on the card (the
    counters zeroed just before each card run).  The card runs go first,
    on a quiet host (a demo run on the card is paced by the host), then
    the CPU runs in 3 spawned workers."""
    import tempfile
    from lsp_dsp_units_tpu_torch.tools import demo
    from lsp_dsp_units_tpu_torch.utils.wavio import read_wav
    t_start = time.perf_counter()
    r = res["demo"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        wavs = demo_wavs(tmp)
        srcs = {m: wavs["wide" if m == "chain" else "stereo"]
                for m in demo.MODES}
        outs = {m: {k: os.path.join(tmp, f"{m}_{k}.wav")
                    for k in ("card", "cpu")} for m in demo.MODES}
        card = {}
        for mode in demo.MODES:
            torch.cuda.synchronize()
            for f in DEMO_KERNELS[mode]:
                f.launches = 0
            text, card_s = run_demo([srcs[mode], outs[mode]["card"], mode])
            card[mode] = (text, card_s, {f.__name__: f.launches
                                         for f in DEMO_KERNELS[mode]})
        # the longest CPU runs first
        order = sorted(demo.MODES, key=("chain", "loudness").__contains__,
                       reverse=True)
        with concurrent.futures.ProcessPoolExecutor(
                3, mp_context=multiprocessing.get_context("spawn")) as pool:
            refs = {m: pool.submit(demo_reference, srcs[m],
                                   outs[m]["cpu"], m) for m in order}
            cpu = {m: refs[m].result() for m in demo.MODES}
        for mode in demo.MODES:
            text, card_s, launched = card[mode]
            cpu_text, cpu_s = cpu[mode]
            outs_m = outs[mode]
            (yc, _), (yh, _) = (read_wav(outs_m["card"]),
                                read_wav(outs_m["cpu"]))
            check(yc.shape == yh.shape and bool(np.isfinite(yc).all()),
                  f"demo {mode}: card output {yc.shape}, CPU {yh.shape}")
            for name, n in launched.items():
                check(n > 0, f"demo {mode}: {name} not launched on the card")
            m = r[mode] = dict(card_s=card_s, cpu_s=cpu_s,
                               launches=launched, shape=list(yc.shape))
            if mode in ("filter", "chain"):
                m["db"] = snr_db(torch.from_numpy(yh), torch.from_numpy(yc))
                check(m["db"] >= DEMO_DB, f"demo {mode}: card {m['db']:.2f}"
                      f" dB from the CPU < {DEMO_DB}")
                what = f"{m['db']:.2f} dB from the CPU"
            elif mode == "loudness":
                lufs = [float(re.search(r"integrated loudness: (\S+) LUFS",
                                        t).group(1)) for t in (text,
                                                               cpu_text)]
                m.update(lufs_card=lufs[0], lufs_cpu=lufs[1])
                check(abs(lufs[0] - lufs[1]) <= LUFS_DB,
                      f"demo loudness: {lufs[0]} LUFS on the card, "
                      f"{lufs[1]} on the CPU")
                what = f"{lufs[0]:.4f} LUFS, CPU {lufs[1]:.4f}"
            else:
                m["identical"] = bool(np.array_equal(yc, yh))
                check(m["identical"], f"demo {mode}: card run differs from "
                      f"the CPU run")
                what = "identical to the CPU run"
            print(f"demo {mode}: {yc.shape[0]} x {yc.shape[1]}, {what}; "
                  f"card {card_s:.2f} s, CPU {cpu_s:.2f} s; launches "
                  f"{launched}")
    r["seconds"] = time.perf_counter() - t_start
    print(f"demo: phase {r['seconds']:.1f} s")


def tour_phase(dev, res):
    """Every block of the port's API tour on the card (tools/tour.run),
    the launch counters zeroed just before and read just after: each
    kernel the tour's units route to on the card must have advanced."""
    from lsp_dsp_units_tpu_torch.tools import tour
    t_start = time.perf_counter()
    torch.cuda.synchronize()
    for _, f, attr in TOUR_COUNTERS:
        setattr(f, attr, 0)
    ns = tour.run(dev)
    torch.cuda.synchronize()
    launched = {name: getattr(f, attr) for name, f, attr in TOUR_COUNTERS}
    check(ns["device"] == dev and ns["wet"].device.type == "cuda",
          f"tour: ran on {ns['device']}")
    fft = sum(launched[k] for k in launched
              if k.startswith("#1") and not k.endswith("bwd"))
    check(fft > 0, "tour: kernel #1 not launched")
    for name in TOUR_EXPECTED:
        check(launched[name] > 0, f"tour: {name} not launched")
    seconds = time.perf_counter() - t_start
    res["tour"] = dict(blocks=len(tour.blocks()), launches=launched,
                       seconds=seconds)
    print(f"tour: {len(tour.blocks())} blocks on the card in "
          f"{seconds:.1f} s; kernels launched: "
          + ", ".join(f"{k} {v}" for k, v in launched.items() if v)
          + "; not launched: "
          + ", ".join(k for k, v in launched.items() if not v))


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
    warm_cpu_pool()
    res = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    sources = ("fft_packed", "fdl_fused", "env", "env_units", "ring_mac",
               "slicedma", "biquad", "limiter", "riders", "biquad_scan",
               "delay", "biquad_bwd")
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
    filters_phase(dev, res)
    dynamics_phase(dev, res)
    spectral_phase(dev, res)
    spectral_timings(dev, res)
    synth_phase(dev, res)
    parallel_phase(chain, params, dev, res)
    threed_phase(dev, res)
    serve_phase(dev, res)
    grad_phase(chain, params, dev, res)
    grad_ring_phase(chain, params, dev, res)
    grad_units_phase(dev, res)
    demo_phase(dev, res)
    tour_phase(dev, res)
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
            replaces=f"lsp_dsp_units_tpu/{replaces}",
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
