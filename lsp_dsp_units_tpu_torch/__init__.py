"""lsp_dsp_units_tpu_torch: the PyTorch/CUDA port of the JAX package
beside it in this repository.

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``utils/``, ``pipeline.py``) so each module's counterpart has the same
name.  Plain tensor code is PyTorch; each Pallas kernel of the JAX
package on the ported path is a CUDA kernel written for Hopper under
``csrc/``, built with ``nvcc`` at first use (ops/_build.py) and launched
only for CUDA tensors; CPU tensors take each kernel's plain PyTorch
version.  The package imports neither JAX nor the JAX package.

Every TPU kernel of the JAX package has its CUDA counterpart here.
Ported so far: the chain ``pipeline.FilterConvChain`` (EQ -> convolver
-> RMS sidechain -> compressor) as ``step_ring`` with its int16 delivery
(``utils.delivery``), ``step`` and ``bulk_step``; ``entry.entry``; the
dynamics units Sidechain, Compressor, Expander and Gate; the standalone
convolver (``models.util.convolver``, ``ops.fftconv.fdl_ring_step`` on a
natural or packed ring, ``utils.blocks``); the sampler
(``models.sampling``: Sample, SamplePlayer, InSampleStream and the
device mixdown ``device_mix``), ``ops.resample`` and ``utils.wavio``;
the biquad cascades ``ops.biquad`` (time-parallel scan, and the
sequential cascade on the CUDA kernel ``csrc/biquad.cu``) with the
filter units on them (``models.filters``: Filter, FilterBank,
ButterworthFilter, SpectralTilt, Equalizer in its IIR/FIR/FFT/SPM modes,
DynamicFilters; ``models.misc.windows``) and the IIR ``Crossover``
(``models.util.crossover``); the Limiter (CUDA kernel
``csrc/limiter.cu``), AutoGain, SimpleAutoGain, SurgeProtector and
DynamicProcessor (their chains on ``csrc/riders.cu``) in
``models.dynamics``; the meters (``models.meters``: LoudnessMeter,
ILUFSMeter, TruePeakMeter, PeakMeter, Correlometer, Panometer); the
spectral units (``models.util``: SpectralProcessor,
MultiSpectralProcessor, SpectralSplitter, FFTCrossover, Analyzer), the
Oversampler (its anti-alias cascade on the CUDA kernel
``csrc/biquad_scan.cu``) and the measurement units (LatencyDetector,
ResponseTaker, SyncChirpProcessor); and the generators and utility
machines: the Randomizer, the noise cores and NoiseGenerator
(``models.noise``: MLS, LCG, Velvet), Dither, the buffers (RingBuffer,
ShiftBuffer, RawRingBuffer, MeterGraph, ScaledMeterGraph), ADSREnvelope,
the Oscillator, the delay lines (Delay; DynamicDelay on the CUDA kernel
``csrc/delay.cu``), the Trigger and the Depopper (their machines on
``csrc/riders.cu``), and ``models.misc``'s quickmath, LFO and sigmoid
functions; the sharded chain (``parallel/``: the ('chan', 'time') mesh
on ``torch.distributed``, halo exchange, the time-sharded IIR cascades
and the global meters; ``FilterConvChain.sharded_step``,
``entry.dryrun_multichip``, ``tools/multihost_demo.py``), the control
units (``models.ctl``: Bypass, Crossfade, Counter, Toggle, Blink), the
QuantizedCounter (``models.stat``), state checkpoints
(``utils.state``, whose paths are the JAX package's) and
``utils.profiling``; the room acoustics (``models.threed``: scenes and OBJ
loading, the twelve source shapes, the capture rigs, the BSP painter tree
and ``RayTrace3D``, whose bounces run on the card) and the host runtime
(``shared``: AudioStream, Catalog and StreamEngine over the repository's
C++ shared-memory runtime, built with g++ at first use), with the
streaming server ``tools.serve`` and ``tools.room_demo``.  Entry points allocate on the card
(``device="cuda"``) unless the caller passes another device.
"""

import torch as _torch

__version__ = "0.1.0"


def _warm_cpu_math() -> None:
    """One call of each vectorised transcendental the port uses, in
    float32 and float64, on a tensor small enough to run on the calling
    thread alone, before any call large enough to be split across
    PyTorch's intra-op thread pool.  Without it the first split call of a
    process can round one thread's whole share off (~1e-5 to 1.5e-4
    relative; ``tools/cpu_probe.py`` found it in fresh processes of the
    Oversampler's tanh, the oscillator's sin and ``step``),
    so that a CPU run would not repeat from one process to the next."""
    for dtype in (_torch.float32, _torch.float64):
        v = _torch.linspace(0.1, 0.9, 64, dtype=dtype)
        for fn in (_torch.exp, _torch.log, _torch.log10, _torch.sin,
                   _torch.cos, _torch.tanh, _torch.atan, _torch.sqrt):
            fn(v)


_warm_cpu_math()
