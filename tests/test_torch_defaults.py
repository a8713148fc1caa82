"""The port's entry points run on the card unless the caller asks for the
CPU: every public constructor, ``init_*`` and ``convert`` helper that
allocates defaults to ``device="cuda"`` (read from the signature, so nothing is allocated and
no card is needed).  And the same call gives the same ring layout in
both packages: ``init_ring_fdl`` defaults to the natural order, as the
JAX package's does."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu.ops import fftconv as jfc

from lsp_dsp_units_tpu_torch import convert, pipeline
from lsp_dsp_units_tpu_torch.models.dynamics import (
    AutoGain, DynamicProcessor, Limiter, SimpleAutoGain, SurgeProtector)
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import Compressor
from lsp_dsp_units_tpu_torch.models.dynamics.expander import Expander
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate
from lsp_dsp_units_tpu_torch.models.filters import (
    ButterworthFilter, DynamicFilters, Equalizer, Filter, FilterBank,
    SpectralTilt)
from lsp_dsp_units_tpu_torch.models.meters import (
    Correlometer, ILUFSMeter, LoudnessMeter, Panometer, PeakMeter,
    TruePeakMeter)
from lsp_dsp_units_tpu_torch.models.sampling import device_mix
from lsp_dsp_units_tpu_torch.models.util.convolver import Convolver
from lsp_dsp_units_tpu_torch.models.util.crossover import Crossover
from lsp_dsp_units_tpu_torch.models.util import (
    Analyzer, FFTCrossover, LatencyDetector, MultiSpectralProcessor,
    Oversampler, SpectralProcessor, SpectralSplitter, SyncChirpProcessor)
from lsp_dsp_units_tpu_torch.models.util.sidechain import Sidechain
from lsp_dsp_units_tpu_torch.models.util import (
    Delay, Depopper, DynamicDelay, Oscillator, Trigger)
from lsp_dsp_units_tpu_torch.models.noise import NoiseGenerator, lcg_device
from lsp_dsp_units_tpu_torch.entry import dryrun_multichip
from lsp_dsp_units_tpu_torch.parallel.launch import spawn
from lsp_dsp_units_tpu_torch.models.ctl import Bypass, Crossfade
from lsp_dsp_units_tpu_torch.models.stat import QuantizedCounter
from lsp_dsp_units_tpu_torch.models.threed import RayTrace3D
from lsp_dsp_units_tpu_torch.tools import room_demo, serve
from lsp_dsp_units_tpu_torch.ops import biquad, biquad_block, cplx, dynamics
from lsp_dsp_units_tpu_torch.ops import fftconv
from lsp_dsp_units_tpu_torch.ops import resample
from lsp_dsp_units_tpu_torch.utils import blocks, delivery

ALLOCATING = [
    pipeline.FilterConvChain.__init__, Sidechain.init_state,
    Compressor.init_state, Expander.init_state, Gate.init_state,
    fftconv.init_fdl, fftconv.init_ring_fdl, fftconv.init_ols_bulk,
    Convolver.__init__, device_mix.build_bank, device_mix.build_bank_padded,
    device_mix.build_voices, device_mix.voices_from_host,
    biquad_block.init_state, biquad_block.precompute_fused,
    dynamics.env_init, delivery.tpdf_i16_table, blocks.BlockStream.__init__,
    resample.upsample_history, convert.params_from_jax,
    convert.compressor_params_from_jax,
    convert.state_from_jax, convert.bulk_state_from_jax,
    convert.ring_from_natural, convert.ring_fdl_from_jax,
    convert.ring_state_from_jax, convert.voices_from_jax,
    biquad.init_state, Filter.coefficients, Filter.init_state,
    Filter.impulse_response, FilterBank.coefficients, FilterBank.init_state,
    FilterBank.impulse_response, ButterworthFilter.__init__,
    ButterworthFilter.init_state, SpectralTilt.coefficients,
    SpectralTilt.init_state, Equalizer.build, Equalizer.init_state,
    DynamicFilters.init_state, Crossover.__init__, Crossover.init_state,
    convert.biquad_state_from_jax, convert.eq_params_from_jax,
    convert.eq_state_from_jax,
    Limiter.build, Limiter.init_state, AutoGain.init_state,
    SimpleAutoGain.init_state, SurgeProtector.init_state,
    DynamicProcessor.build, DynamicProcessor.init_state,
    PeakMeter.init_state, Panometer.init_state, Correlometer.init_state,
    TruePeakMeter.init_state, LoudnessMeter.__init__, ILUFSMeter.__init__,
    convert.env_state_from_jax, convert.limiter_params_from_jax,
    convert.limiter_state_from_jax, convert.dynproc_params_from_jax,
    convert.autogain_state_from_jax, convert.simple_autogain_state_from_jax,
    convert.surge_state_from_jax, convert.peak_meter_state_from_jax,
    convert.loudness_state_from_jax, convert.ilufs_state_from_jax,
    convert.true_peak_state_from_jax, convert.correlometer_state_from_jax,
    convert.panometer_state_from_jax,
    SpectralProcessor.__init__, SpectralProcessor.init_state,
    MultiSpectralProcessor.__init__, MultiSpectralProcessor.init_state,
    SpectralSplitter.__init__, SpectralSplitter.init_state,
    FFTCrossover.__init__, FFTCrossover.init_state, Analyzer.__init__,
    Analyzer.init_state, Oversampler.__init__, Oversampler.init_state,
    LatencyDetector.__init__, SyncChirpProcessor.__init__,
    SyncChirpProcessor.load_profile, convert.spectral_state_from_jax,
    convert.splitter_state_from_jax, convert.analyzer_state_from_jax,
    convert.oversampler_state_from_jax,
    Oscillator.__init__, NoiseGenerator.__init__, lcg_device,
    Delay.init_state, DynamicDelay.init_state, Trigger.init_state,
    Depopper.init_state, convert.delay_state_from_jax,
    convert.dynamic_delay_state_from_jax, convert.trigger_state_from_jax,
    convert.depopper_state_from_jax, convert.oscillator_state_from_jax,
    Bypass.init_state, Crossfade.init_state, QuantizedCounter.init_state,
    cplx.sc_zeros, convert.bypass_state_from_jax,
    convert.crossfade_state_from_jax,
    convert.quantized_counter_state_from_jax, dryrun_multichip, spawn,
    RayTrace3D.__init__, serve.run, room_demo.room_tracer,
]


@pytest.mark.parametrize("fn", ALLOCATING, ids=lambda f: f.__qualname__)
def test_default_device_is_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_init_ring_fdl_layout_matches_jax(packed, batch):
    block = 1024
    ir = np.random.default_rng(1).standard_normal(2500).astype(np.float32)
    jh = jfc.parse_ir(jnp.asarray(ir), block)
    th = fftconv.parse_ir(torch.from_numpy(ir), block)
    if packed:
        j = jfc.init_ring_fdl(jh, batch, packed=True)
        t = fftconv.init_ring_fdl(th, batch, packed=True, device="cpu")
    else:
        j = jfc.init_ring_fdl(jh, batch)
        t = fftconv.init_ring_fdl(th, batch, device="cpu")
    assert tuple(t.spec_re.shape) == j.spec_re.shape
    assert tuple(t.spec_im.shape) == j.spec_im.shape
    assert tuple(t.history.shape) == j.history.shape
    assert t.pos == int(j.pos)
