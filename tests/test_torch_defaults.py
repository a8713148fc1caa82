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
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import Compressor
from lsp_dsp_units_tpu_torch.models.dynamics.expander import Expander
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate
from lsp_dsp_units_tpu_torch.models.sampling import device_mix
from lsp_dsp_units_tpu_torch.models.util.convolver import Convolver
from lsp_dsp_units_tpu_torch.models.util.sidechain import Sidechain
from lsp_dsp_units_tpu_torch.ops import biquad_block, dynamics, fftconv
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
    convert.state_from_jax, convert.bulk_state_from_jax,
    convert.ring_from_natural, convert.ring_fdl_from_jax,
    convert.ring_state_from_jax, convert.voices_from_jax,
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
