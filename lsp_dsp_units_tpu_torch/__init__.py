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
device mixdown ``device_mix``), ``ops.resample`` and ``utils.wavio``.
Entry points allocate on the card (``device="cuda"``) unless the caller
passes another device.
"""

__version__ = "0.1.0"
