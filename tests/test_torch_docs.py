"""Execute every python code block of the port's API tour
(lsp_dsp_units_tpu_torch/docs/API_TOUR.md) on the CPU, in one namespace
and in document order, as tests/test_docs.py runs the JAX package's: the
port's docs are part of the test suite and cannot rot."""

import torch

from lsp_dsp_units_tpu_torch.tools import tour


def test_torch_api_tour_snippets_run():
    """All 21 blocks, the first one's device bound to the CPU by the
    tour's runner; the namespace shows the blocks ran there."""
    assert len(tour.blocks()) >= 21
    ns = tour.run("cpu")
    assert ns["device"] == torch.device("cpu")
    assert ns["wet"].device.type == "cpu" and ns["c"].grad is not None
