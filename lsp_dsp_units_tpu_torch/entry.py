"""The port's counterpart of the JAX package's ``__graft_entry__.entry``:
a forward step of the filter + convolver + dynamics chain on small
shapes (4 channels, rank 9, a 0.05 s IR, two blocks per call), on an
explicit device.

    fn, args = entry("cuda")
    state, y = fn(*args)
"""

from __future__ import annotations

import torch

from lsp_dsp_units_tpu_torch.pipeline import FilterConvChain


def entry(device):
    """Returns (fn, (params, state, x)) with ``fn(params, state, x) ->
    (state', y)`` the chain's :meth:`FilterConvChain.step`."""
    chain = FilterConvChain(sample_rate=48000, channels=4, rank=9,
                            ir_seconds=0.05, device=device)
    params = chain.build()
    state = chain.init_state(params)
    x = torch.zeros((4, chain.block * 2), dtype=torch.float32,
                    device=chain.device)

    def fn(params, state, x):
        return chain.step(params, state, x)

    return fn, (params, state, x)
