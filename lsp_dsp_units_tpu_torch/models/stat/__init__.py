from lsp_dsp_units_tpu_torch.models.stat.quantized_counter import (  # noqa
    QuantizedCounter, QuantizedCounterState)
