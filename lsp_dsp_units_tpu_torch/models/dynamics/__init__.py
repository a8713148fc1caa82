from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (  # noqa: F401
    Compressor, CompressorMode)
from lsp_dsp_units_tpu_torch.models.dynamics.expander import (  # noqa: F401
    Expander, ExpanderMode)
from lsp_dsp_units_tpu_torch.models.dynamics.gate import Gate  # noqa: F401
from lsp_dsp_units_tpu_torch.models.dynamics.limiter import (  # noqa: F401
    Limiter, LimiterMode)
from lsp_dsp_units_tpu_torch.models.dynamics.dynamic_processor import (  # noqa: F401
    DynamicProcessor)
from lsp_dsp_units_tpu_torch.models.dynamics.autogain import (  # noqa: F401
    AutoGain, SimpleAutoGain)
from lsp_dsp_units_tpu_torch.models.dynamics.surge_protector import (  # noqa: F401
    SurgeProtector)
