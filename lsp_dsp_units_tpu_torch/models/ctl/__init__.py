from lsp_dsp_units_tpu_torch.models.ctl.bypass import (  # noqa: F401
    Bypass, BypassState)
from lsp_dsp_units_tpu_torch.models.ctl.control import (  # noqa: F401
    Blink, Counter, Toggle)
from lsp_dsp_units_tpu_torch.models.ctl.crossfade import (  # noqa: F401
    Crossfade, CrossfadeState)
