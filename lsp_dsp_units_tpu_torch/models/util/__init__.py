from lsp_dsp_units_tpu_torch.models.util.convolver import (  # noqa: F401
    CONVOLVER_RANK_MAX, CONVOLVER_RANK_MIN, Convolver, convolve_oneshot)
from lsp_dsp_units_tpu_torch.models.util.sidechain import (  # noqa: F401
    Sidechain, SidechainMode, SidechainSource, select_source)
