from lsp_dsp_units_tpu_torch.models.meters.loudness import (  # noqa: F401
    LoudnessMeter, ILUFSMeter, Weighting)
from lsp_dsp_units_tpu_torch.models.meters.true_peak import (  # noqa: F401
    TruePeakMeter)
from lsp_dsp_units_tpu_torch.models.meters.correlometer import (  # noqa: F401
    Correlometer)
from lsp_dsp_units_tpu_torch.models.meters.peak import (  # noqa: F401
    PeakMeter, Panometer, PanLaw)
