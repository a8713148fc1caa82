from lsp_dsp_units_tpu_torch.models.sampling.sample import (  # noqa: F401
    Sample, SampleNormalize, SampleCrossfade)
from lsp_dsp_units_tpu_torch.models.sampling.player import (  # noqa: F401
    SamplePlayer, PlaySettings, Playback, LoopMode, XFadeType)
from lsp_dsp_units_tpu_torch.models.sampling.stream import InSampleStream  # noqa: F401
