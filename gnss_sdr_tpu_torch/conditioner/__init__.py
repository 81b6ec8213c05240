"""Signal conditioner role: adapters, filters, resamplers, the beamformer."""

from gnss_sdr_tpu_torch.conditioner.adapters import ADAPTERS
from gnss_sdr_tpu_torch.conditioner.beamformer import (
    ArrayConditioner,
    Beamformer,
    steering_weights,
)
from gnss_sdr_tpu_torch.conditioner.conditioner import (
    ConditionerConfig,
    PassThrough,
    SignalConditioner,
)
from gnss_sdr_tpu_torch.conditioner.filters import (
    design_fir,
    fir_apply,
    freq_xlating_fir_apply,
    notch_filter_block,
    pulse_blanking_block,
)
from gnss_sdr_tpu_torch.conditioner.resampler import (
    direct_resample,
    polyphase_resample,
)

__all__ = [
    "ADAPTERS",
    "ArrayConditioner",
    "Beamformer",
    "steering_weights",
    "ConditionerConfig",
    "PassThrough",
    "SignalConditioner",
    "design_fir",
    "direct_resample",
    "fir_apply",
    "freq_xlating_fir_apply",
    "notch_filter_block",
    "polyphase_resample",
    "pulse_blanking_block",
]
