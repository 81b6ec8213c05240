"""Acquisition engines (reference: src/algorithms/acquisition/)."""

from gnss_sdr_tpu_torch.acquisition.engines import AssistedAcquisition
from gnss_sdr_tpu_torch.acquisition.pcps import (
    AcqConfig,
    AcqResults,
    PcpsAcquisition,
    threshold_from_pfa,
)

__all__ = ["AcqConfig", "AcqResults", "AssistedAcquisition",
           "PcpsAcquisition", "threshold_from_pfa"]
