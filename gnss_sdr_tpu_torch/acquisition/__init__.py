"""Acquisition engines (reference: src/algorithms/acquisition/)."""

from gnss_sdr_tpu_torch.acquisition.engines import (
    AssistedAcquisition,
    CccwsrAcquisition,
    FineDopplerAcquisition,
    NoncoherentIQAcquisition,
    QuickSyncAcquisition,
    TongAcquisition,
)
from gnss_sdr_tpu_torch.acquisition.pcps import (
    AcqConfig,
    AcqResults,
    PcpsAcquisition,
    threshold_from_pfa,
)

__all__ = ["AcqConfig", "AcqResults", "AssistedAcquisition",
           "CccwsrAcquisition", "FineDopplerAcquisition",
           "NoncoherentIQAcquisition", "PcpsAcquisition",
           "QuickSyncAcquisition", "TongAcquisition", "threshold_from_pfa"]
