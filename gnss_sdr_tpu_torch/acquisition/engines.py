"""Acquisition engine variants beyond plain PCPS.

Counterpart of ``gnss_sdr_tpu/acquisition/engines.py``, for the assisted
engine (reference ``gps_l1_ca_pcps_assisted_acquisition.cc``): a narrow
Doppler search around per-satellite predicted Doppler, which the receiver
uses for a satellite already tracked on another carrier. It schedules the
batched PCPS engine (``pcps.py``) through its per-row offset table. The
fine-Doppler, Tong, QuickSync, CCCWSR and noncoherent I/Q engines are not
ported yet (ROADMAP queue item 11).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from gnss_sdr_tpu_torch.acquisition.pcps import (
    AcqConfig,
    AcqResults,
    PcpsAcquisition,
)


class AssistedAcquisition:
    """Assisted acquisition (gps_l1_ca_pcps_assisted_acquisition analog).

    Searches a narrow window (+-``window_hz``) around per-satellite
    predicted Doppler, through the batched engine's per-row frequency
    offsets; the reported Doppler includes the prediction.
    """

    def __init__(self, conf: AcqConfig, code_table: np.ndarray,
                 prns: list[int], predicted_doppler_hz: dict[int, float],
                 window_hz: float = 500.0, *,
                 device: str | torch.device = "cuda") -> None:
        offsets = np.array(
            [predicted_doppler_hz.get(p, 0.0) for p in prns], np.float64)
        narrow = replace(conf, doppler_max_hz=window_hz, doppler_min_hz=None)
        self.inner = PcpsAcquisition(narrow, code_table, prns,
                                     freq_offset_table=offsets,
                                     device=device)
        self.conf = self.inner.conf
        self.prns = self.inner.prns
        self.threshold = self.inner.threshold
        self._offsets_np = offsets

    def set_predicted_doppler(self, offsets_hz: np.ndarray) -> None:
        """Update the per-row predicted Doppler between calls. The inner
        engine's offset table is rewritten in place: nothing is rebuilt."""
        offsets_hz = np.asarray(offsets_hz, np.float64)
        if offsets_hz.shape != self._offsets_np.shape:
            raise ValueError(
                f"expected {self._offsets_np.shape} offsets, "
                f"got {offsets_hz.shape}")
        self._offsets_np = offsets_hz
        self.inner.set_offsets(offsets_hz)

    def acquire(self, x, prn_idx) -> AcqResults:
        res = self.inner.acquire(x, prn_idx)
        # the engine reports Doppler excluding the offset; assistance
        # offsets are Doppler, so they are added back
        res.doppler_hz = res.doppler_hz + self._offsets_np[
            np.asarray(prn_idx, np.int64)]
        return res
