# Copied from gnss_sdr_tpu/monitor/dumps.py; only the package imports are rewritten.
"""Per-block binary dumps (.npz) — the reference's de-facto tracing layer:
every block writes internal state per iteration when `dump=true`
(dll_pll_veml_tracking.cc:1599 log_data, pcps_acquisition.cc:354-404 grid
dumps), consumed by offline analysis scripts.

Here one TrackingDumper per signal group accumulates the per-period host
outputs (prompts, taps, NCO state, stamps) and writes a single compressed
npz on close; AcquisitionDumper records each acquisition call's results.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


class TrackingDumper:
    KEYS = ("prompt", "taps", "boundary", "acc_prompt", "acc_samples",
            "carrier_doppler", "code_freq", "carrier_phase",
            "rem_code_phase", "n_samples")

    def __init__(self, filename: str) -> None:
        self.filename = filename
        self._chunks: dict[str, list] = {k: [] for k in self.KEYS}
        self._stamps: list = []

    def push(self, result) -> None:
        """Append one BlockResult's host outputs ([S, C] arrays)."""
        for k in self.KEYS:
            self._chunks[k].append(result.outputs[k])
        self._stamps.append(result.abs_sample_end)

    def close(self) -> None:
        if not self._stamps:
            return
        arrays = {
            k: np.concatenate(v, axis=0) for k, v in self._chunks.items()
        }
        arrays["abs_sample_end"] = np.concatenate(self._stamps, axis=0)
        np.savez_compressed(self.filename, **arrays)
        log.info("tracking dump: %s (%d periods x %d channels)",
                 self.filename, arrays["prompt"].shape[0],
                 arrays["prompt"].shape[1])
        self._chunks = {k: [] for k in self.KEYS}
        self._stamps = []


class AcquisitionDumper:
    def __init__(self, filename: str) -> None:
        self.filename = filename
        self._rows: list = []

    def push(self, prns, res) -> None:
        for i, prn in enumerate(prns):
            self._rows.append((
                prn, bool(res.detected[i]), float(res.test_statistic[i]),
                float(res.delay_samples[i]), float(res.doppler_hz[i]),
                float(res.input_power[i]), float(res.threshold),
            ))

    def close(self) -> None:
        if not self._rows:
            return
        arr = np.array(self._rows, dtype=[
            ("prn", "i4"), ("detected", "?"), ("test_statistic", "f8"),
            ("delay_samples", "f8"), ("doppler_hz", "f8"),
            ("input_power", "f8"), ("threshold", "f8"),
        ])
        np.savez_compressed(self.filename, acquisitions=arr)
        log.info("acquisition dump: %s (%d attempts)",
                 self.filename, len(arr))
        self._rows = []
