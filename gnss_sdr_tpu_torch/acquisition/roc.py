"""Acquisition detection-performance (Pd/Pfa, ROC) measurement harness.

Counterpart of ``gnss_sdr_tpu/acquisition/roc.py``. Mirrors the
reference's acq_performance_test (tests/unit-tests/signal-processing-blocks/
acquisition/acq_performance_test.cc): Monte-Carlo sweeps of detection
probability against C/N0 at a configured false-alarm rate, plus the
measured Pfa on noise-only input, so acquisition thresholds are justified
by measurement. Trials run as one batched ``acquire`` call of the port's
PCPS engine (the channel axis is the trial axis); the signals come from
the copied baseband generator (``simulate/generator.py``), so both
packages see the same samples for the same seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sdr_tpu_torch.acquisition.pcps import AcqConfig, PcpsAcquisition
from gnss_sdr_tpu_torch.simulate.generator import (
    SatelliteSignalParams,
    generate_baseband,
)


def measure_pfa(
    acq: PcpsAcquisition, trials: int = 64, seed: int = 0
) -> float:
    """Fraction of noise-only acquisitions crossing the threshold."""
    conf = acq.conf
    rng = np.random.default_rng(seed)
    x = (rng.normal(scale=np.sqrt(0.5), size=(trials, conf.input_samples))
         + 1j * rng.normal(scale=np.sqrt(0.5),
                           size=(trials, conf.input_samples))
         ).astype(np.complex64)
    res = acq.acquire(x, np.zeros(trials, dtype=np.int32))
    return float(np.mean(res.detected))


def measure_pd(
    acq: PcpsAcquisition,
    prn: int,
    cn0_dbhz: float,
    trials: int = 20,
    doppler_hz: float = 1234.0,
    delay_chips: float = 333.25,
    seed: int = 1,
    signal: str = "1C",
) -> dict:
    """Detection probability + measured delay/Doppler errors at one C/N0."""
    conf = acq.conf
    rows = []
    for k in range(trials):
        sat = SatelliteSignalParams(
            prn=prn, cn0_dbhz=cn0_dbhz, doppler_hz=doppler_hz,
            delay_chips=delay_chips, signal=signal,
            carrier_phase_rad=2.0 * np.pi * k / trials,
        )
        rows.append(generate_baseband(
            [sat], conf.fs, conf.input_samples, seed=seed * 1000 + k
        ))
    x = np.stack(rows)
    res = acq.acquire(x, np.full(trials, prn - 1, dtype=np.int32))
    det = res.detected
    # generator: code phase = t*rate - delay_chips, so the code start lands
    # delay_chips into the window
    sps_chip = conf.fs / conf.code_rate_cps
    true_delay = (delay_chips % conf.code_length_chips) * sps_chip
    derr = np.abs(res.delay_samples - true_delay)
    derr = np.minimum(derr, conf.samples_per_code - derr)
    return {
        "cn0_dbhz": cn0_dbhz,
        "pd": float(np.mean(det)),
        "doppler_err_hz": float(np.mean(np.abs(
            res.doppler_hz[det] - doppler_hz))) if det.any() else None,
        "delay_err_samples": float(np.mean(derr[det])) if det.any() else None,
    }


def measure_roc(
    conf: AcqConfig,
    code_table: np.ndarray,
    prn: int = 7,
    cn0_list: tuple = (35.0, 40.0, 45.0),
    trials: int = 20,
    pfa_trials: int = 64,
    *,
    device: str | torch.device = "cuda",
) -> dict:
    """Full sweep: measured Pfa + Pd(C/N0) curve for the configured
    statistic/threshold, on ``device``."""
    acq = PcpsAcquisition(conf, code_table, list(range(1, 33)),
                          device=device)
    return {
        "statistic": conf.statistic,
        "threshold": acq.threshold,
        "target_pfa": conf.pfa,
        "measured_pfa": measure_pfa(acq, trials=pfa_trials),
        "pd_curve": [measure_pd(acq, prn, c, trials=trials)
                     for c in cn0_list],
    }
