"""Signal conditioner: DataTypeAdapter -> InputFilter -> Resampler.

Counterpart of ``gnss_sdr_tpu/conditioner/conditioner.py`` for the chains
this slice carries: a data-type adapter (or pass-through) with no filter
and no resampler. ``ConditionerConfig`` keeps the JAX package's fields, so
the factory fills it from the same properties; a configuration that turns
on an FIR or frequency-translating FIR, decimation, the notch or pulse
blanking filter, or the fractional resampler raises
``NotImplementedError`` (ROADMAP queue item 13).

``process`` widens each raw block on ``device`` ("cuda" by default;
without a card that raises unless "cpu" is asked for) and returns the
complex64 block on the host, where the receiver's acquisition buffer
takes it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device
from gnss_sdr_tpu_torch.conditioner.adapters import ADAPTERS


@dataclass(frozen=True)
class ConditionerConfig:
    """One config covers the reference's DataTypeAdapter/InputFilter/Resampler
    role properties (the JAX package's fields)."""

    input_format: str = "passthrough"  # ADAPTERS key
    fs_in: float = 4e6
    fs_out: float | None = None        # None -> no fractional resampling
    if_freq_hz: float = 0.0            # freq-xlating LO (0 -> plain FIR)
    fir_taps: int = 0                  # 0 -> no FIR stage
    fir_band_hz: tuple[float, float] | float | None = None
    decimation: int = 1
    enable_notch: bool = False
    notch_pfa_ratio: float = 10.0
    enable_pulse_blanking: bool = False
    pulse_blanking_sigmas: float = 4.0

    @property
    def fs_final(self) -> float:
        fs = self.fs_in / self.decimation
        return self.fs_out if self.fs_out else fs


def check_supported(cfg: ConditionerConfig) -> None:
    """Raise for the conditioner stages this slice does not carry."""
    for on, what in ((cfg.fir_taps > 0 or cfg.if_freq_hz != 0.0,
                      "FIR / frequency-translating FIR filter"),
                     (cfg.decimation != 1, "decimation"),
                     (cfg.enable_notch, "notch filter"),
                     (cfg.enable_pulse_blanking, "pulse blanking filter"),
                     (bool(cfg.fs_out), "resampler")):
        if on:
            raise NotImplementedError(
                f"signal conditioner: {what} (ROADMAP queue item 13)")
    if cfg.input_format not in ADAPTERS:
        raise KeyError(cfg.input_format)


class SignalConditioner:
    """Streaming conditioner; ``process(block)`` -> conditioned complex64."""

    def __init__(self, cfg: ConditionerConfig,
                 device: str | torch.device = "cuda") -> None:
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._adapter = ADAPTERS[cfg.input_format]

    def process(self, raw: np.ndarray) -> np.ndarray:
        """Condition one raw block; returns the complex64 chunk."""
        x = torch.as_tensor(np.asarray(raw), device=self.device)
        return self._adapter(x).cpu().numpy()


class PassThrough:
    """Pass_Through analog (algorithms/libs/pass_through.cc)."""

    def process(self, raw: np.ndarray) -> np.ndarray:
        return np.asarray(raw, dtype=np.complex64)
