"""Signal conditioner: DataTypeAdapter -> InputFilter -> Resampler.

Counterpart of ``gnss_sdr_tpu/conditioner/conditioner.py``. Reference:
Signal_Conditioner composes three separately scheduled GR blocks
(src/algorithms/conditioner/adapters/signal_conditioner.cc); Pass_Through
can replace any stage. Here each raw block goes to ``device`` ("cuda" by
default; without a card that raises unless "cpu" is asked for) and runs
there through the dtype widen, pulse blanking, the notch, the LO mix and
the FIR with decimation (``filters.py``), then the optional fractional
resampler (``resampler.py``); the conditioned block comes back to the host,
where the receiver's acquisition buffer takes it.

Streaming state, carried across blocks as the JAX conditioner carries it:
the FIR tail (overlap-save, including the samples a block length that is
not a multiple of the decimation leaves over), the LO phase (float64), and
the resampler's unconsumed samples and fractional position.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device
from gnss_sdr_tpu_torch.conditioner.adapters import ADAPTERS
from gnss_sdr_tpu_torch.conditioner.filters import (
    design_fir,
    fir_apply,
    lo_mix,
    notch_filter_block,
    pulse_blanking_block,
)
from gnss_sdr_tpu_torch.conditioner.resampler import polyphase_resample

_RES_TAPS = 8  # polyphase interpolator taps (GR MMSE interpolator is 8-tap)


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


class SignalConditioner:
    """Streaming conditioner; ``process(block)`` -> conditioned complex64."""

    def __init__(self, cfg: ConditionerConfig,
                 device: str | torch.device = "cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self._adapter = ADAPTERS[cfg.input_format]
        if cfg.fir_taps:
            band = cfg.fir_band_hz or (0.0, 0.45 * cfg.fs_in / cfg.decimation)
            taps = design_fir(cfg.fir_taps, cfg.fs_in, band)
        else:
            taps = np.ones(1)
        self.taps = torch.as_tensor(np.asarray(taps, np.float32),
                                    device=self.device)
        self._tail = torch.zeros(self.taps.shape[0] - 1,
                                 dtype=torch.complex64, device=self.device)
        self._lo_phase = 0.0
        # fractional-resampler carry: unconsumed mid-rate samples + position
        self._res_carry = torch.zeros(0, dtype=torch.complex64,
                                      device=self.device)
        self._res_pos = 0.0
        self._ratio = (cfg.fs_in / cfg.decimation) / cfg.fs_final

    def _widen(self, raw: np.ndarray) -> torch.Tensor:
        """A raw host block as complex64 on the device: complex blocks and
        float32 [N, 2] re/im lanes as they are, integer capture formats
        through the configured dtype adapter."""
        if np.iscomplexobj(raw):
            return torch.as_tensor(raw.astype(np.complex64, copy=False),
                                   device=self.device)
        x = torch.as_tensor(raw, device=self.device)
        if raw.ndim == 2 and raw.dtype == np.float32:
            return torch.complex(x[:, 0], x[:, 1])
        return self._adapter(x)

    def _filter(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.enable_pulse_blanking:
            x = pulse_blanking_block(x, cfg.pulse_blanking_sigmas)
        if cfg.enable_notch:
            x = notch_filter_block(x, cfg.notch_pfa_ratio)
        if cfg.if_freq_hz:
            x, self._lo_phase = lo_mix(x, self._lo_phase, cfg.fs_in,
                                       cfg.if_freq_hz)
        xt = torch.cat([self._tail, x])
        y = fir_apply(xt, self.taps, cfg.decimation)
        # carry the FULL unconsumed residue: the next block's first output
        # must use xt[n_out*decim:], so when the block length is not a
        # multiple of the decimation factor the tail grows by the leftover
        # samples (keeps the decimation phase continuous for arbitrary
        # block lengths)
        self._tail = xt[y.shape[0] * cfg.decimation:]
        return y

    # ------------------------------------------------------------- streaming
    def process(self, raw: np.ndarray) -> np.ndarray:
        """Condition one raw block; returns the final-rate complex64 chunk."""
        y = self._filter(self._widen(np.asarray(raw)))
        if self.cfg.fs_out:
            y = self._resample(y)
        return y.cpu().numpy()

    def _resample(self, y_mid: torch.Tensor) -> torch.Tensor:
        half = _RES_TAPS // 2
        buf = torch.cat([self._res_carry, y_mid])
        pos = self._res_pos
        # outputs k at pos + k*ratio need input up to floor(.)+half
        n_out = int((buf.shape[0] - 1 - half - pos) / self._ratio) + 1
        if n_out <= 0:
            self._res_carry = buf
            return torch.zeros(0, dtype=torch.complex64, device=self.device)
        out = polyphase_resample(buf, self._ratio, n_out, pos, _RES_TAPS)
        end_pos = pos + n_out * self._ratio
        start = max(int(np.floor(end_pos)) - (half - 1), 0)
        self._res_carry = buf[start:]
        self._res_pos = end_pos - start
        return out


class PassThrough:
    """Pass_Through analog (algorithms/libs/pass_through.cc)."""

    def process(self, raw: np.ndarray) -> np.ndarray:
        return np.asarray(raw, dtype=np.complex64)
