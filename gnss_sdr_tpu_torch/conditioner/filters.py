"""Input filters: FIR, frequency-translating FIR, notch, pulse blanking.

Counterpart of ``gnss_sdr_tpu/conditioner/filters.py``. Reference
components (src/algorithms/input_filter/):

- Fir_Filter / Freq_Xlating_Fir_Filter (adapters/freq_xlating_fir_filter.cc):
  a band-pass FIR designed from config bands; the xlating variant shifts
  the IF to baseband and decimates in the same pass;
- Notch_Filter / Notch_Filter_Lite (gnuradio_blocks/notch_cc.cc,
  notch_lite_cc.cc): CW-interference rejection. As in the JAX package the
  notch works per block in the frequency domain (FFT, attenuate the
  detected CW bins, IFFT) with the reference's power-ratio detection,
  here through complex64 ``torch.fft``;
- Pulse_Blanking_Filter (pulse_blanking_cc.cc): zero the samples whose
  magnitude exceeds a threshold over the noise floor.

Every filter is a function of one block (plus the previous block's tail
for the FIR) on the tensor's device. The FIR is a sum over taps of strided
slices of the block in float32, in the same order on every device; a cuDNN
convolution could round through TF32 on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import signal as sp_signal


# --------------------------------------------------------------------- design
def design_fir(
    num_taps: int,
    fs: float,
    passband_hz: tuple[float, float] | float,
    window: str = "hamming",
) -> np.ndarray:
    """Linear-phase FIR design (host-side, at build time).

    The reference designs Parks-McClellan taps from config bands
    (freq_xlating_fir_filter.cc, conf example
    conf/File_input/GPS/gnss-sdr_GPS_L1_CA_ibyte.conf:22-41); windowed-sinc
    via scipy.firwin is equivalent capability with monotone stopband.
    """
    if isinstance(passband_hz, tuple):
        lo, hi = passband_hz
        if lo <= 0:
            return sp_signal.firwin(num_taps, hi, fs=fs, window=window)
        return sp_signal.firwin(
            num_taps, [lo, hi], fs=fs, pass_zero=False, window=window
        )
    return sp_signal.firwin(num_taps, passband_hz, fs=fs, window=window)


# ------------------------------------------------------------------ FIR block
def fir_apply(x: torch.Tensor, taps: torch.Tensor,
              decim: int = 1) -> torch.Tensor:
    """Causal FIR + decimation on one block.

    x: [N + T - 1] complex64 (block prepended with the previous tail)
    taps: [T] float32
    returns [N // decim] complex64 aligned so output[k] uses
    x[k*decim : k*decim+T], weighted by the reversed taps.
    """
    t = taps.shape[0]
    n_out = (x.shape[0] - (t - 1)) // decim
    rt = taps.flip(0).to(torch.float32).tolist()
    y = torch.zeros(n_out, dtype=torch.complex64, device=x.device)
    for j, w in enumerate(rt):
        y = y + x[j:j + (n_out - 1) * decim + 1:decim] * w
    return y


def freq_xlating_fir_apply(
    x: torch.Tensor,
    taps: torch.Tensor,
    phase0: float,
    fs: float,
    if_freq_hz: float,
    decim: int = 1,
) -> tuple[torch.Tensor, float]:
    """Frequency-translating FIR: x * exp(-j 2π f_if t) -> FIR -> decimate.

    ``phase0`` (radians) carries the LO phase across blocks so the
    translation is continuous. Returns (output, next_phase0).
    """
    y, next_phase = lo_mix(x, phase0, fs, if_freq_hz)
    return fir_apply(y, taps, decim), next_phase


def lo_mix(x: torch.Tensor, phase0: float, fs: float,
           if_freq_hz: float) -> tuple[torch.Tensor, float]:
    """x * exp(j (phase0 + w k)), w = -2π f_if / fs: the phase in float64,
    its sine and cosine cast to float32. Returns (mixed, next_phase0)."""
    n = x.shape[0]
    w = -2.0 * np.pi * if_freq_hz / fs
    ph = phase0 + w * torch.arange(n, dtype=torch.float64, device=x.device)
    lo = torch.complex(torch.cos(ph).to(torch.float32),
                       torch.sin(ph).to(torch.float32))
    return x * lo, (phase0 + w * n) % (2.0 * np.pi)


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor, the mean of the two middle values for an
    even length (as ``jnp.median``)."""
    s = torch.sort(v).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return s[n // 2 - 1] * 0.5 + s[n // 2] * 0.5


# -------------------------------------------------------------------- notch
def notch_filter_block(x: torch.Tensor,
                       pfa_ratio: float = 10.0) -> torch.Tensor:
    """Frequency-domain CW notch with automatic detection.

    Detection mirrors the reference's power-ratio test (notch_cc.cc
    computes the ratio of peak spectral power to average power and engages
    the filter past a threshold): every bin whose power exceeds
    ``pfa_ratio`` x the median bin power is attenuated down to the noise
    floor, which covers a CW's leakage skirt and any number of
    interferers in one elementwise pass.
    """
    spec = torch.fft.fft(x)
    p = torch.abs(spec) ** 2
    floor = _median(p)
    hit = p > pfa_ratio * floor
    scale = torch.where(hit, torch.sqrt(floor / torch.maximum(p, floor)),
                        1.0)
    return torch.fft.ifft(spec * scale).to(torch.complex64)


# ----------------------------------------------------------- pulse blanking
def pulse_blanking_block(
    x: torch.Tensor, pfa_sigmas: float = 4.0
) -> torch.Tensor:
    """Zero samples above ``pfa_sigmas`` x the robust noise scale
    (Pulse_Blanking_Filter analog, pulse_blanking_cc.cc)."""
    mag2 = torch.abs(x) ** 2
    noise = _median(mag2)  # robust to the pulses themselves
    keep = mag2 <= (pfa_sigmas ** 2) * noise
    return torch.where(keep, x, 0.0).to(torch.complex64)
