# Copied from gnss_sdr_tpu/simulate/generator.py; only the package imports are rewritten.
"""Multi-satellite baseband GNSS signal synthesis (host-side, NumPy f64).

Signal model, per satellite (complex baseband at sampling rate fs):

    s(t) = A * d(t) * c(t) * exp(j*(2*pi*(fd*t + 0.5*fd_rate*t^2) + phi0))

where c(t) is the PRN code sequence evaluated at the code phase

    phase_chips(t) = (t - tau(t)) * code_rate_eff,   tau(0) = delay_chips/code_rate

with code_rate_eff = code_rate * (1 + fd/f_carrier) (code Doppler coherent
with carrier Doppler, as for a real moving satellite), and d(t) the data bit
active during the code period (bit edges aligned to code-period boundaries,
CODES_PER_BIT periods per bit, as transmitted).

Amplitude from C/N0: with unit-variance complex AWGN (total variance
sigma^2 = 1 across I+Q), the noise density is N0 = 1/fs, so
A = sqrt(10^(cn0_dbhz/10) / fs).

Reference analog: signal_generator_c.cc generate_codes()/work().
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code
from gnss_sdr_tpu_torch.constants import galileo_e5a as e5a_const
from gnss_sdr_tpu_torch.constants import gps_l1_ca
from gnss_sdr_tpu_torch.constants import gps_l5 as l5_const


@dataclass
class SatelliteSignalParams:
    """One simulated satellite signal component.

    BPSK signals ("1C"): d(t)*c(t) on the carrier. QPSK pilot+data signals
    ("L5" = GPS L5, "5X" = Galileo E5a): data component (primary x data
    secondary x symbols) on I, pilot component (primary x pilot secondary)
    on Q, each at half the total C/N0 power (IS-GPS-705 §3.2 / Galileo ICD
    §2.3 modulation layouts).
    """

    prn: int
    cn0_dbhz: float = 44.0
    doppler_hz: float = 0.0
    doppler_rate_hz_s: float = 0.0
    delay_chips: float = 0.0          # code delay at t=0, in chips
    carrier_phase_rad: float = 0.0
    system: str = "GPS"
    signal: str = "1C"
    # data bits/symbols (+1/-1), one per codes_per_bit code periods;
    # None -> all +1.
    nav_bits: np.ndarray | None = None
    # index of the bit active at transmit-time code period 0
    nav_bit_offset: int = 0

    def code(self) -> np.ndarray:
        """Data-component primary code."""
        if self.signal == "1C":
            return gps_l1_ca_code(self.prn).astype(np.float64)
        if self.signal == "L5":
            from gnss_sdr_tpu_torch.codes.gps_l5 import gps_l5i_code

            return gps_l5i_code(self.prn).astype(np.float64)
        if self.signal == "5X":
            from gnss_sdr_tpu_torch.codes.galileo_e5a import galileo_e5ai_code

            return galileo_e5ai_code(self.prn).astype(np.float64)
        raise NotImplementedError(f"simulator: {self.system}/{self.signal}")

    def pilot_code(self) -> np.ndarray | None:
        if self.signal == "L5":
            from gnss_sdr_tpu_torch.codes.gps_l5 import gps_l5q_code

            return gps_l5q_code(self.prn).astype(np.float64)
        if self.signal == "5X":
            from gnss_sdr_tpu_torch.codes.galileo_e5a import galileo_e5aq_code

            return galileo_e5aq_code(self.prn).astype(np.float64)
        return None

    def secondary_data(self) -> np.ndarray | None:
        if self.signal == "L5":
            from gnss_sdr_tpu_torch.codes.gps_l5 import nh10_levels

            return nh10_levels().astype(np.float64)
        if self.signal == "5X":
            from gnss_sdr_tpu_torch.codes.galileo_e5a import e5ai_secondary_levels

            return e5ai_secondary_levels().astype(np.float64)
        return None

    def secondary_pilot(self) -> np.ndarray | None:
        if self.signal == "L5":
            from gnss_sdr_tpu_torch.codes.gps_l5 import nh20_levels

            return nh20_levels().astype(np.float64)
        if self.signal == "5X":
            from gnss_sdr_tpu_torch.codes.galileo_e5a import e5aq_secondary_levels

            return e5aq_secondary_levels(self.prn).astype(np.float64)
        return None

    def code_rate(self) -> float:
        if self.signal == "L5":
            return l5_const.CODE_RATE_CPS
        if self.signal == "5X":
            return e5a_const.CODE_RATE_CPS
        return gps_l1_ca.CODE_RATE_CPS

    def carrier_freq(self) -> float:
        if self.signal == "L5":
            return l5_const.FREQ_HZ
        if self.signal == "5X":
            return e5a_const.FREQ_HZ
        return gps_l1_ca.FREQ_HZ

    def codes_per_bit(self) -> int:
        if self.signal == "L5":
            return l5_const.CODES_PER_SYMBOL
        if self.signal == "5X":
            return e5a_const.CODES_PER_SYMBOL
        return gps_l1_ca.CODES_PER_BIT


def generate_baseband(
    sats: list[SatelliteSignalParams],
    fs: float,
    num_samples: int,
    noise: bool = True,
    seed: int = 0,
    t0: float = 0.0,
    chunk: int = 1 << 20,
) -> np.ndarray:
    """Synthesize ``num_samples`` of complex64 baseband starting at time t0."""
    rng = np.random.default_rng(seed)
    out = np.empty(num_samples, dtype=np.complex64)
    for start in range(0, num_samples, chunk):
        n = min(chunk, num_samples - start)
        t = t0 + (start + np.arange(n, dtype=np.float64)) / fs
        acc = np.zeros(n, dtype=np.complex128)
        for sat in sats:
            acc += _sat_component(sat, t, fs)
        if noise:
            acc += rng.normal(scale=np.sqrt(0.5), size=n) + 1j * rng.normal(
                scale=np.sqrt(0.5), size=n
            )
        out[start : start + n] = acc.astype(np.complex64)
    return out


def _sat_component(sat: SatelliteSignalParams, t: np.ndarray, fs: float) -> np.ndarray:
    code = sat.code()
    code_len = code.shape[0]
    fc = sat.carrier_freq()
    code_rate_eff = sat.code_rate() * (1.0 + sat.doppler_hz / fc)

    phase_chips = t * code_rate_eff - sat.delay_chips
    chip_idx = np.floor(phase_chips).astype(np.int64)
    chips = code[chip_idx % code_len]
    period_idx = np.floor_divide(chip_idx, code_len)

    data = chips
    sec_d = sat.secondary_data()
    if sec_d is not None:
        data = data * sec_d[period_idx % len(sec_d)]
    if sat.nav_bits is not None:
        bit_idx = (
            np.floor_divide(period_idx, sat.codes_per_bit()) + sat.nav_bit_offset
        ) % len(sat.nav_bits)
        data = data * sat.nav_bits[bit_idx]

    pilot_code = sat.pilot_code()
    if pilot_code is not None:
        pilot = pilot_code[chip_idx % code_len]
        sec_p = sat.secondary_pilot()
        if sec_p is not None:
            pilot = pilot * sec_p[period_idx % len(sec_p)]
        # QPSK: data on I, pilot on Q, each at half the total power
        base = (data + 1j * pilot) / np.sqrt(2.0)
    else:
        base = data

    carrier_phase = (
        2.0 * np.pi * (sat.doppler_hz * t + 0.5 * sat.doppler_rate_hz_s * t * t)
        + sat.carrier_phase_rad
    )
    amp = np.sqrt(10.0 ** (sat.cn0_dbhz / 10.0) / fs)
    return amp * base * np.exp(1j * carrier_phase)
