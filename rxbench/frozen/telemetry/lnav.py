# Frozen copy of gnss_sdr_tpu_torch/telemetry/lnav.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/telemetry/lnav.py; only the package imports are
# rewritten, and what the benchmark never calls is left out (the docstring is the original's).
"""GPS LNAV (L1 C/A 50 bps) navigation message: frame sync, parity, parsing.

Independent implementation from IS-GPS-200 (§20.3.2-20.3.3): 30-bit words
with (32,26) Hamming parity chained through D29*/D30*, 300-bit subframes,
8-bit preamble 10001011, HOW with truncated TOW and subframe ID; subframes
1-3 carry clock + ephemeris, 4/5 almanac/iono/UTC.

Reference analog: gps_l1_ca_telemetry_decoder_gs.cc (frame sync/parity,
:216-233,270,623) + core/system_parameters/gps_navigation_message.cc
(subframe_decoder). Host-side bit logic per SURVEY.md §7 (control-heavy,
not worth device cycles).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PREAMBLE_BITS = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int8)
BITS_PER_WORD = 30
WORDS_PER_SUBFRAME = 10
BITS_PER_SUBFRAME = 300
SUBFRAME_SECONDS = 6.0
BIT_SECONDS = 0.02

# Parity tap sets (IS-GPS-200 Table 20-XIV): data bits d1..d24 feeding
# D25..D30. Each row lists 1-based source-bit indices.
_PARITY_TAPS = [
    [1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23],          # D25 (+D29*)
    [2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24],          # D26 (+D30*)
    [1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22],           # D27 (+D29*)
    [2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23],           # D28 (+D30*)
    [1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24],       # D29 (+D30*)
    [3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24],              # D30 (+D29*)
]
_PARITY_PREV = [0, 1, 0, 1, 1, 0]  # 0 -> D29*, 1 -> D30*


def compute_parity(d24: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """Parity bits D25..D30 for source bits d24 (len 24) given D29*/D30*."""
    prev = (d29s, d30s)
    out = np.empty(6, dtype=np.int8)
    for i, taps in enumerate(_PARITY_TAPS):
        p = prev[_PARITY_PREV[i]]
        for t in taps:
            p ^= int(d24[t - 1])
        out[i] = p
    return out


@dataclass
class GpsEphemeris:
    """GPS clock + ephemeris parameters (IS-GPS-200 Table 20-III scalings
    applied; angles in radians, times in seconds of week).

    Reference analog: core/system_parameters/gps_ephemeris.h."""

    prn: int = 0
    week: int = 0
    sv_health: int = 0
    ura_index: int = 0
    iodc: int = 0
    iode_sf2: int = 0
    iode_sf3: int = 0
    tgd: float = 0.0
    toc: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    crs: float = 0.0
    delta_n: float = 0.0
    m0: float = 0.0
    cuc: float = 0.0
    ecc: float = 0.0
    cus: float = 0.0
    sqrt_a: float = 0.0
    toe: float = 0.0
    cic: float = 0.0
    omega0: float = 0.0
    cis: float = 0.0
    i0: float = 0.0
    crc: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0
    idot: float = 0.0
    fit_interval: int = 0

    # decode progress
    has_sf1: bool = False
    has_sf2: bool = False
    has_sf3: bool = False

    @property
    def complete(self) -> bool:
        return (
            self.has_sf1 and self.has_sf2 and self.has_sf3
            and self.iode_sf2 == self.iode_sf3
        )


@dataclass
class GpsAlmanac:
    """Almanac entry (subframes 4/5 pages; IS-GPS-200 20.3.3.5.1.2).
    Reference analog: gps_almanac.h."""

    prn: int = 0
    ecc: float = 0.0
    toa: float = 0.0
    delta_i: float = 0.0          # rad, offset from 0.30 semicircles
    omega_dot: float = 0.0
    sv_health: int = 0
    sqrt_a: float = 0.0
    omega0: float = 0.0
    omega: float = 0.0
    m0: float = 0.0
    af0: float = 0.0
    af1: float = 0.0


PI_GPS = 3.1415926535898  # semicircle->rad factor fixed by the ICD
