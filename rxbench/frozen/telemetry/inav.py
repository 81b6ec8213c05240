# Frozen copy of gnss_sdr_tpu_torch/telemetry/inav.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/telemetry/inav.py; only the package imports are
# rewritten, and what the benchmark never calls is left out (the docstring is the original's).
"""Galileo E1-B I/NAV navigation message: page sync, FEC, word parsing.

Structure (Galileo OS SIS ICD §4.3): the E1-B stream at 250 sym/s carries
nominal pages of 2 s, split into an even (1 s) and odd (1 s) part. Each part
is 10 sync symbols (0101100000) + 240 coded symbols; the 240 symbols are a
30x8 block interleaving of the rate-1/2 K=7 convolutionally-encoded 120-bit
part (114 data + 6 tail). Even part: even/odd(1)=0, page type(1), data(112).
Odd part: even/odd(1)=1, page type(1), data(16), OSNMA(40), SAR(22),
spare(2), CRC24Q(24), SSP(8). The CRC covers the 196 bits from the even
part's first bit through the odd part's spare field.

A 128-bit word (112 even + 16 odd data bits) carries word types 1-5 with
clock/ephemeris/iono/GST (parsed in `parse_word`, scalings per ICD Tables
57-75).

Reference analog: galileo_telemetry_decoder_gs.cc (deinterleave + Viterbi +
CRC24) and core/system_parameters/galileo_inav_message.cc (word parsing).
`InavEncoder` is the simulator-side inverse (the reference uses the external
gnss-sim generator instead).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


PREAMBLE = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], dtype=np.int8)
PART_SYMBOLS = 250          # 10 preamble + 240 coded
PAGE_SECONDS = 2.0
SYMBOL_SECONDS = 0.004


@dataclass
class GalileoEphemeris:
    """Galileo clock + ephemeris (I/NAV words 1-4 + BGD from word 5).

    Field names match GpsEphemeris so pvt.ephemeris.eph_to_pos_vel_clock
    propagates either (with the GTRF mu selected by ``system``).
    Reference analog: core/system_parameters/galileo_ephemeris.h.
    """

    prn: int = 0
    system: str = "E"
    week: int = 0               # Galileo System Time week
    iod_nav: int = -1
    toe: float = 0.0
    toc: float = 0.0
    m0: float = 0.0
    ecc: float = 0.0
    sqrt_a: float = 0.0
    omega0: float = 0.0
    i0: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0
    delta_n: float = 0.0
    idot: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    bgd_e1e5a: float = 0.0
    bgd_e1e5b: float = 0.0
    sisa: int = 107
    e1b_hs: int = 0
    e1b_dvs: int = 0

    # decode progress (word types 1-4 received with matching IODnav)
    has_w1: bool = False
    has_w2: bool = False
    has_w3: bool = False
    has_w4: bool = False

    @property
    def tgd(self) -> float:
        """Group delay applicable to single-frequency E1 (BGD E1/E5b is the
        E1B broadcast convention used by the solver's tgd hook)."""
        return self.bgd_e1e5b

    @property
    def complete(self) -> bool:
        return self.has_w1 and self.has_w2 and self.has_w3 and self.has_w4


@dataclass
class GalileoIono:
    """NeQuick-G broadcast coefficients (word 5)."""

    ai0: float = 0.0
    ai1: float = 0.0
    ai2: float = 0.0


def _put(bits: np.ndarray, pos: int, n: int, value: int) -> None:
    v = int(value) & ((1 << n) - 1)
    for k in range(n):
        bits[pos + n - 1 - k] = (v >> k) & 1


SEMI = np.pi  # semicircles -> radians
