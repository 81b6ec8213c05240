# Frozen copy of gnss_sdr_tpu_torch/codes/gps_l1_ca.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/codes/gps_l1_ca.py; only the package imports are
# rewritten, and what the benchmark never calls is left out (the docstring is the original's).
"""GPS L1 C/A PRN code generation.

Implements the Gold-code generator of IS-GPS-200 §3.3.2.3: two 10-stage
LFSRs (G1: 1+x^3+x^10, G2: 1+x^2+x^3+x^6+x^8+x^9+x^10), with the C/A code
formed as G1 output XOR two phase-selected taps of G2.

The reference implements the same generator in
src/algorithms/libs/gps_sdr_signal_replica.cc (gps_l1_ca_code_gen_complex /
gps_l1_ca_code_gen_float); this is an independent implementation from the
public ICD.
"""

from __future__ import annotations

import functools

import numpy as np

# G2 phase-select taps per PRN (IS-GPS-200 Table 3-Ia, PRN 1..32).
# Entry i (1-based PRN) gives the two G2 register stages whose XOR forms the
# delayed G2 sequence for that satellite.
_G2_TAPS = {
    1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9), 6: (2, 10),
    7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3), 11: (3, 4), 12: (5, 6),
    13: (6, 7), 14: (7, 8), 15: (8, 9), 16: (9, 10), 17: (1, 4), 18: (2, 5),
    19: (3, 6), 20: (4, 7), 21: (5, 8), 22: (6, 9), 23: (1, 3), 24: (4, 6),
    25: (5, 7), 26: (6, 8), 27: (7, 9), 28: (8, 10), 29: (1, 6), 30: (2, 7),
    31: (3, 8), 32: (4, 9),
}

CODE_LENGTH = 1023

# G2 delays for the C/A-family codes specified by delay rather than phase
# taps: SBAS PRN 120..138 (RTCA DO-229; reference gps_sdr_signal_replica.cc
# delays[32:]) and QZSS PRN 193..202 (IS-QZSS-PNT Table 3.2.2-1; reference
# qzss_signal_replica.cc qzss_l1_table).
_G2_DELAYS = {
    120: 145, 121: 175, 122: 52, 123: 21, 124: 237, 125: 235, 126: 886,
    127: 657, 128: 634, 129: 762, 130: 355, 131: 1012, 132: 176, 133: 603,
    134: 130, 135: 359, 136: 595, 137: 68, 138: 386,
    193: 339, 194: 208, 195: 711, 196: 189, 197: 263, 198: 537, 199: 663,
    200: 942, 201: 173, 202: 900,
}


@functools.lru_cache(maxsize=128)
def gps_l1_ca_code(prn: int) -> np.ndarray:
    """Return the 1023-chip C/A code for ``prn`` as int8 in {+1, -1}.

    Chip value +1 corresponds to binary 0, -1 to binary 1 (BPSK mapping),
    matching the convention of the reference replica generator. Covers the
    whole C/A code family: GPS PRN 1-32 (G2 phase taps), SBAS PRN 120-138
    and QZSS PRN 193-202 (G2 delay).
    """
    if prn not in _G2_TAPS and prn not in _G2_DELAYS:
        raise ValueError(f"unsupported C/A-family PRN {prn}")

    g1 = np.ones(10, dtype=np.int64)
    g2 = np.ones(10, dtype=np.int64)
    g1_seq = np.empty(CODE_LENGTH, dtype=np.int64)
    g2_seq = np.empty(CODE_LENGTH, dtype=np.int64)
    taps = _G2_TAPS.get(prn)
    g2_sel = np.empty(CODE_LENGTH, dtype=np.int64)
    for i in range(CODE_LENGTH):
        g1_seq[i] = g1[9]
        g2_seq[i] = g2[9]
        if taps is not None:
            g2_sel[i] = g2[taps[0] - 1] ^ g2[taps[1] - 1]
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1[1:] = g1[:-1]
        g1[0] = fb1
        g2[1:] = g2[:-1]
        g2[0] = fb2
    if taps is None:
        # delayed-G2 formulation: code = G1 XOR G2 shifted by the delay
        g2_sel = np.roll(g2_seq, _G2_DELAYS[prn])
    bits = g1_seq ^ g2_sel
    return (1 - 2 * bits).astype(np.int8)
