# Copied from gnss_sdr_tpu/codes/beidou_b1i.py; only the package imports are rewritten.
"""BeiDou B1I ranging codes (BDS-SIS-ICD-2.1 §5.2.2).

Two 11-stage LFSRs: G1 with taps 1,2,3,4,5,11 and G2 with taps
1,3,4,7,8,9,10,11, both seeded 01010101010; the B1I code for a PRN is
G1 XOR a PRN-specific two- or three-tap phase selection of G2.
Reference analog: src/algorithms/libs/beidou_b1i_signal_replica.cc
(validated bit-exact against it by tests/test_reference_oracle.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from gnss_sdr_tpu_torch.constants.beidou_b1i import CODE_LENGTH_CHIPS

# G2 phase-selector assignments per PRN (ICD Table 5-4; three-tap entries
# appear from PRN 38 on)
_PHASE1 = (1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4,
           4, 5, 5, 5, 5, 5, 6, 6, 6, 6, 8, 8, 8, 9, 9, 10, 2, 3, 3, 3, 3,
           3, 4, 4, 5, 5, 5, 5, 6, 8, 9, 9, 3, 5, 7, 4, 4, 5, 5, 5, 5, 6)
_PHASE2 = (3, 4, 5, 6, 8, 9, 10, 11, 7, 4, 5, 6, 8, 9, 10, 11, 5, 6, 8, 9,
           10, 11, 6, 8, 9, 10, 11, 8, 9, 10, 11, 9, 10, 11, 10, 11, 11, 7,
           4, 6, 8, 10, 11, 5, 9, 6, 8, 10, 11, 9, 9, 10, 11, 7, 7, 9, 5,
           9, 6, 8, 10, 11, 9)
_PHASE3 = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
           0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
           1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3)

NUM_PRNS = 37          # tracked set: MEO/IGSO + GEO assignments 1..37


@lru_cache(maxsize=None)
def _b1i_bits(prn: int) -> tuple:
    if not 1 <= prn <= len(_PHASE1):
        raise ValueError(f"B1I PRN must be 1..{len(_PHASE1)}, got {prn}")
    p1, p2, p3 = (_PHASE1[prn - 1], _PHASE2[prn - 1], _PHASE3[prn - 1])
    # register index 0 = output (oldest) stage; seed 01010101010 puts the
    # alternation with 0 at the output
    g1 = [0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0]
    g2 = list(g1)
    out = np.empty(CODE_LENGTH_CHIPS, dtype=np.int8)
    for i in range(CODE_LENGTH_CHIPS):
        sel = g2[11 - p1] ^ g2[11 - p2]
        if p3:
            sel ^= g2[11 - p3]
        out[i] = g1[0] ^ sel
        fb1 = g1[0] ^ g1[1] ^ g1[2] ^ g1[3] ^ g1[4] ^ g1[10]
        fb2 = (g2[0] ^ g2[2] ^ g2[3] ^ g2[6] ^ g2[7] ^ g2[8]
               ^ g2[9] ^ g2[10])
        g1 = g1[1:] + [fb1]
        g2 = g2[1:] + [fb2]
    return tuple(out.tolist())


def beidou_b1i_code(prn: int) -> np.ndarray:
    """B1I chip levels (+-1, bit 1 -> +1 as the reference emits)."""
    bits = np.asarray(_b1i_bits(prn), dtype=np.int8)
    return (2.0 * bits - 1.0).astype(np.float64)


def beidou_b1i_code_table(num_prns: int = NUM_PRNS) -> np.ndarray:
    return np.stack([
        beidou_b1i_code(p).astype(np.float32) for p in range(1, num_prns + 1)
    ])


def nh20_levels() -> np.ndarray:
    from gnss_sdr_tpu_torch.constants.beidou_b1i import NH20

    return 1.0 - 2.0 * np.asarray(NH20, dtype=np.float64)
