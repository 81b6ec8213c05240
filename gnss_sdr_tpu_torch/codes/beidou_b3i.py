# Copied from gnss_sdr_tpu/codes/beidou_b3i.py; only the package imports are rewritten.
"""BeiDou B3I ranging codes (BDS-SIS-ICD-B3I-1.0 §5.2.2).

Two 13-stage LFSRs clocked at 10.23 Mcps and truncated at 10230 chips:
G1 with feedback taps 1,3,4,13 (self-resetting to all-ones when it reaches
the published short-cycle state) and G2 with taps 1,2,4,5,7,8,9,13; the
B3I code for a PRN is G1 XOR G2 where G2 starts from a PRN-specific
initial phase (ICD Table 5-5, carried by the reference in
src/algorithms/libs/beidou_b3i_signal_replica.cc G2_register_shifted,
extracted by tools/extract_l2c_b3i_tables.py as 13-bit integers with the
ICD's leftmost bit at bit 12).

Register convention here: index 0 is the output stage (matches the
reference's bitset layout where bit 0 of the 13-bit word is the output).
Validated bit-exact against the reference generator by
tests/test_reference_oracle.py.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from gnss_sdr_tpu_torch.constants.beidou_b3i import CODE_LENGTH_CHIPS

_DATA = Path(__file__).parent / "data" / "l2c_b3i_tables.npz"

NUM_PRNS = 37          # tracked set: MEO/IGSO + GEO assignments 1..37

# G1 short-cycle reset trigger: all ones except stages 0 and 1
_G1_RESET = (1 << 13) - 1 - 0b11
_ALL_ONES = (1 << 13) - 1


@functools.lru_cache(maxsize=1)
def _g2_inits() -> np.ndarray:
    return np.load(_DATA)["b3i_g2_init"]


@functools.lru_cache(maxsize=None)
def _b3i_bits(prn: int) -> tuple:
    inits = _g2_inits()
    if not 1 <= prn <= len(inits):
        raise ValueError(f"B3I PRN must be 1..{len(inits)}, got {prn}")
    g1 = _ALL_ONES
    g2 = int(inits[prn - 1])
    out = np.empty(CODE_LENGTH_CHIPS, dtype=np.int8)
    for i in range(CODE_LENGTH_CHIPS):
        out[i] = (g1 ^ g2) & 1
        fb1 = ((g1 >> 0) ^ (g1 >> 9) ^ (g1 >> 10) ^ (g1 >> 12)) & 1
        fb2 = ((g2 >> 0) ^ (g2 >> 1) ^ (g2 >> 3) ^ (g2 >> 4)
               ^ (g2 >> 6) ^ (g2 >> 7) ^ (g2 >> 8) ^ (g2 >> 12)) & 1
        g1 = (g1 >> 1) | (fb1 << 12)
        g2 = (g2 >> 1) | (fb2 << 12)
        if g1 == _G1_RESET:
            g1 = _ALL_ONES
    return tuple(out.tolist())


def beidou_b3i_code(prn: int) -> np.ndarray:
    """B3I chip levels (+-1, bit 1 -> +1 as the reference emits)."""
    bits = np.asarray(_b3i_bits(prn), dtype=np.int8)
    return (2.0 * bits - 1.0).astype(np.float64)


def beidou_b3i_code_table(num_prns: int = NUM_PRNS) -> np.ndarray:
    return np.stack([
        beidou_b3i_code(p).astype(np.float32) for p in range(1, num_prns + 1)
    ])
