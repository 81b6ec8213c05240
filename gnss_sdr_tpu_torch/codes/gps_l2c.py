# Copied from gnss_sdr_tpu/codes/gps_l2c.py; only the package imports are rewritten.
"""GPS L2 CM ranging codes (IS-GPS-200 §3.3.3.2).

The CM code is a 27-stage modular (Galois) LFSR with the end-shortened
polynomial 0112225171 (octal), reset every 10230 chips; each PRN starts
from a published initial state (IS-GPS-200 Table 3-IIa, carried by the
reference in src/core/system_parameters/GPS_L2C.h GPS_L2C_M_INIT_REG,
extracted by tools/extract_l2c_b3i_tables.py). The chip is the register
LSB; the Galois step is x = (x >> 1) ^ ((x & 1) * 0445112474)
(reference analog: src/algorithms/libs/gps_l2c_signal_replica.cc:25,
validated bit-exact by tests/test_reference_oracle.py).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from gnss_sdr_tpu_torch.constants.gps_l2c import CODE_LENGTH_CHIPS

_DATA = Path(__file__).parent / "data" / "l2c_b3i_tables.npz"

_POLY = 0o445112474
NUM_CODES = 50


@functools.lru_cache(maxsize=1)
def _init_regs() -> np.ndarray:
    return np.load(_DATA)["l2cm_init"]


def gps_l2cm_code(prn: int) -> np.ndarray:
    """L2 CM chip levels in {+1,-1} (bit 0 -> +1), PRN 1..50."""
    regs = _init_regs()
    if not 1 <= prn <= min(NUM_CODES, len(regs)):
        raise ValueError(f"L2C PRN must be 1..{NUM_CODES}, got {prn}")
    x = int(regs[prn - 1])
    chips = np.empty(CODE_LENGTH_CHIPS, dtype=np.int8)
    for n in range(CODE_LENGTH_CHIPS):
        chips[n] = x & 1
        x = (x >> 1) ^ ((x & 1) * _POLY)
    return (1 - 2 * chips).astype(np.float64)


@functools.lru_cache(maxsize=1)
def gps_l2cm_code_table(num_prns: int = 32) -> np.ndarray:
    """[P, 10230] float32 CM chip levels for PRNs 1..num_prns."""
    return np.stack([
        gps_l2cm_code(p).astype(np.float32) for p in range(1, num_prns + 1)
    ])
