# Copied from gnss_sdr_tpu/codes/glonass_ca.py; only the package imports are rewritten.
"""GLONASS C/A ranging code (reference: glonass_l1_signal_replica.cc).

One 511-chip maximum-length sequence shared by every satellite: 9-stage
shift register (polynomial x^9 + x^5 + 1), all-ones initial state, output
from stage 3 (register index 2 counting from the input end, matching the
reference's G1_register[2] tap). Chip levels are +-1 floats (bit 1 -> +1).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from gnss_sdr_tpu_torch.constants.glonass_l1 import CODE_LENGTH_CHIPS, SLOT_TO_K


@lru_cache(maxsize=1)
def glonass_ca_code() -> np.ndarray:
    """[511] chip levels (+-1, float32)."""
    reg = [1] * 9
    chips = np.empty(CODE_LENGTH_CHIPS, dtype=np.float32)
    for i in range(CODE_LENGTH_CHIPS):
        chips[i] = 1.0 if reg[2] else -1.0
        fb = reg[4] ^ reg[0]
        reg = reg[1:] + [fb]
    return chips


@lru_cache(maxsize=1)
def glonass_ca_code_table() -> np.ndarray:
    """[24, 511] code table: identical rows (FDMA — the carrier offset
    distinguishes slots), one row per orbital slot so the engines' per-row
    frequency-offset tables line up with PRN rows."""
    return np.tile(glonass_ca_code()[None, :], (24, 1))


def slot_freq_offsets_hz() -> np.ndarray:
    """[24] baseband FDMA carrier offset per table row (slot - 1)."""
    from gnss_sdr_tpu_torch.constants.glonass_l1 import DFREQ_HZ

    return np.array(
        [SLOT_TO_K[s] * DFREQ_HZ for s in range(1, 25)], dtype=np.float64
    )
