# Copied from gnss_sdr_tpu/codes/galileo_e5b.py; only the package imports are rewritten.
"""Galileo E5b spreading codes: E5b-I (data) + E5b-Q (pilot) primaries and
the CS4/CS100 secondary codes.

The E5b primary codes are published memory-code tables (Galileo OS SIS ICD
Annex C), bundled as packed bits in ``data/galileo_e5b_codes.npz`` (50 PRNs
x 10230 chips each component; the reference carries the same ICD tables in
src/core/system_parameters/Galileo_E5b.h). Extraction script:
tools/extract_e5b_codes.py. The pilot CS100 secondaries are per-SV
(ICD Table 20); the data CS4 is one shared sequence.

E5b baseband layout mirrors E5a: data on I, pilot on Q.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from gnss_sdr_tpu_torch.constants.galileo_e5b import (
    CODE_LENGTH_CHIPS,
    E5BI_SECONDARY,
)

_DATA = Path(__file__).parent / "data" / "galileo_e5b_codes.npz"

NUM_CODES = 50


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    z = np.load(_DATA)
    out = {}
    for key in ("e5bi", "e5bq"):
        bits = np.unpackbits(z[key], axis=1)[:, :CODE_LENGTH_CHIPS]
        out[key] = (1 - 2 * bits.astype(np.int8)).astype(np.int8)
    out["sec_q"] = (1 - 2 * z["sec_q"].astype(np.int8)).astype(np.float32)
    return out


def galileo_e5bi_code(prn: int) -> np.ndarray:
    """E5b-I (data) primary chips in {+1,-1}, PRN 1..50."""
    if not 1 <= prn <= NUM_CODES:
        raise ValueError(f"Galileo PRN must be in 1..50, got {prn}")
    return _load()["e5bi"][prn - 1]


def galileo_e5bq_code(prn: int) -> np.ndarray:
    """E5b-Q (pilot) primary chips in {+1,-1}, PRN 1..50."""
    if not 1 <= prn <= NUM_CODES:
        raise ValueError(f"Galileo PRN must be in 1..50, got {prn}")
    return _load()["e5bq"][prn - 1]


@functools.lru_cache(maxsize=1)
def galileo_e5bi_code_table() -> np.ndarray:
    """[50, 10230] float32 E5b-I chip levels."""
    return _load()["e5bi"].astype(np.float32)


@functools.lru_cache(maxsize=1)
def galileo_e5bq_code_table() -> np.ndarray:
    """[50, 10230] float32 E5b-Q chip levels."""
    return _load()["e5bq"].astype(np.float32)


def e5bi_secondary_levels() -> np.ndarray:
    """CS4 data secondary in {+1,-1} (shared by all SVs)."""
    bits = np.array([int(c) for c in E5BI_SECONDARY], dtype=np.int8)
    return (1 - 2 * bits).astype(np.float32)


def e5bq_secondary_levels(prn: int) -> np.ndarray:
    """CS100 pilot secondary in {+1,-1} for PRN 1..50."""
    if not 1 <= prn <= NUM_CODES:
        raise ValueError(f"Galileo PRN must be in 1..50, got {prn}")
    return _load()["sec_q"][prn - 1]
