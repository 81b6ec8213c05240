# Copied from gnss_sdr_tpu/codes/galileo_e6.py; only the package imports are rewritten.
"""Galileo E6-B (data) / E6-C (pilot) spreading codes.

Memory codes from the Galileo HAS SIS ICD (5115 chips at 5.115 Mcps, BPSK;
E6-C adds a 100-chip per-PRN secondary). Bundled as packed bits in
``data/galileo_e6_codes.npz`` extracted from the published ICD tables
(tools/extract_e6_codes.py; the reference carries the same constants in
src/core/system_parameters/Galileo_E6.h)."""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from gnss_sdr_tpu_torch.constants.galileo_e6 import CODE_LENGTH_CHIPS, SEC_LEN_C

_DATA = Path(__file__).parent / "data" / "galileo_e6_codes.npz"

NUM_CODES = 50


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    z = np.load(_DATA)
    out = {}
    for key, n in (("e6b", CODE_LENGTH_CHIPS), ("e6c", CODE_LENGTH_CHIPS),
                   ("e6c_sec", SEC_LEN_C)):
        bits = np.unpackbits(z[key], axis=1)[:, :n]
        out[key] = (1 - 2 * bits.astype(np.int8)).astype(np.int8)
    return out


def galileo_e6b_code(prn: int) -> np.ndarray:
    """[5115] chips in {+1,-1}, PRN 1..50."""
    return _load()["e6b"][prn - 1]


def galileo_e6c_code(prn: int) -> np.ndarray:
    return _load()["e6c"][prn - 1]


def galileo_e6c_secondary(prn: int) -> np.ndarray:
    """[100] E6-C secondary chips in {+1,-1}."""
    return _load()["e6c_sec"][prn - 1]


@functools.lru_cache(maxsize=1)
def galileo_e6b_code_table() -> np.ndarray:
    return _load()["e6b"].astype(np.float32)


@functools.lru_cache(maxsize=1)
def galileo_e6c_code_table() -> np.ndarray:
    return _load()["e6c"].astype(np.float32)


@functools.lru_cache(maxsize=1)
def galileo_e6c_secondary_table() -> np.ndarray:
    return _load()["e6c_sec"].astype(np.float32)
