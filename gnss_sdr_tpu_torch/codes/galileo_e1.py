# Copied from gnss_sdr_tpu/codes/galileo_e1.py; only the package imports are rewritten.
"""Galileo E1-B/E1-C spreading codes + CBOC modulation.

The E1 OS primary codes are *memory codes*: 4092-chip pseudo-random
sequences published as hex tables in the Galileo OS SIS ICD Annex C (there
is no generating LFSR). They are bundled here as packed bits in
``data/galileo_e1_codes.npz`` (50 PRNs x 4092 chips for E1-B and E1-C; the
reference carries the same ICD tables in
src/core/system_parameters/Galileo_E1.h:56,760).

Modulation (ICD §2.3.1): E1-B and E1-C are CBOC(6,1,1/11) —
  e1b(t) = c_B(t) * [ a*sc1(t) + b*sc6(t) ]   (data, subcarriers in phase)
  e1c(t) = c_C(t) * [ a*sc1(t) - b*sc6(t) ]   (pilot, BOC(6,1) anti-phase)
with a = sqrt(10/11), b = sqrt(1/11), sc_m = sign(sin(2*pi*m*f_c*t)).
For acquisition/tracking replicas a plain sinBOC(1,1) is the standard
low-loss approximation (~0.4 dB); both are provided.

Reference analog: src/algorithms/libs/galileo_e1_signal_replica.cc
(galileo_e1_code_gen_*, galileo_e1_sinboc_11_gen_int, cboc selection).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from gnss_sdr_tpu_torch.constants.galileo_e1 import (
    CBOC_ALPHA,
    CBOC_BETA,
    CODE_LENGTH_CHIPS,
    CODE_RATE_CPS,
    E1C_SECONDARY_CODE,
)

_DATA = Path(__file__).parent / "data" / "galileo_e1_codes.npz"

NUM_CODES = 50


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    z = np.load(_DATA)
    out = {}
    for key in ("e1b", "e1c"):
        bits = np.unpackbits(z[key], axis=1)[:, :CODE_LENGTH_CHIPS]
        out[key] = (1 - 2 * bits.astype(np.int8)).astype(np.int8)  # 0->+1, 1->-1
    return out


def galileo_e1b_code(prn: int) -> np.ndarray:
    """E1-B (data) primary code chips in {+1,-1}, PRN 1..50."""
    if not 1 <= prn <= NUM_CODES:
        raise ValueError(f"Galileo PRN must be in 1..50, got {prn}")
    return _load()["e1b"][prn - 1]


def galileo_e1c_code(prn: int) -> np.ndarray:
    """E1-C (pilot) primary code chips in {+1,-1}, PRN 1..50."""
    if not 1 <= prn <= NUM_CODES:
        raise ValueError(f"Galileo PRN must be in 1..50, got {prn}")
    return _load()["e1c"][prn - 1]


def e1c_secondary_chips() -> np.ndarray:
    """CS25_1 secondary code chips in {+1,-1} (ICD Table 19)."""
    return np.array([1 - 2 * int(c) for c in E1C_SECONDARY_CODE], dtype=np.int8)


# ----------------------------------------------------------------- subcoded
def sinboc11_expand(chips: np.ndarray) -> np.ndarray:
    """Expand primary chips with the sinBOC(1,1) subcarrier: each chip
    becomes (+c, -c) at 2x chip rate (galileo_e1_sinboc_11_gen_int analog)."""
    return (chips[:, None] * np.array([1, -1], dtype=np.int8)).reshape(-1)


def cboc_expand(chips: np.ndarray, pilot: bool = False) -> np.ndarray:
    """Expand primary chips with the exact CBOC(6,1,1/11) waveform at
    12 sub-chips per chip (float32; the 12-sample LCM grid of the 2- and
    12-phase subcarriers)."""
    sc1 = np.repeat(np.array([1.0, -1.0], dtype=np.float32), 6)   # BOC(1,1)
    sc6 = np.tile(np.array([1.0, -1.0], dtype=np.float32), 6)     # BOC(6,1)
    wave = CBOC_ALPHA * sc1 + (-CBOC_BETA if pilot else CBOC_BETA) * sc6
    return (chips.astype(np.float32)[:, None] * wave[None, :]).reshape(-1)


# ------------------------------------------------------------------- tables
@functools.lru_cache(maxsize=4)
def galileo_e1b_sinboc_table() -> np.ndarray:
    """[50, 8184] float32 sinBOC(1,1)-expanded E1-B codes (table rate
    2*1.023 Mcps). The standard acquisition/tracking replica table."""
    return np.stack(
        [sinboc11_expand(galileo_e1b_code(p)) for p in range(1, NUM_CODES + 1)]
    ).astype(np.float32)


@functools.lru_cache(maxsize=4)
def galileo_e1c_sinboc_table() -> np.ndarray:
    return np.stack(
        [sinboc11_expand(galileo_e1c_code(p)) for p in range(1, NUM_CODES + 1)]
    ).astype(np.float32)


SINBOC_TABLE_RATE_CPS = 2.0 * CODE_RATE_CPS
SINBOC_TABLE_LENGTH = 2 * CODE_LENGTH_CHIPS
CBOC_TABLE_RATE_CPS = 12.0 * CODE_RATE_CPS
CBOC_TABLE_LENGTH = 12 * CODE_LENGTH_CHIPS


def galileo_e1_code_sampled(
    prn: int,
    fs: float,
    num_samples: int | None = None,
    chip_shift: float = 0.0,
    pilot: bool = False,
    cboc: bool = True,
) -> np.ndarray:
    """One code period sampled at fs (nearest sub-chip), CBOC or sinBOC.

    chip_shift is in *primary* chips. Reference analog:
    galileo_e1_code_gen_complex_sampled.
    """
    chips = galileo_e1c_code(prn) if pilot else galileo_e1b_code(prn)
    if cboc:
        sub = cboc_expand(chips, pilot=pilot)
        rate = CBOC_TABLE_RATE_CPS
        shift = chip_shift * 12.0
    else:
        sub = sinboc11_expand(chips).astype(np.float32)
        rate = SINBOC_TABLE_RATE_CPS
        shift = chip_shift * 2.0
    if num_samples is None:
        num_samples = int(round(fs * CODE_LENGTH_CHIPS / CODE_RATE_CPS))
    n = np.arange(num_samples, dtype=np.float64)
    idx = np.floor(n * (rate / fs) + shift).astype(np.int64) % len(sub)
    return sub[idx].astype(np.float32)
