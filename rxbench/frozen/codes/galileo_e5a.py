# Frozen copy of gnss_sdr_tpu_torch/codes/galileo_e5a.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/codes/galileo_e5a.py; only the package imports are
# rewritten, and what the benchmark never calls is left out (the docstring is the original's).
"""Galileo E5a spreading codes: E5a-I (data) + E5a-Q (pilot) primaries and
the CS20/CS100 secondary codes.

The E5a primary codes are published memory-code tables (Galileo OS SIS ICD
Annex C), bundled as packed bits in ``data/galileo_e5a_codes.npz`` (50 PRNs
x 10230 chips each component; the reference carries the same ICD tables in
src/core/system_parameters/Galileo_E5a.h:72,1827). Extraction script:
tools/extract_e5a_codes.py. The pilot CS100 secondaries are per-SV
(ICD Table 19; only 47 are assigned); the data CS20 is one shared sequence.

E5a is QPSK at baseband: data on I, pilot on Q (after the receiver's pilot
PLL locks the pilot to the real axis the data symbols appear on the
quadrature axis, as in the reference's Prompt_Q symbol extraction,
gps_l5_telemetry_decoder_gs.cc:213 for the analogous L5 layout).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from rxbench.frozen.constants.galileo_e5a import (
    CODE_LENGTH_CHIPS,
    E5AI_SECONDARY,
)

_DATA = Path(__file__).parent / "data" / "galileo_e5a_codes.npz"

NUM_CODES = 50
NUM_PILOT_SECONDARIES = 47  # CS100 assigned PRNs


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    z = np.load(_DATA)
    out = {}
    for key in ("e5ai", "e5aq"):
        bits = np.unpackbits(z[key], axis=1)[:, :CODE_LENGTH_CHIPS]
        out[key] = (1 - 2 * bits.astype(np.int8)).astype(np.int8)
    out["sec_q"] = (1 - 2 * z["sec_q"].astype(np.int8)).astype(np.float32)
    return out


def galileo_e5ai_code(prn: int) -> np.ndarray:
    """E5a-I (data) primary chips in {+1,-1}, PRN 1..50."""
    if not 1 <= prn <= NUM_CODES:
        raise ValueError(f"Galileo PRN must be in 1..50, got {prn}")
    return _load()["e5ai"][prn - 1]


def galileo_e5aq_code(prn: int) -> np.ndarray:
    """E5a-Q (pilot) primary chips in {+1,-1}, PRN 1..50."""
    if not 1 <= prn <= NUM_CODES:
        raise ValueError(f"Galileo PRN must be in 1..50, got {prn}")
    return _load()["e5aq"][prn - 1]


def e5ai_secondary_levels() -> np.ndarray:
    """CS20 data secondary in {+1,-1} (shared by all SVs)."""
    bits = np.array([int(c) for c in E5AI_SECONDARY], dtype=np.int8)
    return (1 - 2 * bits).astype(np.float32)


def e5aq_secondary_levels(prn: int) -> np.ndarray:
    """CS100 pilot secondary in {+1,-1} for PRN 1..47."""
    if not 1 <= prn <= NUM_PILOT_SECONDARIES:
        raise ValueError(
            f"E5a-Q secondary assigned for PRN 1..{NUM_PILOT_SECONDARIES}, "
            f"got {prn}"
        )
    return _load()["sec_q"][prn - 1]
