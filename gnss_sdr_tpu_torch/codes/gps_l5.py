# Copied from gnss_sdr_tpu/codes/gps_l5.py; only the package imports are rewritten.
"""GPS L5 spreading codes: L5I (data) and L5Q (pilot), IS-GPS-705.

Each code is the XOR of two 13-stage LFSR sequences (ICD §3.2.1.1):

- XA: taps at stages 9, 10, 12, 13 (polynomial 1 + x^9 + x^10 + x^12 +
  x^13), short-cycled to 8190 chips by restarting to all-ones one chip
  before its natural 8191 cycle;
- XB: taps at stages 1, 3, 4, 6, 7, 8, 12, 13, free-running (8191 period,
  allowed to run past it to the 10230-chip code length);
- per-PRN codes select a cyclic advance of the XB sequence within the
  10230-chip window (ICD Table 3-I "XB code advance"); the advance tables
  below are those published constants.

Both components use the same LFSR structure with different XB advances.

Reference analog: src/algorithms/libs/gps_l5_signal_replica.cc
(l5i_xa_shift/l5i_xb_shift/make_l5i/make_l5q); validated bit-exact against
it in tests/test_codes.py (md5 over PRNs 1..37 of both components).
"""

from __future__ import annotations

import functools

import numpy as np

from gnss_sdr_tpu_torch.constants.gps_l5 import CODE_LENGTH_CHIPS, NH10, NH20

NUM_CODES = 37  # PRNs 1..37 (ICD defines more for QZSS/SBAS expansions)

# XB code advance per PRN (IS-GPS-705 Table 3-I), PRNs 1..37
_L5I_XB_ADVANCE = (
    266, 365, 804, 1138, 1509, 1559, 1756, 2084, 2170, 2303, 2527, 2687,
    2930, 3471, 3940, 4132, 4332, 4924, 5343, 5443, 5641, 5816, 5898, 5918,
    5955, 6243, 6345, 6477, 6518, 6875, 7168, 7187, 7329, 7577, 7720, 7777,
    8057,
)
_L5Q_XB_ADVANCE = (
    1701, 323, 5292, 2020, 5429, 7136, 1041, 5947, 4315, 148, 535, 1939,
    5206, 5910, 3595, 5135, 6082, 6990, 3546, 1523, 4548, 4484, 1893, 3961,
    7106, 5299, 4660, 276, 4389, 3783, 1591, 1601, 749, 1387, 1661, 3210,
    708,
)


def _run_xa() -> np.ndarray:
    """XA sequence over 10230 chips (chips in {0,1}).

    State s[0..12], output s[12], shift-in feedback at s[0]; feedback =
    s[12]^s[11]^s[9]^s[8]. Restarts to all-ones from the state reached one
    chip before the natural m-sequence cycle (the ICD's 8190 short cycle).
    """
    restart = (1,) * 11 + (0, 1)
    s = [1] * 13
    out = np.empty(CODE_LENGTH_CHIPS, dtype=np.uint8)
    for n in range(CODE_LENGTH_CHIPS):
        out[n] = s[12]
        if tuple(s) == restart:
            s = [1] * 13
        else:
            fb = s[12] ^ s[11] ^ s[9] ^ s[8]
            s = [fb] + s[:12]
    return out


def _run_xb() -> np.ndarray:
    """Free-running XB sequence over 10230 chips (chips in {0,1});
    feedback = s[12]^s[11]^s[7]^s[6]^s[5]^s[3]^s[2]^s[0]."""
    s = [1] * 13
    out = np.empty(CODE_LENGTH_CHIPS, dtype=np.uint8)
    for n in range(CODE_LENGTH_CHIPS):
        out[n] = s[12]
        fb = s[12] ^ s[11] ^ s[7] ^ s[6] ^ s[5] ^ s[3] ^ s[2] ^ s[0]
        s = [fb] + s[:12]
    return out


@functools.lru_cache(maxsize=2)
def _code_table_bits(component: str) -> np.ndarray:
    """[NUM_CODES, 10230] chips in {0,1} for 'I' or 'Q'."""
    adv = _L5I_XB_ADVANCE if component == "I" else _L5Q_XB_ADVANCE
    xa = _run_xa().astype(np.uint8)
    xb = _run_xb().astype(np.uint8)
    rows = [xa ^ np.roll(xb, -a) for a in adv]
    return np.stack(rows)


def gps_l5i_code(prn: int) -> np.ndarray:
    """L5I (data) chips in {+1,-1}, PRN 1..37."""
    if not 1 <= prn <= NUM_CODES:
        raise ValueError(f"L5 PRN must be in 1..{NUM_CODES}, got {prn}")
    return (1 - 2 * _code_table_bits("I")[prn - 1].astype(np.int8)).astype(np.int8)


def gps_l5q_code(prn: int) -> np.ndarray:
    """L5Q (pilot) chips in {+1,-1}, PRN 1..37."""
    if not 1 <= prn <= NUM_CODES:
        raise ValueError(f"L5 PRN must be in 1..{NUM_CODES}, got {prn}")
    return (1 - 2 * _code_table_bits("Q")[prn - 1].astype(np.int8)).astype(np.int8)


@functools.lru_cache(maxsize=1)
def gps_l5i_code_table() -> np.ndarray:
    """[37, 10230] float32 L5I chip levels for the batched engines."""
    return (1.0 - 2.0 * _code_table_bits("I").astype(np.float32))


@functools.lru_cache(maxsize=1)
def gps_l5q_code_table() -> np.ndarray:
    """[37, 10230] float32 L5Q chip levels for the batched engines."""
    return (1.0 - 2.0 * _code_table_bits("Q").astype(np.float32))


# QZSS L5 XB initial register states, PRN 193..202 (IS-QZSS-PNT Table
# 3.2.5-1; reference qzss_signal_replica.cc qzss_l5_table). The QZSS codes
# are specified by XB *initial state* (stage 1 first) rather than by the
# GPS-style code advance.
_QZSS_L5I_XB_INIT = {
    193: 0b0110000101110, 194: 0b0110010011111, 195: 0b1000111001100,
    196: 0b0111101110001, 197: 0b0011111100001, 198: 0b0000001110001,
    199: 0b1010110100100, 200: 0b0100001110110, 201: 0b0111110100011,
    202: 0b0001111001011,
}
_QZSS_L5Q_XB_INIT = {
    193: 0b1001110000111, 194: 0b0110100111010, 195: 0b0110001100110,
    196: 0b0000100001100, 197: 0b0101000101101, 198: 0b1000001010111,
    199: 0b0011001110001, 200: 0b0100011100110, 201: 0b0100101100101,
    202: 0b1110001010111,
}


def _run_xb_from(init13: int) -> np.ndarray:
    """Free-running XB from a 13-bit initial state (MSB = stage 1)."""
    s = [(init13 >> (12 - i)) & 1 for i in range(13)]
    out = np.empty(CODE_LENGTH_CHIPS, dtype=np.uint8)
    for n in range(CODE_LENGTH_CHIPS):
        out[n] = s[12]
        fb = s[12] ^ s[11] ^ s[7] ^ s[6] ^ s[5] ^ s[3] ^ s[2] ^ s[0]
        s = [fb] + s[:12]
    return out


def qzss_l5i_code(prn: int) -> np.ndarray:
    """QZSS L5I chips in {+1,-1}, PRN 193..202."""
    bits = _run_xa() ^ _run_xb_from(_QZSS_L5I_XB_INIT[prn])
    return (1 - 2 * bits.astype(np.int8)).astype(np.int8)


def qzss_l5q_code(prn: int) -> np.ndarray:
    """QZSS L5Q chips in {+1,-1}, PRN 193..202."""
    bits = _run_xa() ^ _run_xb_from(_QZSS_L5Q_XB_INIT[prn])
    return (1 - 2 * bits.astype(np.int8)).astype(np.int8)


def nh10_levels() -> np.ndarray:
    """NH10 data-component secondary code in {+1,-1}."""
    return (1 - 2 * np.asarray(NH10, dtype=np.int8)).astype(np.float32)


def nh20_levels() -> np.ndarray:
    """NH20 pilot-component secondary code in {+1,-1}."""
    return (1 - 2 * np.asarray(NH20, dtype=np.int8)).astype(np.float32)
