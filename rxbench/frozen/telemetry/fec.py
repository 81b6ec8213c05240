# Frozen copy of gnss_sdr_tpu_torch/telemetry/fec.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/telemetry/fec.py; only the package imports are
# rewritten, and what the benchmark never calls is left out (the docstring is the original's).
"""Channel-coding toolkit shared by telemetry codecs: CRC-24Q,
rate-1/2 K=7 convolutional code (encode + Viterbi decode), block
interleaving.

Reference analogs: telemetry_decoder/libs/viterbi_decoder.cc:21-123 (the
Galileo INAV/FNAV Viterbi), libswiftcnav edc.c (CRC-24Q),
core/system_parameters/reed_solomon.cc is covered separately. Bit-exact
behavior required (SURVEY.md §2.3); the Viterbi here is a vectorized NumPy
trellis (all 64 states updated per symbol via array ops, traceback over the
stored decision matrix) — telemetry runs at 250 sym/s per channel, host-side
per SURVEY.md §7.
"""

from __future__ import annotations

import numpy as np

# ------------------------------------------------------------------ CRC-24Q
_CRC24Q_POLY = 0x1864CFB


def _crc24q_table() -> np.ndarray:
    tbl = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24Q_POLY
        tbl[i] = crc & 0xFFFFFF
    return tbl


_CRC_TBL = _crc24q_table()


def crc24q(bits: np.ndarray) -> int:
    """CRC-24Q over an MSB-first bit array (zero-padded to bytes on the
    left, per RTCM/Galileo convention)."""
    bits = np.asarray(bits, dtype=np.uint8)
    pad = (-len(bits)) % 8
    padded = np.concatenate([np.zeros(pad, dtype=np.uint8), bits])
    crc = 0
    for byte in np.packbits(padded):
        crc = ((crc << 8) & 0xFFFFFF) ^ int(_CRC_TBL[((crc >> 16) ^ byte) & 0xFF])
    return crc


# ------------------------------------------------- convolutional code (K=7)
G1 = 0o171  # 1+D+D^2+D^3+D^6 with the newest input at the register MSB
G2 = 0o133  # 1+D^2+D^3+D^5+D^6


def _parity6(x: np.ndarray) -> np.ndarray:
    x = x & 0x7F
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return x & 1


def conv_encode(bits: np.ndarray, invert_g2: bool = True) -> np.ndarray:
    """Rate-1/2 K=7 convolutional encoder, newest input at register MSB.

    Polynomials G1=0o171, G2=0o133 with the 7-bit word built as
    ``(input << 6) | state`` and ``state = word >> 1`` — the ICD convention
    (1+D+D^2+D^3+D^6, 1+D^2+D^3+D^5+D^6; reference viterbi_decoder.cc
    builds its trellis the same way). Galileo transmits the second branch
    inverted (invert_g2=True, ICD §4.1.4.1); GPS CNAV/SBAS use the plain
    code (invert_g2=False). Input must include the 6 tail zeros if
    frame-terminated output is wanted. Output: interleaved
    [g1_0, g2_0, g1_1, g2_1, ...].
    """
    bits = np.asarray(bits, dtype=np.int64)
    n = len(bits)
    s = 0  # 6-bit register of the previous inputs, newest at bit 5
    out = np.empty(2 * n, dtype=np.uint8)
    for k in range(n):
        word = ((int(bits[k]) << 6) | s) & 0x7F
        out[2 * k] = _parity6(np.int64(word & G1))
        out[2 * k + 1] = _parity6(np.int64(word & G2)) ^ (1 if invert_g2 else 0)
        s = word >> 1
    return out


# -------------------------------------------------------------- interleaver
def block_interleave(x: np.ndarray, cols: int = 30, rows: int = 8) -> np.ndarray:
    """Write column-by-column, read row-by-row (Galileo INAV §4.1.4.2)."""
    return np.asarray(x).reshape(cols, rows).T.reshape(-1)
