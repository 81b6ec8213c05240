# Copied from gnss_sdr_tpu/telemetry/fec.py; only the package imports are rewritten.
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


def viterbi_decode(
    symbols: np.ndarray,
    invert_g2: bool = True,
    soft: bool = False,
    start_state: int | None = 0,
    end_state: int | None = 0,
) -> np.ndarray:
    """Viterbi decode rate-1/2 K=7.

    symbols: [2N] hard bits (0/1) or soft values in [-1,1] (soft=True,
    +1 <=> bit 0). Returns N decoded bits (including any tail bits).
    start_state/end_state: register state constraints; None = free
    (all-equal initial metrics / traceback from the best final state) for
    continuously-encoded streams like GPS CNAV, where a message is decoded
    out of a longer symbol window (reference analog: libswiftcnav
    cnav_msg_decoder's running decoder).
    """
    sym = np.asarray(symbols, dtype=np.float64)
    if not soft:
        sym = 1.0 - 2.0 * sym   # bit 0 -> +1, bit 1 -> -1
    # native C++ trellis when built (native/sdr_kernels.cpp viterbi27 —
    # the libswiftcnav viterbi27.c analog); NumPy fallback below is
    # bit-identical (tests/test_native.py)
    from gnss_sdr_tpu_torch import native as _native

    nat = _native.viterbi27(sym, invert_g2, start_state, end_state)
    if nat is not None:
        return nat
    n = len(sym) // 2
    n_states = 64

    # branch outputs for (state, input): 7-bit word = (b<<6)|state (newest
    # at MSB, matching conv_encode); next state = word >> 1
    states = np.arange(n_states)
    exp_g1 = np.empty((n_states, 2))
    exp_g2 = np.empty((n_states, 2))
    for b in (0, 1):
        reg = ((b << 6) | states) & 0x7F
        exp_g1[:, b] = 1.0 - 2.0 * _parity6(reg & G1)
        g2v = _parity6(reg & G2) ^ (1 if invert_g2 else 0)
        exp_g2[:, b] = 1.0 - 2.0 * g2v
    next_state = (
        (np.array([0, 1])[None, :] << 5) | (states[:, None] >> 1)
    ) & 0x3F

    if start_state is None:
        metric = np.zeros(n_states)
    else:
        metric = np.full(n_states, -1e18)
        metric[start_state] = 0.0
    decisions = np.zeros((n, n_states), dtype=np.uint8)   # surviving input bit
    prev_of = np.zeros((n, n_states), dtype=np.uint8)     # surviving prev state

    for k in range(n):
        bm = exp_g1 * sym[2 * k] + exp_g2 * sym[2 * k + 1]   # [S, 2]
        cand = metric[:, None] + bm                          # [S, 2]
        new_metric = np.full(n_states, -1e18)
        new_prev = np.zeros(n_states, dtype=np.uint8)
        new_bit = np.zeros(n_states, dtype=np.uint8)
        flat = cand.ravel()
        targets = next_state.ravel()
        order = np.argsort(flat, kind="stable")             # ascending
        new_metric[targets[order]] = flat[order]            # max wins (last)
        src = np.repeat(states, 2)[order]
        bit = np.tile([0, 1], n_states)[order]
        new_prev[targets[order]] = src
        new_bit[targets[order]] = bit
        metric = new_metric
        prev_of[k] = new_prev
        decisions[k] = new_bit

    # traceback
    out = np.empty(n, dtype=np.uint8)
    s = int(np.argmax(metric)) if end_state is None else end_state
    for k in range(n - 1, -1, -1):
        out[k] = decisions[k, s]
        s = prev_of[k, s]
    return out


# -------------------------------------------------------------- interleaver
def block_interleave(x: np.ndarray, cols: int = 30, rows: int = 8) -> np.ndarray:
    """Write column-by-column, read row-by-row (Galileo INAV §4.1.4.2)."""
    return np.asarray(x).reshape(cols, rows).T.reshape(-1)


def block_deinterleave(y: np.ndarray, cols: int = 30, rows: int = 8) -> np.ndarray:
    return np.asarray(y).reshape(rows, cols).T.reshape(-1)
