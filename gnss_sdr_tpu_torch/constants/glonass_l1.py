# Copied from gnss_sdr_tpu/constants/glonass_l1.py; only the package imports are rewritten.
"""GLONASS L1 C/A constants (reference: GLONASS_L1_L2_CA.h).

FDMA: each satellite slot transmits at 1602 MHz + k * 562.5 kHz with
frequency channel k in [-7, +6]; all satellites share the same 511-chip
ranging code (unlike CDMA systems, the carrier — not the code —
distinguishes satellites).
"""

FREQ_HZ = 1.602e9               # L1 band center (k = 0)
DFREQ_HZ = 562500.0             # FDMA channel spacing
CODE_RATE_CPS = 0.511e6
CODE_LENGTH_CHIPS = 511
CODE_PERIOD_S = 1e-3
SYMBOL_PERIOD_S = 0.01          # 100 sps meander/bi-binary chip (10 periods)
CODES_PER_SYMBOL = 10           # code periods per 10 ms telemetry symbol
SYMBOLS_PER_STRING = 200        # 30 time-mark + 170 bi-binary, at 10 ms
STRING_PERIOD_S = 2.0
GLONASS_TO_UTC_S = 3 * 3600     # GLONASS time = UTC(SU) + 3 h

# Orbital-slot -> frequency-channel assignment (GLONASS_L1_L2_CA.h
# GLONASS_PRN map; the operational constellation's k per slot 1..24 —
# antipodal slot pairs share k)
SLOT_TO_K = {
    1: 1, 2: -4, 3: 5, 4: 6, 5: 1, 6: -4, 7: 5, 8: 6,
    9: -2, 10: -7, 11: 0, 12: -1, 13: -2, 14: -7, 15: 0, 16: -1,
    17: 4, 18: -3, 19: 3, 20: 2, 21: 4, 22: -3, 23: 3, 24: 2,
}


def channel_freq_hz(slot: int) -> float:
    """Actual L1 carrier of an orbital slot."""
    return FREQ_HZ + SLOT_TO_K[slot] * DFREQ_HZ
