# Copied from gnss_sdr_tpu/constants/galileo_e6.py; only the package imports are rewritten.
"""Galileo E6-B/C constants (reference: Galileo_E6.h, Galileo_CNAV.h)."""

FREQ_HZ = 1278.75e6
CODE_RATE_CPS = 5.115e6
CODE_LENGTH_CHIPS = 5115
CODE_PERIOD_S = 1e-3
SYMBOL_RATE_SPS = 1000.0
SEC_LEN_C = 100                  # E6-C pilot secondary (per PRN)

# CNAV/HAS page structure (HAS SIS ICD 1.0 Tables 4-6)
SYMBOLS_PER_PAGE = 1000
SYNC_PATTERN = "1011011101110000"
INTERLEAVER_COLS = 123
INTERLEAVER_ROWS = 8
PAGE_DATA_BITS = 448
PAGE_RESERVED_BITS = 14
BITS_FOR_CRC = PAGE_DATA_BITS + PAGE_RESERVED_BITS   # 462
