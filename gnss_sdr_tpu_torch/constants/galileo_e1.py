# Copied from gnss_sdr_tpu/constants/galileo_e1.py; only the package imports are rewritten.
"""Galileo E1 OS signal constants.

Values from the Galileo OS SIS ICD (public); the reference keeps the same
set in src/core/system_parameters/Galileo_E1.h.
"""

FREQ_HZ = 1_575_420_000.0          # E1 carrier frequency [Hz] (same as GPS L1)
CODE_RATE_CPS = 1_023_000.0        # E1-B/C primary code chipping rate [chips/s]
CODE_LENGTH_CHIPS = 4092           # E1-B/C primary code period [chips]
CODE_PERIOD_S = CODE_LENGTH_CHIPS / CODE_RATE_CPS   # 4 ms
CODE_PERIOD_MS = 4.0

# CBOC(6,1,1/11) modulation parameters
CBOC_ALPHA = (10.0 / 11.0) ** 0.5  # weight of BOC(1,1) component
CBOC_BETA = (1.0 / 11.0) ** 0.5    # weight of BOC(6,1) component

# E1-C secondary code (CS25_1), 25 chips, from OS SIS ICD Table 19
E1C_SECONDARY_CODE = "0011100000001010110110010"

# I/NAV
SYMBOL_RATE_SPS = 250              # E1-B symbol rate [symbols/s]
PAGE_SYMBOLS = 250                 # nominal page part duration: 1 s
