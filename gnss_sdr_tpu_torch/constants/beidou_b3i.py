# Copied from gnss_sdr_tpu/constants/beidou_b3i.py; only the package imports are rewritten.
"""BeiDou B3I signal constants (BDS-SIS-ICD-B3I-1.0; reference analog:
src/core/system_parameters/Beidou_B3I.h)."""

FREQ_HZ = 1268.52e6               # B3 carrier
CODE_RATE_CPS = 10.23e6           # B3I chipping rate
CODE_LENGTH_CHIPS = 10230         # primary code length (1 ms)
CODE_PERIOD_S = 1e-3

# D1 NAV on MEO/IGSO: 50 bps with the NH(20) secondary, identical framing
# to B1I (shared with constants/beidou_b1i.py)
SYMBOL_RATE_SPS = 50.0
CODES_PER_BIT = 20
