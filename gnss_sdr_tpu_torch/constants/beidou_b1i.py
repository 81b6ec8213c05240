# Copied from gnss_sdr_tpu/constants/beidou_b1i.py; only the package imports are rewritten.
"""BeiDou B1I signal constants (BDS-SIS-ICD-2.1; reference analog:
src/core/system_parameters/Beidou_B1I.h)."""

FREQ_HZ = 1561.098e6              # B1I carrier
CODE_RATE_CPS = 2.046e6           # B1I chipping rate
CODE_LENGTH_CHIPS = 2046          # primary code length (1 ms)
CODE_PERIOD_S = 1e-3

# Neuman-Hofman NH(20) secondary on MEO/IGSO D1 signals (one 20 ms nav
# bit long; GEO D2 satellites, PRN 1-5, carry no NH)
NH20 = (0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0)

BIT_RATE_BPS = 50.0               # D1 nav bits/s
CODES_PER_BIT = 20                # 20 x 1 ms periods per D1 bit

# BDT starts 2006-01-01 UTC; BDT = GPST - 14 s (constant; both are
# continuous timescales). Internal timelines are GPS time everywhere.
BDT_TO_GPST_S = 14.0
