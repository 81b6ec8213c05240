# Copied from gnss_sdr_tpu/constants/gps_l5.py; only the package imports are rewritten.
"""GPS L5 signal constants (IS-GPS-705; reference analog:
src/core/system_parameters/GPS_L5.h)."""

FREQ_HZ = 1176.45e6               # L5 carrier
CODE_RATE_CPS = 10.23e6           # L5I/L5Q chipping rate
CODE_LENGTH_CHIPS = 10230         # primary code length (1 ms)
CODE_PERIOD_S = 1e-3

# Neuman-Hofman secondary codes (IS-GPS-705 §3.2.2): NH10 on the data
# component (one 10 ms data symbol long), NH20 on the pilot
NH10 = (0, 0, 0, 0, 1, 1, 0, 1, 0, 1)
NH20 = (0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0)

SYMBOL_RATE_SPS = 100.0           # CNAV symbols/s (50 bps rate-1/2 coded)
CODES_PER_SYMBOL = 10             # 10 x 1 ms primary periods per symbol
