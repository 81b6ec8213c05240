# Copied from gnss_sdr_tpu/constants/galileo_e5b.py; only the package imports are rewritten.
"""Galileo E5b signal constants (Galileo OS SIS ICD; reference analog:
src/core/system_parameters/Galileo_E5b.h)."""

FREQ_HZ = 1207.14e6               # E5b carrier
CODE_RATE_CPS = 10.23e6           # E5b-I/Q chipping rate
CODE_LENGTH_CHIPS = 10230         # primary code length (1 ms)
CODE_PERIOD_S = 1e-3

# E5b-I (data) secondary code CS4, common to all SVs (ICD §3.8.2); one
# 4 ms I/NAV symbol long. E5b-Q (pilot) secondaries are per-SV CS100
# sequences bundled with the primary code tables.
E5BI_SECONDARY = "1110"

SYMBOL_RATE_SPS = 250.0           # I/NAV symbols/s (125 bps rate-1/2 coded)
CODES_PER_SYMBOL = 4              # 4 x 1 ms primary periods per symbol
