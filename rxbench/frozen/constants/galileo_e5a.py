# Frozen copy of gnss_sdr_tpu_torch/constants/galileo_e5a.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/constants/galileo_e5a.py; only the package imports are rewritten.
"""Galileo E5a signal constants (Galileo OS SIS ICD; reference analog:
src/core/system_parameters/Galileo_E5a.h)."""

FREQ_HZ = 1176.45e6               # E5a carrier (same band as GPS L5)
CODE_RATE_CPS = 10.23e6           # E5a-I/Q chipping rate
CODE_LENGTH_CHIPS = 10230         # primary code length (1 ms)
CODE_PERIOD_S = 1e-3

# E5a-I (data) secondary code CS20_1, common to all SVs (ICD §3.8.2); one
# 20 ms FNAV symbol long. E5a-Q (pilot) secondaries are per-SV CS100
# sequences bundled with the primary code tables.
E5AI_SECONDARY = "10000100001011101001"

SYMBOL_RATE_SPS = 50.0            # FNAV symbols/s (25 bps rate-1/2 coded)
CODES_PER_SYMBOL = 20             # 20 x 1 ms primary periods per symbol
