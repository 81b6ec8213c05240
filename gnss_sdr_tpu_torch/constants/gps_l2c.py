# Copied from gnss_sdr_tpu/constants/gps_l2c.py; only the package imports are rewritten.
"""GPS L2C signal constants (IS-GPS-200 §3.3.3; reference analog:
src/core/system_parameters/GPS_L2C.h).

Tracking runs on the CM component only (20 ms period, 10230 chips at
511.5 kcps), ignoring the chip-multiplexed CL — the reference's
GPS_L2_M_DLL_PLL_Tracking does the same (3 dB of the composite power)."""

FREQ_HZ = 1227.60e6               # L2 carrier
CODE_RATE_CPS = 0.5115e6          # CM chipping rate (CM-only replica)
CODE_LENGTH_CHIPS = 10230         # CM code length (20 ms)
CODE_PERIOD_S = 20e-3

SYMBOL_RATE_SPS = 50.0            # CNAV symbols/s (25 bps rate-1/2 coded)
CODES_PER_SYMBOL = 1              # one 20 ms CM period per symbol
