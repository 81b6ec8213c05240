# Frozen copy of gnss_sdr_tpu_torch/constants/gps_l1_ca.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/constants/gps_l1_ca.py; only the package imports are rewritten.
"""GPS L1 C/A signal constants.

Values from IS-GPS-200 (public ICD); the reference keeps the same set in
src/core/system_parameters/GPS_L1_CA.h.
"""

FREQ_HZ = 1_575_420_000.0          # L1 carrier frequency [Hz]
CODE_RATE_CPS = 1_023_000.0        # C/A code chipping rate [chips/s]
CODE_LENGTH_CHIPS = 1023           # C/A code period [chips]
CODE_PERIOD_S = CODE_LENGTH_CHIPS / CODE_RATE_CPS   # 1 ms
CODE_PERIOD_MS = 1.0
CHIP_PERIOD_S = 1.0 / CODE_RATE_CPS

# LNAV navigation message
BIT_PERIOD_MS = 20                 # 50 bps
CODES_PER_BIT = 20
PREAMBLE_BITS = (1, 0, 0, 0, 1, 0, 1, 1)  # TLM word 8-bit preamble 0x8B
BITS_PER_WORD = 30
WORDS_PER_SUBFRAME = 10
BITS_PER_SUBFRAME = 300
SUBFRAME_PERIOD_S = 6.0
SUBFRAME_MS = 6000

# Wavelength
from rxbench.frozen.constants.general import SPEED_OF_LIGHT_M_S as _C
WAVELENGTH_M = _C / FREQ_HZ
