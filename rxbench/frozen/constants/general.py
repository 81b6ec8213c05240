# Frozen copy of gnss_sdr_tpu_torch/constants/general.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/constants/general.py; only the package imports are rewritten.
"""Shared physical constants (reference: src/core/system_parameters/MATH_CONSTANTS.h, gnss_frequencies.h)."""

SPEED_OF_LIGHT_M_S = 299_792_458.0  # [m/s]
GPS_WEEK_SECONDS = 604_800  # seconds in a GPS week

# WGS84 / GPS ephemeris model constants (IS-GPS-200, Table 20-IV)
GM_EARTH = 3.986005e14          # WGS84 value of Earth's gravitational constant [m^3/s^2]
OMEGA_EARTH_DOT = 7.2921151467e-5  # WGS84 Earth rotation rate [rad/s]
F_REL = -4.442807633e-10        # relativistic correction constant [s/m^1/2]

# WGS84 ellipsoid
WGS84_A = 6378137.0             # semi-major axis [m]
WGS84_F = 1.0 / 298.257223563   # flattening
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared
