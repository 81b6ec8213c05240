# Frozen copy of gnss_sdr_tpu_torch/simulate/constellation.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/simulate/constellation.py; only the package imports are
# rewritten, and what the benchmark never calls is left out (the docstring is the original's).
"""Synthetic GPS constellation + measurement truth models.

Builds realistic broadcast ephemerides (nominal 6-plane GPS geometry) and
computes geometry-consistent truth (pseudoranges, Doppler, light time) for
a receiver — the role the external gnss-sim simulator plays for the
reference's system tests (SURVEY.md §4: position_test truth source).
"""

from __future__ import annotations

import numpy as np

from rxbench.frozen.pvt.coords import az_el
from rxbench.frozen.pvt.ephemeris import eph_to_pos_vel_clock
from rxbench.frozen.telemetry.lnav import GpsEphemeris

GPS_L1_HZ = 1575.42e6
NOMINAL_SQRT_A = 5153.65        # ~26560 km semi-major axis
NOMINAL_INCLINATION = 0.9616    # 55 deg


def make_constellation(
    num_sats: int = 24,
    week: int = 300,
    toe: float = 7200.0,
    seed: int = 0,
) -> dict[int, GpsEphemeris]:
    """Nominal GPS constellation: 6 planes x 4 slots, small per-SV clock
    biases and eccentricities; IODs consistent; quantized at ICD scalings
    by construction of the encoder (values chosen representable)."""
    rng = np.random.default_rng(seed)
    ephs: dict[int, GpsEphemeris] = {}
    for i in range(num_sats):
        prn = i + 1
        plane = i % 6
        slot = i // 6
        ephs[prn] = GpsEphemeris(
            prn=prn, week=week,
            iodc=prn, iode_sf2=prn, iode_sf3=prn,
            toc=toe, toe=toe,
            af0=float(rng.uniform(-2e-4, 2e-4)),
            af1=float(rng.uniform(-3e-12, 3e-12)),
            af2=0.0,
            tgd=float(rng.uniform(-8e-9, 8e-9)),
            sqrt_a=NOMINAL_SQRT_A + float(rng.uniform(-0.2, 0.2)),
            ecc=float(rng.uniform(0.002, 0.02)),
            m0=float((2.0 * np.pi * slot / 4.0 + plane * 0.25
                      + rng.uniform(-0.1, 0.1)) % (2 * np.pi) - np.pi),
            omega0=float((2.0 * np.pi * plane / 6.0
                          + rng.uniform(-0.05, 0.05)) % (2 * np.pi) - np.pi),
            i0=NOMINAL_INCLINATION + float(rng.uniform(-0.02, 0.02)),
            omega=float(rng.uniform(-np.pi, np.pi)),
            omega_dot=-8.0e-9,
            idot=float(rng.uniform(-3e-10, 3e-10)),
            delta_n=float(rng.uniform(3e-9, 6e-9)),
            cus=float(rng.uniform(-8e-6, 8e-6)),
            cuc=float(rng.uniform(-8e-6, 8e-6)),
            crs=float(rng.uniform(-100, 100)),
            crc=float(rng.uniform(100, 300)),
            cis=float(rng.uniform(-2e-7, 2e-7)),
            cic=float(rng.uniform(-2e-7, 2e-7)),
        )
    return ephs


def visible_sats(
    ephs: dict[int, GpsEphemeris],
    rx_ecef: np.ndarray,
    tow_s: float,
    min_elevation_rad: float = np.deg2rad(10.0),
) -> list[int]:
    out = []
    for prn, eph in ephs.items():
        p, _, _, _ = eph_to_pos_vel_clock(eph, tow_s)
        _, el = az_el(rx_ecef, p)
        if el >= min_elevation_rad:
            out.append(prn)
    return out
