# Frozen copy of gnss_sdr_tpu_torch/pvt/coords.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/pvt/coords.py; only the package imports are rewritten.
"""Geodetic coordinate transforms (host-side, NumPy f64).

WGS-84 ECEF <-> LLH <-> local ENU, azimuth/elevation. Reference analog:
geofunctions.h / rtklib_rtkcmn.cc (ecef2pos, pos2ecef, ecef2enu, satazel).
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)


def llh_to_ecef(lat_rad: float, lon_rad: float, h_m: float) -> np.ndarray:
    sl, cl = np.sin(lat_rad), np.cos(lat_rad)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    return np.array([
        (n + h_m) * cl * np.cos(lon_rad),
        (n + h_m) * cl * np.sin(lon_rad),
        (n * (1.0 - WGS84_E2) + h_m) * sl,
    ])


def ecef_to_llh(xyz: np.ndarray) -> tuple[float, float, float]:
    x, y, z = float(xyz[0]), float(xyz[1]), float(xyz[2])
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(6):
        sl = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    sl = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    h = p / np.cos(lat) - n
    return float(lat), float(lon), float(h)


def enu_matrix(lat_rad: float, lon_rad: float) -> np.ndarray:
    """Rows = east, north, up unit vectors in ECEF."""
    sl, cl = np.sin(lat_rad), np.cos(lat_rad)
    so, co = np.sin(lon_rad), np.cos(lon_rad)
    return np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])


def ecef_to_enu(d_ecef: np.ndarray, lat_rad: float, lon_rad: float) -> np.ndarray:
    return enu_matrix(lat_rad, lon_rad) @ np.asarray(d_ecef)


def az_el(rx_ecef: np.ndarray, sat_ecef: np.ndarray) -> tuple[float, float]:
    """Azimuth/elevation (rad) of a satellite from a receiver position."""
    lat, lon, _ = ecef_to_llh(rx_ecef)
    enu = ecef_to_enu(np.asarray(sat_ecef) - np.asarray(rx_ecef), lat, lon)
    az = float(np.arctan2(enu[0], enu[1]) % (2.0 * np.pi))
    el = float(np.arcsin(enu[2] / np.linalg.norm(enu)))
    return az, el
