# Frozen copy of gnss_sdr_tpu_torch/pvt/ephemeris.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/pvt/ephemeris.py; only the package imports are rewritten.
"""Broadcast ephemeris -> satellite position/velocity/clock (NumPy f64).

Standard IS-GPS-200 §20.3.3.4.3 Kepler orbit propagation, equivalent in
behavior to rtklib_ephemeris.cc eph2pos/ephclk (reference PVT dependency,
SURVEY.md §2.2). Velocity by analytic differentiation.
"""

from __future__ import annotations

import numpy as np

from rxbench.frozen.telemetry.lnav import GpsEphemeris

GM_EARTH = 3.986005e14          # WGS-84 mu, m^3/s^2 (GPS ICD value)
GM_GAL = 3.986004418e14         # GTRF mu (Galileo OS SIS ICD §5.1.1)
OMEGA_E = 7.2921151467e-5       # earth rotation rate, rad/s
C_LIGHT = 299792458.0
F_REL = -4.442807633e-10        # relativistic clock factor, s/sqrt(m)
HALF_WEEK = 302400.0


def time_diff(t: float, t_ref: float) -> float:
    """Seconds-of-week difference with week rollover (rtklib timediff)."""
    dt = t - t_ref
    if dt > HALF_WEEK:
        dt -= 2.0 * HALF_WEEK
    elif dt < -HALF_WEEK:
        dt += 2.0 * HALF_WEEK
    return dt


def eph_to_pos_vel_clock(
    eph: GpsEphemeris, t_sv: float
) -> tuple[np.ndarray, np.ndarray, float, float]:
    """Satellite ECEF position [m], velocity [m/s], clock bias [s] and clock
    drift [s/s] at GPS transmit time ``t_sv`` (seconds of week).

    The clock bias includes the relativistic correction but NOT TGD (applied
    per-frequency by the solver, as rtklib does).

    Non-Keplerian ephemerides (GLONASS state vectors, SBAS corrections)
    plug in by exposing a ``pos_vel_clock(t)`` method (duck dispatch, the
    rtklib geph2pos/seph2pos split re-expressed).
    """
    if hasattr(eph, "pos_vel_clock"):
        return eph.pos_vel_clock(t_sv)
    a = eph.sqrt_a * eph.sqrt_a
    # Galileo (GTRF) and BeiDou (CGCS2000) share the 3.986004418e14 value
    gm = (GM_GAL if getattr(eph, "system", "G") in ("E", "C")
          else GM_EARTH)
    n0 = np.sqrt(gm / a**3)
    tk = time_diff(t_sv, eph.toe)
    n = n0 + eph.delta_n
    mk = eph.m0 + n * tk

    # Kepler's equation by Newton iteration
    e = eph.ecc
    ek = mk
    for _ in range(12):
        ek = ek - (ek - e * np.sin(ek) - mk) / (1.0 - e * np.cos(ek))
    sek, cek = np.sin(ek), np.cos(ek)

    nu = np.arctan2(np.sqrt(1.0 - e * e) * sek, cek - e)
    phi = nu + eph.omega
    s2p, c2p = np.sin(2.0 * phi), np.cos(2.0 * phi)

    du = eph.cus * s2p + eph.cuc * c2p
    dr = eph.crs * s2p + eph.crc * c2p
    di = eph.cis * s2p + eph.cic * c2p

    u = phi + du
    r = a * (1.0 - e * cek) + dr
    i = eph.i0 + di + eph.idot * tk

    x_op = r * np.cos(u)
    y_op = r * np.sin(u)
    omega_k = (
        eph.omega0 + (eph.omega_dot - OMEGA_E) * tk - OMEGA_E * eph.toe
    )
    so, co = np.sin(omega_k), np.cos(omega_k)
    si, ci = np.sin(i), np.cos(i)

    pos = np.array([
        x_op * co - y_op * ci * so,
        x_op * so + y_op * ci * co,
        y_op * si,
    ])

    # ---- velocity (analytic) ------------------------------------------------
    ek_dot = n / (1.0 - e * cek)
    phi_dot = np.sqrt(1.0 - e * e) / (1.0 - e * cek) * ek_dot
    u_dot = phi_dot * (1.0 + 2.0 * (eph.cus * c2p - eph.cuc * s2p))
    r_dot = a * e * sek * ek_dot + 2.0 * phi_dot * (
        eph.crs * c2p - eph.crc * s2p
    )
    i_dot = eph.idot + 2.0 * phi_dot * (eph.cis * c2p - eph.cic * s2p)
    omega_k_dot = eph.omega_dot - OMEGA_E

    x_op_dot = r_dot * np.cos(u) - r * np.sin(u) * u_dot
    y_op_dot = r_dot * np.sin(u) + r * np.cos(u) * u_dot

    vel = np.array([
        x_op_dot * co - y_op_dot * ci * so
        - (x_op * so + y_op * ci * co) * omega_k_dot
        + y_op * si * so * i_dot,
        x_op_dot * so + y_op_dot * ci * co
        + (x_op * co - y_op * ci * so) * omega_k_dot
        - y_op * si * co * i_dot,
        y_op_dot * si + y_op * ci * i_dot,
    ])

    # ---- clock --------------------------------------------------------------
    tc = time_diff(t_sv, eph.toc)
    rel = F_REL * e * eph.sqrt_a * sek
    clk = eph.af0 + eph.af1 * tc + eph.af2 * tc * tc + rel
    clk_dot = eph.af1 + 2.0 * eph.af2 * tc + F_REL * e * eph.sqrt_a * cek * ek_dot

    return pos, vel, float(clk), float(clk_dot)
