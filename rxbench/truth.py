"""Geometry truth of a scenario, vectorised over epochs, in a chosen float
precision.

The same equations as the port's ``simulate/constellation.py::
truth_measurement`` and the frozen ``pvt/ephemeris.py::
eph_to_pos_vel_clock`` (GPS
and Galileo broadcast orbits, light-time iteration with the Sagnac
rotation, Saastamoinen troposphere), over arrays of receiver times. The
generator builds its per-satellite timelines with ``dtype=float64``; the
reference judges the receiver's answers with them, and the control is the
same reference computed in float32.
"""

from __future__ import annotations

import numpy as np

from rxbench.frozen.pvt.coords import ecef_to_llh, enu_matrix
from rxbench.frozen.pvt.ephemeris import (
    C_LIGHT,
    F_REL,
    GM_EARTH,
    GM_GAL,
    HALF_WEEK,
    OMEGA_E,
)

_ORBIT_FIELDS = ("sqrt_a", "toe", "delta_n", "m0", "ecc", "omega", "cus",
                 "cuc", "crs", "crc", "cis", "cic", "i0", "idot", "omega0",
                 "omega_dot", "toc", "af0", "af1", "af2")


def _time_diff(t, t_ref, dtype):
    dt = t - t_ref
    week = dtype(2.0 * HALF_WEEK)
    return np.where(dt > HALF_WEEK, dt - week,
                    np.where(dt < -HALF_WEEK, dt + week, dt))


def orbit(eph, t_sv, dtype=np.float64):
    """Satellite ECEF position and velocity [N, 3], clock bias and drift
    [N] at satellite times ``t_sv`` [N] (seconds of week), every step in
    ``dtype``."""
    dt = np.dtype(dtype).type
    e_ = {k: dt(getattr(eph, k)) for k in _ORBIT_FIELDS}
    t_sv = np.asarray(t_sv, dtype)
    gm = dt(GM_GAL if getattr(eph, "system", "G") in ("E", "C")
            else GM_EARTH)
    om_e, one, two = dt(OMEGA_E), dt(1.0), dt(2.0)
    a = e_["sqrt_a"] * e_["sqrt_a"]
    n = np.sqrt(gm / (a * a * a)) + e_["delta_n"]
    tk = _time_diff(t_sv, e_["toe"], dt)
    mk = e_["m0"] + n * tk
    e = e_["ecc"]
    ek = mk
    for _ in range(12):
        ek = ek - (ek - e * np.sin(ek) - mk) / (one - e * np.cos(ek))
    sek, cek = np.sin(ek), np.cos(ek)
    nu = np.arctan2(np.sqrt(one - e * e) * sek, cek - e)
    phi = nu + e_["omega"]
    s2p, c2p = np.sin(two * phi), np.cos(two * phi)
    u = phi + e_["cus"] * s2p + e_["cuc"] * c2p
    r = a * (one - e * cek) + e_["crs"] * s2p + e_["crc"] * c2p
    i = e_["i0"] + e_["cis"] * s2p + e_["cic"] * c2p + e_["idot"] * tk
    x_op, y_op = r * np.cos(u), r * np.sin(u)
    omk = e_["omega0"] + (e_["omega_dot"] - om_e) * tk - om_e * e_["toe"]
    so, co = np.sin(omk), np.cos(omk)
    si, ci = np.sin(i), np.cos(i)
    pos = np.stack([x_op * co - y_op * ci * so, x_op * so + y_op * ci * co,
                    y_op * si], axis=-1)
    ek_dot = n / (one - e * cek)
    phi_dot = np.sqrt(one - e * e) / (one - e * cek) * ek_dot
    u_dot = phi_dot * (one + two * (e_["cus"] * c2p - e_["cuc"] * s2p))
    r_dot = a * e * sek * ek_dot + two * phi_dot * (
        e_["crs"] * c2p - e_["crc"] * s2p)
    i_dot = e_["idot"] + two * phi_dot * (e_["cis"] * c2p - e_["cic"] * s2p)
    omk_dot = e_["omega_dot"] - om_e
    x_dot = r_dot * np.cos(u) - r * np.sin(u) * u_dot
    y_dot = r_dot * np.sin(u) + r * np.cos(u) * u_dot
    vel = np.stack([
        x_dot * co - y_dot * ci * so - (x_op * so + y_op * ci * co) * omk_dot
        + y_op * si * so * i_dot,
        x_dot * so + y_dot * ci * co + (x_op * co - y_op * ci * so) * omk_dot
        - y_op * si * co * i_dot,
        y_dot * si + y_op * ci * i_dot], axis=-1)
    tc = _time_diff(t_sv, e_["toc"], dt)
    f_rel = dt(F_REL)
    clk = (e_["af0"] + e_["af1"] * tc + e_["af2"] * tc * tc
           + f_rel * e * e_["sqrt_a"] * sek)
    clk_dot = (e_["af1"] + two * e_["af2"] * tc
               + f_rel * e * e_["sqrt_a"] * cek * ek_dot)
    return pos, vel, clk, clk_dot


def measure(eph, rx_ecef, rx_tow, rx_bias, carrier_hz: float,
            rx_vel=None, dtype=np.float64) -> dict:
    """Truth at receiver-clock times ``rx_tow`` [N] with the receiver clock
    ``rx_bias`` [N] s behind: the satellite-clock transmit time
    ``t_tx_sv``, the light time ``tau``, the Doppler at ``carrier_hz`` and
    the satellite position in the reception frame ``sat_pos`` [N, 3]."""
    dt = np.dtype(dtype).type
    rx = np.asarray(rx_ecef, dtype)
    rxv = np.zeros(3, dtype) if rx_vel is None else np.asarray(rx_vel, dtype)
    t_rx = np.asarray(rx_tow, dtype) - np.asarray(rx_bias, dtype)
    c, om_e = dt(C_LIGHT), dt(OMEGA_E)
    tau = np.full(t_rx.shape, dt(0.07), dtype)
    for _ in range(4):
        p, v, dts, dts_dot = orbit(eph, t_rx - tau, dtype)
        th = om_e * tau
        cs, sn = np.cos(th), np.sin(th)
        p_rx = np.stack([cs * p[:, 0] + sn * p[:, 1],
                         -sn * p[:, 0] + cs * p[:, 1], p[:, 2]], axis=-1)
        tau = np.linalg.norm(p_rx - rx, axis=-1) / c
    v_rx = np.stack([cs * v[:, 0] + sn * v[:, 1],
                     -sn * v[:, 0] + cs * v[:, 1], v[:, 2]], axis=-1)
    los = (p_rx - rx) / np.linalg.norm(p_rx - rx, axis=-1)[:, None]
    rr = np.sum((v_rx - rxv) * los, axis=-1)
    return {"t_tx_sv": t_rx - tau + dts, "tau": tau, "sat_pos": p_rx,
            "doppler_hz": (-rr / c + dts_dot) * dt(carrier_hz)}


def elevation(rx_ecef, sat_pos) -> np.ndarray:
    """Elevation [N] of satellites at ``sat_pos`` [N, 3] (float64)."""
    lat, lon, _ = ecef_to_llh(rx_ecef)
    enu = (np.asarray(sat_pos) - rx_ecef) @ enu_matrix(lat, lon).T
    return np.arcsin(enu[:, 2] / np.linalg.norm(enu, axis=-1))


def tropo_delay(el, h_m: float, humidity: float = 0.7) -> np.ndarray:
    """Saastamoinen delay in metres, as the port's ``pvt/atmosphere.py::
    tropo_delay`` computes it, over an array of elevations."""
    h = max(min(h_m, 11000.0), 0.0)
    pres = 1013.25 * (1.0 - 2.2557e-5 * h) ** 5.2568
    temp = 15.0 - 6.5e-3 * h + 273.16
    e = 6.108 * humidity * np.exp((17.15 * temp - 4684.0) / (temp - 38.45))
    cz = np.cos(np.pi / 2.0 - np.asarray(el, np.float64))
    trph = 0.0022768 * pres / (1.0 - 0.00266 - 0.00028 * h / 1e3) / cz
    trpw = 0.002277 * (1255.0 / temp + 0.05) * e / cz
    return np.where(np.asarray(el) > 0.0, trph + trpw, 0.0)
