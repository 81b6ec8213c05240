# Copied from gnss_sdr_tpu/pvt/glonass.py; only the package imports are rewritten.
"""GLONASS broadcast ephemeris and PZ-90 orbit propagation.

The GNAV ephemeris is a satellite state vector (position/velocity at the
reference epoch tb, plus lunisolar acceleration) in the rotating PZ-90
ECEF frame; satellite position at arbitrary t comes from 4th-order
Runge-Kutta integration of the J2-perturbed equations of motion
(GLONASS ICD A.3.1.2). Reference analogs: rtklib_ephemeris.cc deq()/
glorbit()/geph2pos() and glonass_gnav_ephemeris.{h,cc}.

Times here are GPS TOW seconds: the GNAV decoder converts GLONASS day time
(UTC(SU)+3h) to GPS time once (telemetry/gnav.py glot_to_gpst), so the
solver and simulator never touch the GLONASS timescale.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MU_GLO = 3.9860044e14        # PZ-90 gravitational constant [m^3/s^2]
J2_GLO = 1.0826257e-3        # 2nd zonal harmonic
RE_GLO = 6378136.0           # PZ-90 Earth radius [m]
OMEGA_GLO = 7.292115e-5      # Earth rotation rate [rad/s]
TSTEP = 60.0                 # max RK4 step [s] (rtklib TSTEP)


@dataclass
class GlonassEphemeris:
    """Decoded GNAV ephemeris (strings 1-4) with times in GPS TOW."""

    slot: int = 0                   # orbital slot n (string 4)
    freq_k: int = 0                 # FDMA frequency channel
    tb_gps_tow: float = 0.0         # reference epoch, GPS TOW [s]
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))  # [m] PZ-90
    vel: np.ndarray = field(default_factory=lambda: np.zeros(3))  # [m/s]
    acc: np.ndarray = field(default_factory=lambda: np.zeros(3))  # [m/s^2]
    tau_n: float = 0.0              # SV clock bias [s] (-tau_n convention)
    gamma_n: float = 0.0            # relative frequency bias
    dtau_n: float = 0.0             # L1/L2 group delay difference [s]
    health: int = 0                 # Bn(3) health flag
    ft: int = 0                     # user range accuracy index
    nt: int = 0                     # day within four-year period
    n4: int = 0                     # four-year interval number
    tgd: float = 0.0                # interface parity with Kepler ephemerides

    @property
    def prn(self) -> int:
        return self.slot

    def pos_vel_clock(self, t_gps_tow: float):
        """(pos[3], vel[3], clock_bias_s, clock_drift) at GPS TOW t.

        Duck-typed plug-in for pvt.ephemeris.eph_to_pos_vel_clock dispatch.
        """
        dt = float(t_gps_tow - self.tb_gps_tow)
        x = np.concatenate([self.pos, self.vel]).astype(np.float64)
        t_remaining = dt
        step = TSTEP if dt >= 0 else -TSTEP
        while abs(t_remaining) > 1e-9:
            h = step if abs(t_remaining) > TSTEP else t_remaining
            x = _rk4(x, h, self.acc)
            t_remaining -= h
        # SV clock: dts = -tau_n + gamma_n * (t - tb)  (ICD sign convention)
        dts = -self.tau_n + self.gamma_n * dt
        return x[:3].copy(), x[3:].copy(), dts, self.gamma_n


def _deq(x: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """J2-perturbed equations of motion in the rotating PZ-90 frame
    (reference deq(), rtklib_ephemeris.cc:414)."""
    r2 = float(x[0] ** 2 + x[1] ** 2 + x[2] ** 2)
    if r2 <= 0.0:
        return np.zeros(6)
    r3 = r2 * np.sqrt(r2)
    omg2 = OMEGA_GLO ** 2
    a = 1.5 * J2_GLO * MU_GLO * RE_GLO ** 2 / r2 / r3
    b = 5.0 * x[2] ** 2 / r2
    c = -MU_GLO / r3 - a * (1.0 - b)
    return np.array([
        x[3], x[4], x[5],
        (c + omg2) * x[0] + 2.0 * OMEGA_GLO * x[4] + acc[0],
        (c + omg2) * x[1] - 2.0 * OMEGA_GLO * x[3] + acc[1],
        (c - 2.0 * a) * x[2] + acc[2],
    ])


def _rk4(x: np.ndarray, h: float, acc: np.ndarray) -> np.ndarray:
    k1 = _deq(x, acc)
    k2 = _deq(x + k1 * h / 2.0, acc)
    k3 = _deq(x + k2 * h / 2.0, acc)
    k4 = _deq(x + k3 * h, acc)
    return x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) * h / 6.0
