# Copied from gnss_sdr_tpu/pvt/ppp.py; only the package imports are rewritten.
"""Precise Point Positioning (float, dual-frequency iono-free).

Reference analog: src/algorithms/libs/rtklib/rtklib_ppp.cc (pppos(): EKF
over position, receiver clock, zenith troposphere delay and float
iono-free carrier ambiguities). Scope matches the reference's PPP-float
mode (no integer PPP-AR, no precise-product file readers — orbit/clock
quality is whatever the supplied ephemerides give; the filter structure
and observation model are the point).

Observables per satellite: dual-frequency pseudorange + carrier phase,
combined iono-free:

    P_IF = (f1^2 P1 - f2^2 P2) / (f1^2 - f2^2)
    L_IF = (f1^2 l1 Phi1 - f2^2 l2 Phi2) / (f1^2 - f2^2)   [meters]

    P_IF = rho + c dt_r + m(el) ZTD + e
    L_IF = rho + c dt_r + m(el) ZTD + B_IF + e'
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.pvt import tides
from gnss_sdr_tpu_torch.pvt.antex import antmodel, satantoff
from gnss_sdr_tpu_torch.pvt.coords import az_el, ecef_to_llh
from gnss_sdr_tpu_torch.pvt.ephemeris import C_LIGHT, OMEGA_E, eph_to_pos_vel_clock


@dataclass
class DualFreqObs:
    system: str
    prn: int
    p1_m: float                   # pseudorange at f1
    p2_m: float                   # pseudorange at f2
    phi1_cycles: float            # carrier phase at f1 (~ -range/lambda1)
    phi2_cycles: float
    f1_hz: float
    f2_hz: float
    cn0_dbhz: float = 45.0


@dataclass
class PppSolution:
    valid: bool = False
    pos_ecef: np.ndarray | None = None
    clock_m: float = 0.0
    ztd_m: float = 0.0
    num_sats: int = 0


def _mapping(el: float) -> float:
    """Simple 1/sin(el) wet mapping (rtklib uses NMF; equivalent role)."""
    return 1.0 / max(np.sin(el), 0.05)


class PppEngine:
    """Static/kinematic float PPP filter (rtklib_ppp.cc pppos analog)."""

    def __init__(self, mode: str = "static",
                 code_sigma_m: float = 1.0, phase_sigma_m: float = 0.01,
                 pos_q_m: float = 20.0,
                 rx_antenna=None, sat_antennas=None,
                 gps_week: int = 0,
                 tide_correction: bool = False,
                 oload: np.ndarray | None = None,
                 phase_windup: bool = False,
                 pole_tide: bool = False,
                 exclude_eclipse: bool = False) -> None:
        """``rx_antenna``: pvt.antex.AntennaPcv for the receiver
        (marker->phase-center correction, rtklib antmodel);
        ``sat_antennas``: {'G01': AntennaPcv, ...} — satellite
        center-of-mass -> phase-center offsets applied to precise orbits
        (rtklib satantoff; broadcast ephemerides are already
        antenna-referenced, so the offset is applied only with SP3).

        ``tide_correction``: apply solid-earth (+ pole) tide site
        displacement (rtklib_tides.cc tidedisp, rtklib_ppp.cc
        tidecorr opt); ``oload``: optional (11, 6) BLQ table adds ocean
        loading; ``phase_windup``: apply the carrier windup correction
        (rtklib_rtkcmn.cc windupcorr via rtklib_ppp.cc:1655);
        ``pole_tide``: add ocean-loading/pole-tide class corrections to
        the solid tide (the reference's PVT.earth_tide=2 tier);
        ``exclude_eclipse``: drop satellites inside the earth's shadow
        cylinder (rtklib_ppp.cc testeclipse).

        The tide/windup/eclipse corrections need absolute GPS time and
        are skipped (with the filter otherwise unaffected) until
        ``gps_week`` is known (> 0)."""
        self.mode = mode
        self.code_sigma = code_sigma_m
        self.phase_sigma = phase_sigma_m
        self.pos_q = pos_q_m
        self.rx_antenna = rx_antenna
        self.sat_antennas = sat_antennas or {}
        self.gps_week = gps_week
        self.tide_correction = tide_correction
        self.oload = oload
        self.phase_windup = phase_windup
        self.pole_tide = pole_tide
        self.exclude_eclipse = exclude_eclipse
        self.phw: dict[tuple[str, int], float] = {}
        self.x: np.ndarray | None = None     # [x y z clk ztd B_1..B_n]
        self.P: np.ndarray | None = None
        self.amb_index: dict[tuple[str, int], int] = {}
        self.t_last: float | None = None

    def _init(self, x0: np.ndarray) -> None:
        self.x = np.zeros(5)
        self.x[:3] = x0
        self.P = np.diag([1e6] * 3 + [1e8, 0.25])

    def _ensure(self, keys, b_init):
        for key in keys:
            if key not in self.amb_index:
                n = len(self.x)
                self.amb_index[key] = n
                self.x = np.append(self.x, b_init.get(key, 0.0))
                P = np.zeros((n + 1, n + 1))
                P[:n, :n] = self.P
                P[n, n] = 1e4
                self.P = P
        live = set(keys)
        for key in [k for k in self.amb_index if k not in live]:
            i = self.amb_index.pop(key)
            keep = [j for j in range(len(self.x)) if j != i]
            self.x = self.x[keep]
            self.P = self.P[np.ix_(keep, keep)]
            for k2, j in self.amb_index.items():
                if j > i:
                    self.amb_index[k2] = j - 1

    def process_epoch(self, t: float, obs: list[DualFreqObs],
                      ephemerides: dict,
                      x0: np.ndarray | None = None,
                      precise=None) -> PppSolution:
        """``precise``: optional pvt.preceph.PreciseEphemeris — SP3
        orbit/clock interpolation replaces the broadcast satellite
        position/clock (rtklib satpos EPHOPT_PREC), the defining input of
        real PPP processing."""
        if precise is not None:
            usable = [o for o in obs
                      if precise.sat_pos_clock(o.system, o.prn, t) is not None
                      or (o.system, o.prn) in ephemerides]
        else:
            usable = [o for o in obs if (o.system, o.prn) in ephemerides]
        if len(usable) < 4:
            return PppSolution()
        if self.x is None:
            self._init(np.zeros(3) if x0 is None else np.asarray(x0))

        # iono-free combinations + satellite geometry; each row carries
        # its combination coefficients (a1, a2) for the downstream
        # antenna/windup corrections
        rows = []
        for o in usable:
            g1 = o.f1_hz ** 2
            g2 = o.f2_hz ** 2
            a1 = g1 / (g1 - g2)
            a2 = -g2 / (g1 - g2)
            lam1 = C_LIGHT / o.f1_hz
            lam2 = C_LIGHT / o.f2_hz
            p_if = a1 * o.p1_m + a2 * o.p2_m
            # phase convention: phi ~ -range/lambda (+N); convert to a
            # range-like quantity -lambda*phi
            l_if = a1 * (-lam1 * o.phi1_cycles) + a2 * (-lam2 * o.phi2_cycles)
            tau = p_if / C_LIGHT
            prec = (precise.sat_pos_clock(o.system, o.prn, t - tau)
                    if precise is not None else None)
            if prec is not None:
                p, dts = prec
                spcv = self.sat_antennas.get(f"{o.system}{o.prn:02d}")
                if spcv is not None:
                    p = np.asarray(p) + satantoff(
                        spcv, np.asarray(p), t, week=self.gps_week)
            else:
                p, _, dts, _ = eph_to_pos_vel_clock(
                    ephemerides[(o.system, o.prn)], t - tau)
            th = OMEGA_E * tau
            rot = np.array([[np.cos(th), np.sin(th), 0.0],
                            [-np.sin(th), np.cos(th), 0.0],
                            [0.0, 0.0, 1.0]])
            rows.append((o, p_if + C_LIGHT * dts, l_if + C_LIGHT * dts,
                         rot @ p, a1, a2))

        keys = [(o.system, o.prn) for o, *_ in rows]
        b_init = {
            (o.system, o.prn): l_if - p_if
            for o, p_if, l_if, *_ in rows
        }
        self._ensure(keys, b_init)
        n = len(self.x)

        # time update
        if self.t_last is not None:
            dt = max(t - self.t_last, 0.0)
            if self.mode == "kinematic":
                self.P[:3, :3] += np.eye(3) * self.pos_q ** 2 * dt
            self.P[3, 3] += 1e6 * dt          # clock ~ white
            self.P[4, 4] += 1e-8 * dt         # ZTD random walk (3e-4 m/sqrt h)
        self.t_last = t

        # site displacement by earth tides + sun position for windup
        # (rtklib_ppp.cc ppp_res: rr_ = rr + tidedisp). All three need
        # absolute GPS time: without a known week, t_abs would place the
        # epoch in January 1980 and the "corrections" would be
        # wrong-epoch noise — skip until gps_week arrives.
        t_abs = self.gps_week * 604800.0 + t
        disp = np.zeros(3)
        rsun = None
        if (self.tide_correction or self.phase_windup
                or self.exclude_eclipse) and self.gps_week > 0 and \
                np.linalg.norm(self.x[:3]) > 1e6:
            if self.tide_correction:
                disp = tides.tidedisp(t_abs, self.x[:3],
                                      oload=self.oload,
                                      pole=self.pole_tide)
            if self.phase_windup or self.exclude_eclipse:
                rsun, _, _ = tides.sun_moon_ecef(t_abs)
            if self.exclude_eclipse and rsun is not None:
                kept = [rw for rw in rows
                        if not tides.in_eclipse(rw[3], rsun)]
                if len(kept) >= 4:
                    rows = kept
                if not self.phase_windup:
                    rsun = None

        H, v, r = [], [], []
        lat, lon, _ = ecef_to_llh(self.x[:3])
        rr_disp = self.x[:3] + disp
        for o, p_if, l_if, sat, a1, a2 in rows:
            rho = float(np.linalg.norm(sat - rr_disp))
            e = (sat - rr_disp) / rho
            az, el = az_el(self.x[:3], sat) if np.linalg.norm(
                self.x[:3]) > 1e6 else (0.0, np.pi / 2)
            m = _mapping(el)
            if self.rx_antenna is not None:
                # iono-free combination of the per-frequency receiver
                # phase-center corrections (rtklib antmodel + combination
                # in ppp corr_meas)
                f1c = "G01" if o.system == "G" else "E01"
                f2c = "G02" if o.system == "G" else "E05"
                d_if = (a1 * antmodel(self.rx_antenna, f1c, az, el)
                        + a2 * antmodel(self.rx_antenna, f2c, az, el))
                p_if = p_if - d_if
                l_if = l_if - d_if
            if rsun is not None:
                # windup adds phw cycles at both frequencies; the
                # iono-free phase range shifts by lam_IF * phw where
                # lam_IF = a1*lam1 + a2*lam2 (rtklib corr_meas applies
                # -phw*lam per frequency before combining)
                key = (o.system, o.prn)
                phw = tides.phase_windup(sat, rr_disp, rsun,
                                         self.phw.get(key, 0.0))
                self.phw[key] = phw
                lam_if = a1 * C_LIGHT / o.f1_hz + a2 * C_LIGHT / o.f2_hz
                l_if = l_if - lam_if * phw
            pred_p = rho + self.x[3] + m * self.x[4]
            row = np.zeros(n)
            row[:3] = -e
            row[3] = 1.0
            row[4] = m
            H.append(row.copy())
            v.append(p_if - pred_p)
            r.append(self.code_sigma ** 2)
            bi = self.amb_index[(o.system, o.prn)]
            row2 = row.copy()
            row2[bi] = 1.0
            H.append(row2)
            v.append(l_if - (pred_p + self.x[bi]))
            r.append(self.phase_sigma ** 2)
        H = np.asarray(H)
        v = np.asarray(v)
        R = np.diag(r)
        S = H @ self.P @ H.T + R
        K = self.P @ H.T @ np.linalg.inv(S)
        self.x = self.x + K @ v
        self.P = (np.eye(n) - K @ H) @ self.P
        return PppSolution(
            valid=True, pos_ecef=self.x[:3].copy(),
            clock_m=float(self.x[3]), ztd_m=float(self.x[4]),
            num_sats=len(rows),
        )
