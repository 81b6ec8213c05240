# Copied from gnss_sdr_tpu/pvt/rtk.py; only the package imports are rewritten.
"""Differential positioning: DGPS code corrections and carrier-phase RTK
with float-Kalman ambiguities + LAMBDA integer fixing.

Reference analog: src/algorithms/libs/rtklib/rtklib_rtkpos.cc (rtkpos():
DGPS/kinematic/static engine over double-differenced observables with an
EKF whose state is [position (, velocity), single-difference ambiguities])
and rtklib_lambda.cc (integer resolution, here pvt/lambda_ilr.py).

This is deliberately host-side numpy: one epoch involves matrices of
size ~(2 * #sats); the TPU earns nothing here, and the control flow
(satellite set changes, ambiguity bookkeeping, validation) is dynamic.

Scope vs the reference: single-baseline, single-frequency code+carrier,
GPS/Galileo/BeiDou/GLONASS double differences with per-system reference
satellites (GLONASS DD ambiguities stay float-only — inter-channel FDMA
biases make their integers unreliable, as rtklib's default also treats
them). No tropo/iono gradient states (short-baseline assumption).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.pvt.ephemeris import C_LIGHT, OMEGA_E, eph_to_pos_vel_clock
from gnss_sdr_tpu_torch.pvt.lambda_ilr import lambda_fix


@dataclass
class DiffObs:
    """One satellite's observables at one station (code + carrier)."""

    system: str
    prn: int
    pseudorange_m: float
    carrier_phase_cycles: float       # accumulated, sign: phase ~ -range/lambda
    wavelength_m: float
    cn0_dbhz: float = 45.0


@dataclass
class RtkSolution:
    valid: bool = False
    pos_ecef: np.ndarray | None = None
    fixed: bool = False               # integer ambiguities accepted
    ratio: float = 0.0
    num_dd: int = 0
    baseline_m: float = 0.0


def _sat_pos(eph, t_tx: float) -> np.ndarray:
    p, _, _, _ = eph_to_pos_vel_clock(eph, t_tx)
    return p


class RtkEngine:
    """Single-baseline RTK/DGPS filter (reference rtkpos() modes
    PMODE_DGPS / PMODE_KINEMA / PMODE_STATIC)."""

    def __init__(
        self,
        base_pos_ecef: np.ndarray,
        mode: str = "kinematic",          # "dgps" | "kinematic" | "static"
        code_sigma_m: float = 0.5,
        phase_sigma_m: float = 0.005,
        pos_process_noise_m: float = 10.0,   # per sqrt(s), kinematic
        ratio_threshold: float = 3.0,
    ) -> None:
        self.base_pos = np.asarray(base_pos_ecef, dtype=np.float64)
        self.mode = mode
        self.code_sigma = code_sigma_m
        self.phase_sigma = phase_sigma_m
        self.pos_q = pos_process_noise_m
        self.ratio_threshold = ratio_threshold
        # EKF state: x = [pos(3), N_sd for tracked (sys, prn)]
        self.x: np.ndarray | None = None
        self.P: np.ndarray | None = None
        self.amb_index: dict[tuple[str, int], int] = {}
        self.t_last: float | None = None

    # ------------------------------------------------------------- plumbing
    def _ensure_states(self, keys: list[tuple[str, int]],
                       sd_phase_minus_code: dict) -> None:
        """Grow the filter for new single-difference ambiguity states."""
        if self.x is None:
            self.x = np.zeros(3)
            self.x[:] = self.base_pos          # start at the base
            self.P = np.eye(3) * 1e6
        for key in keys:
            if key not in self.amb_index:
                n = len(self.x)
                self.amb_index[key] = n
                self.x = np.append(self.x, sd_phase_minus_code.get(key, 0.0))
                P = np.zeros((n + 1, n + 1))
                P[:n, :n] = self.P
                P[n, n] = 1e4                   # cycles^2, fresh ambiguity
                self.P = P
        # drop states for satellites gone > this epoch
        live = set(keys)
        for key in [k for k in self.amb_index if k not in live]:
            i = self.amb_index.pop(key)
            keep = [j for j in range(len(self.x)) if j != i]
            self.x = self.x[keep]
            self.P = self.P[np.ix_(keep, keep)]
            for k2, j in self.amb_index.items():
                if j > i:
                    self.amb_index[k2] = j - 1

    # ------------------------------------------------------------ the epoch
    def process_epoch(
        self,
        t: float,
        rover: list[DiffObs],
        base: list[DiffObs],
        ephemerides: dict,
    ) -> RtkSolution:
        """One common-epoch update. `rover`/`base` observables must be
        epoch-aligned (the reference interpolates base obs in time; the
        caller does the same here if base epochs differ)."""
        base_by = {(o.system, o.prn): o for o in base}
        pairs = [
            (r, base_by[(r.system, r.prn)])
            for r in rover if (r.system, r.prn) in base_by
            and (r.system, r.prn) in ephemerides
        ]
        if len(pairs) < 4:
            return RtkSolution()

        # satellite positions at transmit (approx: geometry-grade)
        sat_pos = {}
        for r, b in pairs:
            key = (r.system, r.prn)
            tau = r.pseudorange_m / C_LIGHT
            p = _sat_pos(ephemerides[key], t - tau)
            theta = OMEGA_E * tau
            rot = np.array([
                [np.cos(theta), np.sin(theta), 0.0],
                [-np.sin(theta), np.cos(theta), 0.0],
                [0.0, 0.0, 1.0],
            ])
            sat_pos[key] = rot @ p

        # reference satellite per system: highest elevation proxy = max C/N0
        by_sys: dict[str, list] = {}
        for r, b in pairs:
            by_sys.setdefault(r.system, []).append((r, b))
        refs = {
            s: max(lst, key=lambda rb: rb[0].cn0_dbhz)[0].prn
            for s, lst in by_sys.items()
        }

        if self.mode == "dgps":
            return self._dgps(t, pairs, refs, sat_pos)
        return self._rtk(t, pairs, refs, sat_pos)

    # ----------------------------------------------------------------- DGPS
    def _dgps(self, t, pairs, refs, sat_pos) -> RtkSolution:
        """Code double differences, iterated LS (rtkpos PMODE_DGPS)."""
        x = self.base_pos.copy()
        for _ in range(6):
            rows, resid = [], []
            for sys, lst in _group(pairs).items():
                ref_key = (sys, refs[sys])
                rr, bb = next(
                    (r, b) for r, b in lst if r.prn == refs[sys])
                for r, b in lst:
                    if r.prn == refs[sys]:
                        continue
                    key = (sys, r.prn)
                    dd = (r.pseudorange_m - b.pseudorange_m) - (
                        rr.pseudorange_m - bb.pseudorange_m)
                    e_i = _unit(sat_pos[key], x)
                    e_r = _unit(sat_pos[ref_key], x)
                    rho = (
                        np.linalg.norm(sat_pos[key] - x)
                        - np.linalg.norm(sat_pos[key] - self.base_pos)
                        - np.linalg.norm(sat_pos[ref_key] - x)
                        + np.linalg.norm(sat_pos[ref_key] - self.base_pos)
                    )
                    resid.append(dd - rho)
                    rows.append(-(e_i - e_r))
            if len(resid) < 3:
                return RtkSolution()
            H = np.asarray(rows)
            v = np.asarray(resid)
            dx, *_ = np.linalg.lstsq(H, v, rcond=None)
            x += dx
            if np.linalg.norm(dx) < 1e-4:
                break
        return RtkSolution(
            valid=True, pos_ecef=x, fixed=False, num_dd=len(v),
            baseline_m=float(np.linalg.norm(x - self.base_pos)),
        )

    # ------------------------------------------------------------------ RTK
    def _rtk(self, t, pairs, refs, sat_pos) -> RtkSolution:
        keys = [(r.system, r.prn) for r, _ in pairs]
        # rough SD ambiguity init from (phase - code/lambda)
        sd_init = {}
        for r, b in pairs:
            lam = r.wavelength_m
            sd_init[(r.system, r.prn)] = (
                (r.carrier_phase_cycles - b.carrier_phase_cycles)
                + (r.pseudorange_m - b.pseudorange_m) / lam
            )
        self._ensure_states(keys, sd_init)
        n = len(self.x)

        # time update
        if self.t_last is not None and self.mode == "kinematic":
            dt = max(t - self.t_last, 0.0)
            self.P[:3, :3] += np.eye(3) * (self.pos_q ** 2) * dt
        elif self.t_last is None:
            pass
        self.t_last = t

        # measurement update: DD code + DD phase
        H_rows, v_rows, r_diag = [], [], []
        dd_keys = []
        x = self.x
        for sys, lst in _group(pairs).items():
            ref_key = (sys, refs[sys])
            rr, bb = next((r, b) for r, b in lst if r.prn == refs[sys])
            for r, b in lst:
                if r.prn == refs[sys]:
                    continue
                key = (sys, r.prn)
                lam = r.wavelength_m
                e_i = _unit(sat_pos[key], x[:3])
                e_r = _unit(sat_pos[ref_key], x[:3])
                rho = (
                    np.linalg.norm(sat_pos[key] - x[:3])
                    - np.linalg.norm(sat_pos[key] - self.base_pos)
                    - np.linalg.norm(sat_pos[ref_key] - x[:3])
                    + np.linalg.norm(sat_pos[ref_key] - self.base_pos)
                )
                # code DD
                dd_p = (r.pseudorange_m - b.pseudorange_m) - (
                    rr.pseudorange_m - bb.pseudorange_m)
                row = np.zeros(n)
                row[:3] = -(e_i - e_r)
                H_rows.append(row)
                v_rows.append(dd_p - rho)
                r_diag.append(self.code_sigma ** 2 * 4)
                # phase DD: lam*(dd_phase) = rho + lam*(N_i - N_ref)
                dd_l = (r.carrier_phase_cycles - b.carrier_phase_cycles) - (
                    rr.carrier_phase_cycles - bb.carrier_phase_cycles)
                # carrier phase accumulates -doppler: phase decreases as
                # range grows; observable convention: lam*phase ~ -range.
                row = np.zeros(n)
                row[:3] = (e_i - e_r) / lam
                row[self.amb_index[key]] = 1.0
                row[self.amb_index[ref_key]] = -1.0
                H_rows.append(row)
                v_rows.append(dd_l - (-rho / lam
                                      + x[self.amb_index[key]]
                                      - x[self.amb_index[ref_key]]))
                r_diag.append((self.phase_sigma / lam) ** 2 * 4)
                if sys != "R":
                    dd_keys.append((key, ref_key))
        if len(v_rows) < 6:
            return RtkSolution()
        H = np.asarray(H_rows)
        v = np.asarray(v_rows)
        R = np.diag(r_diag)
        # EKF update
        S = H @ self.P @ H.T + R
        K = self.P @ H.T @ np.linalg.inv(S)
        self.x = self.x + K @ v
        self.P = (np.eye(n) - K @ H) @ self.P

        pos_float = self.x[:3].copy()
        sol = RtkSolution(
            valid=True, pos_ecef=pos_float, fixed=False,
            num_dd=len(dd_keys),
            baseline_m=float(np.linalg.norm(pos_float - self.base_pos)),
        )

        # ---- integer fixing on DD ambiguities (non-GLONASS)
        if not dd_keys:
            return sol
        m = len(dd_keys)
        T = np.zeros((m, n))
        for i, (key, ref_key) in enumerate(dd_keys):
            T[i, self.amb_index[key]] = 1.0
            T[i, self.amb_index[ref_key]] = -1.0
        a_float = T @ self.x
        Q_a = T @ self.P @ T.T
        Q_a = 0.5 * (Q_a + Q_a.T) + np.eye(m) * 1e-12
        a_fix, ratio = lambda_fix(a_float, Q_a, self.ratio_threshold)
        sol.ratio = ratio
        if a_fix is None:
            return sol
        # constrain the solution to the fixed integers:
        # x_fixed = x - P T' (T P T')^-1 (a_float - a_fix)
        TP = T @ self.P
        corr = TP.T @ np.linalg.solve(Q_a, a_float - a_fix)
        x_fixed = self.x - corr
        sol.pos_ecef = x_fixed[:3].copy()
        sol.fixed = True
        sol.baseline_m = float(np.linalg.norm(sol.pos_ecef - self.base_pos))
        return sol


def _group(pairs) -> dict[str, list]:
    out: dict[str, list] = {}
    for r, b in pairs:
        out.setdefault(r.system, []).append((r, b))
    return out


def _unit(sat: np.ndarray, rx: np.ndarray) -> np.ndarray:
    d = sat - rx
    return d / np.linalg.norm(d)
