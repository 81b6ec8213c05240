# Copied from gnss_sdr_tpu/pvt/kf.py; only the package imports are rewritten.
"""Position/velocity Kalman smoothing of single-point solutions.

Equivalent in role to the reference's Pvt_Kf
(src/algorithms/PVT/libs/pvt_kf.{h,cc}): a 6-state constant-velocity
filter over the LS solver's ECEF position/velocity outputs, engaged by
``PVT.enable_pvt_kf``. Static and dynamic process noises mirror the
reference's config knobs (measured_ecef_vel_sd_m_s etc.).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PvtKfConfig:
    # measurement standard deviations (reference Kf_* config defaults)
    measures_pos_sd_m: float = 1.0
    measures_vel_sd_ms: float = 0.1
    # process noise: random-walk acceleration driving the velocity states
    system_vel_sd_ms: float = 0.1       # m/s per sqrt(s) velocity walk
    system_pos_sd_m: float = 0.01       # extra position process noise
    # reject-and-reset guard: innovation beyond this many sigmas resets
    # the filter (reference re-initializes on large residuals)
    reset_innovation_sigmas: float = 10.0


class PvtKalmanFilter:
    """x = [pos_ecef (3), vel_ecef (3)]; measurements: LS pos + vel."""

    def __init__(self, cfg: PvtKfConfig | None = None) -> None:
        self.cfg = cfg or PvtKfConfig()
        self.x: np.ndarray | None = None
        self.P: np.ndarray | None = None
        self.t_last: float | None = None

    def reset(self) -> None:
        self.x = None
        self.P = None
        self.t_last = None

    def update(self, t_s: float, pos_ecef: np.ndarray,
               vel_ecef: np.ndarray | None) -> tuple[np.ndarray, np.ndarray]:
        """Fuse one epoch's LS outputs; returns smoothed (pos, vel)."""
        cfg = self.cfg
        z_pos = np.asarray(pos_ecef, dtype=np.float64)
        has_vel = vel_ecef is not None and np.all(np.isfinite(vel_ecef))
        z_vel = (np.asarray(vel_ecef, dtype=np.float64)
                 if has_vel else np.zeros(3))

        if self.x is None or self.t_last is None:
            self.x = np.concatenate([z_pos, z_vel])
            self.P = np.diag([cfg.measures_pos_sd_m**2] * 3
                             + [max(cfg.measures_vel_sd_ms, 1.0)**2] * 3)
            self.t_last = t_s
            return self.x[:3].copy(), self.x[3:].copy()

        dt = max(t_s - self.t_last, 1e-3)
        self.t_last = t_s

        # predict: constant velocity
        f_mat = np.eye(6)
        f_mat[0:3, 3:6] = dt * np.eye(3)
        qv = cfg.system_vel_sd_ms**2 * dt
        qp = cfg.system_pos_sd_m**2 * dt + qv * dt * dt / 3.0
        q_mat = np.zeros((6, 6))
        q_mat[0:3, 0:3] = qp * np.eye(3)
        q_mat[0:3, 3:6] = q_mat[3:6, 0:3] = 0.5 * qv * dt * np.eye(3)
        q_mat[3:6, 3:6] = qv * np.eye(3)
        x = f_mat @ self.x
        p_mat = f_mat @ self.P @ f_mat.T + q_mat

        # measure
        if has_vel:
            h_mat = np.eye(6)
            z = np.concatenate([z_pos, z_vel])
            r_mat = np.diag([cfg.measures_pos_sd_m**2] * 3
                            + [cfg.measures_vel_sd_ms**2] * 3)
        else:
            h_mat = np.zeros((3, 6))
            h_mat[:, :3] = np.eye(3)
            z = z_pos
            r_mat = cfg.measures_pos_sd_m**2 * np.eye(3)

        innov = z - h_mat @ x
        s_mat = h_mat @ p_mat @ h_mat.T + r_mat
        # divergence guard: a jump far beyond the innovation covariance
        # means the filter state is stale (first fix after an outage)
        n_sig = float(innov @ np.linalg.solve(s_mat, innov)) / len(innov)
        if n_sig > self.cfg.reset_innovation_sigmas**2:
            self.reset()
            return self.update(t_s, pos_ecef, vel_ecef)

        k_gain = p_mat @ h_mat.T @ np.linalg.inv(s_mat)
        self.x = x + k_gain @ innov
        self.P = (np.eye(6) - k_gain @ h_mat) @ p_mat
        return self.x[:3].copy(), self.x[3:].copy()
