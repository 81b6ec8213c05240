# Copied from gnss_sdr_tpu/simulate/beidou.py; only the package imports are rewritten.
"""Synthetic BeiDou MEO constellation + B1I D1 signal scenario.

Counterpart of simulate/scenario.py (GPS) for BeiDou B1I: nominal Walker
24/3/1 MEO shell (GEO/IGSO PRN 1-5 are D2 satellites and are not
simulated), live D1 NAV bit streams on the BDT timescale, NH(20)
secondary modulation, geometry-consistent baseband at the 1561.098 MHz
carrier. Reference analog: the gnss-sim BeiDou outputs used by the
reference's BeiDou system tests (SURVEY.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.codes.beidou_b1i import beidou_b1i_code, nh20_levels
from gnss_sdr_tpu_torch.constants import beidou_b1i as BDS
from gnss_sdr_tpu_torch.simulate.constellation import truth_measurement, visible_sats
from gnss_sdr_tpu_torch.telemetry.dnav import BeidouEphemeris, D1Encoder

BDS_MEO_SQRT_A = 5282.6           # ~27900 km semi-major axis
BDS_INCLINATION = 0.9599          # 55 deg


def make_beidou_constellation(
    num_sats: int = 24,
    week: int = 550,
    toe: float = 7200.0,
    seed: int = 0,
) -> dict[int, BeidouEphemeris]:
    """Nominal Walker 24/3/1 BeiDou MEO shell, PRNs 6..29 (MEO range)."""
    rng = np.random.default_rng(seed + 211)
    ephs: dict[int, BeidouEphemeris] = {}
    for i in range(num_sats):
        prn = i + 6
        plane = i % 3
        slot = i // 3
        ephs[prn] = BeidouEphemeris(
            prn=prn, week=week, aodc=1, aode=1,
            toc=toe, toe=toe,
            af0=float(rng.uniform(-2e-4, 2e-4)),
            af1=float(rng.uniform(-3e-12, 3e-12)),
            af2=0.0,
            tgd=float(rng.uniform(-1e-8, 1e-8)),
            sqrt_a=BDS_MEO_SQRT_A + float(rng.uniform(-0.2, 0.2)),
            ecc=float(rng.uniform(0.0005, 0.005)),
            m0=float((2.0 * np.pi * slot / 8.0 + plane * 0.26
                      + rng.uniform(-0.1, 0.1)) % (2 * np.pi) - np.pi),
            omega0=float((2.0 * np.pi * plane / 3.0
                          + rng.uniform(-0.05, 0.05)) % (2 * np.pi) - np.pi),
            i0=BDS_INCLINATION + float(rng.uniform(-0.02, 0.02)),
            omega=float(rng.uniform(-np.pi, np.pi)),
            omega_dot=-6.5e-9,
            idot=float(rng.uniform(-3e-10, 3e-10)),
            delta_n=float(rng.uniform(2e-9, 5e-9)),
            cus=float(rng.uniform(-7e-6, 7e-6)),
            cuc=float(rng.uniform(-7e-6, 7e-6)),
            crs=float(rng.uniform(-90, 90)),
            crc=float(rng.uniform(90, 280)),
            cis=float(rng.uniform(-2e-7, 2e-7)),
            cic=float(rng.uniform(-2e-7, 2e-7)),
        )
    return ephs


@dataclass
class BeidouScenarioConfig:
    fs: float = 2.6e6
    tow_start_s: float = 7320.0          # receiver-clock GPS TOW at sample 0
    duration_s: float = 40.0
    cn0_dbhz: float = 45.0
    rx_lat_deg: float = 41.275
    rx_lon_deg: float = 1.9876
    rx_height_m: float = 80.0
    rx_clock_bias_s: float = 0.0
    rx_clock_drift_ss: float = 0.0
    min_elevation_deg: float = 15.0
    max_sats: int = 8
    noise: bool = True
    seed: int = 0
    grid_step_s: float = 0.02
    tropo: bool = True


class BeidouScenario:
    """Multi-satellite B1I scenario with truth accessors (API-compatible
    with GpsScenario so captures can be mixed)."""

    def __init__(
        self,
        cfg: BeidouScenarioConfig,
        ephemerides: dict[int, BeidouEphemeris] | None = None,
    ) -> None:
        from gnss_sdr_tpu_torch.pvt.coords import llh_to_ecef

        self.cfg = cfg
        self.ephs = ephemerides if ephemerides is not None else (
            make_beidou_constellation(seed=cfg.seed)
        )
        self.rx_ecef = llh_to_ecef(
            np.deg2rad(cfg.rx_lat_deg), np.deg2rad(cfg.rx_lon_deg),
            cfg.rx_height_m,
        )
        vis = visible_sats(
            self.ephs, self.rx_ecef, cfg.tow_start_s,
            np.deg2rad(cfg.min_elevation_deg),
        )
        self.prns = vis[: cfg.max_sats]
        self.encoders = {p: D1Encoder(self.ephs[p]) for p in self.prns}
        self._nh = nh20_levels()
        self._grids: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._geo: dict[int, dict] = {}
        self._build_grids()

    # ------------------------------------------------------------------ truth
    def rx_clock_tow(self, sample: float) -> float:
        return self.cfg.tow_start_s + sample / self.cfg.fs

    def rx_bias_at(self, sample: float) -> float:
        t = sample / self.cfg.fs
        return self.cfg.rx_clock_bias_s + self.cfg.rx_clock_drift_ss * t

    def truth_at(self, prn: int, sample: float) -> dict:
        tr = dict(truth_measurement(
            self.ephs[prn], self.rx_ecef, self.rx_clock_tow(sample),
            rx_clock_bias_s=self.rx_bias_at(sample),
        ))
        tr["doppler_hz"] = tr["doppler_hz"] * BDS.FREQ_HZ / 1575.42e6
        return tr

    # ------------------------------------------------------------- grid setup
    def _build_grids(self) -> None:
        from gnss_sdr_tpu_torch.pvt.atmosphere import tropo_delay
        from gnss_sdr_tpu_torch.pvt.coords import az_el, ecef_to_llh
        from gnss_sdr_tpu_torch.pvt.ephemeris import C_LIGHT

        cfg = self.cfg
        _, _, hgt = ecef_to_llh(self.rx_ecef)
        n_grid = int(np.ceil(cfg.duration_s / cfg.grid_step_s)) + 3
        t_grid = np.arange(n_grid) * cfg.grid_step_s
        for prn in self.prns:
            ttx_sv = np.empty(n_grid)
            tropo_m = np.zeros(n_grid)
            for i, tg in enumerate(t_grid):
                tr = truth_measurement(
                    self.ephs[prn], self.rx_ecef,
                    cfg.tow_start_s + tg,
                    rx_clock_bias_s=cfg.rx_clock_bias_s
                    + cfg.rx_clock_drift_ss * tg,
                )
                ttx_sv[i] = tr["t_tx_sv"]
                if cfg.tropo:
                    _, el = az_el(self.rx_ecef, tr["sat_pos_rx_frame"])
                    tropo_m[i] = tropo_delay(el, hgt)
            self._geo[prn] = {
                "t": t_grid, "ttx_sv": ttx_sv,
                "iono_m": np.zeros(n_grid), "tropo_m": tropo_m,
            }
            # TGD1 is the B1I group delay directly (BDS-SIS-ICD 5.2.4.10)
            ttx = ttx_sv - self.ephs[prn].tgd - tropo_m / C_LIGHT
            self._grids[prn] = (t_grid, ttx)

    # --------------------------------------------------------------- generate
    def generate(self, start_sample: int, num_samples: int) -> np.ndarray:
        cfg = self.cfg
        t = (start_sample + np.arange(num_samples, dtype=np.float64)) / cfg.fs
        acc = np.zeros(num_samples, dtype=np.complex128)
        amp = np.sqrt(10.0 ** (cfg.cn0_dbhz / 10.0) / cfg.fs)
        for prn in self.prns:
            tg, ttxg = self._grids[prn]
            ttx = np.interp(t, tg, ttxg)
            chip = np.floor(ttx * BDS.CODE_RATE_CPS).astype(np.int64)
            code = beidou_b1i_code(prn)[chip % BDS.CODE_LENGTH_CHIPS]
            period = np.floor_divide(chip, BDS.CODE_LENGTH_CHIPS)
            nh = self._nh[period % 20]
            # D1 bits ride the BDT timescale (GPS time - 14 s)
            bit_idx = np.floor(
                (ttx - BDS.BDT_TO_GPST_S) * BDS.BIT_RATE_BPS
            ).astype(np.int64)
            uniq, inv = np.unique(bit_idx, return_inverse=True)
            signs = self.encoders[prn].bits_at(uniq)[inv]
            cycles = -BDS.FREQ_HZ * (t - ttx)
            phase = 2.0 * np.pi * np.mod(cycles, 1.0)
            acc += amp * code * nh * signs * np.exp(1j * phase)
        if cfg.noise:
            rng = np.random.default_rng(
                (cfg.seed * 0x41C64E6D + start_sample) & 0x7FFFFFFF
            )
            acc += rng.normal(scale=np.sqrt(0.5), size=num_samples)
            acc += 1j * rng.normal(scale=np.sqrt(0.5), size=num_samples)
        return acc.astype(np.complex64)

    @property
    def total_samples(self) -> int:
        return int(self.cfg.duration_s * self.cfg.fs)
