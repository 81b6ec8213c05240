# Copied from gnss_sdr_tpu/simulate/glonass.py; only the package imports are rewritten.
"""Synthetic GLONASS constellation + L1 C/A FDMA signal scenario.

Counterpart of simulate/scenario.py (GPS) for GLONASS: nominal 3-plane,
64.8-degree constellation expressed as GNAV state-vector ephemerides
(position/velocity at tb in the rotating PZ-90 frame), live GNAV string
streams (time mark + bi-binary data, KX check bits), and a
geometry-consistent baseband where each slot rides its own FDMA carrier
k * 562.5 kHz off band center. Truth is *defined* by the same J2/RK4
propagation the receiver's geph2pos-equivalent uses
(pvt/glonass.py), so simulator and PVT share the orbit model exactly —
the reference relies on gnss-sim the same way (SURVEY.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.codes.glonass_ca import glonass_ca_code
from gnss_sdr_tpu_torch.constants import glonass_l1 as GLO
from gnss_sdr_tpu_torch.pvt.glonass import GlonassEphemeris
from gnss_sdr_tpu_torch.simulate.constellation import truth_measurement, visible_sats
from gnss_sdr_tpu_torch.telemetry.gnav import GnavEncoder, align_tb_gps, gpst_to_glot

GLO_SQRT_A = 5049.6              # ~25500 km semi-major axis
GLO_INCLINATION = 1.1310         # 64.8 deg
GPS_L1_HZ = 1575.42e6


def make_glonass_constellation(
    week: int = 2290,
    tb_approx_tow: float = 7500.0,
    seed: int = 0,
) -> dict[int, GlonassEphemeris]:
    """24-slot nominal constellation. Orbit shapes are drawn as Kepler
    elements for realism, converted once to ECEF state vectors at tb (the
    GNAV broadcast form); from there the J2/RK4 integrator is the single
    source of orbital truth."""
    from gnss_sdr_tpu_torch.simulate.constellation import make_constellation
    from gnss_sdr_tpu_torch.pvt.ephemeris import eph_to_pos_vel_clock

    rng = np.random.default_rng(seed + 747)
    tb = align_tb_gps(week, tb_approx_tow)
    base = make_constellation(num_sats=24, toe=tb, seed=seed + 747)
    ephs: dict[int, GlonassEphemeris] = {}
    for i, slot in enumerate(range(1, 25)):
        k = base[i + 1]
        # reshape the GPS-style draw into GLONASS geometry: 3 planes,
        # higher inclination, slightly lower orbit
        k.sqrt_a = GLO_SQRT_A + float(rng.uniform(-0.2, 0.2))
        k.i0 = GLO_INCLINATION + float(rng.uniform(-0.01, 0.01))
        k.omega0 = float(
            (2.0 * np.pi * (i % 3) / 3.0 + rng.uniform(-0.05, 0.05))
            % (2 * np.pi) - np.pi
        )
        k.m0 = float(
            (2.0 * np.pi * (i // 3) / 8.0 + (i % 3) * 0.26
             + rng.uniform(-0.1, 0.1)) % (2 * np.pi) - np.pi
        )
        pos, vel, _, _ = eph_to_pos_vel_clock(k, tb)
        ephs[slot] = GlonassEphemeris(
            slot=slot,
            freq_k=GLO.SLOT_TO_K[slot],
            tb_gps_tow=tb,
            pos=pos,
            vel=vel,
            acc=np.zeros(3),
            tau_n=float(rng.uniform(-1e-4, 1e-4)),
            gamma_n=float(rng.uniform(-1e-11, 1e-11)),
        )
    return ephs


@dataclass
class GlonassScenarioConfig:
    fs: float = 5.11e6                  # 10 samples/chip
    week: int = 2290
    tow_start_s: float = 7320.0         # receiver-clock GPS TOW at sample 0
    duration_s: float = 45.0
    cn0_dbhz: float = 45.0
    rx_lat_deg: float = 41.275
    rx_lon_deg: float = 1.9876
    rx_height_m: float = 80.0
    rx_clock_bias_s: float = 0.0
    rx_clock_drift_ss: float = 0.0
    min_elevation_deg: float = 15.0
    max_sats: int = 6
    noise: bool = True
    seed: int = 0
    grid_step_s: float = 0.02
    tropo: bool = True


class GlonassScenario:
    """Multi-slot GLONASS L1 scenario with truth accessors (API-compatible
    with GpsScenario/BeidouScenario)."""

    def __init__(
        self,
        cfg: GlonassScenarioConfig,
        ephemerides: dict[int, GlonassEphemeris] | None = None,
    ) -> None:
        from gnss_sdr_tpu_torch.pvt.coords import llh_to_ecef

        self.cfg = cfg
        self.ephs = ephemerides if ephemerides is not None else (
            make_glonass_constellation(
                week=cfg.week, tb_approx_tow=cfg.tow_start_s + 200.0,
                seed=cfg.seed,
            )
        )
        self.rx_ecef = llh_to_ecef(
            np.deg2rad(cfg.rx_lat_deg), np.deg2rad(cfg.rx_lon_deg),
            cfg.rx_height_m,
        )
        vis = visible_sats(
            self.ephs, self.rx_ecef, cfg.tow_start_s,
            np.deg2rad(cfg.min_elevation_deg),
        )
        # at most one slot per frequency channel k (antipodal slots share
        # k; both are never visible from one site, but the draw is random),
        # and only slots whose FDMA carrier + code mainlobe fit inside the
        # simulated band (real GLONASS front-ends sample >= 9 MHz to cover
        # k = -7..+6; narrower test captures carry the inner channels)
        seen_k, self.slots = set(), []
        for s in vis:
            k = self.ephs[s].freq_k
            if abs(k * GLO.DFREQ_HZ) + 0.6e6 > cfg.fs / 2.0:
                continue
            if k not in seen_k:
                seen_k.add(k)
                self.slots.append(s)
        self.slots = self.slots[: cfg.max_sats]
        self.encoders = {
            s: GnavEncoder(self.ephs[s], week=cfg.week) for s in self.slots
        }
        # GLONASS day time at GPS tow_start (strings tick on this scale)
        self._tod_ref, _, _ = gpst_to_glot(cfg.week, cfg.tow_start_s)
        self._code = glonass_ca_code().astype(np.float64)
        self._grids: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._build_grids()

    # ------------------------------------------------------------------ truth
    @property
    def prns(self) -> list[int]:
        return self.slots

    def rx_clock_tow(self, sample: float) -> float:
        return self.cfg.tow_start_s + sample / self.cfg.fs

    def rx_bias_at(self, sample: float) -> float:
        t = sample / self.cfg.fs
        return self.cfg.rx_clock_bias_s + self.cfg.rx_clock_drift_ss * t

    def truth_at(self, slot: int, sample: float) -> dict:
        tr = dict(truth_measurement(
            self.ephs[slot], self.rx_ecef, self.rx_clock_tow(sample),
            rx_clock_bias_s=self.rx_bias_at(sample),
        ))
        f_ch = GLO.channel_freq_hz(slot)
        tr["doppler_hz"] = tr["doppler_hz"] * f_ch / GPS_L1_HZ
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
        for slot in self.slots:
            ttx_sv = np.empty(n_grid)
            tropo_m = np.zeros(n_grid)
            for i, tg in enumerate(t_grid):
                tr = truth_measurement(
                    self.ephs[slot], self.rx_ecef,
                    cfg.tow_start_s + tg,
                    rx_clock_bias_s=cfg.rx_clock_bias_s
                    + cfg.rx_clock_drift_ss * tg,
                )
                ttx_sv[i] = tr["t_tx_sv"]
                if cfg.tropo:
                    _, el = az_el(self.rx_ecef, tr["sat_pos_rx_frame"])
                    tropo_m[i] = tropo_delay(el, hgt)
            ttx = ttx_sv - tropo_m / C_LIGHT
            self._grids[slot] = (t_grid, ttx)

    # --------------------------------------------------------------- generate
    def generate(self, start_sample: int, num_samples: int) -> np.ndarray:
        cfg = self.cfg
        t = (start_sample + np.arange(num_samples, dtype=np.float64)) / cfg.fs
        acc = np.zeros(num_samples, dtype=np.complex128)
        amp = np.sqrt(10.0 ** (cfg.cn0_dbhz / 10.0) / cfg.fs)
        for slot in self.slots:
            tg, ttxg = self._grids[slot]
            ttx = np.interp(t, tg, ttxg)
            chip = np.floor(ttx * GLO.CODE_RATE_CPS).astype(np.int64)
            code = self._code[chip % GLO.CODE_LENGTH_CHIPS]
            # GNAV symbols tick on the GLONASS day scale (10 ms each)
            tod_tx = self._tod_ref + (ttx - cfg.tow_start_s)
            sym_idx = np.floor(tod_tx / GLO.SYMBOL_PERIOD_S).astype(np.int64)
            uniq, inv = np.unique(sym_idx, return_inverse=True)
            signs = self.encoders[slot].symbols_at(uniq)[inv]
            # baseband after mixing with the band-center LO: the slot's
            # FDMA offset remains as a carrier, the geometry rides the
            # slot's true RF frequency
            f_ch = GLO.channel_freq_hz(slot)
            k_off = GLO.SLOT_TO_K[slot] * GLO.DFREQ_HZ
            cycles = k_off * t - f_ch * (t - ttx)
            phase = 2.0 * np.pi * np.mod(cycles, 1.0)
            acc += amp * code * signs * np.exp(1j * phase)
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
