# Copied from gnss_sdr_tpu/simulate/galileo.py; only the package imports are rewritten.
"""Synthetic Galileo constellation + E1-B signal scenario.

Counterpart of simulate/scenario.py (GPS): builds a nominal Walker 24/3/1
Galileo constellation, encodes live I/NAV symbol streams, and synthesizes
geometry-consistent CBOC(6,1,1/11) baseband — the Galileo half of what the
reference's external gnss-sim generator provides its system tests
(SURVEY.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.codes.galileo_e1 import (
    CBOC_ALPHA,
    cboc_expand,
    galileo_e1b_code,
)


def _sinboc_component(chips: np.ndarray) -> np.ndarray:
    """In-band sinBOC(1,1) part of the CBOC waveform on the same
    12-subchip grid, amplitude CBOC_ALPHA = sqrt(10/11) — what a
    narrowband front end passes of the composite (the BOC(6,1) sideband
    at +-6.138 MHz is filtered; same for data and pilot)."""
    sc1 = np.repeat(np.array([1.0, -1.0], dtype=np.float32), 6)
    wave = np.float32(CBOC_ALPHA) * sc1
    return (chips.astype(np.float32)[:, None] * wave[None, :]).reshape(-1)
from gnss_sdr_tpu_torch.constants import galileo_e1 as GAL
from gnss_sdr_tpu_torch.simulate.constellation import truth_measurement, visible_sats
from gnss_sdr_tpu_torch.telemetry.inav import (
    GalileoEphemeris,
    GalileoIono,
    InavEncoder,
)

GAL_SQRT_A = 5440.588        # ~29600 km semi-major axis
GAL_INCLINATION = 0.9774     # 56 deg
SYMBOL_S = 1.0 / GAL.SYMBOL_RATE_SPS


def make_galileo_constellation(
    num_sats: int = 24,
    week: int = 1250,
    toe: float = 7200.0,
    seed: int = 0,
) -> dict[int, GalileoEphemeris]:
    """Nominal Walker 24/3/1 Galileo constellation with ICD-representable
    parameter values (quantization applied on encode)."""
    rng = np.random.default_rng(seed + 101)
    ephs: dict[int, GalileoEphemeris] = {}
    for i in range(num_sats):
        prn = i + 1
        plane = i % 3
        slot = i // 3
        ephs[prn] = GalileoEphemeris(
            prn=prn, week=week, iod_nav=prn,
            toc=toe, toe=toe,
            af0=float(rng.uniform(-2e-4, 2e-4)),
            af1=float(rng.uniform(-3e-12, 3e-12)),
            af2=0.0,
            bgd_e1e5a=float(rng.uniform(-6e-9, 6e-9)),
            bgd_e1e5b=float(rng.uniform(-6e-9, 6e-9)),
            sqrt_a=GAL_SQRT_A + float(rng.uniform(-0.2, 0.2)),
            ecc=float(rng.uniform(0.0002, 0.003)),
            m0=float((2.0 * np.pi * slot / 8.0 + plane * 0.3
                      + rng.uniform(-0.1, 0.1)) % (2 * np.pi) - np.pi),
            omega0=float((2.0 * np.pi * plane / 3.0
                          + rng.uniform(-0.05, 0.05)) % (2 * np.pi) - np.pi),
            i0=GAL_INCLINATION + float(rng.uniform(-0.02, 0.02)),
            omega=float(rng.uniform(-np.pi, np.pi)),
            omega_dot=-5.6e-9,
            idot=float(rng.uniform(-3e-10, 3e-10)),
            delta_n=float(rng.uniform(2e-9, 4e-9)),
            cus=float(rng.uniform(-6e-6, 6e-6)),
            cuc=float(rng.uniform(-6e-6, 6e-6)),
            crs=float(rng.uniform(-80, 80)),
            crc=float(rng.uniform(80, 250)),
            cis=float(rng.uniform(-2e-7, 2e-7)),
            cic=float(rng.uniform(-2e-7, 2e-7)),
        )
    return ephs


@dataclass
class GalileoScenarioConfig:
    fs: float = 2.6e6
    tow_start_s: float = 7320.0          # receiver-clock TOW at sample 0
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
    tropo: bool = True                   # simulate Saastamoinen delay
    # emit the E1-C pilot component (ICD composite
    # s = (e_B*cboc_B - e_C*cboc_C)/sqrt(2), pilot carrying the CS25
    # secondary). Off by default: the legacy data-only capture puts the
    # full C/N0 on E1-B (existing tests); pilot-tracking tests enable it.
    emit_pilot: bool = False
    # Emit the full CBOC(6,1,1/11) waveform vs the in-band sinBOC(1,1)
    # component only (amplitude sqrt(10/11)). None = auto by fs: the
    # BOC(6,1) sideband sits at +-6.138 MHz, so any fs below ~14 Msps
    # models a narrowband front end that filters it out — POINT-sampling
    # the 12-subchip CBOC grid at such rates would alias the sideband
    # into deterministic prompt-amplitude modulation no real capture
    # shows (it read as ~10 dB of fake "noise" to the variance-based
    # C/N0 estimator).
    cboc: bool | None = None
    # OSNMA broadcast: an OsnmaSigner whose chain params cover the
    # scenario's GST span; each I/NAV page then carries the 40-bit
    # HKROOT/MACK field, tags MAC'd over inav_auth_message(eph).
    # ``osnma_tamper``: PRNs whose tags are signed over FLIPPED nav bits
    # (spoof stand-in — their tags must fail authentication).
    osnma_signer: object = None
    osnma_tamper: tuple = ()


class GalileoScenario:
    """Multi-satellite Galileo E1-B scenario with truth accessors.

    Same API as simulate.scenario.GpsScenario, so system tests can sum the
    two basebands for a dual-constellation capture (set noise=False on one).
    """

    def __init__(
        self,
        cfg: GalileoScenarioConfig,
        ephemerides: dict[int, GalileoEphemeris] | None = None,
    ) -> None:
        from gnss_sdr_tpu_torch.pvt.coords import llh_to_ecef

        self.cfg = cfg
        self.ephs = ephemerides if ephemerides is not None else (
            make_galileo_constellation(seed=cfg.seed)
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
        # I/NAV streams start at the GST even-page boundary at/below the
        # earliest transmit time in the scenario
        t_tx_min = cfg.tow_start_s - 0.1
        self._tow0 = 2.0 * np.floor(t_tx_min / 2.0) - 2.0
        n_pages = int(np.ceil(cfg.duration_s / 2.0)) + 4
        self._signs: dict[int, np.ndarray] = {}
        self._mack_cache: dict[tuple[int, int], np.ndarray] = {}
        for p in self.prns:
            enc = InavEncoder(self.ephs[p], GalileoIono(), tow0_s=self._tow0,
                              osnma_page_bits=self._osnma_page_fn(p))
            syms = enc.symbols(num_pages=n_pages)
            self._signs[p] = (1.0 - 2.0 * syms.astype(np.float64))
        self._grids: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._grids_phase: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._geo: dict[int, dict] = {}
        self._cboc: dict[int, np.ndarray] = {}
        self._cboc_pilot: dict[int, np.ndarray] = {}
        self._build_grids()

    def _osnma_page_fn(self, prn: int):
        """Per-page 40-bit OSNMA field callable for one satellite, or
        None when the scenario has no signer. Page k starts at GST
        self._tow0 + 2k; its subframe/slot follow from the 30 s grid."""
        signer = self.cfg.osnma_signer
        if signer is None:
            return None
        from gnss_sdr_tpu_torch.telemetry.osnma import inav_auth_message

        hkroots = signer.dsm_kroot_subframes()
        p = signer.params
        week = int(self.ephs[prn].week)
        auth = inav_auth_message(self.ephs[prn])
        if prn in self.cfg.osnma_tamper:
            auth = (1 - auth).astype(auth.dtype)

        def page_bits(k: int) -> np.ndarray:
            tow_k = int(round(self._tow0)) + 2 * k
            sf_id, rem = divmod(tow_k % 604800, 30)
            slot = rem // 2
            hk = hkroots[sf_id % len(hkroots)]
            ci = ((week - p.wn0) * 604800 + sf_id * 30
                  - p.tow0_hours * 3600) // 30
            if ci < 0 or ci + 1 >= len(signer.keys):
                mack = np.zeros(480, np.uint8)
            else:
                key = (prn, sf_id)
                if key not in self._mack_cache:
                    self._mack_cache[key] = signer.mack_subframe(
                        int(ci), auth, prn=prn)
                mack = self._mack_cache[key]
            return np.concatenate([hk[slot * 8:(slot + 1) * 8],
                                   mack[slot * 32:(slot + 1) * 32]])

        return page_bits

    # ------------------------------------------------------------------ truth
    def rx_clock_tow(self, sample: float) -> float:
        return self.cfg.tow_start_s + sample / self.cfg.fs

    def rx_bias_at(self, sample: float) -> float:
        t = sample / self.cfg.fs
        return self.cfg.rx_clock_bias_s + self.cfg.rx_clock_drift_ss * t

    def truth_at(self, prn: int, sample: float) -> dict:
        return truth_measurement(
            self.ephs[prn], self.rx_ecef, self.rx_clock_tow(sample),
            rx_clock_bias_s=self.rx_bias_at(sample),
        )

    # ------------------------------------------------------------- grid setup
    def _build_grids(self) -> None:
        cfg = self.cfg
        n_grid = int(np.ceil(cfg.duration_s / cfg.grid_step_s)) + 3
        t_grid = np.arange(n_grid) * cfg.grid_step_s
        from gnss_sdr_tpu_torch.pvt.atmosphere import tropo_delay
        from gnss_sdr_tpu_torch.pvt.coords import az_el, ecef_to_llh
        from gnss_sdr_tpu_torch.pvt.ephemeris import C_LIGHT

        _, _, hgt = ecef_to_llh(self.rx_ecef)
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
            # E1 code rides the SV clock timeline minus the E1 broadcast
            # group delay (BGD E1/E5b), mirroring the GPS TGD convention
            ttx = ttx_sv - self.ephs[prn].tgd - tropo_m / C_LIGHT
            self._grids[prn] = (t_grid, ttx)
            self._grids_phase[prn] = (t_grid, ttx)
            use_cboc = (self.cfg.cboc if self.cfg.cboc is not None
                        else self.cfg.fs >= 14e6)
            self._cboc[prn] = (
                cboc_expand(galileo_e1b_code(prn)) if use_cboc
                else _sinboc_component(galileo_e1b_code(prn)))
            if self.cfg.emit_pilot:
                from gnss_sdr_tpu_torch.codes.galileo_e1 import (
                    e1c_secondary_chips,
                    galileo_e1c_code,
                )

                self._cboc_pilot[prn] = (
                    cboc_expand(galileo_e1c_code(prn), pilot=True)
                    if use_cboc
                    else _sinboc_component(galileo_e1c_code(prn)))
                self._cs25 = e1c_secondary_chips().astype(np.float64)

    # --------------------------------------------------------------- generate
    def generate(self, start_sample: int, num_samples: int) -> np.ndarray:
        """Complex64 baseband chunk for samples [start, start+num)."""
        cfg = self.cfg
        t = (start_sample + np.arange(num_samples, dtype=np.float64)) / cfg.fs
        acc = np.zeros(num_samples, dtype=np.complex128)
        amp = np.sqrt(10.0 ** (cfg.cn0_dbhz / 10.0) / cfg.fs)
        sub_rate = 12.0 * GAL.CODE_RATE_CPS
        sub_len = 12 * GAL.CODE_LENGTH_CHIPS
        for prn in self.prns:
            tg, ttxg = self._grids[prn]
            ttx = np.interp(t, tg, ttxg)
            # integrate-and-dump front end: average the waveform over each
            # sampling cell (4-point boxcar on the 12-subchip grid) instead
            # of point sampling. At commensurate rates (fs = 4.092e6 is
            # EXACTLY 2 samples/subchip) point sampling pins every chip
            # transition to the same grid phase, and the residual
            # code-Doppler slide coherently amplitude-modulates the prompt
            # by ~15% at ~Hz rates — which variance-based C/N0 estimators
            # read as ~8 dB of fake noise. A real ADC integrates over the
            # cell; so does this.
            # centered on ttx: offsets (-1.5, -0.5, +0.5, +1.5) cells.
            # A one-sided boxcar ([ttx, ttx + 1/fs]) delays the signal by
            # half a sample (192 ns at 2.6 Msps) — invisible to a
            # single-constellation solve (absorbed by the rx clock bias)
            # but read as a ~57 m inter-system bias in a GPS+GAL fix.
            cell = 1.0 / (4.0 * cfg.fs)
            sub4 = [np.floor((ttx + (j - 1.5) * cell) * sub_rate)
                    .astype(np.int64) for j in range(4)]
            wave = self._cboc[prn]
            chips = sum(wave[s % sub_len] for s in sub4) / 4.0
            sym_idx = np.floor((ttx - self._tow0) / SYMBOL_S).astype(np.int64)
            signs = self._signs[prn][np.clip(sym_idx, 0,
                                             len(self._signs[prn]) - 1)]
            cycles = -GAL.FREQ_HZ * (t - ttx)
            phase = 2.0 * np.pi * np.mod(cycles, 1.0)
            if cfg.emit_pilot:
                # ICD composite: data and pilot at half power each, pilot
                # with the structural minus sign and CS25 secondary
                pwave = self._cboc_pilot[prn]
                pilot = sum(pwave[s % sub_len] for s in sub4) / 4.0
                per_idx = np.floor(ttx / GAL.CODE_PERIOD_S).astype(np.int64)
                cs = self._cs25[per_idx % 25]
                comp = (chips * signs - pilot * cs) / np.sqrt(2.0)
                acc += amp * comp * np.exp(1j * phase)
            else:
                acc += amp * chips * signs * np.exp(1j * phase)
        if cfg.noise:
            rng = np.random.default_rng(
                (cfg.seed * 0x51ED2701 + start_sample) & 0x7FFFFFFF
            )
            acc += rng.normal(scale=np.sqrt(0.5), size=num_samples)
            acc += 1j * rng.normal(scale=np.sqrt(0.5), size=num_samples)
        return acc.astype(np.complex64)

    @property
    def total_samples(self) -> int:
        return int(self.cfg.duration_s * self.cfg.fs)
