# Copied from gnss_sdr_tpu/simulate/multiband.py; only the package imports are rewritten.
"""Secondary-band signal scenarios: GPS L5 and Galileo E5a basebands that
share geometry with a primary-band scenario.

A dual-band receiver sees the same satellites through two front-ends with a
common sample clock; here a `GpsL5Band` / `GalileoE5aBand` wraps the
primary `GpsScenario` / `GalileoScenario` (same constellation, receiver
position, clock model, and light-time grids) and synthesizes the second
band's QPSK baseband at its own sample rate:

- data component (I): primary code x data secondary (NH10 / CS20_1) x
  CNAV (100 sym/s) or FNAV (50 sym/s) encoded symbols;
- pilot component (Q): pilot primary code x pilot secondary (NH20 / CS100);
- each component carries half the configured C/N0 power (IS-GPS-705 §3.2,
  Galileo OS SIS ICD §2.3);
- the band's code timeline rides the satellite clock minus the band's
  group delay: gamma * TGD for L5 (IS-GPS-200 20.3.3.3.3.2), gamma *
  BGD(E1,E5a) for E5a, with gamma = (f_L1/f_band)^2 — mirroring what the
  reference's rtklib prange() undoes at the solver.

Secondary-code epochs align with symbol and TOW boundaries by construction
(the encoders start at a TOW that is a whole number of secondary epochs).

Reference analog: the external gnss-sim generator's multi-band outputs used
by position_test (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.constants import galileo_e5a as E5A
from gnss_sdr_tpu_torch.constants import gps_l5 as L5
from gnss_sdr_tpu_torch.simulate.galileo import GalileoScenario
from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario

L1_HZ = 1575.42e6
GAMMA_L5 = (L1_HZ / L5.FREQ_HZ) ** 2
GAMMA_E5A = (L1_HZ / E5A.FREQ_HZ) ** 2


class _SecondaryBand:
    """Shared machinery: geometry from the primary scenario, band-specific
    codes/symbols from the subclass."""

    freq_hz: float
    code_rate: float
    code_len: int

    def __init__(self, primary, fs: float, cn0_dbhz: float = 45.0,
                 noise: bool = True, seed_offset: int = 77) -> None:
        self.primary = primary
        self.fs = fs
        self.cn0_dbhz = cn0_dbhz
        self.noise = noise
        self.seed = primary.cfg.seed + seed_offset
        self.prns = list(primary.prns)
        # band timelines from the primary's geometric grids: SV timeline
        # minus the band group delay, plus the band-scaled atmosphere
        # (iono is dispersive: gamma x the L1 delay; tropo is not)
        gamma = (L1_HZ / self.freq_hz) ** 2
        self._grids: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._grids_phase: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        c = 299_792_458.0
        for prn in self.prns:
            geo = primary._geo[prn]
            gd = self._group_delay_shift(prn)
            base = geo["ttx_sv"] - gd
            self._grids[prn] = (
                geo["t"],
                base - (geo["tropo_m"] + gamma * geo["iono_m"]) / c,
            )
            self._grids_phase[prn] = (
                geo["t"],
                base - (geo["tropo_m"] - gamma * geo["iono_m"]) / c,
            )
        self._signs: dict[int, np.ndarray] = {}
        self._build_symbols()

    # -- subclass hooks -----------------------------------------------------
    def _group_delay_shift(self, prn: int) -> float:
        raise NotImplementedError

    def _build_symbols(self) -> None:
        raise NotImplementedError

    def _codes(self, prn: int) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _secondaries(self, prn: int) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _symbol_idx(self, ttx: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- truth --------------------------------------------------------------
    def truth_at(self, prn: int, sample: float) -> dict:
        """Geometry truth at this band's sample index (Doppler scaled to
        the band carrier; pseudorange gets the band group delay)."""
        tr = dict(self.primary.truth_at(prn, sample * self.primary.cfg.fs
                                        / self.fs))
        tr["doppler_hz"] = tr["doppler_hz"] * self.freq_hz / L1_HZ
        return tr

    # -- generation ----------------------------------------------------------
    def generate(self, start_sample: int, num_samples: int) -> np.ndarray:
        t = (start_sample + np.arange(num_samples, dtype=np.float64)) / self.fs
        acc = np.zeros(num_samples, dtype=np.complex128)
        amp = np.sqrt(10.0 ** (self.cn0_dbhz / 10.0) / self.fs)
        for prn in self.prns:
            tg, ttxg = self._grids[prn]
            ttx = np.interp(t, tg, ttxg)
            chip = np.floor(ttx * self.code_rate).astype(np.int64)
            period = np.floor_divide(chip, self.code_len)
            code_d, code_p = self._codes(prn)
            sec_d, sec_p = self._secondaries(prn)
            sym_idx = self._symbol_idx(ttx)
            signs = self._signs[prn][
                np.clip(sym_idx, 0, len(self._signs[prn]) - 1)
            ]
            data = (code_d[chip % self.code_len]
                    * sec_d[period % len(sec_d)] * signs)
            pilot = (code_p[chip % self.code_len]
                     * sec_p[period % len(sec_p)])
            cycles = -self.freq_hz * (t - ttx)
            phase = 2.0 * np.pi * np.mod(cycles, 1.0)
            acc += amp * (data + 1j * pilot) / np.sqrt(2.0) * np.exp(
                1j * phase
            )
        if self.noise:
            rng = np.random.default_rng(
                (self.seed * 0x2545F491 + start_sample) & 0x7FFFFFFF
            )
            acc += rng.normal(scale=np.sqrt(0.5), size=num_samples)
            acc += 1j * rng.normal(scale=np.sqrt(0.5), size=num_samples)
        return acc.astype(np.complex64)

    @property
    def total_samples(self) -> int:
        return int(self.primary.cfg.duration_s * self.fs)


class GpsL5Band(_SecondaryBand):
    """GPS L5 (I: CNAV x NH10, Q: pilot x NH20) sharing a GpsScenario's
    geometry. Reference analog: gps_l5_signal_replica.cc +
    gps_l5_telemetry_decoder_gs.cc signal model."""

    freq_hz = L5.FREQ_HZ
    code_rate = L5.CODE_RATE_CPS
    code_len = L5.CODE_LENGTH_CHIPS
    signal = "L5"

    def __init__(self, primary: GpsScenario, fs: float,
                 cn0_dbhz: float = 45.0, noise: bool = True) -> None:
        super().__init__(primary, fs, cn0_dbhz, noise)

    def _group_delay_shift(self, prn: int) -> float:
        # band timelines subtract the shift from the RAW SV timeline
        # (geo["ttx_sv"], before the primary's own TGD):
        # L5 timeline = t_tx_sv - gamma * TGD (IS-GPS-200 20.3.3.3.3.2)
        tgd = self.primary.ephs[prn].tgd
        return GAMMA_L5 * tgd

    def _build_symbols(self) -> None:
        from gnss_sdr_tpu_torch.telemetry.cnav import CnavEncoder, MSG_SECONDS

        cfg = self.primary.cfg
        # CNAV messages start on 6 s TOW boundaries at/below the earliest
        # transmit time (6000 ms-periods per message: NH10/NH20 aligned)
        self._tow0 = MSG_SECONDS * np.floor(
            (cfg.tow_start_s - 0.1) / MSG_SECONDS
        ) - MSG_SECONDS
        n_msgs = int(np.ceil(cfg.duration_s / MSG_SECONDS)) + 3
        for p in self.prns:
            enc = CnavEncoder(self.primary.ephs[p], tow0_s=self._tow0)
            syms = enc.symbols(n_msgs)
            self._signs[p] = 1.0 - 2.0 * syms.astype(np.float64)

    def _codes(self, prn: int):
        from gnss_sdr_tpu_torch.codes.gps_l5 import gps_l5i_code, gps_l5q_code

        return (gps_l5i_code(prn).astype(np.float64),
                gps_l5q_code(prn).astype(np.float64))

    def _secondaries(self, prn: int):
        from gnss_sdr_tpu_torch.codes.gps_l5 import nh10_levels, nh20_levels

        return (nh10_levels().astype(np.float64),
                nh20_levels().astype(np.float64))

    def _symbol_idx(self, ttx: np.ndarray) -> np.ndarray:
        return np.floor(
            (ttx - self._tow0) * L5.SYMBOL_RATE_SPS
        ).astype(np.int64)


class GalileoE5aBand(_SecondaryBand):
    """Galileo E5a (I: FNAV x CS20, Q: pilot x CS100) sharing a
    GalileoScenario's geometry. Reference analog:
    galileo_e5_signal_replica.cc + galileo_telemetry_decoder_gs.cc FNAV."""

    freq_hz = E5A.FREQ_HZ
    code_rate = E5A.CODE_RATE_CPS
    code_len = E5A.CODE_LENGTH_CHIPS
    signal = "5X"

    def __init__(self, primary: GalileoScenario, fs: float,
                 cn0_dbhz: float = 45.0, noise: bool = True) -> None:
        super().__init__(primary, fs, cn0_dbhz, noise)

    def _group_delay_shift(self, prn: int) -> float:
        # shift from the RAW SV timeline:
        # E5a timeline = t_tx_sv - gamma_E5a * BGD(E1,E5a) (Galileo ICD 5.1.5)
        eph = self.primary.ephs[prn]
        return GAMMA_E5A * eph.bgd_e1e5a

    def _build_symbols(self) -> None:
        from gnss_sdr_tpu_torch.telemetry.fnav import FnavEncoder, PAGE_SECONDS
        from gnss_sdr_tpu_torch.telemetry.inav import GalileoIono

        cfg = self.primary.cfg
        # FNAV pages start on 10 s boundaries (10000 ms-periods per page:
        # CS20/CS100 epochs aligned)
        self._tow0 = PAGE_SECONDS * np.floor(
            (cfg.tow_start_s - 0.1) / PAGE_SECONDS
        ) - PAGE_SECONDS
        n_pages = int(np.ceil(cfg.duration_s / PAGE_SECONDS)) + 3
        for p in self.prns:
            enc = FnavEncoder(self.primary.ephs[p], GalileoIono(),
                              tow0_s=self._tow0)
            syms = enc.symbols(n_pages)
            self._signs[p] = 1.0 - 2.0 * syms.astype(np.float64)

    def _codes(self, prn: int):
        from gnss_sdr_tpu_torch.codes.galileo_e5a import (
            galileo_e5ai_code,
            galileo_e5aq_code,
        )

        return (galileo_e5ai_code(prn).astype(np.float64),
                galileo_e5aq_code(prn).astype(np.float64))

    def _secondaries(self, prn: int):
        from gnss_sdr_tpu_torch.codes.galileo_e5a import (
            e5ai_secondary_levels,
            e5aq_secondary_levels,
        )

        return (e5ai_secondary_levels().astype(np.float64),
                e5aq_secondary_levels(prn).astype(np.float64))

    def _symbol_idx(self, ttx: np.ndarray) -> np.ndarray:
        return np.floor(
            (ttx - self._tow0) * E5A.SYMBOL_RATE_SPS
        ).astype(np.int64)


class GalileoE5bBand(_SecondaryBand):
    """Galileo E5b (I: I/NAV x CS4, Q: pilot x CS100) sharing a
    GalileoScenario's geometry. The E5b-I symbol stream reuses the
    primary scenario's live I/NAV encoding (both components run 250 sym/s
    with the same page timing; the real SIS interleaves different word
    sequences, which the word-agnostic InavDecoder doesn't depend on).
    Reference analog: galileo_e5_signal_replica.cc +
    galileo_telemetry_decoder_gs.cc I/NAV on E5b."""

    freq_hz = 1207.14e6
    code_rate = 10.23e6
    code_len = 10230
    signal = "7X"

    def __init__(self, primary: GalileoScenario, fs: float,
                 cn0_dbhz: float = 45.0, noise: bool = True) -> None:
        super().__init__(primary, fs, cn0_dbhz, noise, seed_offset=79)

    def _group_delay_shift(self, prn: int) -> float:
        # shift from the RAW SV timeline: E5b timeline =
        # t_tx_sv - gamma_E5b * BGD(E1,E5b) (ICD eq. 15 broadcast-group-
        # delay scaling between E1 and E5b)
        gamma = (L1_HZ / self.freq_hz) ** 2
        eph = self.primary.ephs[prn]
        return gamma * eph.bgd_e1e5b

    def _build_symbols(self) -> None:
        self._tow0 = self.primary._tow0
        for p in self.prns:
            self._signs[p] = self.primary._signs[p]

    def _codes(self, prn: int):
        from gnss_sdr_tpu_torch.codes.galileo_e5b import (
            galileo_e5bi_code,
            galileo_e5bq_code,
        )

        return (galileo_e5bi_code(prn).astype(np.float64),
                galileo_e5bq_code(prn).astype(np.float64))

    def _secondaries(self, prn: int):
        from gnss_sdr_tpu_torch.codes.galileo_e5b import (
            e5bi_secondary_levels,
            e5bq_secondary_levels,
        )

        return (e5bi_secondary_levels().astype(np.float64),
                e5bq_secondary_levels(prn).astype(np.float64))

    def _symbol_idx(self, ttx: np.ndarray) -> np.ndarray:
        return np.floor((ttx - self._tow0) * 250.0).astype(np.int64)


class GpsL2Band(_SecondaryBand):
    """GPS L2C CM-only band sharing a GpsScenario's geometry: BPSK CM
    chips x CNAV (50 sym/s, 12 s messages). The CL multiplexing is not
    modeled (the receiver's CM-only replica ignores it; on real SIS the
    zero-mean CL half-chips just cost the documented 3 dB) — the data
    component therefore carries the full configured C/N0 (the +3 dB
    super().__init__ compensation undoes the QPSK half-power split).
    Reference analog: gps_l2c_signal_replica.cc +
    gps_l2c_telemetry_decoder_gs.cc signal model."""

    freq_hz = 1227.60e6
    code_rate = 0.5115e6
    code_len = 10230
    signal = "2S"

    def __init__(self, primary: GpsScenario, fs: float,
                 cn0_dbhz: float = 45.0, noise: bool = True) -> None:
        super().__init__(primary, fs, cn0_dbhz + 10.0 * np.log10(2.0),
                         noise, seed_offset=81)

    def _group_delay_shift(self, prn: int) -> float:
        # shift from the RAW SV timeline: L2 timeline = t_tx_sv - gamma*TGD
        gamma = (L1_HZ / self.freq_hz) ** 2
        tgd = self.primary.ephs[prn].tgd
        return gamma * tgd

    def _build_symbols(self) -> None:
        from gnss_sdr_tpu_torch.telemetry.cnav import CnavEncoder

        msg_s = 12.0              # 600 symbols at 50 sym/s
        cfg = self.primary.cfg
        self._tow0 = msg_s * np.floor((cfg.tow_start_s - 0.1) / msg_s) - msg_s
        n_msgs = int(np.ceil(cfg.duration_s / msg_s)) + 3
        for p in self.prns:
            enc = CnavEncoder(self.primary.ephs[p], tow0_s=self._tow0,
                              msg_seconds=msg_s)
            syms = enc.symbols(n_msgs)
            self._signs[p] = 1.0 - 2.0 * syms.astype(np.float64)

    def _codes(self, prn: int):
        from gnss_sdr_tpu_torch.codes.gps_l2c import gps_l2cm_code

        cm = gps_l2cm_code(prn)
        return cm, np.zeros_like(cm)     # no pilot component modeled

    def _secondaries(self, prn: int):
        one = np.ones(1, dtype=np.float64)
        return one, one

    def _symbol_idx(self, ttx: np.ndarray) -> np.ndarray:
        return np.floor((ttx - self._tow0) * 50.0).astype(np.int64)
