"""Signal plans: everything the receiver needs to run one signal type.

Counterpart of ``gnss_sdr_tpu/receiver/plans.py``, every plan of it:
``SignalPlan``, ``gps_l1ca_plan``, ``qzss_l1_ca_plan``, ``sbas_l1_plan``,
``gps_l2c_plan``, ``galileo_e1b_plan``, ``galileo_e1bc_plan``,
``gps_l5_plan``, ``qzss_l5_plan``, ``galileo_e5a_plan``,
``galileo_e5b_plan``, ``galileo_e6b_plan``, ``glonass_l1_ca_plan``,
``glonass_l2_ca_plan``, ``beidou_b1i_plan``, ``beidou_b1i_geo_plan``,
``beidou_b3i_plan`` and ``beidou_b3i_geo_plan``. A plan bundles
the per-signal pieces the reference spreads across an adapter triple
(Acq/Trk/Tlm) plus the code tables: the engines are built per plan, and
the channels of a plan are one batch on the device. BOC signals use
subcarrier-expanded code tables (table units = sub-chips): all tracking
code-phase quantities are then in table units, and ``table_rate_cps``
converts them to seconds for the observables.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np

from gnss_sdr_tpu_torch.acquisition import AcqConfig
from gnss_sdr_tpu_torch.codes.beidou_b1i import beidou_b1i_code_table
from gnss_sdr_tpu_torch.codes.beidou_b1i import nh20_levels as bds_nh20_levels
from gnss_sdr_tpu_torch.codes.beidou_b3i import beidou_b3i_code_table
from gnss_sdr_tpu_torch.codes.galileo_e1 import (
    SINBOC_TABLE_LENGTH,
    SINBOC_TABLE_RATE_CPS,
    e1c_secondary_chips,
    galileo_e1b_sinboc_table,
    galileo_e1c_sinboc_table,
)
from gnss_sdr_tpu_torch.codes.galileo_e5a import (
    e5ai_secondary_levels,
    e5aq_secondary_levels,
    galileo_e5ai_code_table,
    galileo_e5aq_code_table,
)
from gnss_sdr_tpu_torch.codes.galileo_e5b import (
    e5bi_secondary_levels,
    e5bq_secondary_levels,
    galileo_e5bi_code_table,
    galileo_e5bq_code_table,
)
from gnss_sdr_tpu_torch.codes.galileo_e6 import galileo_e6b_code_table
from gnss_sdr_tpu_torch.codes.glonass_ca import (
    glonass_ca_code_table,
    slot_freq_offsets_hz,
)
from gnss_sdr_tpu_torch.codes.gps_l1_ca import (
    gps_l1_ca_code,
    gps_l1_ca_code_table,
)
from gnss_sdr_tpu_torch.codes.gps_l2c import gps_l2cm_code_table
from gnss_sdr_tpu_torch.codes.gps_l5 import (
    gps_l5i_code_table,
    gps_l5q_code_table,
    nh10_levels,
    nh20_levels,
    qzss_l5i_code,
    qzss_l5q_code,
)
from gnss_sdr_tpu_torch.constants import beidou_b1i as BDS
from gnss_sdr_tpu_torch.constants import beidou_b3i as B3
from gnss_sdr_tpu_torch.constants import galileo_e1 as GAL
from gnss_sdr_tpu_torch.constants import galileo_e5a as E5A
from gnss_sdr_tpu_torch.constants import galileo_e5b as E5B
from gnss_sdr_tpu_torch.constants import galileo_e6 as E6
from gnss_sdr_tpu_torch.constants import glonass_l1 as GLO
from gnss_sdr_tpu_torch.constants import gps_l1_ca as GPS
from gnss_sdr_tpu_torch.constants import gps_l2c as L2C
from gnss_sdr_tpu_torch.constants import gps_l5 as L5
from gnss_sdr_tpu_torch.telemetry.cnav import CnavDecoder
from gnss_sdr_tpu_torch.telemetry.dnav import D1Decoder
from gnss_sdr_tpu_torch.telemetry.dnav_d2 import D2Decoder
from gnss_sdr_tpu_torch.telemetry.fnav import FnavDecoder
from gnss_sdr_tpu_torch.telemetry.gnav import GnavDecoder
from gnss_sdr_tpu_torch.telemetry.hascnav import CnavStreamDecoder
from gnss_sdr_tpu_torch.telemetry.inav import InavDecoder
from gnss_sdr_tpu_torch.telemetry.lnav import LnavDecoder
from gnss_sdr_tpu_torch.telemetry.sbas import SbasDecoder
from gnss_sdr_tpu_torch.tracking import DllPllConf


@dataclass
class SignalPlan:
    name: str                      # reference signal id: "1C", "1B", ...
    system: str                    # 'G', 'E'
    num_channels: int
    code_table: np.ndarray         # [P, table_length] (PILOT code if pilot plan)
    table_rate_cps: float          # table units per second
    carrier_freq_hz: float
    code_period_s: float
    acq_conf: AcqConfig
    trk_conf: DllPllConf
    make_decoder: Callable[[int], object]
    search_prns: tuple = ()
    prn_row: Callable[[int], int] = lambda prn: prn - 1
    # band key: plans sharing a band consume the same sample stream
    band: str = "L1"
    # pilot-tracking plans (track_pilot): data-component code + secondaries
    data_code_table: np.ndarray | None = None   # [P, table_length]
    sec_pilot_table: np.ndarray | None = None   # [P, sec_len_pilot] +-1
    sec_data_levels: np.ndarray | None = None   # [sec_len_data] +-1
    # acquisition searches this table when set (pilot plans may acquire on
    # the data code: same chip boundaries, no secondary ambiguity inside
    # one period)
    acq_code_table: np.ndarray | None = None
    # per-block binary dumps (not carried by the port yet)
    dump_filename: str | None = None
    acq_dump_filename: str | None = None
    # FDMA (GLONASS): per-PRN-row carrier offsets from band center; the
    # acquisition grid and tracking NCO add offset(prn), and the channel's
    # true carrier is carrier_freq_hz + offset(prn)
    freq_offset_table: np.ndarray | None = None
    # acquisition engine variant; the port carries "pcps"
    acq_engine: str = "pcps"
    acq_engine_params: dict = field(default_factory=dict)
    # tracking loop-closure variant; the port carries "dll_pll"
    trk_engine: str = "dll_pll"
    trk_engine_params: dict = field(default_factory=dict)

    def carrier_offset_hz(self, prn: int) -> float:
        if self.freq_offset_table is None:
            return 0.0
        return float(self.freq_offset_table[self.prn_row(prn)])

    @property
    def fs(self) -> float:
        return self.acq_conf.fs

    @property
    def table_length(self) -> int:
        return self.code_table.shape[1]


def gps_l1ca_plan(
    fs: float,
    num_channels: int = 8,
    doppler_max_hz: float = 5000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 35.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 7.5,
    dll_bw_narrow_hz: float = 0.75,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    extend_correlation_symbols: int = 20,
    search_prns: tuple = tuple(range(1, 33)),
    steps_per_block: int = 20,
) -> SignalPlan:
    """GPS L1 C/A (reference adapters GPS_L1_CA_PCPS_Acquisition /
    GPS_L1_CA_DLL_PLL_Tracking / GPS_L1_CA_Telemetry_Decoder).

    ``steps_per_block``: code periods per tracking call; larger blocks
    trade control-loop reaction latency for fewer launches."""
    return SignalPlan(
        name="1C",
        system="G",
        num_channels=num_channels,
        code_table=gps_l1_ca_code_table(),
        table_rate_cps=GPS.CODE_RATE_CPS,
        carrier_freq_hz=GPS.FREQ_HZ,
        code_period_s=GPS.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=GPS.CODE_LENGTH_CHIPS,
            code_rate_cps=GPS.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=GPS.CODE_LENGTH_CHIPS,
            code_rate_cps=GPS.CODE_RATE_CPS,
            carrier_freq_hz=GPS.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=extend_correlation_symbols,
            codes_per_bit=GPS.CODES_PER_BIT,
            max_channels=num_channels,
            steps_per_block=steps_per_block,
        ),
        make_decoder=LnavDecoder,
        search_prns=search_prns,
    )


def _rs_inav(prn: int):
    """InavDecoder with FEC2 CED assembly enabled (reference
    TelemetryDecoder_1B.enable_reed_solomon)."""
    d = InavDecoder(prn)
    d.enable_reed_solomon()
    return d


def galileo_e1b_plan(
    fs: float,
    num_channels: int = 8,
    doppler_max_hz: float = 5000.0,
    doppler_step_hz: float = 125.0,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 15.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 7.5,
    dll_bw_narrow_hz: float = 0.5,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.5,
    early_late_space_chips: float = 0.25,
    search_prns: tuple = tuple(range(1, 37)),
    enable_reed_solomon: bool = False,
    steps_per_block: int | None = None,
) -> SignalPlan:
    """Galileo E1-B data channel with a sinBOC(1,1) replica
    (reference adapters Galileo_E1_PCPS_Ambiguous_Acquisition /
    Galileo_E1_DLL_PLL_VEML_Tracking / Galileo_E1B_Telemetry_Decoder).

    Table units are sinBOC sub-chips (2 per primary chip, 2.046 Mcps):
    spacing/code-phase parameters are converted here so plan users think in
    primary chips. The 4 ms symbol equals one code period, so tracking runs
    with extend_correlation_symbols=1 and telemetry consumes every period's
    prompt sign (250 sym/s).
    """
    table = galileo_e1b_sinboc_table()
    # BOC(1,1) has a sharp triangular peak of +-0.5 primary chips; VEML adds
    # the very-early/late taps that disambiguate its side peaks
    el_sub = 2.0 * early_late_space_chips
    vel_sub = 2.0 * 0.6
    return SignalPlan(
        name="1B",
        system="E",
        num_channels=num_channels,
        code_table=table,
        table_rate_cps=SINBOC_TABLE_RATE_CPS,
        carrier_freq_hz=GAL.FREQ_HZ,
        code_period_s=GAL.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=SINBOC_TABLE_LENGTH,
            code_rate_cps=SINBOC_TABLE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=1,
            # the 4 ms symbol can flip mid-window; double-length FFT
            # (reference bit_transition_flag for E1) keeps one clean period
            bit_transition_flag=True,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=SINBOC_TABLE_LENGTH,
            code_rate_cps=SINBOC_TABLE_RATE_CPS,
            carrier_freq_hz=GAL.FREQ_HZ,
            early_late_spacing_chips=el_sub,
            very_early_late_spacing_chips=vel_sub,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=1,
            codes_per_bit=1,
            steps_per_block=steps_per_block or 8,          # 8 x 4 ms = 32 ms per device call
            max_channels=num_channels,
        ),
        make_decoder=(
            (lambda prn: _rs_inav(prn)) if enable_reed_solomon
            else InavDecoder),
        search_prns=search_prns,
    )


def galileo_e1bc_plan(
    fs: float,
    num_channels: int = 8,
    doppler_max_hz: float = 5000.0,
    doppler_step_hz: float = 125.0,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 15.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 2.5,
    dll_bw_narrow_hz: float = 0.35,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.5,
    early_late_space_chips: float = 0.25,
    extend_correlation_symbols: int = 5,
    search_prns: tuple = tuple(range(1, 37)),
    enable_reed_solomon: bool = False,
    steps_per_block: int | None = None,
) -> SignalPlan:
    """Galileo E1 B+C with PILOT tracking (the reference's default E1
    configuration: Galileo_E1_DLL_PLL_VEML_Tracking with track_pilot=true,
    dll_pll_conf.h:81): VEML taps run on the E1-C pilot, the CS25
    secondary is wiped on-device after host sync, the PLL goes
    four-quadrant, and coherent integration extends past the 4 ms
    data-symbol ceiling (default 20 ms; up to the 100 ms secondary epoch —
    each T of coherent extension narrows the Costas pull range to
    +-1/(4T), so very long T needs a correspondingly settled loop). A
    separate prompt correlator on E1-B feeds the I/NAV decoder."""
    pilot_table = galileo_e1c_sinboc_table()
    data_table = galileo_e1b_sinboc_table()
    cs25 = e1c_secondary_chips().astype(np.float32)
    sec_pilot = np.tile(cs25, (pilot_table.shape[0], 1))
    el_sub = 2.0 * early_late_space_chips
    vel_sub = 2.0 * 0.6
    extend = min(extend_correlation_symbols, 25)
    return SignalPlan(
        name="1B",
        system="E",
        num_channels=num_channels,
        code_table=pilot_table,
        table_rate_cps=SINBOC_TABLE_RATE_CPS,
        carrier_freq_hz=GAL.FREQ_HZ,
        code_period_s=GAL.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=SINBOC_TABLE_LENGTH,
            code_rate_cps=SINBOC_TABLE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=1,
            bit_transition_flag=True,
            pfa=acq_pfa,
            # two-step Doppler zoom: with 4 ms coherent periods the FLL's
            # false-lock lines sit at +-125 Hz, and a 125 Hz primary grid
            # leaves up to 62.5 Hz of error — exactly the watershed. The
            # fine pass hands tracking a <16 Hz seed (reference E1 confs
            # use make_two_steps for the same reason).
            make_two_steps=True,
            doppler_step2_hz=31.25,
            num_doppler_bins_step2=4,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=SINBOC_TABLE_LENGTH,
            code_rate_cps=SINBOC_TABLE_RATE_CPS,
            carrier_freq_hz=GAL.FREQ_HZ,
            early_late_spacing_chips=el_sub,
            very_early_late_spacing_chips=vel_sub,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=extend,
            codes_per_bit=1,
            track_pilot=True,
            sec_len_pilot=25,
            sec_len_data=1,
            pilot_pll_atan2=True,
            data_on_quadrature=False,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=(
            (lambda prn: _rs_inav(prn)) if enable_reed_solomon
            else InavDecoder),
        search_prns=search_prns,
        data_code_table=data_table,
        sec_pilot_table=sec_pilot,
        sec_data_levels=np.ones(1, dtype=np.float32),
        acq_code_table=data_table,
    )


def gps_l5_plan(
    fs: float,
    num_channels: int = 8,
    doppler_max_hz: float = 4000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 30.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 5.0,
    dll_bw_narrow_hz: float = 0.5,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    extend_correlation_symbols: int = 20,
    search_prns: tuple = tuple(range(1, 33)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """GPS L5: pilot (Q, NH20) tracking with data (I, NH10 x CNAV) symbol
    extraction (reference adapters GPS_L5i_PCPS_Acquisition /
    GPS_L5_DLL_PLL_Tracking / GPS_L5_Telemetry_Decoder; signal model
    gps_l5_signal_replica.cc, track_pilot dll_pll_conf.h:81).

    Acquisition runs on the data (L5I) code with the double-length FFT:
    NH chips flip the sign at any code boundary inside the window, and the
    zero-padded-code FFT guarantees one cleanly correlated period
    (pcps_acquisition.cc bit_transition_flag)."""
    pilot_table = gps_l5q_code_table()
    data_table = gps_l5i_code_table()
    return SignalPlan(
        name="L5",
        system="G",
        band="L5",
        num_channels=num_channels,
        code_table=pilot_table,
        table_rate_cps=L5.CODE_RATE_CPS,
        carrier_freq_hz=L5.FREQ_HZ,
        code_period_s=L5.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=L5.CODE_LENGTH_CHIPS,
            code_rate_cps=L5.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            bit_transition_flag=True,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=L5.CODE_LENGTH_CHIPS,
            code_rate_cps=L5.CODE_RATE_CPS,
            carrier_freq_hz=L5.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=extend_correlation_symbols,
            codes_per_bit=L5.CODES_PER_SYMBOL,
            track_pilot=True,
            sec_len_pilot=20,
            sec_len_data=10,
            data_on_quadrature=True,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=CnavDecoder,
        search_prns=search_prns,
        data_code_table=data_table,
        sec_pilot_table=np.tile(nh20_levels(), (pilot_table.shape[0], 1)),
        sec_data_levels=nh10_levels(),
        acq_code_table=data_table,
    )


def galileo_e5a_plan(
    fs: float,
    num_channels: int = 8,
    doppler_max_hz: float = 4000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 20.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 5.0,
    dll_bw_narrow_hz: float = 0.5,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    extend_correlation_symbols: int = 20,
    search_prns: tuple = tuple(range(1, 37)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """Galileo E5a: pilot (Q, CS100) tracking with data (I, CS20 x FNAV)
    symbol extraction (reference adapters Galileo_E5a_Pcps_Acquisition /
    Galileo_E5a_DLL_PLL_Tracking / Galileo_E5a_Telemetry_Decoder; codes
    galileo_e5_signal_replica.cc, FNAV galileo_fnav_message.cc)."""
    # code tables carry 50 PRN rows but CS100 assignments exist for 1..47
    # (Galileo OS SIS ICD Table 19); search lists stay within 1..36
    pilot_table = galileo_e5aq_code_table()[:47]
    data_table = galileo_e5ai_code_table()[:47]
    sec_pilot = np.stack([
        e5aq_secondary_levels(p + 1) for p in range(pilot_table.shape[0])
    ])
    return SignalPlan(
        name="5X",
        system="E",
        band="L5",                   # E5a shares the 1176.45 MHz band
        num_channels=num_channels,
        code_table=pilot_table,
        table_rate_cps=E5A.CODE_RATE_CPS,
        carrier_freq_hz=E5A.FREQ_HZ,
        code_period_s=E5A.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=E5A.CODE_LENGTH_CHIPS,
            code_rate_cps=E5A.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            bit_transition_flag=True,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=E5A.CODE_LENGTH_CHIPS,
            code_rate_cps=E5A.CODE_RATE_CPS,
            carrier_freq_hz=E5A.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=extend_correlation_symbols,
            codes_per_bit=E5A.CODES_PER_SYMBOL,
            track_pilot=True,
            sec_len_pilot=100,
            sec_len_data=20,
            data_on_quadrature=True,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=FnavDecoder,
        search_prns=search_prns,
        data_code_table=data_table,
        sec_pilot_table=sec_pilot,
        sec_data_levels=e5ai_secondary_levels(),
        acq_code_table=data_table,
    )


def qzss_l1_ca_plan(
    fs: float,
    num_channels: int = 4,
    doppler_max_hz: float = 5000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 35.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 7.5,
    dll_bw_narrow_hz: float = 0.75,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    extend_correlation_symbols: int = 20,
    search_prns: tuple = tuple(range(193, 203)),
) -> SignalPlan:
    """QZSS L1 C/A (reference adapters QZSS_L1_PCPS_Acquisition /
    QZSS_L1_DLL_PLL_Tracking; codes qzss_signal_replica.cc): the GPS plan
    with the QZSS PRN rows (193..202), LNAV-compatible."""
    table = np.stack(
        [gps_l1_ca_code(p) for p in range(193, 203)]
    ).astype(np.float32)
    base = gps_l1ca_plan(
        fs=fs, num_channels=num_channels, doppler_max_hz=doppler_max_hz,
        doppler_step_hz=doppler_step_hz, acq_dwells=acq_dwells,
        acq_pfa=acq_pfa, pll_bw_hz=pll_bw_hz, dll_bw_hz=dll_bw_hz,
        pll_bw_narrow_hz=pll_bw_narrow_hz,
        dll_bw_narrow_hz=dll_bw_narrow_hz,
        enable_fll_pull_in=enable_fll_pull_in, fll_bw_hz=fll_bw_hz,
        pull_in_time_s=pull_in_time_s,
        extend_correlation_symbols=extend_correlation_symbols,
        search_prns=search_prns,
    )
    base.name = "J1"
    base.system = "J"
    base.code_table = table
    base.prn_row = lambda prn: prn - 193
    return base


def qzss_l5_plan(
    fs: float,
    num_channels: int = 4,
    doppler_max_hz: float = 4000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 30.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 5.0,
    dll_bw_narrow_hz: float = 0.5,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    extend_correlation_symbols: int = 20,
    search_prns: tuple = tuple(range(193, 203)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """QZSS L5 (PRN 193-202): GPS L5's signal structure (NH20 pilot, NH10
    x CNAV data) with the QZSS XB-initial-state codes (reference
    qzss_l5_signal_replica.cc, QZSS_L5i_PCPS_Acquisition /
    QZSS_L5i_DLL_PLL_Tracking adapters)."""
    prns = list(search_prns)
    pilot_table = np.stack([qzss_l5q_code(p) for p in prns]).astype(
        np.float32)
    data_table = np.stack([qzss_l5i_code(p) for p in prns]).astype(
        np.float32)
    return SignalPlan(
        name="J5",
        system="J",
        band="L5",
        num_channels=num_channels,
        code_table=pilot_table,
        table_rate_cps=L5.CODE_RATE_CPS,
        carrier_freq_hz=L5.FREQ_HZ,
        code_period_s=L5.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=L5.CODE_LENGTH_CHIPS,
            code_rate_cps=L5.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            bit_transition_flag=True,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=L5.CODE_LENGTH_CHIPS,
            code_rate_cps=L5.CODE_RATE_CPS,
            carrier_freq_hz=L5.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=extend_correlation_symbols,
            codes_per_bit=L5.CODES_PER_SYMBOL,
            track_pilot=True,
            sec_len_pilot=20,
            sec_len_data=10,
            data_on_quadrature=True,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=CnavDecoder,
        search_prns=tuple(prns),
        prn_row=lambda prn: prn - 193,
        data_code_table=data_table,
        sec_pilot_table=np.tile(nh20_levels(), (pilot_table.shape[0], 1)),
        sec_data_levels=nh10_levels(),
        acq_code_table=data_table,
    )


def galileo_e5b_plan(
    fs: float,
    num_channels: int = 8,
    doppler_max_hz: float = 4000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 20.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 5.0,
    dll_bw_narrow_hz: float = 0.5,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    extend_correlation_symbols: int = 4,
    search_prns: tuple = tuple(range(1, 37)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """Galileo E5b: pilot (Q, CS100) tracking with data (I, CS4 x I/NAV)
    symbol extraction (reference adapters Galileo_E5b_PCPS_Acquisition /
    Galileo_E5b_DLL_PLL_Tracking / Galileo_E5b_Telemetry_Decoder; codes
    galileo_e5_signal_replica.cc). E5b-I carries E1-B's I/NAV structure at
    250 sym/s, so the I/NAV decoder takes its data symbols; the CS4 data
    secondary spans one 4 ms symbol."""
    pilot_table = galileo_e5bq_code_table()
    data_table = galileo_e5bi_code_table()
    sec_pilot = np.stack([
        e5bq_secondary_levels(p + 1) for p in range(pilot_table.shape[0])
    ])
    extend = max(extend_correlation_symbols, 1) * E5B.CODES_PER_SYMBOL
    return SignalPlan(
        name="7X",
        system="E",
        band="E5b",
        num_channels=num_channels,
        code_table=pilot_table,
        table_rate_cps=E5B.CODE_RATE_CPS,
        carrier_freq_hz=E5B.FREQ_HZ,
        code_period_s=E5B.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=E5B.CODE_LENGTH_CHIPS,
            code_rate_cps=E5B.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            bit_transition_flag=True,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=E5B.CODE_LENGTH_CHIPS,
            code_rate_cps=E5B.CODE_RATE_CPS,
            carrier_freq_hz=E5B.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=extend,
            codes_per_bit=E5B.CODES_PER_SYMBOL,
            track_pilot=True,
            sec_len_pilot=100,
            sec_len_data=4,
            data_on_quadrature=True,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=InavDecoder,
        search_prns=search_prns,
        data_code_table=data_table,
        sec_pilot_table=sec_pilot,
        sec_data_levels=e5bi_secondary_levels(),
        acq_code_table=data_table,
    )


def glonass_l1_ca_plan(
    fs: float,
    num_channels: int = 6,
    doppler_max_hz: float = 5000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 30.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 6.0,
    dll_bw_narrow_hz: float = 0.75,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    search_prns: tuple = tuple(range(1, 25)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """GLONASS L1 C/A (FDMA; reference adapters
    GLONASS_L1_CA_PCPS_Acquisition / GLONASS_L1_CA_DLL_PLL_Tracking /
    GLONASS_L1_CA_Telemetry_Decoder, code glonass_l1_signal_replica.cc).

    "PRN" = orbital slot 1..24; all slots share one 511-chip code and are
    separated by the FDMA carrier offset k(slot) * 562.5 kHz, carried in
    the plan's freq_offset_table and in TrackingState.carrier_offset
    (conf.fdma). Telemetry: GNAV at 10 ms symbols (bit sync at
    codes_per_bit=10, then 10-period extended integration)."""
    return SignalPlan(
        name="1G",
        system="R",
        band="G1",
        num_channels=num_channels,
        code_table=glonass_ca_code_table(),
        table_rate_cps=GLO.CODE_RATE_CPS,
        carrier_freq_hz=GLO.FREQ_HZ,
        code_period_s=GLO.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=GLO.CODE_LENGTH_CHIPS,
            code_rate_cps=GLO.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=GLO.CODE_LENGTH_CHIPS,
            code_rate_cps=GLO.CODE_RATE_CPS,
            carrier_freq_hz=GLO.FREQ_HZ,
            fdma=True,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=GLO.CODES_PER_SYMBOL,
            codes_per_bit=GLO.CODES_PER_SYMBOL,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=GnavDecoder,
        search_prns=search_prns,
        freq_offset_table=slot_freq_offsets_hz(),
    )


def glonass_l2_ca_plan(
    fs: float,
    num_channels: int = 6,
    doppler_max_hz: float = 4000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    search_prns: tuple = tuple(range(1, 25)),
    **loop_kwargs,
) -> SignalPlan:
    """GLONASS L2 C/A (reference GLONASS_L2_CA_* adapters): L1's code and
    GNAV message at 1246 MHz + k * 437.5 kHz."""
    plan = glonass_l1_ca_plan(
        fs=fs, num_channels=num_channels, doppler_max_hz=doppler_max_hz,
        doppler_step_hz=doppler_step_hz, acq_dwells=acq_dwells,
        acq_pfa=acq_pfa, search_prns=search_prns, **loop_kwargs,
    )
    plan.name = "2G"
    plan.band = "G2"
    plan.carrier_freq_hz = 1.246e9
    plan.freq_offset_table = np.array(
        [GLO.SLOT_TO_K[s] * 437500.0 for s in range(1, 25)], dtype=np.float64
    )
    plan.trk_conf = replace(plan.trk_conf, carrier_freq_hz=1.246e9)
    return plan


def sbas_l1_plan(
    fs: float,
    num_channels: int = 2,
    doppler_max_hz: float = 5000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 30.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 7.5,
    dll_bw_narrow_hz: float = 0.75,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    search_prns: tuple = tuple(range(120, 139)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """SBAS L1 (reference SBAS_L1_* adapters): C/A-family codes of PRN
    120-138, 500 symbols/s (two code periods a symbol), 250 bps messages
    with FEC. GEO satellites sit near zero Doppler; the telemetry events
    carry integrity and correction messages, not ephemerides."""
    table = np.stack(
        [gps_l1_ca_code(p) for p in range(120, 139)]
    ).astype(np.float32)
    return SignalPlan(
        name="1S",
        system="S",
        band="L1",
        num_channels=num_channels,
        code_table=table,
        table_rate_cps=GPS.CODE_RATE_CPS,
        carrier_freq_hz=GPS.FREQ_HZ,
        code_period_s=GPS.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=GPS.CODE_LENGTH_CHIPS,
            code_rate_cps=GPS.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            # symbols flip every 2 ms: keep one clean period per FFT
            bit_transition_flag=True,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=GPS.CODE_LENGTH_CHIPS,
            code_rate_cps=GPS.CODE_RATE_CPS,
            carrier_freq_hz=GPS.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=2,    # one 2 ms symbol
            codes_per_bit=2,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=SbasDecoder,
        search_prns=search_prns,
        prn_row=lambda prn: prn - 120,
    )


def gps_l2c_plan(
    fs: float,
    num_channels: int = 8,
    doppler_max_hz: float = 4000.0,
    doppler_step_hz: float = 60.0,
    acq_dwells: int = 1,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 2.0,
    dll_bw_hz: float = 0.5,
    pll_bw_narrow_hz: float = 1.5,
    dll_bw_narrow_hz: float = 0.25,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 2.0,
    pull_in_time_s: float = 1.0,
    extend_correlation_symbols: int = 1,   # CNAV flips every CM period
    search_prns: tuple = tuple(range(1, 33)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """GPS L2C, CM-only replica (reference adapters
    GPS_L2_M_PCPS_Acquisition / GPS_L2_M_DLL_PLL_Tracking /
    GPS_L2C_Telemetry_Decoder; code gps_l2c_signal_replica.cc).

    The 20 ms CM period is one 50 symbols/s CNAV symbol, so tracking
    integrates one period (the symbol sign may flip at every period
    boundary) and telemetry takes every period's prompt sign. The long
    period narrows the Doppler bins: 60 Hz with the double-length FFT, the
    reference adapter's default, then the two-step zoom."""
    return SignalPlan(
        name="2S",
        system="G",
        band="L2",
        num_channels=num_channels,
        code_table=gps_l2cm_code_table(),
        table_rate_cps=L2C.CODE_RATE_CPS,
        carrier_freq_hz=L2C.FREQ_HZ,
        code_period_s=L2C.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=L2C.CODE_LENGTH_CHIPS,
            code_rate_cps=L2C.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            bit_transition_flag=True,
            pfa=acq_pfa,
            # data-only BPSK at 50 symbols/s has FLL/Costas false locks
            # every 25 Hz; the two-step zoom hands tracking a Doppler
            # inside the +-12.5 Hz true basin (reference make_2_steps)
            make_two_steps=True,
            doppler_step2_hz=8.0,
            num_doppler_bins_step2=6,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=L2C.CODE_LENGTH_CHIPS,
            code_rate_cps=L2C.CODE_RATE_CPS,
            carrier_freq_hz=L2C.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=1,
            codes_per_bit=L2C.CODES_PER_SYMBOL,
            steps_per_block=steps_per_block or 4,   # 4 x 20 ms a call
            max_channels=num_channels,
        ),
        make_decoder=CnavDecoder,
        search_prns=search_prns,
    )


def galileo_e6b_plan(
    fs: float,
    num_channels: int = 4,
    doppler_max_hz: float = 5000.0,
    doppler_step_hz: float = 250.0,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 20.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 7.5,
    dll_bw_narrow_hz: float = 0.75,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    search_prns: tuple = tuple(range(1, 37)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """Galileo E6-B data channel (HAS/CNAV; reference adapters
    Galileo_E6_PCPS_Acquisition / Galileo_E6_DLL_PLL_Tracking /
    Galileo_E6_Telemetry_Decoder). BPSK(5) at 5.115 Mcps, one 1 ms code
    period per 1000 symbols/s CNAV symbol: symbol-rate handling as E1-B
    (one period of integration, a timer for the narrow switch)."""
    return SignalPlan(
        name="E6",
        system="E",
        band="E6",
        num_channels=num_channels,
        code_table=galileo_e6b_code_table(),
        table_rate_cps=E6.CODE_RATE_CPS,
        carrier_freq_hz=E6.FREQ_HZ,
        code_period_s=E6.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=E6.CODE_LENGTH_CHIPS,
            code_rate_cps=E6.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=1,
            # CNAV symbols flip every period
            bit_transition_flag=True,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=E6.CODE_LENGTH_CHIPS,
            code_rate_cps=E6.CODE_RATE_CPS,
            carrier_freq_hz=E6.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=1,
            codes_per_bit=1,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=CnavStreamDecoder,
        search_prns=search_prns,
    )


def _beidou_d1_plan(name: str, band: str, table: np.ndarray, consts,
                    fs: float, num_channels: int, doppler_max_hz: float,
                    doppler_step_hz: float, acq_dwells: int, acq_pfa: float,
                    pll_bw_hz: float, dll_bw_hz: float,
                    pll_bw_narrow_hz: float, dll_bw_narrow_hz: float,
                    enable_fll_pull_in: bool, fll_bw_hz: float,
                    pull_in_time_s: float, extend_correlation_symbols: int,
                    search_prns: tuple,
                    steps_per_block: int | None) -> SignalPlan:
    """A BeiDou MEO/IGSO plan (D1 NAV with the NH20 secondary on the one
    data component). The engines' secondary machinery runs with the pilot
    code equal to the data code, the Costas PLL kept after the lock
    (pilot_pll_atan2=False: the navigation bits still flip the carrier),
    and coherent integration aligned to, and capped at, one 20 ms bit."""
    nh = np.tile(bds_nh20_levels(), (table.shape[0], 1))
    extend = min(extend_correlation_symbols, consts.CODES_PER_BIT)
    return SignalPlan(
        name=name,
        system="C",
        band=band,
        num_channels=num_channels,
        code_table=table,
        table_rate_cps=consts.CODE_RATE_CPS,
        carrier_freq_hz=consts.FREQ_HZ,
        code_period_s=consts.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=consts.CODE_LENGTH_CHIPS,
            code_rate_cps=consts.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            # NH chips flip the sign at any code boundary inside the
            # window; the double-length FFT keeps one clean period
            bit_transition_flag=True,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=consts.CODE_LENGTH_CHIPS,
            code_rate_cps=consts.CODE_RATE_CPS,
            carrier_freq_hz=consts.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=extend,
            codes_per_bit=consts.CODES_PER_BIT,
            track_pilot=True,
            sec_len_pilot=20,
            sec_len_data=20,
            pilot_pll_atan2=False,
            data_on_quadrature=False,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=D1Decoder,
        search_prns=search_prns,
        data_code_table=table,
        sec_pilot_table=nh,
        sec_data_levels=bds_nh20_levels(),
        acq_code_table=table,
    )


def _beidou_d2_plan(name: str, band: str, table: np.ndarray, consts,
                    fs: float, num_channels: int, doppler_max_hz: float,
                    doppler_step_hz: float, acq_dwells: int, acq_pfa: float,
                    pll_bw_hz: float, dll_bw_hz: float,
                    pll_bw_narrow_hz: float, dll_bw_narrow_hz: float,
                    enable_fll_pull_in: bool, fll_bw_hz: float,
                    pull_in_time_s: float, search_prns: tuple,
                    steps_per_block: int | None) -> SignalPlan:
    """A BeiDou GEO plan (D2 NAV at 500 bps, no NH secondary): plain
    Costas tracking with 2 ms bits (codes_per_bit=2), bit-synced 2-period
    integration and the D2 paged decoder."""
    return SignalPlan(
        name=name,
        system="C",
        band=band,
        num_channels=num_channels,
        code_table=table,
        table_rate_cps=consts.CODE_RATE_CPS,
        carrier_freq_hz=consts.FREQ_HZ,
        code_period_s=consts.CODE_PERIOD_S,
        acq_conf=AcqConfig(
            fs=fs,
            code_length_chips=consts.CODE_LENGTH_CHIPS,
            code_rate_cps=consts.CODE_RATE_CPS,
            doppler_max_hz=doppler_max_hz,
            doppler_step_hz=doppler_step_hz,
            max_dwells=acq_dwells,
            # 500 bps: a bit edge can flip inside any 1 ms window
            bit_transition_flag=True,
            pfa=acq_pfa,
        ),
        trk_conf=DllPllConf(
            fs=fs,
            code_length_chips=consts.CODE_LENGTH_CHIPS,
            code_rate_cps=consts.CODE_RATE_CPS,
            carrier_freq_hz=consts.FREQ_HZ,
            pll_bw_hz=pll_bw_hz,
            dll_bw_hz=dll_bw_hz,
            pll_bw_narrow_hz=pll_bw_narrow_hz,
            dll_bw_narrow_hz=dll_bw_narrow_hz,
            enable_fll_pull_in=enable_fll_pull_in,
            fll_bw_hz=fll_bw_hz,
            pull_in_time_s=pull_in_time_s,
            extend_correlation_symbols=2,
            codes_per_bit=2,
            bit_sync_delay_s=0.3,
            steps_per_block=steps_per_block or 20,
            max_channels=num_channels,
        ),
        make_decoder=D2Decoder,
        search_prns=search_prns,
        acq_code_table=table,
    )


def beidou_b1i_plan(
    fs: float,
    num_channels: int = 8,
    doppler_max_hz: float = 5000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 30.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 5.0,
    dll_bw_narrow_hz: float = 0.5,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    extend_correlation_symbols: int = 20,
    search_prns: tuple = tuple(range(6, 30)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """BeiDou B1I MEO/IGSO (reference adapters BEIDOU_B1I_PCPS_Acquisition
    / BEIDOU_B1I_DLL_PLL_Tracking / BEIDOU_B1I_Telemetry_Decoder, codes
    beidou_b1i_signal_replica.cc): D1 NAV with NH20, 2046 chips at
    2.046 Mcps."""
    return _beidou_d1_plan(
        "B1", "B1", beidou_b1i_code_table(), BDS, fs, num_channels,
        doppler_max_hz, doppler_step_hz, acq_dwells, acq_pfa, pll_bw_hz,
        dll_bw_hz, pll_bw_narrow_hz, dll_bw_narrow_hz, enable_fll_pull_in,
        fll_bw_hz, pull_in_time_s, extend_correlation_symbols, search_prns,
        steps_per_block)


def beidou_b1i_geo_plan(
    fs: float,
    num_channels: int = 4,
    doppler_max_hz: float = 3000.0,
    doppler_step_hz: float = 125.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 25.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 5.0,
    dll_bw_narrow_hz: float = 0.5,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    search_prns: tuple = (1, 2, 3, 4, 5),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """BeiDou B1I GEO (D2 NAV; PRNs 1-5; beidou_b1i_telemetry_decoder_gs.cc
    GEO branch). GEO Doppler is small, so the default grid is narrow."""
    return _beidou_d2_plan(
        "B1G", "B1", beidou_b1i_code_table(), BDS, fs, num_channels,
        doppler_max_hz, doppler_step_hz, acq_dwells, acq_pfa, pll_bw_hz,
        dll_bw_hz, pll_bw_narrow_hz, dll_bw_narrow_hz, enable_fll_pull_in,
        fll_bw_hz, pull_in_time_s, search_prns, steps_per_block)


def beidou_b3i_plan(
    fs: float,
    num_channels: int = 8,
    doppler_max_hz: float = 5000.0,
    doppler_step_hz: float = 250.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 30.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 5.0,
    dll_bw_narrow_hz: float = 0.5,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    extend_correlation_symbols: int = 20,
    search_prns: tuple = tuple(range(6, 30)),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """BeiDou B3I MEO/IGSO (reference BEIDOU_B3I_* adapters, codes
    beidou_b3i_signal_replica.cc): B1I's D1 framing and NH20 on the
    10230-chip code at 10.23 Mcps."""
    return _beidou_d1_plan(
        "B3", "B3", beidou_b3i_code_table(), B3, fs, num_channels,
        doppler_max_hz, doppler_step_hz, acq_dwells, acq_pfa, pll_bw_hz,
        dll_bw_hz, pll_bw_narrow_hz, dll_bw_narrow_hz, enable_fll_pull_in,
        fll_bw_hz, pull_in_time_s, extend_correlation_symbols, search_prns,
        steps_per_block)


def beidou_b3i_geo_plan(
    fs: float,
    num_channels: int = 4,
    doppler_max_hz: float = 3000.0,
    doppler_step_hz: float = 125.0,
    acq_dwells: int = 2,
    acq_pfa: float = 1e-3,
    pll_bw_hz: float = 25.0,
    dll_bw_hz: float = 2.0,
    pll_bw_narrow_hz: float = 5.0,
    dll_bw_narrow_hz: float = 0.5,
    enable_fll_pull_in: bool = True,
    fll_bw_hz: float = 4.0,
    pull_in_time_s: float = 0.25,
    search_prns: tuple = (1, 2, 3, 4, 5),
    steps_per_block: int | None = None,
) -> SignalPlan:
    """BeiDou B3I GEO (D2 NAV, no NH secondary): the B3-band twin of
    beidou_b1i_geo_plan (beidou_b3i_telemetry_decoder_gs GEO branch)."""
    return _beidou_d2_plan(
        "B3G", "B3", beidou_b3i_code_table(), B3, fs, num_channels,
        doppler_max_hz, doppler_step_hz, acq_dwells, acq_pfa, pll_bw_hz,
        dll_bw_hz, pll_bw_narrow_hz, dll_bw_narrow_hz, enable_fll_pull_in,
        fll_bw_hz, pull_in_time_s, search_prns, steps_per_block)
