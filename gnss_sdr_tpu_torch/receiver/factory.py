"""String-keyed block factory: reference config strings -> framework objects.

Counterpart of ``gnss_sdr_tpu/receiver/factory.py``, with the same
implementation-string tables, property names and defaults; every
``Channels_XX`` group builds its plan, every source, input filter,
resampler and beamformer the JAX factory builds is built here. The
conditioner runs on ``device`` ("cuda" unless the caller asks for
"cpu").

Reference: src/core/receiver/gnss_block_factory.{h,cc} (GetSignalSource,
GetSignalConditioner, GetChannels, GetObservables, GetPVT, GetBlock,
gnss_block_factory.h:55-95). Roles are fixed and wired by name from an INI
config; implementations are pluggable per role via these strings.

Architectural difference, by design: the reference instantiates one block
*object per channel*; here acquisition/tracking are *batched engines* over a
channel axis (SURVEY.md §2.4 P2), so for those roles the factory returns the
engine configuration (AcqConfig / DllPllConf) resolved from the same config
properties the reference adapters read (e.g.
``Acquisition_1C.doppler_max``, ``Tracking_1C.pll_bw_hz``), and the
``Receiver`` builds the single batched engine from them.
"""

from __future__ import annotations

from dataclasses import dataclass

from gnss_sdr_tpu_torch.conditioner import (
    ConditionerConfig,
    PassThrough,
    SignalConditioner,
)
from gnss_sdr_tpu_torch.config.configuration import ConfigurationInterface
from gnss_sdr_tpu_torch.io import (
    FifoSignalSource,
    FileMeta,
    FileSignalSource,
    MultichannelFileSignalSource,
    UdpSignalSource,
)
from gnss_sdr_tpu_torch.outputs import (
    AnPacketPrinter,
    GeoJsonPrinter,
    GpxPrinter,
    KmlPrinter,
    NmeaPrinter,
    RinexNavWriter,
    RinexObsWriter,
)

# implementation-string tables (mirroring gnss_block_factory.cc GetBlock)
_ITEM_TYPE_MAP = {
    # reference item_type -> io format key
    "byte": "byte",
    "ibyte": "ibyte",
    "cbyte": "ibyte",
    "short": "short",
    "ishort": "ishort",
    "cshort": "ishort",
    "float": "float",
    "gr_complex": "gr_complex",
}


class UnknownImplementation(ValueError):
    pass


# ------------------------------------------------------------- signal source
def get_signal_source(cfg: ConfigurationInterface, role: str = "SignalSource"):
    impl = cfg.property(f"{role}.implementation", "File_Signal_Source")
    fs = cfg.property(f"{role}.sampling_frequency", 4_000_000.0)
    item_type = cfg.property(f"{role}.item_type", "ishort")
    fmt = _ITEM_TYPE_MAP.get(item_type, item_type)

    if impl in ("File_Signal_Source", "File_Timestamp_Signal_Source"):
        meta = FileMeta(
            path=cfg.property(f"{role}.filename", ""),
            format=fmt,
            fs=fs,
            offset_bytes=cfg.property(f"{role}.bytes_to_skip", 0),
            total_samples=cfg.property(f"{role}.samples", 0) or None,
            repeat=cfg.property(f"{role}.repeat", False),
        )
        if impl == "File_Timestamp_Signal_Source":
            from gnss_sdr_tpu_torch.io.sources import TimestampedFileSignalSource
            # recorded samplecounts are in complex samples for every item
            # type (gnss_sdr_timestamp.cc:114 tags file item count*2 for
            # interleaved formats = stream sample `count` after pairing)
            return TimestampedFileSignalSource(
                meta,
                timestamp_path=cfg.property(
                    f"{role}.timestamp_filename",
                    "./example_capture_timestamp.dat"),
                clock_offset_ms=cfg.property(
                    f"{role}.timestamp_clock_offset_ms", 0.0),
            )
        return FileSignalSource(meta)
    if impl == "Multichannel_File_Signal_Source":
        n = cfg.property(f"{role}.n_channels", 2)
        metas = [
            FileMeta(
                path=cfg.property(f"{role}.filename{i}", ""),
                format=fmt,
                fs=fs,
            )
            for i in range(n)
        ]
        return MultichannelFileSignalSource(metas)
    if impl in ("Two_Bit_Cpx_File_Signal_Source",
                "Two_Bit_Packed_File_Signal_Source"):
        meta = FileMeta(
            path=cfg.property(f"{role}.filename", ""), format="2bit_cpx", fs=fs
        )
        return FileSignalSource(meta)
    if impl == "Four_Bit_Cpx_File_Signal_Source":
        meta = FileMeta(
            path=cfg.property(f"{role}.filename", ""), format="4bit_cpx", fs=fs
        )
        return FileSignalSource(meta)
    if impl == "Nsr_File_Signal_Source":
        meta = FileMeta(
            path=cfg.property(f"{role}.filename", ""), format="2bit_real", fs=fs
        )
        return FileSignalSource(meta)
    if impl == "Fifo_Signal_Source":
        return FifoSignalSource(
            cfg.property(f"{role}.filename", ""), fmt=fmt, fs=fs
        )
    if impl == "Custom_UDP_Signal_Source":
        return UdpSignalSource(
            address=cfg.property(f"{role}.origin_address", "127.0.0.1"),
            port=cfg.property(f"{role}.port", 1234),
            fmt=fmt,
            fs=fs,
        )
    if impl == "Spir_File_Signal_Source":
        meta = FileMeta(
            path=cfg.property(f"{role}.filename", ""), format="spir_1bit",
            fs=fs,
        )
        return FileSignalSource(meta)
    if impl == "Spir_GSS6450_File_Signal_Source":
        adc_bits = cfg.property(f"{role}.adc_bits", 4)
        if adc_bits not in (2, 4):
            raise UnknownImplementation(
                f"{role}.adc_bits={adc_bits} (GSS6450 supports 2 or 4)")
        meta = FileMeta(
            path=cfg.property(f"{role}.filename", ""),
            format=f"gss6450_{adc_bits}bit", fs=fs,
            total_samples=cfg.property(f"{role}.samples", 0) or None,
        )
        return FileSignalSource(meta)
    if impl == "NTLab_File_Signal_Source":
        meta = FileMeta(
            path=cfg.property(f"{role}.filename", ""), format="ntlab_2bit",
            fs=fs,
        )
        return FileSignalSource(meta)
    if impl == "Labsat_Signal_Source":
        from gnss_sdr_tpu_torch.io import LabsatSignalSource

        return LabsatSignalSource(
            cfg.property(f"{role}.filename", ""), fs=fs)
    if impl == "RtlTcp_Signal_Source":
        from gnss_sdr_tpu_torch.io import RtlTcpSignalSource

        gain = cfg.property(f"{role}.gain", 0.0)
        return RtlTcpSignalSource(
            address=cfg.property(f"{role}.address", "127.0.0.1"),
            port=cfg.property(f"{role}.port", 1234),
            fs=fs,
            freq_hz=cfg.property(f"{role}.freq", 1_575_420_000.0),
            gain_db=gain if gain else None,
            agc=cfg.property(f"{role}.AGC_enabled", True),
        )
    if impl == "ZMQ_Signal_Source":
        from gnss_sdr_tpu_torch.io import ZmqSignalSource

        return ZmqSignalSource(
            cfg.property(f"{role}.endpoint", "tcp://127.0.0.1:5555"),
            fmt=fmt, fs=fs,
        )
    if impl == "ION_GSMS_Signal_Source":
        from gnss_sdr_tpu_torch.io import IonGsmsSignalSource

        return IonGsmsSignalSource(
            cfg.property(f"{role}.metadata_filename", ""), fs_override=fs)
    if impl == "Raw_Array_Signal_Source":
        # antenna-array capture: one file per element, beamformed in the
        # conditioner (Beamformer_Filter)
        n = cfg.property(f"{role}.channels", 2)
        metas = [
            FileMeta(path=cfg.property(f"{role}.filename{i}", ""),
                     format=fmt, fs=fs)
            for i in range(n)
        ]
        return MultichannelFileSignalSource(metas)
    if impl == "SignalGenerator":
        from gnss_sdr_tpu_torch.io import GeneratorSignalSource
        from gnss_sdr_tpu_torch.simulate import SatelliteSignalParams

        n_sats = cfg.property(f"{role}.num_satellites", 1)
        sats = []
        for i in range(n_sats):
            sats.append(SatelliteSignalParams(
                prn=cfg.property(f"{role}.PRN_{i}", i + 1),
                cn0_dbhz=cfg.property(f"{role}.CN0_dB_{i}", 44.0),
                doppler_hz=cfg.property(f"{role}.doppler_Hz_{i}", 0.0),
                delay_chips=cfg.property(f"{role}.delay_chips_{i}", 0.0),
            ))
        dur = cfg.property(f"{role}.duration_s", 10.0)
        return GeneratorSignalSource(sats, fs, int(dur * fs),
                                     seed=cfg.property(f"{role}.seed", 0))
    raise UnknownImplementation(f"{role}.implementation={impl!r}")


# -------------------------------------------------------- signal conditioner
def get_signal_conditioner(cfg: ConfigurationInterface,
                           role: str = "SignalConditioner",
                           suffix: str = "", device="cuda"):
    """`suffix` numbers the sub-roles for multi-RF-chain configs
    (SignalConditioner0 reads DataTypeAdapter0/InputFilter0/Resampler0, as
    the reference factory does per RF channel)."""
    impl = cfg.property(f"{role}.implementation", "Signal_Conditioner")
    if impl == "Pass_Through":
        return PassThrough()
    if impl not in ("Signal_Conditioner", "Array_Signal_Conditioner"):
        raise UnknownImplementation(f"{role}.implementation={impl!r}")

    fs_in = cfg.property(f"SignalSource{suffix}.sampling_frequency",
                         cfg.property("SignalSource.sampling_frequency",
                                      4_000_000.0))
    adapter_impl = cfg.property(
        f"DataTypeAdapter{suffix}.implementation",
        cfg.property("DataTypeAdapter.implementation", "Pass_Through"))
    adapter_map = {
        "Ibyte_To_Complex": "ibyte",
        "Ibyte_To_Cbyte": "ibyte",
        "Ibyte_To_Cshort": "ibyte",
        "Ishort_To_Complex": "ishort",
        "Ishort_To_Cshort": "ishort",
        "Cshort_To_Gr_Complex": "cshort",
        "Byte_To_Short": "byte",
        "Pass_Through": "passthrough",
    }
    if adapter_impl not in adapter_map:
        raise UnknownImplementation(
            f"DataTypeAdapter.implementation={adapter_impl!r}")

    def p(rolebase: str, prop: str, default):
        key = f"{rolebase}{suffix}.{prop}"
        if suffix and cfg.has_property(key):
            return cfg.property(key, default)
        return cfg.property(f"{rolebase}.{prop}", default)

    filt_impl = p("InputFilter", "implementation", "Pass_Through")
    if_freq = 0.0
    taps = 0
    band = None
    decim = 1
    notch = False
    blanking = False
    if filt_impl in ("Fir_Filter", "Freq_Xlating_Fir_Filter"):
        # number_of_taps is the literal FIR length in the reference
        # (freq_xlating_fir_filter.cc); honor it verbatim for config
        # compatibility, defaulting to a longer filter only when absent
        if cfg.has_property(f"InputFilter{suffix}.taps_length") or (
                not suffix and cfg.has_property("InputFilter.taps_length")):
            taps = p("InputFilter", "taps_length", 65)
        elif cfg.has_property(f"InputFilter{suffix}.number_of_taps") or (
                not suffix and cfg.has_property("InputFilter.number_of_taps")):
            taps = p("InputFilter", "number_of_taps", 5)
        else:
            taps = 65
        band_end = p("InputFilter", "band1_end", 0.45) * fs_in
        band = (0.0, band_end)
        if filt_impl == "Freq_Xlating_Fir_Filter":
            if_freq = p("InputFilter", "IF", 0.0)
            decim = p("InputFilter", "decimation_factor", 1)
    elif filt_impl in ("Notch_Filter", "Notch_Filter_Lite"):
        notch = True
    elif filt_impl == "Pulse_Blanking_Filter":
        blanking = True
    elif filt_impl == "Beamformer_Filter":
        # array conditioner: beamform the element streams, then condition
        import numpy as _np

        from gnss_sdr_tpu_torch.conditioner.beamformer import (
            ArrayConditioner,
            Beamformer,
            steering_weights,
        )

        n_elem = p("InputFilter", "number_of_channels", 8)
        if cfg.has_property(f"InputFilter{suffix}.weight0_real") or (
                not suffix and cfg.has_property("InputFilter.weight0_real")):
            weights = _np.asarray([
                complex(p("InputFilter", f"weight{i}_real", 1.0),
                        p("InputFilter", f"weight{i}_imag", 0.0))
                for i in range(n_elem)
            ], dtype=_np.complex64)
        else:
            weights = steering_weights(
                n_elem,
                p("InputFilter", "spacing_wavelengths", 0.5),
                p("InputFilter", "steer_deg", 0.0))
        # multichannel sources decode to complex already; the inner chain
        # conditions the beamformed complex stream
        inner = SignalConditioner(ConditionerConfig(
            input_format="passthrough", fs_in=fs_in), device=device)
        return ArrayConditioner(Beamformer(weights, device=device), inner)
    elif filt_impl != "Pass_Through":
        raise UnknownImplementation(f"InputFilter.implementation={filt_impl!r}")

    res_impl = p("Resampler", "implementation", "Pass_Through")
    fs_out = None
    if res_impl in ("Direct_Resampler", "Mmse_Resampler",
                    "Fractional_Resampler"):   # legacy alias of Mmse

        fs_out = p("Resampler", "sample_freq_out", fs_in)
        if fs_out == fs_in / decim:
            fs_out = None
    elif res_impl != "Pass_Through":
        raise UnknownImplementation(f"Resampler.implementation={res_impl!r}")

    return SignalConditioner(ConditionerConfig(
        input_format=adapter_map[adapter_impl],
        fs_in=fs_in,
        fs_out=fs_out,
        if_freq_hz=if_freq,
        fir_taps=taps,
        fir_band_hz=band,
        decimation=decim,
        enable_notch=notch,
        enable_pulse_blanking=blanking,
    ), device=device)


# implementation string -> acquisition engine variant (acquisition/engines.py)
_ACQ_ENGINE_BY_IMPL = {
    "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler": "fine_doppler",
    "GPS_L1_CA_PCPS_Tong_Acquisition": "tong",
    "GPS_L1_CA_PCPS_QuickSync_Acquisition": "quicksync",
    "Galileo_E1_PCPS_Tong_Ambiguous_Acquisition": "tong",
    "Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition": "quicksync",
    "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition": "cccwsr",
    "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF": "noncoh_iq",
}


# --------------------------------------------------------------- pvt writers
@dataclass
class PvtOutputs:
    nmea: NmeaPrinter | None = None
    kml: KmlPrinter | None = None
    gpx: GpxPrinter | None = None
    geojson: GeoJsonPrinter | None = None
    rinex_obs: RinexObsWriter | None = None
    rinex_nav: RinexNavWriter | None = None
    an_packet: AnPacketPrinter | None = None

    def print_position(self, sol, sats: list | None = None) -> None:
        for w in (self.nmea, self.kml, self.gpx, self.geojson):
            if w is not None:
                w.print_position(sol)
        if self.an_packet is not None:
            self.an_packet.print_solution(sol, sats or [])

    def close(self) -> None:
        for w in (self.nmea, self.kml, self.gpx, self.geojson,
                  self.rinex_obs, self.rinex_nav, self.an_packet):
            if w is not None:
                w.close()


def get_pvt_outputs(cfg: ConfigurationInterface, week: int = 0,
                    role: str = "PVT") -> PvtOutputs:
    impl = cfg.property(f"{role}.implementation", "RTKLIB_PVT")
    # legacy aliases accepted by gnss_block_factory.cc:878
    if impl not in ("RTKLIB_PVT", "GPS_L1_CA_PVT", "Galileo_E1_PVT",
                    "Hybrid_PVT"):
        raise UnknownImplementation(f"{role}.implementation={impl!r}")
    out = PvtOutputs()
    if cfg.property(f"{role}.flag_nmea_tty_port", False) or cfg.property(
            f"{role}.nmea_dump_filename", ""):
        out.nmea = NmeaPrinter(
            cfg.property(f"{role}.nmea_dump_filename", "nmea.txt"), week=week)
    if cfg.property(f"{role}.kml_output_enabled", False):
        out.kml = KmlPrinter(cfg.property(f"{role}.kml_dump_filename", "pvt.kml"))
    if cfg.property(f"{role}.gpx_output_enabled", False):
        out.gpx = GpxPrinter(
            cfg.property(f"{role}.gpx_dump_filename", "pvt.gpx"), week=week)
    if cfg.property(f"{role}.geojson_output_enabled", False):
        out.geojson = GeoJsonPrinter(
            cfg.property(f"{role}.geojson_dump_filename", "pvt.geojson"))
    if cfg.property(f"{role}.an_output_enabled", False):
        out.an_packet = AnPacketPrinter(
            cfg.property(f"{role}.an_dump_devname", "an_packets.bin"))
    if cfg.property(f"{role}.rinex_output_enabled", False):
        out.rinex_obs = RinexObsWriter(
            cfg.property(f"{role}.rinex_obs_filename", "obs.rnx"), week=week)
        out.rinex_nav = RinexNavWriter(
            cfg.property(f"{role}.rinex_nav_filename", "nav.rnx"))
    return out


# ------------------------------------------------------------------ channels
def get_channel_counts(cfg: ConfigurationInterface) -> dict[str, int]:
    """Per-signal channel counts (Channels_1C.count etc.,
    gnss_block_factory.cc GetChannels grouping)."""
    out = {}
    for sig in ("1C", "1B", "2S", "L5", "5X", "7X", "E6", "1G", "2G",
                "B1", "B1G", "B3", "B3G", "J1", "J5", "SBAS"):
        n = cfg.property(f"Channels_{sig}.count", 0)
        if n:
            out[sig] = n
    if not out:
        out["1C"] = cfg.property("Channels.count", 8)
    return out


# -------------------------------------------------------------- signal plans
# signal id -> (accepted Acquisition impls, accepted Tracking impls,
#               plan factory name in receiver.plans)
_PLAN_TABLE = {
    "1C": (
        {"GPS_L1_CA_PCPS_Acquisition",
         "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler",
         "GPS_L1_CA_PCPS_Assisted_Acquisition",
         "GPS_L1_CA_PCPS_Tong_Acquisition",
         "GPS_L1_CA_PCPS_QuickSync_Acquisition"},
        {"GPS_L1_CA_DLL_PLL_Tracking", "GPS_L1_CA_KF_Tracking",
         "GPS_L1_CA_Gaussian_Tracking",
         "GPS_L1_CA_TCP_CONNECTOR_Tracking"},
        "gps_l1ca_plan",
    ),
    "1B": (
        {"Galileo_E1_PCPS_Ambiguous_Acquisition",
         "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition",
         "Galileo_E1_PCPS_Tong_Ambiguous_Acquisition",
         "Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition",
         "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition"},
        {"Galileo_E1_DLL_PLL_VEML_Tracking",
         "Galileo_E1_TCP_CONNECTOR_Tracking"},
        "galileo_e1b_plan",
    ),
    "L5": (
        {"GPS_L5i_PCPS_Acquisition"},
        {"GPS_L5_DLL_PLL_Tracking", "GPS_L5i_DLL_PLL_Tracking"},
        "gps_l5_plan",
    ),
    "5X": (
        {"Galileo_E5a_Pcps_Acquisition",
         "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF"},
        {"Galileo_E5a_DLL_PLL_Tracking"},
        "galileo_e5a_plan",
    ),
    "B1": (
        {"BEIDOU_B1I_PCPS_Acquisition"},
        {"BEIDOU_B1I_DLL_PLL_Tracking"},
        "beidou_b1i_plan",
    ),
    # GEO satellites stream D2 NAV (no NH secondary, 500 bps); separate
    # batched group so MEO/IGSO (D1) and GEO channels coexist on B1
    "B1G": (
        {"BEIDOU_B1I_PCPS_Acquisition"},
        {"BEIDOU_B1I_DLL_PLL_Tracking"},
        "beidou_b1i_geo_plan",
    ),
    "7X": (
        {"Galileo_E5b_PCPS_Acquisition"},
        {"Galileo_E5b_DLL_PLL_Tracking"},
        "galileo_e5b_plan",
    ),
    "2S": (
        {"GPS_L2_M_PCPS_Acquisition"},
        {"GPS_L2_M_DLL_PLL_Tracking"},
        "gps_l2c_plan",
    ),
    "B3": (
        {"BEIDOU_B3I_PCPS_Acquisition"},
        {"BEIDOU_B3I_DLL_PLL_Tracking"},
        "beidou_b3i_plan",
    ),
    "B3G": (
        {"BEIDOU_B3I_PCPS_Acquisition"},
        {"BEIDOU_B3I_DLL_PLL_Tracking"},
        "beidou_b3i_geo_plan",
    ),
    "1G": (
        {"GLONASS_L1_CA_PCPS_Acquisition"},
        {"GLONASS_L1_CA_DLL_PLL_Tracking",
         "GLONASS_L1_CA_DLL_PLL_C_Aid_Tracking"},
        "glonass_l1_ca_plan",
    ),
    "J1": (
        {"QZSS_L1_PCPS_Acquisition"},
        {"QZSS_L1_CA_DLL_PLL_Tracking"},
        "qzss_l1_ca_plan",
    ),
    "SBAS": (
        {"SBAS_L1_PCPS_Acquisition", "GPS_L1_CA_PCPS_Acquisition"},
        {"SBAS_L1_DLL_PLL_Tracking", "GPS_L1_CA_DLL_PLL_Tracking"},
        "sbas_l1_plan",
    ),
    "E6": (
        {"Galileo_E6_PCPS_Acquisition"},
        {"Galileo_E6_DLL_PLL_Tracking"},
        "galileo_e6b_plan",
    ),
    "J5": (
        {"QZSS_L5i_PCPS_Acquisition"},
        {"QZSS_L5i_DLL_PLL_Tracking", "QZSS_L5_DLL_PLL_Tracking"},
        "qzss_l5_plan",
    ),
    "2G": (
        {"GLONASS_L2_CA_PCPS_Acquisition"},
        {"GLONASS_L2_CA_DLL_PLL_Tracking",
         "GLONASS_L2_CA_DLL_PLL_C_Aid_Tracking"},
        "glonass_l2_ca_plan",
    ),
}

# accepted TelemetryDecoder_XX.implementation per signal group
# (gnss_block_factory.cc:697-752 GetTlmBlock name resolution)
_TLM_IMPLS = {
    "1C": "GPS_L1_CA_Telemetry_Decoder",
    "1B": "Galileo_E1B_Telemetry_Decoder",
    "2S": "GPS_L2C_Telemetry_Decoder",
    "L5": "GPS_L5_Telemetry_Decoder",
    "5X": "Galileo_E5a_Telemetry_Decoder",
    "7X": "Galileo_E5b_Telemetry_Decoder",
    "E6": "Galileo_E6_Telemetry_Decoder",
    "1G": "GLONASS_L1_CA_Telemetry_Decoder",
    "2G": "GLONASS_L2_CA_Telemetry_Decoder",
    "B1": "BEIDOU_B1I_Telemetry_Decoder",
    "B1G": "BEIDOU_B1I_Telemetry_Decoder",
    "B3": "BEIDOU_B3I_Telemetry_Decoder",
    "B3G": "BEIDOU_B3I_Telemetry_Decoder",
    "J1": "QZSS_L1_Telemetry_Decoder",
    "J5": "QZSS_L5_Telemetry_Decoder",
    "SBAS": "SBAS_L1_Telemetry_Decoder",
}

# accepted Observables.implementation strings (gnss_block_factory.cc:871:
# the per-system names are legacy aliases of the hybrid engine)
OBSERVABLES_IMPLS = frozenset({
    "Hybrid_Observables", "GPS_L1_CA_Observables", "GPS_L2C_Observables",
    "Galileo_E1B_Observables", "Galileo_E5A_Observables",
})


def check_observables_impl(cfg: ConfigurationInterface) -> str:
    impl = cfg.property("Observables.implementation", "Hybrid_Observables")
    if impl not in OBSERVABLES_IMPLS:
        raise UnknownImplementation(f"Observables.implementation={impl!r}")
    return impl


_DEFAULT_IMPLS = {
    "1C": ("GPS_L1_CA_PCPS_Acquisition", "GPS_L1_CA_DLL_PLL_Tracking"),
    "1B": ("Galileo_E1_PCPS_Ambiguous_Acquisition",
           "Galileo_E1_DLL_PLL_VEML_Tracking"),
    "L5": ("GPS_L5i_PCPS_Acquisition", "GPS_L5_DLL_PLL_Tracking"),
    "5X": ("Galileo_E5a_Pcps_Acquisition", "Galileo_E5a_DLL_PLL_Tracking"),
    "B1": ("BEIDOU_B1I_PCPS_Acquisition", "BEIDOU_B1I_DLL_PLL_Tracking"),
    "B1G": ("BEIDOU_B1I_PCPS_Acquisition", "BEIDOU_B1I_DLL_PLL_Tracking"),
    "7X": ("Galileo_E5b_PCPS_Acquisition", "Galileo_E5b_DLL_PLL_Tracking"),
    "2S": ("GPS_L2_M_PCPS_Acquisition", "GPS_L2_M_DLL_PLL_Tracking"),
    "B3": ("BEIDOU_B3I_PCPS_Acquisition", "BEIDOU_B3I_DLL_PLL_Tracking"),
    "B3G": ("BEIDOU_B3I_PCPS_Acquisition", "BEIDOU_B3I_DLL_PLL_Tracking"),
    "1G": ("GLONASS_L1_CA_PCPS_Acquisition",
           "GLONASS_L1_CA_DLL_PLL_Tracking"),
    "J1": ("QZSS_L1_PCPS_Acquisition", "QZSS_L1_CA_DLL_PLL_Tracking"),
    "SBAS": ("SBAS_L1_PCPS_Acquisition", "SBAS_L1_DLL_PLL_Tracking"),
    "E6": ("Galileo_E6_PCPS_Acquisition", "Galileo_E6_DLL_PLL_Tracking"),
    "J5": ("QZSS_L5i_PCPS_Acquisition", "QZSS_L5i_DLL_PLL_Tracking"),
    "2G": ("GLONASS_L2_CA_PCPS_Acquisition",
           "GLONASS_L2_CA_DLL_PLL_Tracking"),
}


def get_signal_plan(cfg: ConfigurationInterface, sig: str, fs: float,
                    num_channels: int):
    """Build one SignalPlan for signal group `sig` from its per-signal
    Acquisition_XX / Tracking_XX roles (gnss_block_factory.cc GetAcqBlock/
    GetTrkBlock name resolution)."""
    from gnss_sdr_tpu_torch.receiver import plans as plan_mod

    if sig not in _PLAN_TABLE:
        raise UnknownImplementation(f"Channels_{sig}: unsupported signal")
    acq_ok, trk_ok, factory_name = _PLAN_TABLE[sig]
    acq_default, trk_default = _DEFAULT_IMPLS[sig]
    acq_impl = cfg.property(f"Acquisition_{sig}.implementation", acq_default)
    trk_impl = cfg.property(f"Tracking_{sig}.implementation", trk_default)
    # accelerator-offload twins (the reference's _GPU/_FPGA/OpenCl adapters
    # run the same algorithm on an offload backend; here the TPU engine IS
    # the offload backend, so the twins resolve to the batched engine)
    for suf in ("_GPU", "_FPGA", "_Fpga"):
        if acq_impl.endswith(suf):
            acq_impl = acq_impl[: -len(suf)]
        if trk_impl.endswith(suf):
            trk_impl = trk_impl[: -len(suf)]
    acq_impl = acq_impl.replace("_PCPS_OpenCl_", "_PCPS_")
    if acq_impl not in acq_ok:
        raise UnknownImplementation(
            f"Acquisition_{sig}.implementation={acq_impl!r}")
    if trk_impl not in trk_ok:
        raise UnknownImplementation(
            f"Tracking_{sig}.implementation={trk_impl!r}")
    tlm_impl = cfg.property(f"TelemetryDecoder_{sig}.implementation",
                            _TLM_IMPLS[sig])
    if tlm_impl != _TLM_IMPLS[sig]:
        raise UnknownImplementation(
            f"TelemetryDecoder_{sig}.implementation={tlm_impl!r}")

    make = getattr(plan_mod, factory_name)
    kwargs = dict(fs=fs, num_channels=num_channels)

    def opt(key: str, prop: str, typed_default):
        """Pass the property through only when configured (typed by the
        default), so the plan factory's per-signal defaults apply."""
        if cfg.has_property(prop):
            kwargs[key] = cfg.property(prop, typed_default)

    opt("doppler_max_hz", f"Acquisition_{sig}.doppler_max", 5000.0)
    opt("doppler_step_hz", f"Acquisition_{sig}.doppler_step", 250.0)
    opt("acq_pfa", f"Acquisition_{sig}.pfa", 1e-3)
    opt("pll_bw_hz", f"Tracking_{sig}.pll_bw_hz", 0.0)
    opt("dll_bw_hz", f"Tracking_{sig}.dll_bw_hz", 0.0)
    opt("pll_bw_narrow_hz", f"Tracking_{sig}.pll_bw_narrow_hz", 0.0)
    opt("dll_bw_narrow_hz", f"Tracking_{sig}.dll_bw_narrow_hz", 0.0)
    opt("enable_fll_pull_in", f"Tracking_{sig}.enable_fll_pull_in", False)
    opt("fll_bw_hz", f"Tracking_{sig}.fll_bw_hz", 0.0)
    if sig == "1B":
        opt("early_late_space_chips",
            f"Tracking_{sig}.early_late_space_chips", 0.0)
        opt("enable_reed_solomon",
            f"TelemetryDecoder_{sig}.enable_reed_solomon", False)
    elif sig in ("1G", "2G", "SBAS"):
        # integration length is fixed by the symbol structure (GNAV 10 ms
        # meander chip; SBAS 2 ms symbol)
        opt("acq_dwells", f"Acquisition_{sig}.max_dwells", 0)
    elif sig == "E6":
        pass  # 1 ms CNAV symbols: single-dwell, symbol-rate integration
    else:
        opt("acq_dwells", f"Acquisition_{sig}.max_dwells", 0)
        opt("extend_correlation_symbols",
            f"Tracking_{sig}.extend_correlation_symbols", 0)
    plan = make(**kwargs)
    # global TOW-aided-tracking switch (reference GNSS-SDR.tow_to_trk,
    # dll_pll_conf.cc:151): decoder TOW events flow back to the tracker
    if cfg.property("GNSS-SDR.tow_to_trk", False):
        from dataclasses import replace as _dc_replace

        plan.trk_conf = _dc_replace(plan.trk_conf, tow_to_trk=True)

    # remaining reference acquisition/tracking knobs apply directly onto
    # the built confs (gnss_block_factory.cc passes every Acquisition_XX.*
    # property into the adapter; here the plan factory owns the defaults
    # and the conf dialect overrides them)
    from dataclasses import replace as _replace

    acq_over = {}
    if cfg.has_property(f"Acquisition_{sig}.coherent_integration_time_ms"):
        code_ms = (1000.0 * plan.acq_conf.code_length_chips
                   / plan.acq_conf.code_rate_cps)
        coh_ms = cfg.property(
            f"Acquisition_{sig}.coherent_integration_time_ms", code_ms)
        acq_over["coherent_integration_periods"] = max(
            int(round(coh_ms / code_ms)), 1)
    for key, prop, dv in (
        ("threshold", "threshold", 0.0),
        ("bit_transition_flag", "bit_transition_flag", False),
        ("make_two_steps", "make_two_steps", False),
        ("doppler_step2_hz", "second_doppler_step", 125.0),
        ("num_doppler_bins_step2", "second_nbins", 4),
    ):
        if cfg.has_property(f"Acquisition_{sig}.{prop}"):
            acq_over[key] = cfg.property(f"Acquisition_{sig}.{prop}", dv)
    if acq_over:
        plan.acq_conf = _replace(plan.acq_conf, **acq_over)
    trk_over = {}
    for key, prop, dv in (
        ("pll_filter_order", "pll_filter_order", 3),
        ("dll_filter_order", "dll_filter_order", 2),
        ("cn0_min_dbhz", "cn0_min", 25.0),
    ):
        if cfg.has_property(f"Tracking_{sig}.{prop}"):
            trk_over[key] = cfg.property(f"Tracking_{sig}.{prop}", dv)
    if trk_over:
        plan.trk_conf = _replace(plan.trk_conf, **trk_over)

    # acquisition engine variants (Tong / QuickSync / fine-Doppler / CCCWSR)
    engine = _ACQ_ENGINE_BY_IMPL.get(acq_impl)
    if engine is not None:
        plan.acq_engine = engine
        if engine == "cccwsr":
            import numpy as _np

            from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1b_code

            plan.acq_engine_params["chips_table"] = _np.stack(
                [galileo_e1b_code(p) for p in plan.search_prns])
        elif engine == "tong":
            plan.acq_engine_params.setdefault(
                "tong_init", cfg.property(f"Acquisition_{sig}.tong_init_val", 1))
            plan.acq_engine_params.setdefault(
                "tong_max", cfg.property(f"Acquisition_{sig}.tong_max_val", 8))
            plan.acq_engine_params.setdefault(
                "max_attempts",
                cfg.property(f"Acquisition_{sig}.tong_max_dwells", 0) or None)
        elif engine == "quicksync":
            plan.acq_engine_params.setdefault(
                "folding_factor",
                cfg.property(f"Acquisition_{sig}.folding_factor", 2))
    if acq_impl == "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition":
        # 8 ms = 2 E1 code periods of coherent integration
        from dataclasses import replace as _replace

        plan.acq_conf = _replace(plan.acq_conf,
                                 coherent_integration_periods=2)
    # KF tracking engine (kf_tracking.cc analog): same batched correlator,
    # EKF state update instead of the loop filters
    if trk_impl.endswith("_KF_Tracking"):
        from dataclasses import replace as _replace

        plan.trk_conf = _replace(plan.trk_conf, kf=True)
    # Bayesian (CKF/UKF) carrier loop (gps_l1_ca_gaussian_tracking_cc):
    # the filter owns the carrier estimate after `s_transient` periods;
    # the internal PLL drops to a near-dead bandwidth so only the
    # Gaussian commands move the NCO once the transient ends
    if trk_impl.endswith("_Gaussian_Tracking"):
        from dataclasses import replace as _replace

        plan.trk_engine = "gaussian"
        plan.trk_engine_params = {
            "kind": ("unscented" if cfg.property(
                f"Tracking_{sig}.kind", "cubature") == "unscented"
                else "cubature"),
            "s_transient": cfg.property(f"Tracking_{sig}.s_transient", 100),
        }
        # hybrid closure: the standard loops keep their configured
        # bandwidths (pull-in and steady state stay healthy); the CKF/UKF
        # adds clamped block-cadence frequency aiding once past the
        # transient (reference p/s_transient phases)
        if not cfg.property(f"Tracking_{sig}.bce_run", True):
            # without the Bayesian covariance estimator the reference
            # keeps the standard loop: stay on dll_pll
            plan.trk_engine = "dll_pll"
    # external loop closure over TCP (gps_l1_ca_tcp_connector_tracking_cc
    # + tcp_communication.cc): correlator taps stream to the peer, the
    # peer's NCO commands drive the device state
    if trk_impl.endswith("_TCP_CONNECTOR_Tracking"):
        from dataclasses import replace as _replace

        plan.trk_engine = "tcp"
        plan.trk_engine_params = {
            "port": cfg.property(f"Tracking_{sig}.port_ch0", 2060),
        }
        # the internal loops must not fight the external peer
        plan.trk_conf = _replace(plan.trk_conf, pll_bw_hz=1e-4,
                                 dll_bw_hz=1e-5,
                                 enable_fll_pull_in=False)
    # per-block dumps (reference Tracking_XX.dump / dump_filename)
    if cfg.property(f"Tracking_{sig}.dump", False):
        plan.dump_filename = cfg.property(
            f"Tracking_{sig}.dump_filename", f"tracking_{sig}.npz")
    if cfg.property(f"Acquisition_{sig}.dump", False):
        plan.acq_dump_filename = cfg.property(
            f"Acquisition_{sig}.dump_filename", f"acquisition_{sig}.npz")
    return plan


def get_signal_plans(cfg: ConfigurationInterface,
                     fs_by_band: dict[str, float] | float):
    """One SignalPlan per Channels_XX group (gnss_block_factory.cc
    GetChannels). `fs_by_band` maps band key ("L1"/"L5") to the conditioned
    sample rate of its RF chain, or a single rate for single-band configs."""
    counts = get_channel_counts(cfg)
    plans = []
    for sig, n in counts.items():
        band = {"1C": "L1", "1B": "L1", "L5": "L5", "5X": "L5",
                "B1": "B1", "B1G": "B1", "7X": "E5b", "2S": "L2",
                "B3": "B3", "B3G": "B3", "1G": "G1", "J1": "L1",
                "J5": "L5", "SBAS": "L1", "E6": "E6",
                "2G": "G2"}.get(sig, "L1")
        if isinstance(fs_by_band, dict):
            if band not in fs_by_band:
                raise ValueError(
                    f"Channels_{sig} needs band {band}, but no RF chain "
                    f"provides it (have {sorted(fs_by_band)})")
            fs = fs_by_band[band]
        else:
            fs = fs_by_band
        plans.append(get_signal_plan(cfg, sig, fs, n))
    return plans
