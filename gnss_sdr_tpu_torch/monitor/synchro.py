# Copied from gnss_sdr_tpu/monitor/synchro.py; only the package imports are rewritten.
"""GnssSynchro: the per-channel inter-block record + binary serdes.

Reference: core/system_parameters/gnss_synchro.h:38-242 (the struct streamed
between all blocks) and core/monitor/serdes_gnss_synchro.h with
docs/protobuf/gnss_synchro.proto:8-40 (the UDP wire format).

The wire format here is a fixed-size little-endian struct (layout below)
rather than protobuf — same capability (machine-readable monitoring stream
consumable by an external listener; `decode_synchro` is the listener side),
no codegen step. A JSON mode is available for human tooling.
"""

from __future__ import annotations

import json
import struct
from dataclasses import asdict, dataclass, field


@dataclass
class GnssSynchro:
    """Per-channel, per-epoch tracking/telemetry state record."""

    system: str = "G"            # 'G' GPS, 'E' Galileo, 'R' GLONASS, 'C' BeiDou
    signal: str = "1C"
    prn: int = 0
    channel_id: int = 0
    # acquisition
    acq_delay_samples: float = 0.0
    acq_doppler_hz: float = 0.0
    acq_samplestamp_samples: int = 0
    # tracking
    fs_hz: float = 0.0
    prompt_i: float = 0.0
    prompt_q: float = 0.0
    cn0_db_hz: float = 0.0
    carrier_doppler_hz: float = 0.0
    carrier_phase_rads: float = 0.0
    code_phase_samples: float = 0.0
    tracking_sample_counter: int = 0
    flag_valid_symbol_output: bool = False
    correlation_length_ms: int = 1
    # telemetry
    flag_valid_word: bool = False
    tow_at_current_symbol_ms: int = 0
    # observables
    pseudorange_m: float = 0.0
    carrier_phase_cycles: float = 0.0
    rx_time_s: float = 0.0
    flag_valid_pseudorange: bool = False
    interp_tow_ms: float = 0.0


# wire layout: magic 'GSTX', version u16, then the fields in declared order
_FMT = "<4sH2sH2sHddqd ddddddq?xH?xq dddd?xd".replace(" ", "")
_MAGIC = b"GSTX"
_VERSION = 1

WIRE_SIZE = struct.calcsize(_FMT)


def encode_synchro(s: GnssSynchro) -> bytes:
    return struct.pack(
        _FMT,
        _MAGIC,
        _VERSION,
        s.system.encode().ljust(2)[:2],
        s.prn,
        s.signal.encode().ljust(2)[:2],
        s.channel_id,
        s.acq_delay_samples,
        s.acq_doppler_hz,
        s.acq_samplestamp_samples,
        s.fs_hz,
        s.prompt_i,
        s.prompt_q,
        s.cn0_db_hz,
        s.carrier_doppler_hz,
        s.carrier_phase_rads,
        s.code_phase_samples,
        s.tracking_sample_counter,
        s.flag_valid_symbol_output,
        s.correlation_length_ms,
        s.flag_valid_word,
        s.tow_at_current_symbol_ms,
        s.pseudorange_m,
        s.carrier_phase_cycles,
        s.rx_time_s,
        s.interp_tow_ms,
        s.flag_valid_pseudorange,
        0.0,
    )


def decode_synchro(buf: bytes) -> GnssSynchro:
    vals = struct.unpack(_FMT, buf[:WIRE_SIZE])
    if vals[0] != _MAGIC or vals[1] != _VERSION:
        raise ValueError("not a GnssSynchro wire record")
    return GnssSynchro(
        system=vals[2].decode().strip("\x00 ").strip(),
        prn=vals[3],
        signal=vals[4].decode().strip("\x00 ").strip(),
        channel_id=vals[5],
        acq_delay_samples=vals[6],
        acq_doppler_hz=vals[7],
        acq_samplestamp_samples=vals[8],
        fs_hz=vals[9],
        prompt_i=vals[10],
        prompt_q=vals[11],
        cn0_db_hz=vals[12],
        carrier_doppler_hz=vals[13],
        carrier_phase_rads=vals[14],
        code_phase_samples=vals[15],
        tracking_sample_counter=vals[16],
        flag_valid_symbol_output=vals[17],
        correlation_length_ms=vals[18],
        flag_valid_word=vals[19],
        tow_at_current_symbol_ms=vals[20],
        pseudorange_m=vals[21],
        carrier_phase_cycles=vals[22],
        rx_time_s=vals[23],
        interp_tow_ms=vals[24],
        flag_valid_pseudorange=vals[25],
    )


def synchro_to_json(s: GnssSynchro) -> str:
    return json.dumps(asdict(s), separators=(",", ":"))
