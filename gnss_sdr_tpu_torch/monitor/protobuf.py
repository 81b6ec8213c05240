# Copied from gnss_sdr_tpu/monitor/protobuf.py; only the package imports are rewritten.
"""Proto3 wire-format codec for the reference's monitoring messages.

The reference streams per-channel state and PVT fixes over UDP as
protobuf messages (core/monitor/serdes_gnss_synchro.h with
docs/protobuf/gnss_synchro.proto:8-40, PVT/libs/serdes_monitor_pvt.h
with docs/protobuf/monitor_pvt.proto), so its ecosystem tooling
(utils/nav-listener, utils/skyplot, gnss-sdr-monitor) expects that exact
wire format. This module hand-rolls the proto3 encoding for those two
schemas in pure stdlib — no codegen, no protobuf runtime dependency —
with field numbers/types copied from the reference .proto files.
tests/test_protobuf_wire.py cross-validates the bytes against
protoc-generated bindings compiled from the reference tree at test time.

Proto3 wire rules implemented (all this schema needs):
- varint (wire type 0): uint32/uint64/int32/int64/bool
- fixed64 (wire type 1): double
- length-delimited (wire type 2): string, embedded message
- fixed32 (wire type 5): float
- default-valued fields are omitted (proto3 implicit presence)
"""

from __future__ import annotations

import struct
from typing import Any

# ---------------------------------------------------------------- primitives


def _varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1        # proto3 negative int32/int64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


# ------------------------------------------------------------------ schemas
# (field_number, name, kind); kind in
# {"double","float","varint","bool","string","sint"}  ("sint" here means a
# plain int32/int64 encoded as two's-complement varint, per proto3 int32)

GNSS_SYNCHRO_FIELDS = [
    (1, "system", "string"),
    (2, "signal", "string"),
    (3, "prn", "varint"),
    (4, "channel_id", "sint"),
    (5, "acq_delay_samples", "double"),
    (6, "acq_doppler_hz", "double"),
    (7, "acq_samplestamp_samples", "varint"),
    (8, "acq_doppler_step", "varint"),
    (9, "flag_valid_acquisition", "bool"),
    (10, "fs", "sint"),
    (11, "prompt_i", "double"),
    (12, "prompt_q", "double"),
    (13, "cn0_db_hz", "double"),
    (14, "carrier_doppler_hz", "double"),
    (15, "carrier_phase_rads", "double"),
    (16, "code_phase_samples", "double"),
    (17, "tracking_sample_counter", "varint"),
    (18, "flag_valid_symbol_output", "bool"),
    (19, "correlation_length_ms", "sint"),
    (20, "flag_valid_word", "bool"),
    (21, "tow_at_current_symbol_ms", "varint"),
    (22, "pseudorange_m", "double"),
    (23, "rx_time", "double"),
    (24, "flag_valid_pseudorange", "bool"),
    (25, "interp_tow_ms", "double"),
    (26, "flag_PLL_180_deg_phase_locked", "bool"),
    (27, "flag_cycle_slip", "bool"),
]

MONITOR_PVT_FIELDS = [
    (1, "tow_at_current_symbol_ms", "varint"),
    (2, "week", "varint"),
    (3, "rx_time", "double"),
    (4, "user_clk_offset", "double"),
    (5, "pos_x", "double"),
    (6, "pos_y", "double"),
    (7, "pos_z", "double"),
    (8, "vel_x", "double"),
    (9, "vel_y", "double"),
    (10, "vel_z", "double"),
    (11, "cov_xx", "double"),
    (12, "cov_yy", "double"),
    (13, "cov_zz", "double"),
    (14, "cov_xy", "double"),
    (15, "cov_yz", "double"),
    (16, "cov_zx", "double"),
    (17, "latitude", "double"),
    (18, "longitude", "double"),
    (19, "height", "double"),
    (20, "valid_sats", "varint"),
    (21, "solution_status", "varint"),
    (22, "solution_type", "varint"),
    (23, "ar_ratio_factor", "float"),
    (24, "ar_ratio_threshold", "float"),
    (25, "gdop", "double"),
    (26, "pdop", "double"),
    (27, "hdop", "double"),
    (28, "vdop", "double"),
    (29, "user_clk_drift_ppm", "double"),
    (30, "utc_time", "string"),
    (31, "vel_e", "double"),
    (32, "vel_n", "double"),
    (33, "vel_u", "double"),
    (34, "cog", "double"),
]

_WIRE_OF_KIND = {"double": 1, "float": 5, "varint": 0, "sint": 0,
                 "bool": 0, "string": 2}


def encode_message(fields, values: dict[str, Any]) -> bytes:
    """Encode a flat proto3 message; default-valued fields are skipped."""
    out = bytearray()
    for num, name, kind in fields:
        v = values.get(name)
        if v is None:
            continue
        if kind == "double":
            v = float(v)
            if v == 0.0:
                continue
            out += _tag(num, 1) + struct.pack("<d", v)
        elif kind == "float":
            v = float(v)
            if v == 0.0:
                continue
            out += _tag(num, 5) + struct.pack("<f", v)
        elif kind in ("varint", "sint"):
            v = int(v)
            if v == 0:
                continue
            out += _tag(num, 0) + _varint(v)
        elif kind == "bool":
            if not v:
                continue
            out += _tag(num, 0) + b"\x01"
        elif kind == "string":
            b = str(v).encode()
            if not b:
                continue
            out += _tag(num, 2) + _varint(len(b)) + b
    return bytes(out)


def decode_message(fields, buf: bytes) -> dict[str, Any]:
    """Decode a flat proto3 message; unknown fields are skipped."""
    by_num = {num: (name, kind) for num, name, kind in fields}
    out: dict[str, Any] = {}
    for num, name, kind in fields:
        if kind == "double":
            out[name] = 0.0
        elif kind == "float":
            out[name] = 0.0
        elif kind == "bool":
            out[name] = False
        elif kind == "string":
            out[name] = ""
        else:
            out[name] = 0
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            v = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 5:
            v = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if num not in by_num:
            continue
        name, kind = by_num[num]
        if kind == "string":
            out[name] = v.decode() if isinstance(v, bytes) else str(v)
        elif kind == "bool":
            out[name] = bool(v)
        elif kind == "sint":
            v = int(v)
            if v >= 1 << 63:
                v -= 1 << 64
            out[name] = v
        elif kind in ("double", "float"):
            out[name] = float(v)
        else:
            out[name] = int(v)
    return out


# ------------------------------------------------------------ message level


def encode_gnss_synchro(s) -> bytes:
    """GnssSynchro (monitor/synchro.py dataclass or dict) -> proto bytes."""
    v = s if isinstance(s, dict) else s.__dict__
    vals = dict(v)
    # repo-side names -> .proto names where they differ
    vals.setdefault("fs", int(v.get("fs_hz", 0)))
    vals.setdefault("rx_time", v.get("rx_time_s", 0.0))
    return encode_message(GNSS_SYNCHRO_FIELDS, vals)


def decode_gnss_synchro(buf: bytes) -> dict[str, Any]:
    return decode_message(GNSS_SYNCHRO_FIELDS, buf)


def encode_observables(synchros) -> bytes:
    """Observables { repeated GnssSynchro observable = 1; }"""
    out = bytearray()
    for s in synchros:
        sub = encode_gnss_synchro(s)
        out += _tag(1, 2) + _varint(len(sub)) + sub
    return bytes(out)


def decode_observables(buf: bytes) -> list[dict[str, Any]]:
    out = []
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire != 2:
            raise ValueError("Observables: expected length-delimited")
        ln, pos = _read_varint(buf, pos)
        if num == 1:
            out.append(decode_gnss_synchro(buf[pos:pos + ln]))
        pos += ln
    return out


def encode_monitor_pvt_pb(sol, week: int = 0) -> bytes:
    """PVT solution (pvt/solver.py PvtSolution) -> MonitorPvt bytes."""
    import math

    p = getattr(sol, "pos_ecef", (0.0, 0.0, 0.0))
    v = getattr(sol, "vel_ecef", None)
    vel = tuple(v) if v is not None else (0.0, 0.0, 0.0)
    tow = float(getattr(sol, "tow_s", 0.0))
    vals = {
        "tow_at_current_symbol_ms": int(1000.0 * tow),
        "week": int(week),
        "rx_time": tow,
        "user_clk_offset": float(getattr(sol, "clock_bias_s", 0.0)),
        "pos_x": float(p[0]), "pos_y": float(p[1]), "pos_z": float(p[2]),
        "vel_x": float(vel[0]), "vel_y": float(vel[1]),
        "vel_z": float(vel[2]),
        "latitude": math.degrees(float(getattr(sol, "lat_rad", 0.0))),
        "longitude": math.degrees(float(getattr(sol, "lon_rad", 0.0))),
        "height": float(getattr(sol, "height_m", 0.0)),
        "valid_sats": int(getattr(sol, "num_sats", 0)),
        "gdop": float(getattr(sol, "gdop", 0.0)),
        "pdop": float(getattr(sol, "pdop", 0.0)),
        "hdop": float(getattr(sol, "hdop", 0.0) or 0.0),
        "vdop": float(getattr(sol, "vdop", 0.0) or 0.0),
    }
    return encode_message(MONITOR_PVT_FIELDS, vals)


def decode_monitor_pvt_pb(buf: bytes) -> dict[str, Any]:
    return decode_message(MONITOR_PVT_FIELDS, buf)
