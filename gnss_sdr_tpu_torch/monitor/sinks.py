# Copied from gnss_sdr_tpu/monitor/sinks.py; only the package imports are rewritten.
"""UDP monitoring sinks.

Reference: core/monitor/gnss_synchro_monitor.{h,cc} (decimated per-channel
Gnss_Synchro UDP stream, enabled by Monitor.enable_monitor,
gnss_flowgraph.cc:249-260) and PVT/libs/monitor_pvt_udp_sink.cc /
monitor_ephemeris_udp_sink.cc. Wire format is the fixed struct of
monitor/synchro.py (or JSON lines), one record per datagram, fanned out to
multiple client addresses like the reference.
"""

from __future__ import annotations

import json
import socket
import struct
from dataclasses import asdict

from gnss_sdr_tpu_torch.monitor.synchro import GnssSynchro, encode_synchro, synchro_to_json


class _UdpFanout:
    def __init__(self, clients: list[tuple[str, int]]) -> None:
        self.clients = clients
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, payload: bytes) -> None:
        for addr in self.clients:
            self._sock.sendto(payload, addr)

    def close(self) -> None:
        self._sock.close()


class GnssSynchroMonitor:
    """Decimated per-channel synchro stream (gnss_synchro_monitor analog)."""

    def __init__(
        self,
        clients: list[tuple[str, int]],
        decimation: int = 1,
        mode: str = "binary",     # "binary" | "json" | "protobuf"
    ) -> None:
        """mode="protobuf" emits the reference's exact proto3 wire format
        (docs/protobuf/gnss_synchro.proto via monitor/protobuf.py), so
        gnss-sdr-monitor / reference listeners decode the stream
        unmodified."""
        self._out = _UdpFanout(clients)
        self.decimation = max(decimation, 1)
        self.mode = mode
        self._count = 0

    def push(self, synchro: GnssSynchro) -> None:
        self._count += 1
        if self._count % self.decimation:
            return
        if self.mode == "json":
            self._out.send(synchro_to_json(synchro).encode())
        elif self.mode == "protobuf":
            from gnss_sdr_tpu_torch.monitor.protobuf import encode_gnss_synchro

            self._out.send(encode_gnss_synchro(synchro))
        else:
            self._out.send(encode_synchro(synchro))

    def close(self) -> None:
        self._out.close()


_PVT_FMT = "<4sH d ddd ddd dddd dd H"
PVT_WIRE_SIZE = struct.calcsize(_PVT_FMT)
_PVT_MAGIC = b"GPVT"


def encode_monitor_pvt(sol, week: int = 0) -> bytes:
    """Serialize a PvtSolution (monitor_pvt.h analog fields)."""
    return struct.pack(
        _PVT_FMT, _PVT_MAGIC, 1,
        sol.tow_s,
        *[float(v) for v in sol.pos_ecef],
        *[float(v) for v in sol.vel_ecef],
        sol.lat_rad, sol.lon_rad, sol.height_m, sol.clock_bias_s,
        sol.gdop, sol.pdop,
        sol.num_sats,
    )


def decode_monitor_pvt(buf: bytes) -> dict:
    vals = struct.unpack(_PVT_FMT, buf[:PVT_WIRE_SIZE])
    if vals[0] != _PVT_MAGIC:
        raise ValueError("not a Monitor_Pvt record")
    return {
        "tow_s": vals[2],
        "pos_ecef": list(vals[3:6]),
        "vel_ecef": list(vals[6:9]),
        "lat_rad": vals[9], "lon_rad": vals[10], "height_m": vals[11],
        "clock_bias_s": vals[12],
        "gdop": vals[13], "pdop": vals[14],
        "num_sats": vals[15],
    }


class MonitorPvtUdpSink:
    """Per-fix PVT stream (monitor_pvt_udp_sink analog).

    protocol="protobuf" emits the reference's MonitorPvt proto3 wire
    format (docs/protobuf/monitor_pvt.proto)."""

    def __init__(self, clients: list[tuple[str, int]], week: int = 0,
                 protocol: str = "binary") -> None:
        self._out = _UdpFanout(clients)
        self.week = week
        self.protocol = protocol

    def push(self, sol) -> None:
        if self.protocol == "protobuf":
            from gnss_sdr_tpu_torch.monitor.protobuf import encode_monitor_pvt_pb

            self._out.send(encode_monitor_pvt_pb(sol, self.week))
        else:
            self._out.send(encode_monitor_pvt(sol, self.week))

    def close(self) -> None:
        self._out.close()


class MonitorEphemerisUdpSink:
    """Ephemeris broadcast as JSON datagrams
    (monitor_ephemeris_udp_sink analog)."""

    def __init__(self, clients: list[tuple[str, int]]) -> None:
        self._out = _UdpFanout(clients)

    def push(self, eph) -> None:
        d = asdict(eph)
        d["_type"] = type(eph).__name__
        self._out.send(json.dumps(d, separators=(",", ":")).encode())

    def close(self) -> None:
        self._out.close()


class NavMessageMonitor:
    """Decoded navigation-message events as JSON datagrams (reference
    core/libs/nav_message_monitor.cc + nav_message_packet.h: system,
    signal, PRN, TOW and the decoder event payload, consumed by
    utils/nav-listener)."""

    def __init__(self, clients: list[tuple[str, int]]) -> None:
        self._out = _UdpFanout(clients)

    def push(self, system: str, signal: str, prn: int, event: dict) -> None:
        d = {"_type": "nav_message", "system": system, "signal": signal,
             "prn": int(prn)}
        for k, v in event.items():
            if isinstance(v, (int, float, str, bool)) or v is None:
                d[k] = v
        self._out.send(json.dumps(d, separators=(",", ":")).encode())

    def close(self) -> None:
        self._out.close()
