# Copied from gnss_sdr_tpu/outputs/an_packet.py; only the package imports are rewritten.
"""Advanced Navigation "SDR GNSS" packet printer (INS integration link).

Reference analog: src/algorithms/PVT/libs/an_packet_printer.{h,cc} — the
receiver streams a fixed 113-byte packet (id 201) per fix to an Advanced
Navigation INS over a serial device. Wire format reproduced here:

  header  = [LRC, packet id=201, CRC16-CCITT(data) little-endian]
  data    = nsvfix u8 | num_gps u8 | num_gal u8 | microseconds u32 |
            latitude f64 (rad) | longitude f64 (rad) | height f64 (m) |
            velocity[3] f32 (NED m/s) |
            16 x { prn u8 (Galileo +100) | snr u8 | doppler i16 } |
            status u16 at byte 111  (15 = 3D fix + velocity + time valid)

  LRC = ((id + crc_lo + crc_hi) ^ 0xFF) + 1, all little-endian fields
  (an_packet_printer.cc encode_sdr_gnss_packet/an_packet_encode).

The writer targets any file-like path (a serial device node, FIFO, or
plain file for tests).
"""

from __future__ import annotations

import struct
import time

import numpy as np

SDR_GNSS_PACKET_ID = 201
SDR_GNSS_PACKET_LENGTH = 113
MAX_REPORTED_SATS = 16


def crc16_ccitt(data: bytes) -> int:
    """CRC16-CCITT (poly 0x1021, init 0xFFFF) — an_packet CRC."""
    crc = 0xFFFF
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (
                (crc << 1) & 0xFFFF)
    return crc


def encode_sdr_gnss_packet(sol, sats: list[dict],
                           elapsed_us: int) -> bytes:
    """Build the full packet (header + 113 data bytes).

    sol: PvtSolution-like (valid, lat_rad, lon_rad, height_m, vel_ecef->
    converted by caller? velocity here is NED); sats: [{system, prn,
    cn0_dbhz, doppler_hz}] in observation order.
    """
    data = bytearray(SDR_GNSS_PACKET_LENGTH)
    n_gps = sum(1 for s in sats if s.get("system", "G") == "G")
    n_gal = sum(1 for s in sats if s.get("system") == "E")
    struct.pack_into("<BBBI", data, 0,
                     int(getattr(sol, "num_sats", len(sats))) & 0xFF,
                     n_gps & 0xFF, n_gal & 0xFF, elapsed_us & 0xFFFFFFFF)
    vel = np.asarray(getattr(sol, "vel_ned", np.zeros(3)), dtype=np.float32)
    struct.pack_into("<ddd", data, 7, float(sol.lat_rad),
                     float(sol.lon_rad), float(sol.height_m))
    struct.pack_into("<fff", data, 31, float(vel[0]), float(vel[1]),
                     float(vel[2]))
    off = 43
    for s in sats[:MAX_REPORTED_SATS]:
        prn = int(s["prn"]) + (100 if s.get("system") == "E" else 0)
        dop = int(np.clip(round(s.get("doppler_hz", 0.0)), -32768, 32767))
        struct.pack_into("<BBh", data, off, prn & 0xFF,
                         int(s.get("cn0_dbhz", 0)) & 0xFF, dop)
        off += 4
    status = 15 if getattr(sol, "valid", False) else 0
    struct.pack_into("<H", data, SDR_GNSS_PACKET_LENGTH - 2, status)

    crc = crc16_ccitt(bytes(data))
    crc_lo, crc_hi = crc & 0xFF, (crc >> 8) & 0xFF
    lrc = (((SDR_GNSS_PACKET_ID + crc_lo + crc_hi) ^ 0xFF) + 1) & 0xFF
    header = bytes([lrc, SDR_GNSS_PACKET_ID, crc_lo, crc_hi])
    return header + bytes(data)


def decode_sdr_gnss_packet(buf: bytes) -> dict | None:
    """Parse + CRC/LRC-check a packet (tests / the INS side)."""
    if len(buf) < 4 + SDR_GNSS_PACKET_LENGTH:
        return None
    lrc, pid, crc_lo, crc_hi = buf[0], buf[1], buf[2], buf[3]
    if pid != SDR_GNSS_PACKET_ID:
        return None
    if (((pid + crc_lo + crc_hi) ^ 0xFF) + 1) & 0xFF != lrc:
        return None
    data = buf[4:4 + SDR_GNSS_PACKET_LENGTH]
    if crc16_ccitt(data) != (crc_hi << 8 | crc_lo):
        return None
    nsvfix, n_gps, n_gal, micro = struct.unpack_from("<BBBI", data, 0)
    lat, lon, h = struct.unpack_from("<ddd", data, 7)
    vel = struct.unpack_from("<fff", data, 31)
    sats = []
    off = 43
    for _ in range(MAX_REPORTED_SATS):
        prn, snr, dop = struct.unpack_from("<BBh", data, off)
        off += 4
        if prn:
            sats.append({"prn": prn, "snr": snr, "doppler_hz": dop})
    (status,) = struct.unpack_from("<H", data, SDR_GNSS_PACKET_LENGTH - 2)
    return {"nsvfix": nsvfix, "num_gps": n_gps, "num_gal": n_gal,
            "microseconds": micro, "lat_rad": lat, "lon_rad": lon,
            "height_m": h, "vel_ned": vel, "sats": sats, "status": status}


class AnPacketPrinter:
    """Streams SDR GNSS packets to a device path/file (An_Packet_Printer)."""

    def __init__(self, path: str) -> None:
        self._f = open(path, "wb")
        self._t0 = time.monotonic()

    def print_solution(self, sol, sats: list[dict]) -> None:
        us = int((time.monotonic() - self._t0) * 1e6)
        self._f.write(encode_sdr_gnss_packet(sol, sats, us))
        self._f.flush()

    def close(self) -> None:
        self._f.close()
