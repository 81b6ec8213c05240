# Copied from gnss_sdr_tpu/outputs/nmea.py; only the package imports are rewritten.
"""NMEA 0183 sentence output (reference: PVT/libs/nmea_printer.cc).

Emits GGA (fix), RMC (recommended minimum), VTG (track/speed) and GSA
(DOP/active sats) sentences per fix, with standard '*XX' checksums, to a
file and/or an in-memory list (serial output is just a different file path
on POSIX, as in the reference).
"""

from __future__ import annotations

import math

import numpy as np

from gnss_sdr_tpu_torch.outputs.gpstime import DEFAULT_LEAP_SECONDS, gps_to_utc_datetime


def _checksum(body: str) -> str:
    c = 0
    for ch in body:
        c ^= ord(ch)
    return f"{c:02X}"


def sentence(body: str) -> str:
    return f"${body}*{_checksum(body)}"


def _lat_str(lat_deg: float) -> tuple[str, str]:
    hemi = "N" if lat_deg >= 0 else "S"
    lat = abs(lat_deg)
    deg = int(lat)
    minutes = (lat - deg) * 60.0
    return f"{deg:02d}{minutes:09.6f}", hemi


def _lon_str(lon_deg: float) -> tuple[str, str]:
    hemi = "E" if lon_deg >= 0 else "W"
    lon = abs(lon_deg)
    deg = int(lon)
    minutes = (lon - deg) * 60.0
    return f"{deg:03d}{minutes:09.6f}", hemi


class NmeaPrinter:
    def __init__(self, path: str | None = None, week: int = 0,
                 leap_seconds: float = DEFAULT_LEAP_SECONDS) -> None:
        self.path = path
        self.week = week
        # GPS->UTC offset; update from the decoded UTC parameters
        # (delta_t_LS) via set_leap_seconds when available
        self.leap_seconds = leap_seconds
        self.sentences: list[str] = []
        self._f = open(path, "w") if path else None

    def set_leap_seconds(self, leap_seconds: float) -> None:
        self.leap_seconds = leap_seconds

    def _emit(self, s: str) -> None:
        self.sentences.append(s)
        if self._f:
            self._f.write(s + "\r\n")

    def print_position(self, sol) -> list[str]:
        """Emit GGA/RMC/VTG/GSA for one PvtSolution; returns the sentences."""
        t = gps_to_utc_datetime(
            self.week or getattr(sol, "week", 0), sol.tow_s, self.leap_seconds
        )
        hms = t.strftime("%H%M%S") + f".{int(t.microsecond / 1e4):02d}"
        dmy = t.strftime("%d%m%y")
        lat_deg = math.degrees(sol.lat_rad)
        lon_deg = math.degrees(sol.lon_rad)
        lat_s, ns = _lat_str(lat_deg)
        lon_s, ew = _lon_str(lon_deg)

        gga = (
            f"GPGGA,{hms},{lat_s},{ns},{lon_s},{ew},{1 if sol.valid else 0},"
            f"{sol.num_sats:02d},{sol.hdop:.1f},{sol.height_m:.1f},M,0.0,M,,"
        )
        speed_ms = float(np.linalg.norm(sol.vel_ecef[:2]))
        knots = speed_ms * 1.9438445
        course = math.degrees(math.atan2(sol.vel_ecef[1], sol.vel_ecef[0])) % 360
        rmc = (
            f"GPRMC,{hms},{'A' if sol.valid else 'V'},{lat_s},{ns},{lon_s},{ew},"
            f"{knots:.2f},{course:.2f},{dmy},,,A"
        )
        vtg = f"GPVTG,{course:.2f},T,,M,{knots:.2f},N,{speed_ms * 3.6:.2f},K,A"
        gsa = (
            f"GPGSA,A,3,{',' * 11}{sol.pdop:.1f},{sol.hdop:.1f},{sol.vdop:.1f}"
        )
        out = [sentence(s) for s in (gga, rmc, vtg, gsa)]
        for s in out:
            self._emit(s)
        return out

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
