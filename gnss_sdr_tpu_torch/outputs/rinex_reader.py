# Copied from gnss_sdr_tpu/outputs/rinex_reader.py; only the package imports are rewritten.
"""RINEX 3 GPS navigation file reader.

Reference analog: utils/rinex2assist (which uses gpstk to convert RINEX
navigation files into the receiver's assistance XML for warm starts) and
the ephemeris intake of rtklib's readrnx. Parses the records written by
outputs/rinex.py:RinexNavWriter and standard IGS BRDC files (GPS 'G'
records; 'D' Fortran exponents accepted).
"""

from __future__ import annotations

from datetime import datetime, timezone
from pathlib import Path

from gnss_sdr_tpu_torch.pvt.ephemeris import GpsEphemeris
from gnss_sdr_tpu_torch.pvt.atmosphere import KlobucharParams


def _f(s: str) -> float:
    s = s.strip().replace("D", "E").replace("d", "e")
    return float(s) if s else 0.0


def _fields(line: str, start: int = 4) -> list[float]:
    """Four 19-char float fields per RINEX nav record line."""
    out = []
    for i in range(4):
        out.append(_f(line[start + 19 * i: start + 19 * (i + 1)]))
    return out


def _gps_week_tow(t: datetime) -> tuple[int, float]:
    t0 = datetime(1980, 1, 6, tzinfo=timezone.utc)
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    delta = t - t0
    week = delta.days // 7
    tow = (delta.days % 7) * 86400.0 + delta.seconds + delta.microseconds * 1e-6
    return week, tow


def read_rinex_nav(path: str | Path) -> tuple[dict[int, GpsEphemeris],
                                              KlobucharParams | None]:
    """Parse a RINEX 3 GPS nav file -> ({prn: GpsEphemeris}, Klobuchar).

    When a PRN appears multiple times, the last record wins (newest IODE
    in chronological files).
    """
    lines = Path(path).read_text().splitlines()
    i = 0
    alpha = beta = None
    while i < len(lines):
        line = lines[i]
        label = line[60:].strip()
        if label == "IONOSPHERIC CORR":
            vals = [_f(line[5 + 12 * k: 5 + 12 * (k + 1)]) for k in range(4)]
            if line.startswith("GPSA"):
                alpha = vals
            elif line.startswith("GPSB"):
                beta = vals
        i += 1
        if label == "END OF HEADER":
            break
    iono = None
    if alpha and beta:
        import numpy as _np

        iono = KlobucharParams(alpha=_np.asarray(alpha),
                               beta=_np.asarray(beta))

    ephs: dict[int, GpsEphemeris] = {}
    while i < len(lines):
        line = lines[i]
        if not line.startswith("G"):
            i += 1
            continue
        if i + 7 >= len(lines):
            break
        prn = int(line[1:3])
        t = datetime(int(line[4:8]), int(line[9:11]), int(line[12:14]),
                     int(line[15:17]), int(line[18:20]), int(line[21:23]),
                     tzinfo=timezone.utc)
        week, toc = _gps_week_tow(t)
        af0, af1, af2 = (_f(line[23:42]), _f(line[42:61]), _f(line[61:80]))
        r1 = _fields(lines[i + 1])
        r2 = _fields(lines[i + 2])
        r3 = _fields(lines[i + 3])
        r4 = _fields(lines[i + 4])
        r5 = _fields(lines[i + 5])
        r6 = _fields(lines[i + 6])
        eph = GpsEphemeris(
            prn=prn, week=week, toc=toc, af0=af0, af1=af1, af2=af2,
            iode_sf2=int(r1[0]), crs=r1[1], delta_n=r1[2], m0=r1[3],
            cuc=r2[0], ecc=r2[1], cus=r2[2], sqrt_a=r2[3],
            toe=r3[0], cic=r3[1], omega0=r3[2], cis=r3[3],
            i0=r4[0], crc=r4[1], omega=r4[2], omega_dot=r4[3],
            idot=r5[0],
            sv_health=int(r6[1]), tgd=r6[2], iodc=int(r6[3]),
        )
        ephs[prn] = eph
        i += 8
    return ephs, iono


def rinex2assist(nav_path: str | Path, xml_path: str | Path) -> int:
    """Convert a RINEX nav file to the receiver's assistance XML
    (utils/rinex2assist analog); returns the number of ephemerides."""
    from gnss_sdr_tpu_torch.receiver.assistance import save_assistance
    from gnss_sdr_tpu_torch.telemetry.lnav import GpsIonoUtc

    ephs, iono = read_rinex_nav(nav_path)
    iono_utc = None
    if iono is not None:
        a, b = iono.alpha, iono.beta
        iono_utc = GpsIonoUtc(
            alpha0=float(a[0]), alpha1=float(a[1]), alpha2=float(a[2]),
            alpha3=float(a[3]), beta0=float(b[0]), beta1=float(b[1]),
            beta2=float(b[2]), beta3=float(b[3]), has_iono=True)
    save_assistance(xml_path,
                    ephemerides={("G", prn): e for prn, e in ephs.items()},
                    iono_utc=iono_utc)
    return len(ephs)
