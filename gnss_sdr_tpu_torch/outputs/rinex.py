# Copied from gnss_sdr_tpu/outputs/rinex.py; only the package imports are rewritten.
"""RINEX 3.02 observation + navigation writers.

Reference: PVT/libs/rinex_printer.cc (3379 LoC covering RINEX 2.11/3.02 for
all constellations). This implements the 3.02 dialect for GPS (C1C/L1C/D1C/
S1C observables, LNAV ephemerides) and Galileo (C1B/L1B/D1B/S1B, I/NAV),
the formats the end-to-end receiver currently produces; headers and record
layouts follow the published RINEX 3.02 spec tables (fixed 80-column cards,
'> ' epoch records, %14.3f observables, %19.12E nav fields).
"""

from __future__ import annotations

from gnss_sdr_tpu_torch.outputs.gpstime import gps_to_datetime


def _card(content: str, label: str) -> str:
    return f"{content:<60.60s}{label}"


def _e19(v: float) -> str:
    """%19.12E with 2-digit exponent (RINEX nav field)."""
    s = f"{v:19.12E}"
    # python may emit 3-digit exponents for tiny values; RINEX wants 2
    mant, ex = s.split("E")
    return f"{mant}E{int(ex):+03d}"


_SYS_LETTER = {"GPS": "G", "Galileo": "E", "GLONASS": "R", "BeiDou": "C"}


class RinexObsWriter:
    """RINEX 3.02 observation file writer."""

    def __init__(
        self,
        path: str,
        week: int,
        approx_pos=(0.0, 0.0, 0.0),
        systems: tuple[str, ...] = ("GPS",),
        marker: str = "GNSS_SDR_TPU",
    ) -> None:
        self.path = path
        self.week = week
        self._f = open(path, "w")
        self._header_written = False
        self._approx = approx_pos
        self._systems = systems
        self._marker = marker
        self._first_tow: float | None = None

    def _write_header(self, tow_s: float) -> None:
        f = self._f
        w = lambda c, l: f.write(_card(c, l) + "\n")
        sys_id = "M: MIXED" if len(self._systems) > 1 else (
            {"GPS": "G: GPS", "Galileo": "E: GALILEO"}[self._systems[0]]
        )
        w(f"{'3.02':>9}{'':11}OBSERVATION DATA    {sys_id:<20}", "RINEX VERSION / TYPE")
        w(f"{'GNSS-SDR-TPU':<20}{'':20}{'':20}", "PGM / RUN BY / DATE")
        w(f"{self._marker:<60}", "MARKER NAME")
        w("NON_GEODETIC", "MARKER TYPE")
        w(f"{'UNKNOWN':<20}{'GNSS-SDR-TPU':<40}", "OBSERVER / AGENCY")
        w(f"{'1':<20}{'SOFTWARE RECEIVER':<20}{'1.0':<20}", "REC # / TYPE / VERS")
        w(f"{'':<20}{'NONE':<20}", "ANT # / TYPE")
        x, y, z = self._approx
        w(f"{x:14.4f}{y:14.4f}{z:14.4f}", "APPROX POSITION XYZ")
        w(f"{0.0:14.4f}{0.0:14.4f}{0.0:14.4f}", "ANTENNA: DELTA H/E/N")
        band = {"GPS": ("C1C", "L1C", "D1C", "S1C"),
                "Galileo": ("C1B", "L1B", "D1B", "S1B")}
        for s in self._systems:
            obs = band[s]
            types = "".join(f" {t:>3}" for t in obs)
            w(f"{_SYS_LETTER[s]}  {len(obs):3d}{types}", "SYS / # / OBS TYPES")
        t = gps_to_datetime(self.week, tow_s)
        w(
            f"{t.year:6d}{t.month:6d}{t.day:6d}{t.hour:6d}{t.minute:6d}"
            f"{t.second + t.microsecond / 1e6:13.7f}     GPS",
            "TIME OF FIRST OBS",
        )
        w("", "END OF HEADER")
        self._header_written = True

    def write_epoch(self, tow_s: float, observations: list[dict]) -> None:
        """One epoch. Each observation dict:
        {prn, system?, pseudorange_m, carrier_phase_cycles?, doppler_hz?,
         cn0_dbhz?}."""
        if not self._header_written:
            self._write_header(tow_s)
        t = gps_to_datetime(self.week, tow_s)
        sec = t.second + t.microsecond / 1e6
        self._f.write(
            f"> {t.year:4d} {t.month:02d} {t.day:02d} {t.hour:02d} "
            f"{t.minute:02d}{sec:11.7f}  0{len(observations):3d}\n"
        )
        for o in observations:
            sys = _SYS_LETTER[o.get("system", "GPS")]
            line = f"{sys}{o['prn']:02d}"
            pr = o.get("pseudorange_m")
            cp = o.get("carrier_phase_cycles")
            dop = o.get("doppler_hz")
            cn0 = o.get("cn0_dbhz")
            for v, blank in (
                (pr, pr is None),
                (cp, cp is None),
                (dop, dop is None),
                (cn0, cn0 is None),
            ):
                line += " " * 16 if blank else f"{v:14.3f}  "
            self._f.write(line.rstrip() + "\n")

    def close(self) -> None:
        self._f.close()


class RinexNavWriter:
    """RINEX 3.02 GPS navigation file writer (LNAV broadcast ephemerides)."""

    def __init__(self, path: str, iono=None, utc=None) -> None:
        self.path = path
        self._f = open(path, "w")
        self._write_header(iono)

    def _write_header(self, iono) -> None:
        f = self._f
        f.write(_card(f"{'3.02':>9}{'':11}N: GNSS NAV DATA    G: GPS",
                      "RINEX VERSION / TYPE") + "\n")
        f.write(_card(f"{'GNSS-SDR-TPU':<20}", "PGM / RUN BY / DATE") + "\n")
        if iono is not None:
            a = "".join(f"{v:12.4E}" for v in
                        (iono.alpha0, iono.alpha1, iono.alpha2, iono.alpha3))
            b = "".join(f"{v:12.4E}" for v in
                        (iono.beta0, iono.beta1, iono.beta2, iono.beta3))
            f.write(_card(f"GPSA {a}", "IONOSPHERIC CORR") + "\n")
            f.write(_card(f"GPSB {b}", "IONOSPHERIC CORR") + "\n")
        f.write(_card("", "END OF HEADER") + "\n")

    # IS-GPS-200 Table 20 nominal URA meters per URA index (20.3.3.3.1.3);
    # index 15 means "no accuracy prediction" — written as the largest bound
    _URA_METERS = (2.4, 3.4, 4.85, 6.85, 9.65, 13.65, 24.0, 48.0, 96.0,
                   192.0, 384.0, 768.0, 1536.0, 3072.0, 6144.0, 6144.0)

    def write_ephemeris(self, eph, trans_time_s: float | None = None) -> None:
        """Write one GpsEphemeris as the 8-line RINEX nav record.

        trans_time_s: transmission time of message (seconds of GPS week,
        e.g. the TOW of the decoded subframe); defaults to toc when no
        subframe timestamp is available.
        """
        t = gps_to_datetime(eph.week, eph.toc)
        f = self._f
        f.write(
            f"G{eph.prn:02d} {t.year:4d} {t.month:02d} {t.day:02d} "
            f"{t.hour:02d} {t.minute:02d} {t.second:02d}"
            f"{_e19(eph.af0)}{_e19(eph.af1)}{_e19(eph.af2)}\n"
        )
        ura_m = self._URA_METERS[min(int(eph.ura_index), 15)]
        # fit interval in HOURS per RINEX 3.02 / rinex_printer.cc (flag 0 ->
        # 4 h nominal, flag 1 -> 8 h)
        fit_hours = 4.0 if not eph.fit_interval else 8.0
        ttom = eph.toc if trans_time_s is None else float(trans_time_s)
        rows = [
            (eph.iode_sf2, eph.crs, eph.delta_n, eph.m0),
            (eph.cuc, eph.ecc, eph.cus, eph.sqrt_a),
            (eph.toe, eph.cic, eph.omega0, eph.cis),
            (eph.i0, eph.crc, eph.omega, eph.omega_dot),
            (eph.idot, 1.0, float(eph.week), 0.0),  # codes on L2, week, L2P flag
            (ura_m, float(eph.sv_health), eph.tgd, float(eph.iodc)),
            (ttom, fit_hours, 0.0, 0.0),
        ]
        for r in rows:
            f.write("    " + "".join(_e19(float(v)) for v in r) + "\n")

    def close(self) -> None:
        self._f.close()
