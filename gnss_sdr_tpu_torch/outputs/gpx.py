# Copied from gnss_sdr_tpu/outputs/gpx.py; only the package imports are rewritten.
"""GPX track output (reference: PVT/libs/gpx_printer.cc)."""

from __future__ import annotations

import math

from gnss_sdr_tpu_torch.outputs.gpstime import DEFAULT_LEAP_SECONDS, gps_to_utc_datetime


class GpxPrinter:
    def __init__(self, path: str, week: int = 0,
                 leap_seconds: float = DEFAULT_LEAP_SECONDS) -> None:
        self.path = path
        self.week = week
        self.leap_seconds = leap_seconds
        self._pts: list[str] = []

    def print_position(self, sol) -> None:
        t = gps_to_utc_datetime(self.week, sol.tow_s, self.leap_seconds)
        self._pts.append(
            f'<trkpt lat="{math.degrees(sol.lat_rad):.9f}" '
            f'lon="{math.degrees(sol.lon_rad):.9f}">'
            f"<ele>{sol.height_m:.3f}</ele>"
            f"<time>{t.strftime('%Y-%m-%dT%H:%M:%S.%f')[:-3]}Z</time>"
            f"<hdop>{sol.hdop:.2f}</hdop><vdop>{sol.vdop:.2f}</vdop>"
            f"</trkpt>"
        )

    def close(self) -> None:
        with open(self.path, "w") as f:
            f.write('<?xml version="1.0" encoding="UTF-8"?>\n')
            f.write(
                '<gpx version="1.1" creator="GNSS-SDR-TPU" '
                'xmlns="http://www.topografix.com/GPX/1/1">\n'
                "<trk><name>Position fixes</name><trkseg>\n"
            )
            f.write("\n".join(self._pts))
            f.write("\n</trkseg></trk>\n</gpx>\n")
