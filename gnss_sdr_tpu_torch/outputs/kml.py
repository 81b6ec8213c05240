# Copied from gnss_sdr_tpu/outputs/kml.py; only the package imports are rewritten.
"""KML track output (reference: PVT/libs/kml_printer.cc)."""

from __future__ import annotations

import math

_HEADER = """<?xml version="1.0" encoding="UTF-8"?>
<kml xmlns="http://www.opengis.net/kml/2.2">
<Document>
<name>GNSS-SDR-TPU position log</name>
<Placemark>
<name>Position fixes</name>
<LineString>
<extrude>0</extrude>
<altitudeMode>absolute</altitudeMode>
<coordinates>
"""

_FOOTER = """</coordinates>
</LineString>
</Placemark>
</Document>
</kml>
"""


class KmlPrinter:
    def __init__(self, path: str) -> None:
        self.path = path
        self._coords: list[str] = []

    def print_position(self, sol) -> None:
        self._coords.append(
            f"{math.degrees(sol.lon_rad):.9f},"
            f"{math.degrees(sol.lat_rad):.9f},{sol.height_m:.3f}"
        )

    def close(self) -> None:
        with open(self.path, "w") as f:
            f.write(_HEADER)
            f.write("\n".join(self._coords))
            f.write("\n")
            f.write(_FOOTER)
