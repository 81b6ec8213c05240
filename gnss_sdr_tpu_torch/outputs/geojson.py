# Copied from gnss_sdr_tpu/outputs/geojson.py; only the package imports are rewritten.
"""GeoJSON track output (reference: PVT/libs/geojson_printer.cc)."""

from __future__ import annotations

import json
import math


class GeoJsonPrinter:
    def __init__(self, path: str) -> None:
        self.path = path
        self._coords: list[list[float]] = []

    def print_position(self, sol) -> None:
        self._coords.append(
            [
                round(math.degrees(sol.lon_rad), 9),
                round(math.degrees(sol.lat_rad), 9),
                round(sol.height_m, 3),
            ]
        )

    def close(self) -> None:
        doc = {
            "type": "Feature",
            "properties": {"name": "GNSS-SDR-TPU position log"},
            "geometry": {"type": "LineString", "coordinates": self._coords},
        }
        with open(self.path, "w") as f:
            json.dump(doc, f, indent=1)
