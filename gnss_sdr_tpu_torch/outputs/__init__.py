# Copied from gnss_sdr_tpu/outputs/__init__.py; only the package imports are rewritten.
"""PVT output writers (reference: src/algorithms/PVT/libs/*printer*)."""

from gnss_sdr_tpu_torch.outputs.an_packet import (
    AnPacketPrinter,
    decode_sdr_gnss_packet,
    encode_sdr_gnss_packet,
)
from gnss_sdr_tpu_torch.outputs.geohash import geohash_encode
from gnss_sdr_tpu_torch.outputs.has_text import HasSimplePrinter
from gnss_sdr_tpu_torch.outputs.geojson import GeoJsonPrinter
from gnss_sdr_tpu_torch.outputs.gpx import GpxPrinter
from gnss_sdr_tpu_torch.outputs.kml import KmlPrinter
from gnss_sdr_tpu_torch.outputs.nmea import NmeaPrinter
from gnss_sdr_tpu_torch.outputs.rinex import RinexNavWriter, RinexObsWriter

__all__ = [
    "AnPacketPrinter",
    "GeoJsonPrinter",
    "HasSimplePrinter",
    "decode_sdr_gnss_packet",
    "encode_sdr_gnss_packet",
    "GpxPrinter",
    "KmlPrinter",
    "NmeaPrinter",
    "RinexNavWriter",
    "RinexObsWriter",
    "geohash_encode",
]
