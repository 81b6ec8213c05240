"""The pure-NumPy modules the port copies from the JAX package stay
verbatim copies: each file equals its original after the package import
rewrite (``gnss_sdr_tpu.`` and ``from gnss_sdr_tpu import`` name the port),
apart from its one-line header, and the data files the copies read stay
byte-equal to the originals. A change on either side shows up here."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
COPIES = [
    "codes/beidou_b1i.py",
    "codes/beidou_b3i.py",
    "codes/galileo_e1.py",
    "codes/galileo_e5a.py",
    "codes/galileo_e5b.py",
    "codes/galileo_e6.py",
    "codes/glonass_ca.py",
    "codes/gps_l1_ca.py",
    "codes/gps_l2c.py",
    "codes/gps_l5.py",
    "codes/resample.py",
    "config/__init__.py",
    "config/configuration.py",
    "constants/beidou_b1i.py",
    "constants/beidou_b3i.py",
    "constants/galileo_e1.py",
    "constants/galileo_e5a.py",
    "constants/galileo_e5b.py",
    "constants/galileo_e6.py",
    "constants/general.py",
    "constants/glonass_l1.py",
    "constants/gps_l1_ca.py",
    "constants/gps_l2c.py",
    "constants/gps_l5.py",
    "io/__init__.py",
    "io/formats.py",
    "io/ion_gsms.py",
    "io/labsat.py",
    "io/net_sources.py",
    "io/sources.py",
    "monitor/status.py",
    "native/__init__.py",
    "observables/engine.py",
    "outputs/__init__.py",
    "outputs/an_packet.py",
    "outputs/geohash.py",
    "outputs/geojson.py",
    "outputs/gpstime.py",
    "outputs/gpx.py",
    "outputs/has_text.py",
    "outputs/kml.py",
    "outputs/nmea.py",
    "outputs/rinex.py",
    "pvt/atmosphere.py",
    "pvt/coords.py",
    "pvt/ephemeris.py",
    "pvt/glonass.py",
    "pvt/solver.py",
    "simulate/beidou.py",
    "simulate/constellation.py",
    "simulate/galileo.py",
    "simulate/glonass.py",
    "simulate/multiband.py",
    "simulate/scenario.py",
    "telemetry/cnav.py",
    "telemetry/dnav.py",
    "telemetry/dnav_d2.py",
    "telemetry/fec.py",
    "telemetry/fnav.py",
    "telemetry/gnav.py",
    "telemetry/hascnav.py",
    "telemetry/inav.py",
    "telemetry/lnav.py",
    "telemetry/lnav_encode.py",
    "telemetry/reed_solomon.py",
    "telemetry/sbas.py",
    "tracking/conf.py",
    "tracking/lock_detectors.py",
    "utils/log.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    original = (ROOT / "gnss_sdr_tpu" / rel).read_text()
    copy = (ROOT / "gnss_sdr_tpu_torch" / rel).read_text()
    header, _, body = copy.partition("\n")
    assert header == (f"# Copied from gnss_sdr_tpu/{rel}; only the package "
                      "imports are rewritten.")
    assert body == original.replace(
        "gnss_sdr_tpu.", "gnss_sdr_tpu_torch.").replace(
        "from gnss_sdr_tpu import", "from gnss_sdr_tpu_torch import")


@pytest.mark.parametrize("rel", [
    "codes/data/galileo_e1_codes.npz",
    "codes/data/galileo_e5a_codes.npz",
    "codes/data/galileo_e5b_codes.npz",
    "codes/data/galileo_e6_codes.npz",
    "codes/data/l2c_b3i_tables.npz",
])
def test_data_file_is_byte_equal(rel):
    """The code modules read their tables next to themselves, so the port
    keeps its own copy of each file."""
    original = (ROOT / "gnss_sdr_tpu" / rel).read_bytes()
    assert (ROOT / "gnss_sdr_tpu_torch" / rel).read_bytes() == original
