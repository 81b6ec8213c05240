"""The pure-NumPy modules the port copies from the JAX package stay
verbatim copies: each file equals its original after the package import
rewrite (``gnss_sdr_tpu.`` and ``from gnss_sdr_tpu import`` name the port),
apart from its one-line header, and the data files the copies read stay
byte-equal to the originals. A change on either side shows up here."""

from pathlib import Path

import numpy as np
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
    "monitor/__init__.py",
    "monitor/dumps.py",
    "monitor/protobuf.py",
    "monitor/sinks.py",
    "monitor/status.py",
    "monitor/synchro.py",
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
    "outputs/rinex_reader.py",
    "outputs/rtcm.py",
    "outputs/rtcm2.py",
    "pvt/antex.py",
    "pvt/atmosphere.py",
    "pvt/coords.py",
    "pvt/ephemeris.py",
    "pvt/glonass.py",
    "pvt/kf.py",
    "pvt/lambda_ilr.py",
    "pvt/ppp.py",
    "pvt/preceph.py",
    "pvt/rtk.py",
    "pvt/sbas_corr.py",
    "pvt/solver.py",
    "pvt/tides.py",
    "receiver/agnss.py",
    "receiver/assistance.py",
    "receiver/osnma_rx.py",
    "receiver/supl.py",
    "receiver/telecommand.py",
    "simulate/beidou.py",
    "simulate/constellation.py",
    "simulate/galileo.py",
    "simulate/generator.py",
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
    "telemetry/osnma.py",
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


def _sbas_case(pkg):
    """tests/test_sbas_corr.py::test_sbas_aided_solve_removes_range_biases's
    inputs and both solutions, through ``pkg``'s modules."""
    import importlib

    coords = importlib.import_module(f"{pkg}.pvt.coords")
    sbas = importlib.import_module(f"{pkg}.pvt.sbas_corr")
    solver = importlib.import_module(f"{pkg}.pvt.solver")
    const = importlib.import_module(f"{pkg}.simulate.constellation")
    tow = 7200.0 + 120.0
    ephs = const.make_constellation(seed=3)
    rx = coords.llh_to_ecef(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0)
    vis = const.visible_sats(ephs, rx, tow)[:7]
    rng = np.random.default_rng(9)
    biases = {prn: float(b) for prn, b in
              zip(vis, rng.uniform(-8.0, 8.0, len(vis)))}
    obs = []
    for prn in vis:
        t = const.truth_measurement(ephs[prn], rx, tow, rx_clock_bias_s=1e-4)
        obs.append(solver.ObsEpoch(
            prn=prn, pseudorange_m=t["pseudorange_m"] + biases[prn],
            doppler_hz=t["doppler_hz"]))
    sb = sbas.SbasCorrections()
    sb.ingest(1, sbas.encode_mt1(sorted(vis)))
    slots = {prn: i for i, prn in enumerate(sorted(vis))}
    prc = [0.0] * 13
    for prn in vis:
        prc[slots[prn]] = -biases[prn]
    sb.ingest(2, sbas.encode_mt2_5(prc))
    kw = dict(apply_atmosphere=False, raim_threshold_m=0.0)
    return (rx, solver.solve_pvt(obs, ephs, tow, **kw),
            solver.solve_pvt(obs, ephs, tow, sbas=sb, **kw))


def test_sbas_aided_solve_matches_jax():
    """``solve_pvt(..., sbas=...)`` reaches the port's copy of
    pvt/sbas_corr.py, and the corrected fix equals the JAX package's bit
    for bit (the copy of tests/test_sbas_corr.py's case)."""
    rx, plain_j, aided_j = _sbas_case("gnss_sdr_tpu")
    _, plain_t, aided_t = _sbas_case("gnss_sdr_tpu_torch")
    np.testing.assert_array_equal(aided_t.pos_ecef, aided_j.pos_ecef)
    np.testing.assert_array_equal(plain_t.pos_ecef, plain_j.pos_ecef)
    assert np.linalg.norm(aided_t.pos_ecef - rx) < 0.3


def test_signed_galileo_pages_match_jax():
    """A Galileo scenario with an OSNMA signer builds in the port (its
    copy of telemetry/osnma.py signs the pages), and every satellite's
    page symbols equal the JAX scenario's. The two signers share the JAX
    signer's key and one DSM-KROOT signature: ECDSA draws a fresh nonce
    per signature, the TESLA chain and the tags follow from the seed."""
    from gnss_sdr_tpu.simulate.galileo import (
        GalileoScenario as JScenario,
        GalileoScenarioConfig as JConfig,
    )
    from gnss_sdr_tpu.telemetry.osnma import OsnmaSigner as JSigner
    from gnss_sdr_tpu_torch.simulate.galileo import (
        GalileoScenario,
        GalileoScenarioConfig,
    )
    from gnss_sdr_tpu_torch.telemetry.osnma import OsnmaSigner

    kw = dict(num_keys=48, seed=11, wn0=1250, tow0_hours=2)
    js, ts = JSigner(**kw), OsnmaSigner(**kw)
    sig = js._sign()
    js._sign = ts._sign = lambda: sig
    ts._private, ts.public_key = js._private, js.public_key
    assert ts.keys == js.keys
    scen = dict(fs=4.0e6, tow_start_s=7310.0, duration_s=4.0,
                cn0_dbhz=48.0, max_sats=4, seed=3)
    j = JScenario(JConfig(osnma_signer=js, **scen))
    t = GalileoScenario(GalileoScenarioConfig(osnma_signer=ts, **scen))
    assert t.prns == j.prns
    for prn in j.prns:
        np.testing.assert_array_equal(t._signs[prn], j._signs[prn])
    # the signer's fields really are in the pages
    unsigned = GalileoScenario(GalileoScenarioConfig(**scen))
    assert any((unsigned._signs[p] != t._signs[p]).any() for p in t.prns)
