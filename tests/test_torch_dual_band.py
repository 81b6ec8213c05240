"""The dual-band slice against the JAX package: GPS L5 and Galileo E5a
beside L1, and the assisted acquisition of a satellite already tracked on
another carrier.

- Both packages' ``gps_l5_plan`` and ``galileo_e5a_plan`` are equal field
  by field: the 10230-chip pilot and data tables, the NH20/NH10 and
  CS100/CS20 secondary rows, the engine confs.
- ``AssistedAcquisition`` on tests/test_acq_engines.py's
  ``test_assisted_narrow_window`` case (PRN 21 at 4100 Hz, predicted at
  3900 Hz, a +-500 Hz window): the JAX engine's verdict, Doppler bin,
  delay within one sample and statistic within 1e-3
  (tests/test_torch_acquisition.py's bounds); then the prediction moved
  in place, which rebuilds nothing.
- tests/test_dual_band.py's ``test_project_doppler_assists_secondary_band``
  through the port's ``Receiver``.
- L1 + L5 from Python: 0.2 s of tests/test_dual_band.py's scenario (seed
  4, cut to 3 satellites) through both Receivers. L1 acquires cold; the
  same call searches L5 around the projected Doppler. Both packages start
  the same satellites on both bands with equal Doppler and delays within
  one sample. The 32 s position gates run on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from conftest import cached_capture
from gnss_sdr_tpu.acquisition import AcqConfig as JConf
from gnss_sdr_tpu.acquisition import AssistedAcquisition as JAssisted
from gnss_sdr_tpu.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu.constants import gps_l1_ca as G
from gnss_sdr_tpu.receiver import plans as jplans
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu.simulate import SatelliteSignalParams, generate_baseband
from gnss_sdr_tpu_torch.acquisition import AcqConfig as TConf
from gnss_sdr_tpu_torch.acquisition import AssistedAcquisition as TAssisted
from gnss_sdr_tpu_torch.receiver import plans as tplans
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.simulate.multiband import GpsL5Band
from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig
from gnss_sdr_tpu_torch.tracking import ChannelPhase

from torch_cases import assert_plans_equal

torch.set_num_threads(2)

FS_L1, FS_L5 = 2.6e6, 10.4e6


@pytest.mark.parametrize("name,kw", [
    ("gps_l5_plan", dict(fs=FS_L5, num_channels=4, search_prns=(1, 5, 7))),
    ("galileo_e5a_plan", dict(fs=FS_L5, num_channels=8,
                              steps_per_block=500)),
], ids=["l5", "e5a_dual16"])
def test_plans_match_jax(name, kw):
    a, b = getattr(jplans, name)(**kw), getattr(tplans, name)(**kw)
    assert_plans_equal(a, b)
    conf = b.trk_conf
    assert b.code_table.shape[1] == b.data_code_table.shape[1] == 10230
    assert conf.track_pilot and conf.data_on_quadrature
    assert b.sec_pilot_table.shape[1] == conf.sec_len_pilot
    assert b.sec_data_levels.shape == (conf.sec_len_data,)
    assert (conf.sec_len_pilot, conf.sec_len_data) == (
        (20, 10) if name == "gps_l5_plan" else (100, 20))


def test_assisted_narrow_window_matches_jax():
    kw = dict(fs=2.046e6, code_length_chips=G.CODE_LENGTH_CHIPS,
              code_rate_cps=G.CODE_RATE_CPS, doppler_max_hz=5000.0,
              doppler_step_hz=125.0, max_dwells=1, pfa=1e-3)
    prns = list(range(1, 33))
    predicted = {p: 0.0 for p in prns}
    predicted[21] = 3900.0
    tbl = gps_l1_ca_code_table()
    je = JAssisted(JConf(**kw), tbl, prns, predicted, window_hz=500.0)
    te = TAssisted(TConf(**kw), tbl, prns, predicted, window_hz=500.0,
                   device="cpu")
    sats = [SatelliteSignalParams(prn=21, cn0_dbhz=46.0, doppler_hz=4100.0,
                                  delay_chips=50.0)]
    x = generate_baseband(sats, kw["fs"], je.conf.input_samples, seed=17)
    rows = np.array([20, 3])
    xb = np.stack([x, x])
    j, t = je.acquire(xb, rows), te.acquire(xb, rows)
    np.testing.assert_array_equal(j.detected, t.detected)
    assert t.detected[0] and not t.detected[1]
    assert abs(t.doppler_hz[0] - 4100.0) <= 125.0
    np.testing.assert_array_equal(j.doppler_hz[:1], t.doppler_hz[:1])
    assert abs(j.delay_samples[0] - t.delay_samples[0]) <= 1.0
    rel = np.abs(j.test_statistic - t.test_statistic) / j.test_statistic
    assert rel.max() < 1e-3, rel
    assert t.threshold == pytest.approx(j.threshold, rel=1e-12)
    assert len(te.inner.conf.doppler_grid_hz()) < 12
    # a new prediction, written into the inner engine's table in place
    table = te.inner._offsets
    moved = np.zeros(32)
    moved[20] = 4200.0
    je.set_predicted_doppler(moved)
    te.set_predicted_doppler(moved)
    assert te.inner._offsets is table
    j, t = je.acquire(xb[:1], rows[:1]), te.acquire(xb[:1], rows[:1])
    assert j.detected[0] and t.detected[0]
    np.testing.assert_array_equal(j.doppler_hz, t.doppler_hz)
    with pytest.raises(ValueError):
        te.set_predicted_doppler(np.zeros(31))


def test_project_doppler_assists_secondary_band():
    """GNSSFlowgraph::project_doppler analog: a satellite tracked on L1
    seeds the L5 group's acquisition with Doppler scaled by f_L5/f_L1 and
    a narrow assisted grid (tests/test_dual_band.py's case, on the port)."""
    plans = [
        tplans.gps_l1ca_plan(fs=2.6e6, num_channels=2, search_prns=(7, 8)),
        tplans.gps_l5_plan(fs=12.0e6, num_channels=2, search_prns=(7, 8)),
    ]
    rx = Receiver(ReceiverConfig(fs=2.6e6, device="cpu"), plans=plans)
    g1, g5 = rx.groups
    g1.channel_prn[0] = 7
    g1.tracker.ctl[0].phase = ChannelPhase.WIDE
    g1.tracker.state.carrier_doppler[0] = 1000.0

    proj = rx._project_doppler(g5)
    f_ratio = g5.plan.carrier_freq_hz / g1.plan.carrier_freq_hz
    assert set(proj) == {7}
    assert proj[7] == pytest.approx(1000.0 * f_ratio, rel=1e-6)

    eng = rx._assisted_engine(g5, proj)
    assert len(eng.inner.conf.doppler_grid_hz()) < 12
    assert eng._offsets_np[g5.plan.prn_row(7)] == pytest.approx(proj[7])
    assert eng._offsets_np[g5.plan.prn_row(8)] == 0.0
    assert eng.inner._offsets.device.type == "cpu"
    eng2 = rx._assisted_engine(g5, {7: 500.0})
    assert eng2 is eng
    assert eng._offsets_np[g5.plan.prn_row(7)] == pytest.approx(500.0)
    assert float(eng.inner._offsets[g5.plan.prn_row(7)]) == 500.0
    assert rx._project_doppler(g1) == {}


def _dual_band_capture():
    scen = GpsScenario(ScenarioConfig(
        fs=FS_L1, tow_start_s=7314.0, duration_s=1.0, cn0_dbhz=46.0,
        rx_clock_bias_s=1.3e-4, max_sats=3, min_elevation_deg=15.0, seed=4))
    l5 = GpsL5Band(scen, fs=FS_L5, cn0_dbhz=47.0)
    x1 = cached_capture("torch_dual_band_l1_3sats_0s2",
                        lambda: scen.generate(0, int(0.2 * FS_L1)))
    x5 = cached_capture("torch_dual_band_l5_3sats_0s2",
                        lambda: l5.generate(0, int(0.2 * FS_L5)))
    return scen, x1, x5


def test_dual_band_assisted_acquisition_matches_jax():
    scen, x1, x5 = _dual_band_capture()
    prns = tuple(scen.prns)
    assert len(prns) == 3
    runs = []
    for rcls, ccls, plans, kw in (
            (JReceiver, JConfig, jplans, {}),
            (Receiver, ReceiverConfig, tplans, {"device": "cpu"})):
        rx = rcls(ccls(fs=FS_L1, num_channels=3, **kw), plans=[
            plans.gps_l1ca_plan(fs=FS_L1, num_channels=3, search_prns=prns),
            plans.gps_l5_plan(fs=FS_L5, num_channels=3, search_prns=prns)])
        rx.feed(x1, band="L1")
        rx.feed(x5, band="L5")
        started = rx.acquire()
        g5 = rx.groups[1]
        run = dict(started=started,
                   prns=[list(g.channel_prn) for g in rx.groups],
                   dop=[np.asarray(g.tracker.state.carrier_doppler
                                   if rcls is JReceiver else
                                   g.tracker.state.carrier_doppler.numpy())
                        for g in rx.groups],
                   offsets=np.asarray(g5.assisted_acq._offsets_np))
        run["active"] = [len(g.active_channels()) for g in rx.groups]
        runs.append(run)
    j, t = runs
    # L1 starts all three satellites cold; L5 searches each around its L1
    # Doppler times f_L5 / f_L1 and starts two of them
    assert t["prns"] == j["prns"]
    assert sorted(t["prns"][0]) == sorted(prns)
    assert sum(p > 0 for p in t["prns"][1]) == 2
    assert t["active"] == j["active"] == [3, 2]
    for a, b in zip(j["dop"], t["dop"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(t["offsets"], j["offsets"], rtol=1e-12)
    ratio = 1176.45e6 / 1575.42e6
    for ch, prn in enumerate(t["prns"][0]):
        row = prn - 1
        assert t["offsets"][row] == pytest.approx(t["dop"][0][ch] * ratio)
    assert started.keys() == j["started"].keys()
    for key, (dop, delay) in j["started"].items():
        assert t["started"][key][0] == dop, key
        assert abs(t["started"][key][1] - delay) <= 1.0, key
