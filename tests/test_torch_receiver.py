"""The GPS L1 C/A slice as a whole: the port's Receiver on the CPU against
the JAX Receiver, and the port alone through the 32 s position gates of
tests/test_position.py.

Both receivers get the same 6 s GpsScenario capture in 1 s chunks. They
must acquire the same satellites with the same Doppler and delay (within
one sample), end with the same channel phases and subframe count, and
agree on the first tracking block's code phase and Doppler within the
tolerances of tests/test_fused_receiver.py's _assert_match.
"""

import numpy as np
import pytest
import torch

from conftest import cached_capture
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu_torch.pvt.coords import ecef_to_enu
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig

torch.set_num_threads(2)

FS = 2.6e6


def scenario(duration_s):
    """tests/test_position.py's scenario: it starts at a subframe-5
    boundary, so SF1/SF2/SF3 complete at t = 12/18/24 s."""
    return GpsScenario(ScenarioConfig(
        fs=FS, tow_start_s=7314.0, duration_s=duration_s, cn0_dbhz=46.0,
        rx_clock_bias_s=2.1e-4, max_sats=6, min_elevation_deg=15.0, seed=1))


def capture(duration_s):
    scen = scenario(duration_s)
    x = cached_capture(f"torch_position_{int(duration_s)}s",
                       lambda: scen.generate(0, scen.total_samples))
    return scen, x


def drive(rx, x):
    """Feed 1 s chunks, acquire until 4 satellites are found, run; returns
    the first tracking block's result."""
    first = []
    tracker = rx.groups[0].tracker
    process = tracker.process_device

    def record(*args):
        result = process(*args)
        if not first:
            first.append(result)
        return result

    tracker.process_device = record
    chunk, fed, acquired = int(FS), 0, False
    while fed < len(x):
        n = min(chunk, len(x) - fed)
        rx.feed(x[fed:fed + n])
        fed += n
        if not acquired:
            acquired = len(rx.acquire()) >= 4
        rx.run()
    return first[0]


def test_receiver_matches_jax_on_6s_capture():
    _, x = capture(6.0)
    jrx = JReceiver(JConfig(fs=FS, num_channels=6))
    trx = Receiver(ReceiverConfig(fs=FS, num_channels=6, device="cpu"))
    jfirst, tfirst = drive(jrx, x), drive(trx, x)

    ja, ta = jrx.status.acquired, trx.status.acquired
    assert len(ta) >= 4
    assert ja.keys() == ta.keys()
    for key, (dop, delay) in ja.items():
        assert ta[key][0] == dop, key
        assert abs(ta[key][1] - delay) <= 1.0, key
    assert ([c.phase for c in trx.tracker.ctl]
            == [c.phase for c in jrx.tracker.ctl])
    assert trx.status.subframes == jrx.status.subframes
    for k, tol in (("rem_code_phase", 1e-3), ("carrier_doppler", 0.1)):
        diff = np.abs(jfirst.outputs[k] - tfirst.outputs[k]).max()
        assert diff < tol, (k, diff)
    np.testing.assert_array_equal(jfirst.outputs["n_samples"],
                                  tfirst.outputs["n_samples"])


@pytest.mark.parametrize("kw", [{"num_devices": 2}, {"osnma": True},
                                {"positioning_mode": "PPP_Static",
                                 "earth_tide": 2, "phwindup": True},
                                {"enable_pvt_kf": True}],
                         ids=["multi_device", "osnma", "ppp", "pvt_kf"])
def test_unsupported_options_raise(kw):
    """Multiple devices raise, naming ROADMAP queue item 14. OSNMA, the
    PPP positioning modes and the PVT Kalman filter are carried (the name
    is from when they raised): both Receivers build the same engines for
    them."""
    if "num_devices" in kw:
        with pytest.raises(NotImplementedError, match="queue item 14"):
            Receiver(ReceiverConfig(device="cpu", **kw))
        return
    jrx = JReceiver(JConfig(**kw))
    trx = Receiver(ReceiverConfig(device="cpu", **kw))
    for name in ("osnma", "ppp", "pvt_kf"):
        j, t = getattr(jrx, name), getattr(trx, name)
        assert (t is None) == (j is None), name
        assert t is None or type(t).__name__ == type(j).__name__, name
    if "osnma" in kw:
        assert trx.osnma.rx.public_key is None and not trx.osnma.auth_ok
        assert not trx.osnma.rx.kroot_verified
    if "positioning_mode" in kw:
        for f in ("mode", "tide_correction", "pole_tide", "oload",
                  "phase_windup", "gps_week"):
            assert getattr(trx.ppp, f) == getattr(jrx.ppp, f), f
        assert (trx.ppp.mode, trx.ppp.tide_correction,
                trx.ppp.pole_tide) == ("static", True, True)
    if "enable_pvt_kf" in kw:
        assert vars(trx.pvt_kf).keys() == vars(jrx.pvt_kf).keys()


@pytest.fixture(scope="module")
def position_run():
    scen, x = capture(32.0)
    rx = Receiver(ReceiverConfig(fs=FS, num_channels=6, device="cpu"))
    drive(rx, x)
    return scen, rx


@pytest.mark.slow
def test_position_gates_32s(position_run):
    """tests/test_position.py's gates on the port (the card runs the same
    gates in chip_smoke.py)."""
    scen, rx = position_run
    assert len(rx.status.acquired) >= 4
    for (_, prn), (dop, _) in rx.status.acquired.items():
        if prn in scen.prns:
            assert abs(dop - scen.truth_at(prn, 0.0)["doppler_hz"]) <= 250.0
    assert rx.status.subframes >= 8
    assert len(rx.ephemerides) >= 4
    fixes = rx.status.fixes
    assert len(fixes) >= 10, f"only {len(fixes)} fixes"
    lat = np.deg2rad(scen.cfg.rx_lat_deg)
    lon = np.deg2rad(scen.cfg.rx_lon_deg)
    enu = np.array([ecef_to_enu(f.pos_ecef - scen.rx_ecef, lat, lon)
                    for f in fixes[3:]])
    err_2d = np.hypot(enu[:, 0], enu[:, 1])
    err_3d = np.linalg.norm(enu, axis=1)
    assert np.mean(err_2d) < 2.0, np.mean(err_2d)
    assert np.mean(err_3d) < 5.0, np.mean(err_3d)
    assert np.sqrt(np.mean(err_2d ** 2)) < 3.0
    speed = np.array([np.linalg.norm(f.vel_ecef) for f in fixes[3:]])
    assert np.mean(speed) < 0.5
    assert rx.status.ttff_s is not None and 10.0 < rx.status.ttff_s < 32.0
