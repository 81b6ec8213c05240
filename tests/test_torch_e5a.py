"""Galileo E5a through both Receivers: a short capture of
tests/test_dual_band.py's E5a scenario (seed 4, 10.4 Msps, cut to 3
satellites and 0.3 s; two of them acquire in that window) with
``galileo_e5a_plan`` on the CPU, which runs K1's plain version at the
long-code shape (10230-chip pilot and data tables, about 10400 samples a
period, T = 3 with the data prompt).

Both packages acquire the same satellites with equal Doppler and delays
within one sample, and agree on each of the first three tracking blocks
within tests/test_fused_receiver.py's ``_assert_match`` tolerances, as
tests/test_torch_galileo.py holds E1-B: period lengths, end stamps and
boundaries equal; Doppler within 0.1 Hz, prompt median relative
difference below 5e-3, carrier phase and code phase within 1e-3. The
20 s gates (CS100 lock, F/NAV pages, the assisted fix) run on the card
(chip_smoke.py).
"""

import numpy as np
import torch

from conftest import cached_capture
from gnss_sdr_tpu.receiver import plans as jplans
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu_torch.receiver import plans as tplans
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.simulate.galileo import (
    GalileoScenario,
    GalileoScenarioConfig,
)
from gnss_sdr_tpu_torch.simulate.multiband import GalileoE5aBand

torch.set_num_threads(2)

FS = 10.4e6


def capture():
    scen = GalileoScenario(GalileoScenarioConfig(
        fs=2.6e6, tow_start_s=7312.0, duration_s=1.0, cn0_dbhz=47.0,
        rx_clock_bias_s=0.9e-4, max_sats=3, min_elevation_deg=15.0, seed=4))
    e5a = GalileoE5aBand(scen, fs=FS, cn0_dbhz=47.0)
    return scen, cached_capture("torch_e5a_3sats_0s3",
                                lambda: e5a.generate(0, int(0.3 * FS)))


def blocks(rx, x, n):
    """Feed the capture on L5, acquire, run ``n`` blocks; their results."""
    got = []
    tracker = rx.groups[0].tracker
    process = tracker.process_device

    def record(*args):
        result = process(*args)
        got.append(result)
        return result

    tracker.process_device = record
    rx.feed(x, band="L5")
    rx.acquire()
    rx.run(max_blocks=n)
    return got


def test_receiver_matches_jax_on_e5a_capture():
    scen, x = capture()
    prns = tuple(scen.prns)
    rxs = []
    for rcls, ccls, plans, kw in (
            (JReceiver, JConfig, jplans, {}),
            (Receiver, ReceiverConfig, tplans, {"device": "cpu"})):
        plan = plans.galileo_e5a_plan(fs=FS, num_channels=3,
                                      search_prns=prns)
        rxs.append(rcls(ccls(fs=FS, num_channels=3, **kw), plans=[plan]))
    jb, tb = (blocks(rx, x, 3) for rx in rxs)
    jacq, tacq = rxs[0].status.acquired, rxs[1].status.acquired
    assert len(tacq) == 2 and jacq.keys() == tacq.keys()
    for key, (dop, delay) in jacq.items():
        assert tacq[key][0] == dop, key
        assert abs(tacq[key][1] - delay) <= 1.0, key
    assert len(jb) == len(tb) == 3
    for ja, ta in zip(jb, tb):
        a, b = ja.outputs, ta.outputs
        for k in ("n_samples", "boundary", "data_boundary", "data_count"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(ja.abs_sample_end, ta.abs_sample_end)
        assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < 0.1
        for k in ("prompt", "data_prompt"):
            pa, pb = a[k], b[k]
            assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3
        assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
        assert np.abs(a["rem_code_phase"] - b["rem_code_phase"]).max() < 1e-3
    # the pilot engine: three taps on the pilot, the prompt in the middle
    assert b["taps"].shape[-1] == 3
    np.testing.assert_array_equal(b["taps"][..., 1], b["prompt"])
    js, ts = rxs[0].groups[0].tracker, rxs[1].groups[0].tracker
    np.testing.assert_array_equal(js.pos_abs, ts.pos_abs)
    assert np.abs(np.asarray(js.state.carrier_doppler)
                  - ts.state.carrier_doppler.numpy()).max() < 0.1
