"""The port's acquisition engine variants and ROC harness against the JAX
package's, on the cases of ``tests/test_acq_engines.py`` and
``tests/test_roc.py``.

Fine-Doppler, Tong, QuickSync, CCCWSR and noncoherent I/Q see the same
samples (the copied baseband generator, the same seeds) in both packages:
the detection flags, delays and Dopplers must be equal and the test
statistics within 1e-4 relative; the JAX tests' gates hold for the port's
results too. The ROC sweep runs on the JAX test's seeds with fewer trials
and must count the same detections.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu import acquisition as jacq
from gnss_sdr_tpu.acquisition.roc import measure_roc as j_measure_roc
from gnss_sdr_tpu_torch import acquisition as tacq
from gnss_sdr_tpu_torch.acquisition.roc import measure_roc as t_measure_roc
from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1b_code
from gnss_sdr_tpu_torch.codes.galileo_e5a import (
    galileo_e5ai_code,
    galileo_e5aq_code,
)
from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu_torch.constants import galileo_e1 as GAL
from gnss_sdr_tpu_torch.constants import galileo_e5a as E5A
from gnss_sdr_tpu_torch.constants import gps_l1_ca as G
from gnss_sdr_tpu_torch.simulate import SatelliteSignalParams, generate_baseband

from torch_cases import e1b_cboc_baseband

torch.set_num_threads(2)

FS = 2.046e6
PRNS = list(range(1, 33))


def _conf(pkg, **overrides):
    kw = dict(fs=FS, code_length_chips=G.CODE_LENGTH_CHIPS,
              code_rate_cps=G.CODE_RATE_CPS, doppler_max_hz=5000.0,
              doppler_step_hz=250.0, max_dwells=1, pfa=1e-3)
    kw.update(overrides)
    return pkg.AcqConfig(**kw)


def both(make, x, rows):
    """(JAX result, port result) of one engine built by ``make(pkg,
    **device)`` on the same inputs."""
    rj = make(jacq).acquire(x, rows)
    rt = make(tacq, device="cpu").acquire(x, rows)
    np.testing.assert_array_equal(rt.detected, rj.detected)
    np.testing.assert_array_equal(rt.delay_samples, rj.delay_samples)
    np.testing.assert_array_equal(rt.doppler_hz, rj.doppler_hz)
    np.testing.assert_allclose(rt.test_statistic, rj.test_statistic,
                               rtol=1e-4)
    assert rt.threshold == rj.threshold
    return rt


def test_fine_doppler_matches_jax():
    kw = dict(doppler_step_hz=500.0, coherent_integration_periods=4,
              num_doppler_bins_step2=4)
    true_dop = 1337.0  # far off the 500 Hz coarse grid
    sats = [SatelliteSignalParams(prn=9, cn0_dbhz=48.0, doppler_hz=true_dop,
                                  delay_chips=222.5)]
    n = _conf(tacq, **kw).input_samples
    x = generate_baseband(sats, FS, n, seed=11)
    res = both(lambda pkg, **d: pkg.FineDopplerAcquisition(
        _conf(pkg, **kw), gps_l1_ca_code_table(), PRNS, iterations=4, **d),
        x[None, :], np.array([8]))
    assert res.detected[0]
    assert abs(res.doppler_hz[0] - true_dop) <= 500.0 / 2**4
    assert abs(res.delay_samples[0] - 222.5 * FS / G.CODE_RATE_CPS) <= 1.0


def test_tong_matches_jax():
    def make(pkg, **d):
        return pkg.TongAcquisition(_conf(pkg), gps_l1_ca_code_table(), PRNS,
                                   tong_init=1, tong_max=3, max_attempts=10,
                                   **d)

    win = make(tacq, device="cpu").inner.conf.input_samples
    sats = [SatelliteSignalParams(prn=4, cn0_dbhz=46.0, doppler_hz=-800.0,
                                  delay_chips=500.0)]
    x_sig = generate_baseband(sats, FS, win * 10, seed=12)
    rng = np.random.default_rng(13)
    x_noise = (rng.normal(size=win * 10) + 1j * rng.normal(size=win * 10)
               ).astype(np.complex64) * np.sqrt(0.5)
    res = both(make, np.stack([x_sig, x_noise]), np.array([3, 3]))
    assert res.detected[0] and not res.detected[1]
    assert abs(res.doppler_hz[0] + 800.0) <= 125.0
    assert abs(res.delay_samples[0] - 500.0 * FS / G.CODE_RATE_CPS) <= 1.0


@pytest.mark.parametrize("case", ["signal", "noise"])
def test_quicksync_matches_jax(case):
    """The unfolded lag in the second half of the code (the JAX test's
    folding case), and four channels of noise."""
    def make(pkg, **d):
        return pkg.QuickSyncAcquisition(_conf(pkg), gps_l1_ca_code_table(),
                                        PRNS, folding_factor=2, **d)

    win = make(tacq, device="cpu").win
    if case == "signal":
        sats = [SatelliteSignalParams(prn=17, cn0_dbhz=50.0,
                                      doppler_hz=1500.0, delay_chips=700.0)]
        x = generate_baseband(sats, FS, win, seed=14)[None, :]
        rows = np.array([16])
    else:
        rng = np.random.default_rng(15)
        x = (rng.normal(size=(4, win)) + 1j * rng.normal(size=(4, win))
             ).astype(np.complex64) * np.sqrt(0.5)
        rows = np.arange(4, dtype=np.int32)
    res = both(make, x, rows)
    if case == "signal":
        got_chips = res.delay_samples[0] * G.CODE_RATE_CPS / FS
        assert res.detected[0] and abs(got_chips - 700.0) <= 1.0
    else:
        assert not res.detected.any()


def test_cccwsr_matches_jax():
    fs = 4.092e6
    prns = list(range(1, 11))
    chips = np.stack([galileo_e1b_code(p) for p in prns])

    def make(pkg, **d):
        conf = pkg.AcqConfig(fs=fs, code_length_chips=GAL.CODE_LENGTH_CHIPS,
                             code_rate_cps=GAL.CODE_RATE_CPS,
                             doppler_max_hz=4000.0, doppler_step_hz=125.0,
                             pfa=1e-3)
        return pkg.CccwsrAcquisition(conf, chips, prns, **d)

    x = e1b_cboc_baseband(5, fs, make(tacq, device="cpu").win, 48.0, 750.0,
                          1000.25, seed=16)
    res = both(make, np.stack([x, x]), np.array([4, 7]))
    assert res.detected[0] and not res.detected[1]
    assert abs(res.doppler_hz[0] - 750.0) <= 125.0
    assert abs(res.delay_samples[0] - 1000.25 * fs / GAL.CODE_RATE_CPS) <= 2.0


def test_noncoherent_iq_matches_jax():
    fs = 12.0e6
    prns = list(range(1, 9))
    data = np.stack([galileo_e5ai_code(p) for p in prns]).astype(np.float32)
    pilot = np.stack([galileo_e5aq_code(p) for p in prns]).astype(np.float32)

    def make(pkg, **d):
        conf = pkg.AcqConfig(fs=fs, code_length_chips=E5A.CODE_LENGTH_CHIPS,
                             code_rate_cps=E5A.CODE_RATE_CPS,
                             doppler_max_hz=3000.0, doppler_step_hz=250.0,
                             pfa=1e-3)
        return pkg.NoncoherentIQAcquisition(conf, data, pilot, prns, **d)

    sats = [SatelliteSignalParams(prn=4, system="E", signal="5X",
                                  cn0_dbhz=49.0, doppler_hz=-1200.0,
                                  delay_chips=4000.5)]
    x = generate_baseband(sats, fs, make(tacq, device="cpu").win, seed=21)
    res = both(make, np.stack([x, x]), np.array([3, 6]))
    assert res.detected[0] and not res.detected[1]
    assert abs(res.doppler_hz[0] + 1200.0) <= 250.0
    assert abs(res.delay_samples[0] - 4000.5 * fs / E5A.CODE_RATE_CPS) <= 2.0


@pytest.mark.parametrize("statistic", ["max_to_input_power", "peak1_peak2"])
def test_roc_matches_jax(statistic):
    """tests/test_roc.py's sweep at 4 of its 16 trials per C/N0 and 16 of
    its 64 noise trials: the same false alarms and detections, and the
    same errors of the detected cells."""
    def conf(pkg):
        return pkg.AcqConfig(fs=2.6e6, code_length_chips=1023,
                             code_rate_cps=1.023e6, doppler_max_hz=5000.0,
                             doppler_step_hz=250.0, max_dwells=1, pfa=0.03,
                             statistic=statistic)

    kw = dict(cn0_list=(35.0, 41.0, 47.0), trials=4, pfa_trials=16)
    rj = j_measure_roc(conf(jacq), gps_l1_ca_code_table(), **kw)
    rt = t_measure_roc(conf(tacq), gps_l1_ca_code_table(), device="cpu",
                       **kw)
    assert rt["threshold"] == rj["threshold"]
    assert rt["measured_pfa"] == rj["measured_pfa"]
    assert rt["pd_curve"] == rj["pd_curve"]
    assert rt["pd_curve"][2]["pd"] == 1.0
