"""PCPS acquisition of the port against the JAX engine, on the cases of
tests/test_acquisition.py. Both engines see the same samples. Every
channel: the same detection verdict and a test statistic within 1e-3
relative. Detected channels (where the peak is a signal, not the largest
of many near-equal noise cells): the same Doppler bin and a delay within
one sample."""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.acquisition import AcqConfig as JConf
from gnss_sdr_tpu.acquisition import PcpsAcquisition as JPcps
from gnss_sdr_tpu.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu.constants import gps_l1_ca as G
from gnss_sdr_tpu.simulate import SatelliteSignalParams, generate_baseband
from gnss_sdr_tpu_torch.acquisition import AcqConfig as TConf
from gnss_sdr_tpu_torch.acquisition import PcpsAcquisition as TPcps

torch.set_num_threads(2)

FS = 2.046e6


def _engines(**overrides):
    kw = dict(fs=FS, code_length_chips=G.CODE_LENGTH_CHIPS,
              code_rate_cps=G.CODE_RATE_CPS, doppler_max_hz=5000.0,
              doppler_step_hz=250.0, max_dwells=2, pfa=1e-3)
    kw.update(overrides)
    tbl, prns = gps_l1_ca_code_table(), list(range(1, 33))
    return (JPcps(JConf(**kw), tbl, prns),
            TPcps(TConf(**kw), tbl, prns, device="cpu"))


def _compare(j, t):
    np.testing.assert_array_equal(j.detected, t.detected)
    rel = np.abs(j.test_statistic - t.test_statistic) / j.test_statistic
    assert rel.max() < 1e-3, rel
    d = j.detected
    np.testing.assert_array_equal(j.doppler_hz[d], t.doppler_hz[d])
    assert np.abs(j.delay_samples[d] - t.delay_samples[d]).max(
        initial=0.0) <= 1.0
    assert j.threshold == pytest.approx(t.threshold, rel=1e-12)


def _case(name):
    if name == "known_signal":
        je, te = _engines()
        sats = [SatelliteSignalParams(prn=7, cn0_dbhz=46.0, doppler_hz=1000.0,
                                      delay_chips=300.25),
                SatelliteSignalParams(prn=12, cn0_dbhz=46.0,
                                      doppler_hz=-2750.0, delay_chips=911.0)]
        x = generate_baseband(sats, FS, je.conf.input_samples, seed=1)
        return je, te, np.stack([x, x, x]), np.array([6, 11, 19])
    if name == "two_step":
        je, te = _engines(make_two_steps=True, doppler_step2_hz=31.25,
                          num_doppler_bins_step2=4,
                          coherent_integration_periods=4, max_dwells=1)
        sats = [SatelliteSignalParams(prn=3, cn0_dbhz=48.0, doppler_hz=1130.0,
                                      delay_chips=512.5)]
        x = generate_baseband(sats, FS, je.conf.input_samples, seed=2)
        return je, te, x[None, :], np.array([2])
    if name == "noise_only":
        je, te = _engines(pfa=1e-3, max_dwells=1)
        rng = np.random.default_rng(3)
        n = 16
        shape = (n, je.conf.input_samples)
        x = ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
             * np.sqrt(0.5)).astype(np.complex64)
        return je, te, x, np.arange(n)
    je, te = _engines(bit_transition_flag=True, max_dwells=1)
    bits = np.array([1, -1, 1, -1, 1, -1], dtype=np.float64)
    sats = [SatelliteSignalParams(prn=5, cn0_dbhz=48.0, doppler_hz=500.0,
                                  delay_chips=100.0, nav_bits=bits)]
    x = generate_baseband(sats, FS, je.conf.input_samples, seed=4)
    return je, te, x[None, :], np.array([4])


@pytest.mark.parametrize("name", ["known_signal", "two_step", "noise_only",
                                  "bit_transition"])
def test_pcps_matches_jax(name):
    je, te, x, rows = _case(name)
    j, t = je.acquire(x, rows), te.acquire(x, rows)
    _compare(j, t)
    if name == "noise_only":
        assert not t.detected.any()
    else:
        assert t.detected[0]


def test_peak_ratio_statistic_matches_jax():
    _, _, x, rows = _case("known_signal")
    je, te = _engines(statistic="peak1_peak2")
    _compare(je.acquire(x, rows), te.acquire(x, rows))


def test_fdma_offsets_raise():
    """A per-row frequency-offset table (it raised before the port carried
    it): row p searches offset[p] + the Doppler grid, and the reported
    Doppler excludes the offset. Against the JAX engine on a signal whose
    carrier sits at its row's offset plus 1000 Hz, with the coarse grid,
    the two-step zoom and the peak ratio statistic; then the table
    rewritten in place (``set_offsets``) for a second search."""
    offsets = np.zeros(32)
    offsets[6], offsets[11] = 1500.0, -2250.0
    sats = [SatelliteSignalParams(prn=7, cn0_dbhz=46.0, doppler_hz=2500.0,
                                  delay_chips=300.25),
            SatelliteSignalParams(prn=12, cn0_dbhz=46.0, doppler_hz=-3250.0,
                                  delay_chips=911.0)]
    rows = np.array([6, 11, 19])
    for kw in ({}, dict(make_two_steps=True, doppler_step2_hz=31.25,
                        num_doppler_bins_step2=4),
               dict(statistic="peak1_peak2")):
        kw = dict(dict(fs=FS, code_length_chips=G.CODE_LENGTH_CHIPS,
                       code_rate_cps=G.CODE_RATE_CPS, doppler_max_hz=2000.0,
                       doppler_step_hz=250.0, max_dwells=2, pfa=1e-3), **kw)
        tbl, prns = gps_l1_ca_code_table(), list(range(1, 33))
        je = JPcps(JConf(**kw), tbl, prns, freq_offset_table=offsets)
        te = TPcps(TConf(**kw), tbl, prns, freq_offset_table=offsets,
                   device="cpu")
        x = generate_baseband(sats, FS, je.conf.input_samples, seed=1)
        xb = np.stack([x, x, x])
        j, t = je.acquire(xb, rows), te.acquire(xb, rows)
        _compare(j, t)
        assert t.detected[:2].all() and not t.detected[2], kw
        assert abs(t.doppler_hz[0] - 1000.0) <= 250.0
        assert abs(t.doppler_hz[1] + 1000.0) <= 250.0
    # the table rewritten in place: PRN 7's row now searches -2500 Hz +
    # the grid, 3 kHz away from its 2500 Hz carrier
    before = te._offsets
    moved = offsets.copy()
    moved[6] = -2500.0
    te.set_offsets(moved)
    assert te._offsets is before
    assert not te.acquire(xb[:1], rows[:1]).detected[0]