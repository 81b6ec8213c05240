"""GLONASS L1/L2 C/A (FDMA) and the other plans of the slice through the
port, against the JAX package.

- The plans: ``glonass_l1_ca_plan``, ``glonass_l2_ca_plan``,
  ``galileo_e5b_plan``, ``qzss_l5_plan`` and ``qzss_l1_ca_plan`` equal
  JAX's field for field.
- PCPS with the slot offset table against JAX's on
  ``tests/test_glonass.py::test_fdma_acquisition_resolves_slots``'
  signal: two satellites on frequency channels k = 0 and +1 and an empty
  channel k = -7.
- The receiver's FDMA bookkeeping on a constructed case, in both
  packages: one detection per frequency channel (antipodal slots share
  code and carrier; the stronger detection wins, a twin of a tracked slot
  is skipped), the slot offset in the tracker and the observables, and
  the GNAV slot number re-keying a channel that acquired the wrong twin,
  or dropping it when the true slot is tracked already.
- 0.3 s of tests/test_glonass.py's scenario (3.6 Msps, seed 0) through
  both Receivers on the CPU: the same slots acquired at equal Doppler and
  delays within one sample, and the first three tracking blocks within
  tests/test_fused_receiver.py's ``_assert_match`` tolerances. The 28 s
  position gates run on the card (chip_smoke.py).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import cached_capture
from gnss_sdr_tpu.acquisition import AcqConfig as JAcqConfig
from gnss_sdr_tpu.acquisition import PcpsAcquisition as JPcps
from gnss_sdr_tpu.receiver import plans as jplans
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu_torch.acquisition import AcqConfig, PcpsAcquisition
from gnss_sdr_tpu_torch.codes.glonass_ca import (
    glonass_ca_code,
    glonass_ca_code_table,
    slot_freq_offsets_hz,
)
from gnss_sdr_tpu_torch.constants import glonass_l1 as GLO
from gnss_sdr_tpu_torch.pvt.ephemeris import C_LIGHT
from gnss_sdr_tpu_torch.receiver import plans as tplans
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.simulate.glonass import (
    GlonassScenario,
    GlonassScenarioConfig,
)
from gnss_sdr_tpu_torch.tracking import ChannelPhase

from torch_cases import assert_plans_equal

torch.set_num_threads(2)

FS = 3.6e6


@pytest.mark.parametrize("name,kw", [
    ("glonass_l1_ca_plan", dict(fs=FS, num_channels=6)),
    ("glonass_l2_ca_plan", dict(fs=FS, num_channels=4, pll_bw_hz=25.0)),
    ("galileo_e5b_plan", dict(fs=10.23e6, num_channels=5,
                              steps_per_block=50)),
    ("qzss_l5_plan", dict(fs=10.4e6, search_prns=(193, 195, 199))),
    ("qzss_l1_ca_plan", dict(fs=2.6e6, num_channels=3)),
])
def test_plans_match_jax(name, kw):
    a, b = getattr(jplans, name)(**kw), getattr(tplans, name)(**kw)
    assert_plans_equal(a, b)
    assert b.trk_conf.fdma == name.startswith("glonass")
    for prn in b.search_prns:
        assert b.carrier_offset_hz(prn) == a.carrier_offset_hz(prn)


def test_pcps_matches_jax_fdma():
    kw = dict(fs=FS, code_length_chips=511, code_rate_cps=GLO.CODE_RATE_CPS,
              doppler_max_hz=4000.0, doppler_step_hz=250.0, max_dwells=2,
              pfa=1e-3)
    args = (glonass_ca_code_table(), list(range(1, 25)))
    je = JPcps(JAcqConfig(**kw), *args,
               freq_offset_table=slot_freq_offsets_hz())
    te = PcpsAcquisition(AcqConfig(**kw), *args,
                         freq_offset_table=slot_freq_offsets_hz(),
                         device="cpu")
    # test_fdma_acquisition_resolves_slots' signal
    rng = np.random.default_rng(7)
    n = te.conf.input_samples
    t = np.arange(n) / FS
    code = glonass_ca_code().astype(np.float64)
    x = np.zeros(n, dtype=np.complex128)
    for slot, dop, delay_chips in ((11, 800.0, 100.25), (1, -1500.0, 400.0)):
        k_off = GLO.SLOT_TO_K[slot] * GLO.DFREQ_HZ
        chip = np.floor((t - delay_chips / GLO.CODE_RATE_CPS)
                        * GLO.CODE_RATE_CPS).astype(np.int64)
        x += (np.sqrt(10 ** 4.6 / FS) * code[chip % 511]
              * np.exp(2j * np.pi * (k_off + dop) * t))
    x += rng.normal(scale=np.sqrt(0.5), size=n) + 1j * rng.normal(
        scale=np.sqrt(0.5), size=n)
    xb = np.stack([x.astype(np.complex64)] * 3)
    rows = np.array([10, 0, 9])
    j, r = je.acquire(xb, rows), te.acquire(xb, rows)
    np.testing.assert_array_equal(j.detected, r.detected)
    assert r.detected[:2].all() and not r.detected[2]
    rel = np.abs(j.test_statistic - r.test_statistic) / j.test_statistic
    assert rel.max() < 1e-3, rel
    np.testing.assert_array_equal(j.doppler_hz[:2], r.doppler_hz[:2])
    assert np.abs(j.delay_samples[:2] - r.delay_samples[:2]).max() <= 1.0
    sps = FS / GLO.CODE_RATE_CPS
    assert abs(r.delay_samples[0] - 100.25 * sps) <= 1.5
    assert abs(r.doppler_hz[1] + 1500.0) <= 125.0


def _receivers(num_channels=6):
    """A JAX and a port Receiver of glonass_l1_ca_plan at FS (the port's
    on the CPU)."""
    rxs = []
    for rcls, ccls, plans, kw in (
            (JReceiver, JConfig, jplans, {}),
            (Receiver, ReceiverConfig, tplans, {"device": "cpu"})):
        plan = plans.glonass_l1_ca_plan(fs=FS, num_channels=num_channels)
        rxs.append(rcls(ccls(fs=FS, num_channels=num_channels, **kw),
                        plans=[plan]))
    return rxs


def _fake_acquire(stats):
    """An acquire() that detects the slots of ``stats`` (slot -> test
    statistic) at a Doppler and delay made from the slot number."""
    def acquire(x, rows):
        slots = [int(r) + 1 for r in rows]
        return SimpleNamespace(
            detected=np.array([s in stats for s in slots]),
            test_statistic=np.array([stats.get(s, 1.0) for s in slots]),
            doppler_hz=np.array([100.0 * s - 1000.0 for s in slots]),
            delay_samples=np.array([50.0 * s for s in slots]))
    return acquire


class _StubGnav:
    """A decoder that completes an ephemeris naming ``slot`` at the first
    symbols it is given."""

    def __init__(self, slot):
        self.eph = SimpleNamespace(slot=slot, week=0)

    def push_bits(self, signs, stamps):
        return [{"tow_s": 1000.0, "sample_stamp": int(stamps[0]),
                 "ephemeris_complete": True}]


def _block_result(rx, g):
    """One period of tracking outputs closing a 10-period integration on
    every channel (what _handle_block reads)."""
    c = g.plan.num_channels
    stamp = rx._dev_streams[g.plan.band].base + 36_000
    one = np.ones((1, c))
    return SimpleNamespace(
        events=[], abs_sample_end=np.full((1, c), stamp, np.int64),
        outputs={"rem_code_phase": 0.1 * one, "carrier_doppler": 10.0 * one,
                 "carrier_phase": one, "boundary": one > 0,
                 "acc_samples": np.full((1, c), 36_000, np.int32),
                 "acc_prompt": (one + 0j).astype(np.complex64)})


def test_antipodal_dedup_and_gnav_rekey():
    """Slots 9 and 13 share frequency channel k = -2, slots 1 and 5 k = +1:
    each pair starts one channel, the stronger; a later detection of 9
    beside the tracked 13 starts none. GNAV then names slot 9 on 13's
    channel (re-keyed) and slot 11 on 5's channel while 11 is tracked
    (dropped). Both packages end in the same state."""
    ends = []
    for rx in _receivers():
        g = rx.groups[0]
        rx.feed(np.zeros(2 * g.acq.conf.input_samples, np.complex64))
        g.acq.acquire = _fake_acquire({9: 30.0, 13: 40.0, 1: 20.0,
                                       5: 25.0, 11: 10.0})
        first = rx.acquire()
        g.acq.acquire = _fake_acquire({9: 50.0})
        second = rx.acquire()
        assert sorted(first) == [("R", 5), ("R", 11), ("R", 13)]
        assert second == {}
        prns = list(g.channel_prn)
        offs = np.asarray(g.tracker.state.carrier_offset)
        for ch, prn in enumerate(prns[:3]):
            k = GLO.SLOT_TO_K[prn]
            assert offs[ch] == k * 562.5e3
            ob = rx.obs.ch[g.offset + ch]
            assert ob.carrier_offset_hz == k * 562.5e3
            assert ob.wavelength_m == C_LIGHT / (GLO.FREQ_HZ + k * 562.5e3)
        for ch in range(3):
            g.tracker.ctl[ch].phase = ChannelPhase.NARROW
        g.decoders[13] = _StubGnav(9)
        g.decoders[5] = _StubGnav(11)
        rx._handle_block(g, _block_result(rx, g))
        ends.append((prns, list(g.channel_prn), sorted(g.decoders),
                     sorted(rx.ephemerides),
                     [c.phase for c in g.tracker.ctl]))
    assert ends[0] == ends[1]
    prns, after, decoders, ephs, phases = ends[1]
    ch13, ch5 = prns.index(13), prns.index(5)
    assert after[ch13] == 9 and ("R", 9) in ephs
    assert phases[ch5] == ChannelPhase.IDLE and 5 not in decoders
    assert 13 not in decoders and 9 in decoders and 11 in decoders


def _capture():
    scen = GlonassScenario(GlonassScenarioConfig(
        fs=FS, tow_start_s=7335.0, duration_s=28.0, cn0_dbhz=46.0,
        max_sats=6, seed=0))
    return cached_capture("torch_glonass_seed0_0s3",
                          lambda: scen.generate(0, int(0.3 * FS)))


def _blocks(rx, x, n):
    """Feed the capture, acquire, run ``n`` blocks; their results."""
    got = []
    tracker = rx.groups[0].tracker
    process = tracker.process_device

    def record(*args):
        result = process(*args)
        got.append(result)
        return result

    tracker.process_device = record
    rx.feed(x)
    rx.acquire()
    rx.run(max_blocks=n)
    return got


def test_receiver_matches_jax_on_glonass_capture():
    x = _capture()
    rxs = _receivers()
    jb, tb = (_blocks(rx, x, 3) for rx in rxs)
    jacq, tacq = rxs[0].status.acquired, rxs[1].status.acquired
    assert len(tacq) == 4 and jacq.keys() == tacq.keys()
    for key, (dop, delay) in jacq.items():
        assert tacq[key][0] == dop, key
        assert abs(tacq[key][1] - delay) <= 1.0, key
    assert len(jb) == len(tb) == 3
    for ja, ta in zip(jb, tb):
        a, b = ja.outputs, ta.outputs
        for k in ("n_samples", "boundary"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(ja.abs_sample_end, ta.abs_sample_end)
        assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < 0.1
        pa, pb = a["prompt"], b["prompt"]
        assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3
        assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
        assert np.abs(a["rem_code_phase"] - b["rem_code_phase"]).max() < 1e-3
    js, ts = rxs[0].groups[0].tracker, rxs[1].groups[0].tracker
    np.testing.assert_array_equal(js.pos_abs, ts.pos_abs)
    np.testing.assert_array_equal(np.asarray(js.state.carrier_offset),
                                  ts.state.carrier_offset.numpy())
