"""BeiDou B1I through the port, against the JAX package.

The D1 mode (``beidou_b1i_plan``, and B3I on the 10230-chip code) tracks
the one data component as a pilot: the data code equals the pilot code,
the NH20 secondary is wiped from both, the Costas discriminator stays on
after the secondary lock (atan2 off) and 20-period integration starts
mid-symbol, at the secondary chip of the next period.

- The port's eager engine against JAX's XLA path in the D1 mode, on two
  channels of a B1I signal (NH20 and navigation bits) started mid-symbol,
  over two blocks of 20 periods: tests/test_fused_receiver.py's
  ``_assert_match`` tolerances, the data prompts too.
- 0.5 s of tests/test_beidou.py's scenario (GPS L1 C/A and BeiDou B1I at
  2.6 Msps, seed 1, two satellites each) through both Receivers on the
  CPU: equal acquisitions, both B1I channels NH20-locked, and every
  block's outputs within tests/test_torch_glonass.py's bounds. The 35 s
  position gates run on the card (chip_smoke.py).
- K1's plain version in the D1 mode against the JAX kernel:
  tests/test_torch_last_plans.py::test_plain_matches_jax_blocked_kernel_d1.
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from conftest import cached_capture
from gnss_sdr_tpu.receiver import plans as jplans
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu.tracking import dll_pll as jdll
from gnss_sdr_tpu.tracking.conf import DllPllConf as JConf
from gnss_sdr_tpu.tracking.tracker import Tracker as JTracker
from gnss_sdr_tpu_torch.receiver import plans as tplans
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.simulate.beidou import (
    BeidouScenario,
    BeidouScenarioConfig,
)
from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig
from gnss_sdr_tpu_torch.tracking import dll_pll as tdll
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf as TConf

from torch_cases import B1I_FS, d1_signal

torch.set_num_threads(2)

def _assert_match(a, b):
    """tests/test_fused_receiver.py's _assert_match on output dicts, and
    the data prompts within the same bound as the prompts."""
    for k in ("n_samples", "pos_end", "boundary", "data_boundary",
              "data_count"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < 0.1
    for k in ("prompt", "data_prompt"):
        pa, pb = a[k], b[k]
        assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3, k
    assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
    assert np.abs(a["rem_code_phase"] - b["rem_code_phase"]).max() < 1e-3


def test_eager_matches_jax_xla_d1():
    dops, delays, sec0 = [1200.0, -2500.0], [37.0, 1311.0], [7, 13]
    plan = tplans.beidou_b1i_plan(B1I_FS, num_channels=2)
    kw = {f.name: getattr(plan.trk_conf, f.name)
          for f in dataclasses.fields(plan.trk_conf)}
    jconf = JConf(**dict(kw, pallas_correlator=False))
    tconf = TConf(**kw)
    sig = d1_signal(plan, int(B1I_FS * 0.05), dops, delays, sec0, seed=2)
    trk = JTracker(jconf, plan.code_table, plan.data_code_table,
                   plan.sec_pilot_table, plan.sec_data_levels)
    for ch in range(2):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=delays[ch],
                          acq_doppler_hz=dops[ch] + 3.0,
                          acq_samplestamp=0, current_abs_sample=0)
    on = jnp.ones(2, bool)
    idx = jnp.asarray(sec0, jnp.int32)
    sj = trk.state._replace(
        pos=jnp.asarray(trk.pos_abs.astype(np.int32)), sec_active=on,
        use_atan2=~on, narrow=on, fll_active=~on,
        integ_len=jnp.full(2, 20, jnp.int32), integ_count=idx, sec_idx=idx)
    st = tdll.state_from_numpy(
        {k: np.asarray(v) for k, v in sj._asdict().items()}, "cpu")
    tabs = (trk.codes, trk.data_codes, trk.sec_pilot, trk.sec_data)
    symbols = 0
    for _ in range(2):
        sj, oj = jdll.track_block(jconf, sj, jnp.asarray(sig),
                                  *[jnp.asarray(t) for t in tabs])
        st, ot = tdll.track_block(tconf, st, torch.as_tensor(sig),
                                  *[torch.as_tensor(t) for t in tabs])
        a = {k: np.asarray(v) for k, v in oj._asdict().items()}
        b = {k: v.numpy() for k, v in ot.items()}
        _assert_match(a, b)
        symbols += int(b["data_boundary"].sum())
    # one symbol a channel in each block of 20 periods
    assert symbols == 4
    np.testing.assert_array_equal(np.asarray(sj.sec_idx), st.sec_idx.numpy())


FS = 2.6e6


def _captures():
    common = dict(fs=FS, duration_s=35.0, rx_clock_bias_s=1.2e-4,
                  min_elevation_deg=15.0, max_sats=2)
    gps = GpsScenario(ScenarioConfig(tow_start_s=7314.0, cn0_dbhz=46.0,
                                     seed=1, **common))
    bds = BeidouScenario(BeidouScenarioConfig(tow_start_s=7314.0,
                                              cn0_dbhz=46.0, seed=1,
                                              **common))
    n = int(0.5 * FS)
    return (cached_capture("torch_gps_bds_seed1_0s5_l1",
                           lambda: gps.generate(0, n)),
            cached_capture("torch_gps_bds_seed1_0s5_b1",
                           lambda: bds.generate(0, n)),
            gps.prns, bds.prns)


def _run(rcls, ccls, plans, kw, xg, xb, gprns, bprns):
    """A Receiver of 2 GPS and 2 BeiDou channels fed the captures, acquired
    once and run to the end; its blocks' results per group."""
    rx = rcls(ccls(fs=FS, num_channels=4, **kw), plans=[
        plans.gps_l1ca_plan(fs=FS, num_channels=2, search_prns=gprns),
        plans.beidou_b1i_plan(fs=FS, num_channels=2, search_prns=bprns)])
    got = []
    for g in rx.groups:
        blocks, process = [], g.tracker.process_device

        def record(*args, _process=process, _blocks=blocks):
            result = _process(*args)
            _blocks.append(result)
            return result

        g.tracker.process_device = record
        got.append(blocks)
    rx.feed(xg, band="L1")
    rx.feed(xb, band="B1")
    rx.acquire()
    rx.run()
    return rx, got


def test_receiver_matches_jax_on_gps_bds_capture():
    xg, xb, gprns, bprns = _captures()
    args = (xg, xb, tuple(gprns), tuple(bprns))
    jrx, jb = _run(JReceiver, JConfig, jplans, {}, *args)
    trx, tb = _run(Receiver, ReceiverConfig, tplans, {"device": "cpu"},
                   *args)
    jacq, tacq = jrx.status.acquired, trx.status.acquired
    assert len(tacq) == 4 and jacq.keys() == tacq.keys()
    assert {k[0] for k in tacq} == {"G", "C"}
    for key, (dop, delay) in jacq.items():
        assert tacq[key][0] == dop, key
        assert abs(tacq[key][1] - delay) <= 1.0, key
    for jg, tg in zip(jrx.groups, trx.groups):
        assert [c.sec_locked for c in tg.tracker.ctl] == [
            c.sec_locked for c in jg.tracker.ctl]
        np.testing.assert_array_equal(jg.tracker.pos_abs, tg.tracker.pos_abs)
    assert all(c.sec_locked for c in trx.groups[1].tracker.ctl)
    for jblocks, tblocks in zip(jb, tb):
        assert len(jblocks) == len(tblocks) >= 20
        for ja, ta in zip(jblocks, tblocks):
            a, b = ja.outputs, ta.outputs
            for k in ("n_samples", "boundary", "data_boundary"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(ja.abs_sample_end,
                                          ta.abs_sample_end)
            assert np.abs(a["carrier_doppler"]
                          - b["carrier_doppler"]).max() < 0.1
            pa, pb = a["prompt"], b["prompt"]
            assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3
            assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
            assert np.abs(a["rem_code_phase"]
                          - b["rem_code_phase"]).max() < 1e-3
