"""The port's fused engine against the JAX eager engine, in the Tracker.

``gnss_sdr_tpu_torch`` ``Tracker(fused_tracker=True)`` runs K1's plain
version on the CPU; ``gnss_sdr_tpu`` ``Tracker(fused_tracker=False)`` runs
the XLA scan. This is the comparison the JAX suite makes between its own
two engines (tests/test_fused_receiver.py), on its WIDE, FLL pull-in and
extended-integration setups, with its tolerances.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu.tracking.conf import DllPllConf as JConf
from gnss_sdr_tpu.tracking.tracker import Tracker as JTracker
from gnss_sdr_tpu_torch.tracking import dll_pll as tdll
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf as TConf
from gnss_sdr_tpu_torch.tracking.tracker import Tracker as TTracker

from torch_cases import C, DOPS, conf_kw, make_signal

torch.set_num_threads(2)


def assert_match(a, b, prompt_tol=5e-3, dop_tol=0.1):
    """tests/test_fused_receiver.py's _assert_match on BlockResults."""
    for k in ("n_samples", "pos_end", "boundary"):
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k])
    assert np.abs(a.outputs["carrier_doppler"]
                  - b.outputs["carrier_doppler"]).max() < dop_tol
    pa, pb = a.outputs["prompt"], b.outputs["prompt"]
    assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < prompt_tol
    assert np.abs(a.outputs["carrier_phase"]
                  - b.outputs["carrier_phase"]).max() < 1e-3
    assert np.abs(a.outputs["rem_code_phase"]
                  - b.outputs["rem_code_phase"]).max() < 1e-3


def start(trk):
    for ch in range(C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=0.0,
                          acq_doppler_hz=DOPS[ch] + 30.0,
                          acq_samplestamp=0, current_abs_sample=0)


def run_pair(blocks, n, engage_jax=None, engage_port=None, **kw):
    tbl = gps_l1_ca_code_table()[:C].astype(np.float32)
    sig = make_signal(tbl, n)
    jt = JTracker(JConf(**conf_kw(pallas_correlator=False,
                                  fused_tracker=False, **kw)), tbl)
    tt = TTracker(TConf(**conf_kw(fused_tracker=True, **kw)), tbl,
                  device="cpu")
    assert tt._block.fused
    start(jt)
    start(tt)
    if engage_jax is not None:
        engage_jax(jt)
        engage_port(tt)
    rj = [jt.process(sig, 0) for _ in range(blocks)]
    rt = [tt.process(sig, 0) for _ in range(blocks)]
    return rj, rt, jt, tt


def test_fused_matches_jax_wide():
    rj, rt, _, _ = run_pair(2, 200_000)
    for a, b in zip(rj, rt):
        assert_match(a, b)


def test_fused_matches_jax_fll_pull_in():
    rj, rt, jt, tt = run_pair(2, 200_000, enable_fll_pull_in=True)
    assert bool(np.asarray(jt.state.fll_active).all())
    assert bool(tt.state.fll_active.all())
    for a, b in zip(rj, rt):
        assert_match(a, b)


def test_fused_matches_jax_extended():
    def engage_jax(trk):
        s = trk.state
        trk.state = s._replace(narrow=s.narrow.at[:].set(True),
                               integ_len=s.integ_len.at[:].set(20))

    def engage_port(trk):
        trk.state.narrow[:] = True
        trk.state.integ_len[:] = 20

    rj, rt, _, _ = run_pair(3, 300_000, engage_jax, engage_port,
                            extend_correlation_symbols=20)
    a, b = rj[2], rt[2]
    assert_match(a, b)
    np.testing.assert_array_equal(a.outputs["acc_samples"],
                                  b.outputs["acc_samples"])
    ba = a.outputs["boundary"]
    assert ba.sum() > 0
    pa, pb = a.outputs["acc_prompt"][ba], b.outputs["acc_prompt"][ba]
    assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3


def test_fused_disabled_channels_hold_state():
    """A channel never started keeps its state through a fused block."""
    tbl = gps_l1_ca_code_table()[:C].astype(np.float32)
    trk = TTracker(TConf(**conf_kw(fused_tracker=True)), tbl, device="cpu")
    trk.start_channel(0, prn=1, code_row=0, acq_delay_samples=0.0,
                      acq_doppler_hz=DOPS[0], acq_samplestamp=0,
                      current_abs_sample=0)
    before = tdll.state_to_numpy(trk.state)
    trk.process(make_signal(tbl, 200_000), 0)
    after = tdll.state_to_numpy(trk.state)
    for name in ("pos", "rem_code_phase", "code_freq", "carrier_phase",
                 "carrier_doppler", "integ_count", "acc_samples", "sec_idx"):
        assert after[name][1] == pytest.approx(before[name][1]), name
    assert after["pos"][0] > 0


def test_output_dtypes_match_jax():
    tbl = gps_l1_ca_code_table()[:C].astype(np.float32)
    sig = make_signal(tbl, 200_000)
    jt = JTracker(JConf(**conf_kw(pallas_correlator=False)), tbl)
    start(jt)
    rj = jt.process(sig, 0)
    for fused in (True, False):
        tt = TTracker(TConf(**conf_kw(fused_tracker=fused)), tbl,
                      device="cpu")
        start(tt)
        rt = tt.process(sig, 0)
        assert rt.outputs.keys() == rj.outputs.keys()
        for k, v in rj.outputs.items():
            got = rt.outputs[k].dtype
            # the port keeps tracker.py's int32 leaves; the JAX host
            # unpacker widens them to int64
            assert got == v.dtype or (got == np.int32
                                      and v.dtype == np.int64), k
            assert rt.outputs[k].shape == v.shape, k
        assert rt.abs_sample_end.dtype == rj.abs_sample_end.dtype
