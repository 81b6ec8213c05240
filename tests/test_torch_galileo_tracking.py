"""Pilot/secondary tracking in the port's engines and host FSM against the
JAX package's.

The setup is tests/test_fused_receiver.py's pilot case: two channels of a
composite pilot + data signal (GPS-shaped codes at 2.6 Msps, pilot
secondary of 25 chips, data secondary of 4), one block to settle, the
secondary engaged at its known phase, then the blocks compared. Engines:
the port's eager engine (K3's plain version) against the JAX XLA scan, and
the port's fused engine (K1's plain version) against the JAX fused engine
(its blocked kernel in interpret mode), each pair from the same state and
held to that file's ``_assert_match`` tolerances, with the data-symbol
boundaries, counts and secondary counters equal. The secondary sync: one
prompt-sign sequence through both trackers' FSMs gives the same shift,
polarity, start period and device state after the engage.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.tracking import dll_pll as jdll
from gnss_sdr_tpu.tracking.conf import DllPllConf as JConf
from gnss_sdr_tpu.tracking.tracker import Tracker as JTracker
from gnss_sdr_tpu_torch.tracking import dll_pll as tdll
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf as TConf
from gnss_sdr_tpu_torch.tracking.tracker import ChannelControl, ChannelPhase
from gnss_sdr_tpu_torch.tracking.tracker import Tracker as TTracker

from torch_cases import (
    C,
    DOPS,
    SD,
    SP,
    conf_kw,
    pilot_signal,
    pilot_tables,
)

torch.set_num_threads(2)

PILOT_KW = dict(track_pilot=True, sec_len_pilot=SP, sec_len_data=SD,
                extend_correlation_symbols=5)


def assert_match(a, b, prompt_tol=5e-3, dop_tol=0.1):
    """tests/test_fused_receiver.py's _assert_match on output dicts, plus
    its pilot case's data-symbol checks."""
    for k in ("n_samples", "pos_end", "boundary", "data_boundary",
              "data_count"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < dop_tol
    pa, pb = a["prompt"], b["prompt"]
    assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < prompt_tol
    assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
    assert np.abs(a["rem_code_phase"] - b["rem_code_phase"]).max() < 1e-3
    db = a["data_boundary"]
    assert db.sum() > 0
    da, dd = a["data_prompt"][db], b["data_prompt"][db]
    assert np.median(np.abs(da - dd) / (np.abs(da) + 1e-9)) < prompt_tol


def trackers(fused, steps):
    """Started JAX and port trackers of one pilot conf."""
    tbl, dtbl, sec_p, sec_d = pilot_tables()
    kw = dict(PILOT_KW, steps_per_block=steps)
    jt = JTracker(JConf(**dict(conf_kw(pallas_correlator=False,
                                       fused_tracker=fused), **kw)),
                  tbl, data_code_table=dtbl, sec_pilot_table=sec_p,
                  sec_data_levels=sec_d)
    tt = TTracker(TConf(**dict(conf_kw(fused_tracker=fused), **kw)), tbl,
                  dtbl, sec_p, sec_d, device="cpu")
    assert tt._block.fused == fused
    for trk in (jt, tt):
        for ch in range(C):
            trk.start_channel(ch, prn=ch + 1, code_row=ch,
                              acq_delay_samples=0.0,
                              acq_doppler_hz=DOPS[ch] + 30.0,
                              acq_samplestamp=0, current_abs_sample=0)
    return jt, tt


def engaged_state(jt, sig):
    """The JAX tracker's state after one settling block and the secondary
    engaged at its known phase (tests/test_fused_receiver.py)."""
    jt.process(sig, 0)
    for ch in range(C):
        jt._engage_secondary(ch, p0=0, k0=0, polarity=1.0)
    return jt


def test_eager_pilot_matches_jax_xla_scan():
    """The port's eager engine with the pilot, from the JAX tracker's
    engaged state, against JAX dll_pll's XLA scan over two blocks."""
    sig = pilot_signal(200_000)
    jt, _ = trackers(False, 20)
    jt = engaged_state(jt, sig)
    conf = TConf(**dict(conf_kw(), **PILOT_KW, steps_per_block=20))
    jconf = jt.conf
    sj = jt.state._replace(pos=jnp.asarray(
        jt.pos_abs.astype(np.int32)))
    st = tdll.state_from_numpy(
        {k: np.asarray(v) for k, v in sj._asdict().items()}, "cpu")
    jtabs = [jnp.asarray(t) for t in (jt.codes, jt.data_codes,
                                      jt.sec_pilot, jt.sec_data)]
    ttabs = [torch.as_tensor(t) for t in (jt.codes, jt.data_codes,
                                          jt.sec_pilot, jt.sec_data)]
    w_j, w_t = jnp.asarray(sig), torch.as_tensor(sig)
    for _ in range(2):
        sj, oj = jdll.track_block(jconf, sj, w_j, *jtabs)
        st, ot = tdll.track_block(conf, st, w_t, *ttabs)
        assert_match({k: np.asarray(v) for k, v in oj._asdict().items()},
                     {k: v.numpy() for k, v in ot.items()})
    np.testing.assert_array_equal(np.asarray(sj.sec_idx), st.sec_idx.numpy())
    assert bool(st.sec_active.all()) and bool(st.use_atan2.all())


def test_fused_pilot_matches_jax_fused():
    """The port's fused engine (K1's plain version) against the JAX fused
    engine (its blocked kernel, interpret mode), each in its Tracker from
    the same engaged state: one settling block in JAX, the state and
    tables handed over, two blocks in both."""
    sig = pilot_signal(200_000)
    jt, tt = trackers(True, 10)
    jt = engaged_state(jt, sig)
    tt.state = tdll.state_from_numpy(
        {k: np.asarray(v) for k, v in jt.state._asdict().items()}, "cpu")
    tt.pos_abs = jt.pos_abs.copy()
    tt.ctl = [ChannelControl(**{
        f: getattr(c, f) for f in ChannelControl.__dataclass_fields__})
        for c in jt.ctl]
    for name in ("codes", "data_codes", "sec_pilot", "sec_data"):
        setattr(tt, name, getattr(jt, name).copy())
    tt._codes_dev = None
    for _ in range(2):
        a, b = jt.process(sig, 0), tt.process(sig, 0)
        assert_match(a.outputs, b.outputs)
    np.testing.assert_array_equal(np.asarray(jt.state.sec_idx),
                                  tt.state.sec_idx.numpy())


@pytest.mark.parametrize("shift,polarity", [(0, 1.0), (7, -1.0)],
                         ids=["aligned", "shifted_inverted"])
def test_secondary_sync_matches_jax(shift, polarity):
    """The same per-period prompt signs (the pilot secondary from chip
    ``shift``, times ``polarity``) through both FSMs: the same block
    engages, with the same shift, polarity and start period, and the same
    device state and wipe tables after it."""
    steps = 100
    jt, tt = trackers(False, steps)
    sec = jt.sec_pilot[0].astype(np.float64)
    for blk in range(12):
        per = np.arange(blk * steps, (blk + 1) * steps)
        signs = polarity * sec[(per + shift) % SP]
        host = {
            "prompt": np.repeat(signs[:, None], C, 1).astype(np.complex64),
            "boundary": np.zeros((steps, C), bool),
            "acc_prompt": np.zeros((steps, C), np.complex64),
            "acc_samples": np.zeros((steps, C), np.int32),
        }
        ev_j = jt._update_channel_control(0, host)
        ev_t = tt._update_channel_control(0, host)
        assert ev_j == ev_t
        if "secondary_sync" in ev_t:
            break
    assert ev_t == ["secondary_sync"]
    cj, ct = jt.ctl[0], tt.ctl[0]
    assert ct.phase == ChannelPhase.NARROW and ct.sec_locked
    for f in ("sec_locked", "sec_hist", "sec_hist_start", "total_periods",
              "warmup_until_period"):
        assert getattr(ct, f) == getattr(cj, f), f
    np.testing.assert_array_equal(tt.sec_pilot, jt.sec_pilot)
    np.testing.assert_array_equal(tt.sec_data, jt.sec_data)
    end_j = {k: np.asarray(v) for k, v in jt.state._asdict().items()}
    end_t = tdll.state_to_numpy(tt.state)
    for k in ("sec_idx", "sec_active", "use_atan2", "narrow", "fll_active",
              "pll_state", "integ_len", "integ_count", "acc_taps",
              "acc_samples", "acc_data", "acc_data_count"):
        np.testing.assert_array_equal(end_t[k], end_j[k].astype(
            end_t[k].dtype), err_msg=k)
