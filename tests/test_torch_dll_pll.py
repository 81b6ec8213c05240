"""The port's eager tracking engine against the JAX one.

``gnss_sdr_tpu_torch.tracking.dll_pll.track_block`` (correlations through
the plain K3 on the CPU) and ``gnss_sdr_tpu.tracking.dll_pll.track_block``
(the XLA path, ``pallas_correlator=False``) run the same signal from the
same state, on the setups of ``tests/test_fused_receiver.py``: WIDE, FLL
pull-in and extended integration. The period lengths, end positions and
boundaries must be equal; the rest is held to that file's
``_assert_match`` tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu.tracking import dll_pll as jdll
from gnss_sdr_tpu.tracking.conf import DllPllConf as JConf
from gnss_sdr_tpu.tracking.tracker import Tracker as JTracker
from gnss_sdr_tpu_torch.tracking import dll_pll as tdll
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf as TConf

from torch_cases import (
    C,
    DOPS,
    SD,
    SP,
    conf_kw,
    make_signal,
    pilot_signal,
    pilot_tables,
)

torch.set_num_threads(2)


def started_jax_tracker(conf):
    tbl = gps_l1_ca_code_table()[:C].astype(np.float32)
    trk = JTracker(conf, tbl)
    for ch in range(C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=0.0,
                          acq_doppler_hz=DOPS[ch] + 30.0,
                          acq_samplestamp=0, current_abs_sample=0)
    return trk


def to_numpy(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def assert_match(a, b, prompt_tol=5e-3, dop_tol=0.1):
    """tests/test_fused_receiver.py's _assert_match on output dicts."""
    for k in ("n_samples", "pos_end", "boundary"):
        np.testing.assert_array_equal(a[k], b[k])
    assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < dop_tol
    pa, pb = a["prompt"], b["prompt"]
    assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < prompt_tol
    assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
    assert np.abs(a["rem_code_phase"] - b["rem_code_phase"]).max() < 1e-3


def run_both(kw, blocks, engage=None, handover=False):
    """Chained blocks in both packages from the same start; with
    ``handover`` the port's first block starts from the JAX state after
    block 1 instead of running block 1 itself."""
    jconf = JConf(**conf_kw(pallas_correlator=False, **kw))
    tconf = TConf(**conf_kw(**kw))
    trk = started_jax_tracker(jconf)
    tbl = trk.codes
    sig = make_signal(gps_l1_ca_code_table()[:C], 300_000)
    st0 = trk.state._replace(pos=jnp.asarray(trk.pos_abs.astype(np.int32)))
    if engage is not None:
        st0 = engage(st0)
    window_j, codes_j = jnp.asarray(sig), jnp.asarray(tbl)
    window_t, codes_t = torch.as_tensor(sig), torch.as_tensor(tbl)

    outs_j, sj = [], st0
    for _ in range(blocks):
        sj, o = jdll.track_block(jconf, sj, window_j, codes_j)
        outs_j.append({k: np.asarray(v) for k, v in o._asdict().items()})
        if handover and len(outs_j) == 1:
            st_t = tdll.state_from_numpy(to_numpy(sj), "cpu")
    outs_t = [None] if handover else []
    if not handover:
        st_t = tdll.state_from_numpy(to_numpy(st0), "cpu")
    while len(outs_t) < blocks:
        st_t, o = tdll.track_block(tconf, st_t, window_t, codes_t)
        outs_t.append({k: v.numpy() for k, v in o.items()})
    return outs_j, outs_t, sj, st_t


def test_wide():
    """WIDE phase, 1-period integration, order-3 PLL / order-2 DLL."""
    oj, ot, _, _ = run_both({}, blocks=2)
    for a, b in zip(oj, ot):
        assert_match(a, b)


def test_fll_pull_in_with_state_handover():
    """FLL-assisted pull-in. Block 1 runs in JAX only; its state crosses
    over through state_from_numpy and block 2 runs in both packages."""
    oj, ot, sj, st = run_both({"enable_fll_pull_in": True}, blocks=2,
                              handover=True)
    assert bool(np.asarray(sj.fll_active).all())
    assert bool(st.fll_active.all())
    assert_match(oj[1], ot[1])
    end_j, end_t = to_numpy(sj), tdll.state_to_numpy(st)
    np.testing.assert_array_equal(end_j["pos"], end_t["pos"])
    assert np.abs(end_j["code_freq"] - end_t["code_freq"]).max() < 1e-2


def test_extended_integration():
    """NARROW phase with 20-period coherent integration: accumulators
    carry across periods, loop updates fire on boundaries only."""
    def engage(s):
        return s._replace(narrow=s.narrow.at[:].set(True),
                          integ_len=s.integ_len.at[:].set(20))

    oj, ot, _, _ = run_both({"extend_correlation_symbols": 20}, blocks=3,
                            engage=engage)
    for a, b in zip(oj, ot):
        assert_match(a, b)
        np.testing.assert_array_equal(a["acc_samples"], b["acc_samples"])
    a, b = oj[2], ot[2]
    ba = a["boundary"]
    assert ba.sum() > 0
    pa, pb = a["acc_prompt"][ba], b["acc_prompt"][ba]
    assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3


def test_state_round_trip():
    conf = JConf(**conf_kw(pallas_correlator=False))
    d = to_numpy(started_jax_tracker(conf).state)
    back = tdll.state_to_numpy(tdll.state_from_numpy(d, "cpu"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, d[k].astype(v.dtype), err_msg=k)


FDMA_OFFS = [562.5e3, -1125.0e3]   # tests/test_fused_receiver.py's slots


def run_fdma(pilot):
    """Two blocks of the FDMA mode (with the pilot: engaged secondaries,
    atan2 and 5-period integration) in both packages from the same started
    state, on a signal whose carriers sit at FDMA_OFFS."""
    kw = dict(fdma=True)
    if pilot:
        kw.update(track_pilot=True, sec_len_pilot=SP, sec_len_data=SD,
                  extend_correlation_symbols=5)
        tbl, dtbl, sec_p, sec_d = pilot_tables()
        sig = pilot_signal(200_000, FDMA_OFFS)
    else:
        tbl = gps_l1_ca_code_table()[:C].astype(np.float32)
        dtbl = sec_p = sec_d = None
        sig = make_signal(tbl, 200_000, offs=FDMA_OFFS)
    jconf = JConf(**conf_kw(pallas_correlator=False, **kw))
    trk = JTracker(jconf, tbl, data_code_table=dtbl, sec_pilot_table=sec_p,
                   sec_data_levels=sec_d)
    for ch in range(C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=0.0,
                          acq_doppler_hz=DOPS[ch] + 30.0,
                          acq_samplestamp=0, current_abs_sample=0,
                          carrier_offset_hz=FDMA_OFFS[ch])
    sj = trk.state._replace(pos=jnp.asarray(trk.pos_abs.astype(np.int32)))
    if pilot:
        on = jnp.ones(C, bool)
        sj = sj._replace(sec_active=on, use_atan2=on,
                         integ_len=jnp.full(C, 5, jnp.int32))
        tabs = (trk.codes, trk.data_codes, trk.sec_pilot, trk.sec_data)
    else:
        tabs = (trk.codes,)
    st = tdll.state_from_numpy(to_numpy(sj), "cpu")
    tconf = TConf(**conf_kw(**kw))
    outs = []
    for _ in range(2):
        sj, oj = jdll.track_block(jconf, sj, jnp.asarray(sig),
                                  *[jnp.asarray(t) for t in tabs])
        st, ot = tdll.track_block(tconf, st, torch.as_tensor(sig),
                                  *[torch.as_tensor(t) for t in tabs])
        outs.append(({k: np.asarray(v) for k, v in oj._asdict().items()},
                     {k: v.numpy() for k, v in ot.items()}))
    return outs, sj, st


@pytest.mark.parametrize("kw", [
    {"track_pilot": True, "fdma": True}, {"fdma": True}, {"kf": True}],
    ids=["pilot", "fdma", "kf"])
def test_unsupported_modes_raise(kw):
    """The modes that once raised here run (the name is from then).
    FDMA, with or without the pilot mode: the port's eager engine (the
    samples wiped off in float64, K3's plain version at a zero phase)
    against JAX's XLA path over two blocks with this file's tolerances,
    the slot offset in the accumulated carrier phase of both. The Kalman
    mode, from FLL pull-in: two blocks against JAX's XLA path with this
    file's tolerances, and the Kalman states kf_x, kf_P and kf_pc within
    1e-5 relative."""
    if kw.get("kf"):
        oj, ot, sj, st = run_both({"kf": True, "enable_fll_pull_in": True},
                                  blocks=2)
        for a, b in zip(oj, ot):
            assert_match(a, b)
        end_j, end_t = to_numpy(sj), tdll.state_to_numpy(st)
        for k in ("kf_x", "kf_P", "kf_pc"):
            np.testing.assert_allclose(end_t[k], end_j[k], rtol=1e-5,
                                       atol=0, err_msg=k)
        assert (end_t["kf_pc"] < 0.25).all()      # the filter updated
        return
    outs, sj, st = run_fdma(kw.get("track_pilot", False))
    for a, b in outs:
        assert_match(a, b)
    np.testing.assert_array_equal(to_numpy(sj)["pos"], st.pos.numpy())
    # 30 periods of the 562.5 kHz offset alone move the phase ~1e5 rad
    assert np.abs(outs[1][1]["carrier_phase"]).max() > 1e4
