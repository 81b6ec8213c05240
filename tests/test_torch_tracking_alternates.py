"""The port's tracking alternates against the JAX package's: the Kalman
mode of the eager engine, the CKF/UKF carrier filter and its block-cadence
loop closer, and the TCP connector.

- KF (``conf.kf``): the port's ``Tracker`` asked for the fused engine
  keeps the eager one (the fused kernel does not carry the mode), and two
  blocks of ``tests/test_kf_tracking.py``'s signal match the JAX
  ``Tracker`` on its XLA path: period lengths, end stamps and boundaries
  equal, the rest within tests/test_fused_receiver.py's ``_assert_match``
  tolerances, ``kf_x``/``kf_P``/``kf_pc`` within 1e-5 relative.
- Gaussian: the cubature and unscented points and ``gauss_update`` within
  1e-12 of each result's largest element (the unscented weights at
  alpha = 1e-2 are about +-1e4 and cancel, so an element near zero
  carries the rounding of the large ones), ``run_carry`` within 1e-9
  relative (both in float64). The loop
  closer, fed the same blocks as the JAX closer on a dead-PLL conf where
  it commands, writes ``carrier_doppler`` and ``pll_state[:, 0]`` within
  1e-6 Hz of the JAX closer's writes; the fused engine's scalar block
  then carries the written values, and the port's fused block from that
  state matches the JAX block.
- TCP: one block's records to ``SimpleLoopServer`` and the state written
  from its replies equal the JAX connector's.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.tracking import gaussian as jg
from gnss_sdr_tpu.tracking import tcp_connector as jtcp
from gnss_sdr_tpu.tracking.conf import DllPllConf as JConf
from gnss_sdr_tpu.tracking.tracker import Tracker as JTracker
from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu_torch.simulate import SatelliteSignalParams, generate_baseband
from gnss_sdr_tpu_torch.tracking import dll_pll as tdll
from gnss_sdr_tpu_torch.tracking import gaussian as tg
from gnss_sdr_tpu_torch.tracking import tcp_connector as ttcp
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf as TConf
from gnss_sdr_tpu_torch.tracking.fused import _pack_scalars
from gnss_sdr_tpu_torch.tracking.tracker import (
    ChannelControl,
    ChannelPhase,
    Tracker as TTracker,
)

from test_torch_dll_pll import assert_match

torch.set_num_threads(2)

FS = 2.6e6
SPC = FS / 1.023e6           # samples per chip


def conf_kw(**kw):
    return dict(dict(fs=FS, code_length_chips=1023, code_rate_cps=1.023e6,
                     carrier_freq_hz=1575.42e6, max_channels=2,
                     steps_per_block=20), **kw)


def start(trk, prn, dop, delay_chips):
    trk.start_channel(ch=0, prn=prn, code_row=prn - 1,
                      acq_delay_samples=delay_chips * SPC,
                      acq_doppler_hz=dop, acq_samplestamp=0,
                      current_abs_sample=0)


def step(trk, x):
    base, w = trk.window_request()
    return trk.process(x[base:base + w], base)


def jstate(trk) -> dict:
    return {k: np.asarray(v) for k, v in trk.state._asdict().items()}


def port_twin(jtrk, tconf):
    """A port Tracker in the JAX tracker's state: the same state tensors,
    channel controls, positions and code rows."""
    t = TTracker(tconf, gps_l1_ca_code_table(), device="cpu")
    t.state = tdll.state_from_numpy(jstate(jtrk), "cpu")
    t.ctl = [ChannelControl(**{
        f.name: copy.deepcopy(getattr(c, f.name))
        for f in dataclasses.fields(ChannelControl)}) for c in jtrk.ctl]
    for c in t.ctl:
        c.phase = ChannelPhase(int(c.phase))
    t.pos_abs = jtrk.pos_abs.copy()
    t.codes = jtrk.codes.copy()
    t._codes_dev = None
    return t


# ------------------------------------------------------------------ KF
def test_kf_tracker_matches_jax():
    rng = np.random.default_rng(21)
    sat = SatelliteSignalParams(
        prn=5, cn0_dbhz=46.0, doppler_hz=-1234.0, delay_chips=400.0,
        nav_bits=rng.choice([-1.0, 1.0], size=200), carrier_phase_rad=1.1)
    x = generate_baseband([sat], FS, int(FS * 0.06), seed=22)
    kw = conf_kw(kf=True, enable_fll_pull_in=True, pull_in_time_s=0.25,
                 extend_correlation_symbols=20)
    jt = JTracker(JConf(pallas_correlator=False, **kw),
                  gps_l1_ca_code_table())
    tt = TTracker(TConf(fused_tracker=True, **kw), gps_l1_ca_code_table(),
                  device="cpu")
    assert not tt._block.fused            # the fused kernel has no KF mode
    for trk in (jt, tt):
        start(trk, 5, -1234.0 + 90.0, 400.0 + 0.5 / SPC)
    for _ in range(2):
        rj, rt = step(jt, x), step(tt, x)
        assert_match(rj.outputs, rt.outputs)
        np.testing.assert_array_equal(rt.abs_sample_end, rj.abs_sample_end)
    sj, st = jstate(jt), tdll.state_to_numpy(tt.state)
    for k in ("kf_x", "kf_P", "kf_pc"):
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, atol=0, err_msg=k)
    assert sj["kf_P"][0, 1, 1] < 2500.0  # the filter updated


# ------------------------------------------------------------- Gaussian
def spd(rng, c, n=3):
    a = rng.normal(size=(c, n, n))
    return np.einsum("cij,ckj->cik", a, a) + n * np.eye(n)[None]


def close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("kind", ["cubature", "unscented"])
def test_points_and_update_match_jax(kind):
    rng = np.random.default_rng(3)
    mean, cov = rng.normal(size=(4, 3)), spd(rng, 4)
    z, amp = rng.normal(size=(4, 2)), np.abs(rng.normal(size=4)) + 0.5
    R = np.eye(2)[None] * rng.uniform(0.1, 1.0, size=(4, 1, 1))
    jfun = jg.cubature_points if kind == "cubature" else jg.unscented_points
    tfun = tg.cubature_points if kind == "cubature" else tg.unscented_points
    jp, jw = jfun(jnp.asarray(mean), jnp.asarray(cov))
    tp, tw = tfun(torch.as_tensor(mean), torch.as_tensor(cov))
    jw = (jw, jw) if kind == "cubature" else jw
    tw = (tw, tw) if kind == "cubature" else tw
    close(tp, jp)
    for a, b in zip(tw, jw):
        close(a, b)

    def h(pts, amp, lib):
        phi = pts[..., 0]
        return amp[:, None, None] * lib.stack(
            [lib.cos(phi), lib.sin(phi)], -1)

    jm, jc = jg.gauss_update(jp, *jw, jnp.asarray(z),
                             lambda p: h(p, jnp.asarray(amp), jnp),
                             jnp.asarray(R))
    tm, tc = tg.gauss_update(tp, *tw, torch.as_tensor(z),
                             lambda p: h(p, torch.as_tensor(amp), torch),
                             torch.as_tensor(R))
    close(tm, jm)
    close(tc, jc)


@pytest.mark.parametrize("kind", ["cubature", "unscented"])
def test_run_carry_matches_jax(kind):
    """60 periods of a 7 Hz residual carrier with BPSK signs and noise on
    three channels, from a seeded prior, with a per-channel R."""
    rng = np.random.default_rng(5)
    t = np.arange(60)[:, None]
    phase = 0.3 + 2 * np.pi * 7.0 * 1e-3 * t + np.array([0.0, 1.0, 2.0])
    bits = np.repeat(rng.choice([-1.0, 1.0], size=(3, 3)), 20, axis=0)
    p = 20.0 * bits * np.exp(1j * phase) + rng.normal(
        size=(60, 3)) + 1j * rng.normal(size=(60, 3))
    x0 = np.array([[0.3, 0.04, 0.0], [1.3, 0.05, 0.0], [2.3, 0.03, 0.0]])
    P0 = np.tile(np.diag([1.0, 1e-3, 1e-6]), (3, 1, 1))
    R = np.eye(2)[None] * np.array([1.0, 2.0, 0.5])[:, None, None]
    jr = jg.GaussianCarrierTracker(3, kind=kind).run_carry(p, x0, P0, R=R)
    tr = tg.GaussianCarrierTracker(3, kind=kind, device="cpu").run_carry(
        p, x0, P0, R=R)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)
    # every channel's omega estimate stays on the residual's side
    assert (np.abs(tr[0][-1, :, 1] - 2 * np.pi * 7e-3) < 0.02).all()


def test_closer_writes_match_jax():
    """Both closers get the JAX tracker's blocks on a dead-PLL conf (the
    one where the closer commands, tracking/gaussian.py:283); the port's
    acts on a port tracker in the JAX tracker's state before each block's
    writes. Six blocks: one to seed, three to agree in sign, a command on
    the fourth, two more."""
    sat = SatelliteSignalParams(prn=9, cn0_dbhz=50.0, doppler_hz=640.0,
                                delay_chips=120.0)
    x = generate_baseband([sat], FS, int(FS * 0.15), seed=9)
    kw = conf_kw(pll_bw_hz=1e-4, pll_bw_narrow_hz=1e-4, dll_bw_hz=2.0,
                 enable_fll_pull_in=False)
    tconf = TConf(fused_tracker=True, **kw)
    jt = JTracker(JConf(pallas_correlator=False, **kw),
                  gps_l1_ca_code_table())
    start(jt, 9, 640.0 - 3.0, 120.0)
    jc = jg.GaussianLoopCloser(2, 1e-3, s_transient=0)
    tc = tg.GaussianLoopCloser(2, 1e-3, s_transient=0, device="cpu")
    commanded = 0
    for _ in range(6):
        result = step(jt, x)
        tt = port_twin(jt, tconf)
        before = jstate(jt)["carrier_doppler"][0]
        jc.after_block(jt, result)
        tc.after_block(tt, result)
        sj, st = jstate(jt), tdll.state_to_numpy(tt.state)
        assert abs(st["carrier_doppler"][0] - sj["carrier_doppler"][0]) < 1e-6
        assert abs(st["pll_state"][0, 0] - sj["pll_state"][0, 0]) < 1e-6
        commanded += sj["carrier_doppler"][0] != before
    assert commanded >= 1
    # the fused engine reads the written Doppler and PLL integrator ...
    scal = _pack_scalars(tconf, tt.state)
    assert scal[0, 4] == tt.state.carrier_doppler[0]
    assert scal[0, 5] == tt.state.pll_state[0, 0]
    # ... and its next block (K1's plain version) matches the JAX block on
    # the started channel (an idle channel burns periods in the XLA scan
    # and holds still in the fused engine)
    assert tt._block.fused
    oj, ot = step(jt, x).outputs, step(tt, x).outputs
    assert_match({k: v[:, :1] for k, v in oj.items()},
                 {k: v[:, :1] for k, v in ot.items()})


# ------------------------------------------------------------------ TCP
def test_tcp_block_matches_jax():
    """One block of tests/test_tcp_connector.py's setup in the JAX
    Tracker; each package's connector sends its records to its own
    SimpleLoopServer and writes the replies."""
    sat = SatelliteSignalParams(prn=9, cn0_dbhz=48.0, doppler_hz=640.0,
                                delay_chips=120.0)
    x = generate_baseband([sat], FS, int(FS * 0.05), seed=9)
    kw = conf_kw(pll_bw_hz=1e-4, dll_bw_hz=1e-5, enable_fll_pull_in=False,
                 steps_per_block=10)
    jt = JTracker(JConf(pallas_correlator=False, **kw),
                  gps_l1_ca_code_table())
    start(jt, 9, 640.0 - 4.0, 120.0)
    result = step(jt, x)
    tt = port_twin(jt, TConf(**kw))
    sent = {}
    for name, mod, trk in (("jax", jtcp, jt), ("port", ttcp, tt)):
        srv = mod.SimpleLoopServer(pll_bw_hz=8.0)
        client = mod.TcpLoopClient(port=srv.port)
        exchange = client.exchange
        client.exchange = lambda r, name=name, f=exchange: (
            sent.__setitem__(name, list(r)) or f(r))
        try:
            mod.TcpConnectorTracking(trk, client, [0]).after_block(
                trk, result)
        finally:
            client.close()
            srv.close()
        assert srv.records_seen == 1
    assert sent["port"] == sent["jax"]
    sj, st = jstate(jt), tdll.state_to_numpy(tt.state)
    for k in ("carrier_doppler", "pll_state", "code_freq"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert sj["carrier_doppler"][0] != np.float32(640.0 - 4.0)
