"""The receiver's host options through the port against the JAX package,
on the CPU: the PPP positioning modes (``Receiver._refine_ppp``), the
OSNMA strict filter and the OSNMA manager on a signed I/NAV symbol
stream, the PVT Kalman filter, and the tracking and acquisition dumps
written by the Receiver's glue.

Every case feeds one input to both packages. The PPP fixes agree to
1e-9 relative and the kept rows are equal; the dump files have the same
keys, shapes and dtypes (the port's int32 output leaves are widened in
the glue, as the JAX unpacker gives them), equal stamps and integer
leaves, and prompts within 5e-3 of the prompt's scale
(tests/test_fused_receiver.py's tolerance); the OSNMA managers reach
the same anchors, subframe buffers, reports and authenticated sets.
OSNMA's cold authentication needs about 4 minutes of broadcast, so the
full cases of tests/test_osnma_receiver.py run on the port's modules
only under ``-m slow``.
"""

import dataclasses
import gzip
import importlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.observables.engine import (
    ChannelObsState as JChannelObsState,
)
from gnss_sdr_tpu.pvt.coords import ecef_to_enu, llh_to_ecef
from gnss_sdr_tpu.pvt.ephemeris import C_LIGHT
from gnss_sdr_tpu.pvt.kf import PvtKalmanFilter as JPvtKalmanFilter
from gnss_sdr_tpu.pvt.solver import PvtSolution as JPvtSolution
from gnss_sdr_tpu.receiver.osnma_rx import OsnmaManager as JOsnmaManager
from gnss_sdr_tpu.receiver.plans import gps_l1ca_plan as j_gps_l1ca_plan
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu.simulate.constellation import (
    make_constellation,
    visible_sats,
)
from gnss_sdr_tpu.simulate.galileo import (
    GalileoScenario as JGalileoScenario,
    GalileoScenarioConfig as JGalileoScenarioConfig,
)
from gnss_sdr_tpu.telemetry.inav import InavDecoder as JInavDecoder
from gnss_sdr_tpu.telemetry.osnma import OsnmaSigner as JOsnmaSigner
from gnss_sdr_tpu_torch.observables.engine import (
    ChannelObsState,
    EpochObservation,
)
from gnss_sdr_tpu_torch.pvt.kf import PvtKalmanFilter
from gnss_sdr_tpu_torch.pvt.solver import PvtSolution
from gnss_sdr_tpu_torch.receiver.osnma_rx import OsnmaManager
from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.telemetry.inav import InavDecoder
from gnss_sdr_tpu_torch.telemetry.osnma import ChainParams, _HAVE_CRYPTO

from test_ppp_receiver import F1, F2, _rows_at
from test_torch_control_plane import BLQ

torch.set_num_threads(2)

FS = 2.6e6
RX_LLH = (np.deg2rad(41.275), np.deg2rad(1.9876), 80.0)


def _port_rows(rows):
    """The JAX observables rows as the port's EpochObservation."""
    return [EpochObservation(**dataclasses.asdict(r)) for r in rows]


def _ppp_receivers(nch: int, **kw):
    """A JAX and a port Receiver with the PPP options ``kw``, each with
    2 * nch observables channels configured L1 (i) and L5 (i + 8)."""
    out = []
    for make, cfg, state in ((JReceiver, JConfig(**kw), JChannelObsState),
                             (Receiver, ReceiverConfig(device="cpu", **kw),
                              ChannelObsState)):
        rx = make(cfg)
        while len(rx.obs.ch) < 16:
            rx.obs.ch.append(state())
        for i in range(nch):
            rx.obs.configure_channel(i, 1e-3, 1.023e6, F1)
            rx.obs.configure_channel(i + 8, 1e-3, 1.023e6, F2, signal="L5")
        out.append(rx)
    return out


def _sols(p0, clock_s=0.0, n=None):
    kw = dict(valid=True, vel_ecef=np.zeros(3), clock_bias_s=clock_s,
              clock_drift_ss=0.0)
    if n is not None:
        kw["num_sats"] = n
    return (JPvtSolution(pos_ecef=p0.copy(), **kw),
            PvtSolution(pos_ecef=p0.copy(), **kw))


def test_receiver_ppp_refines_ls_fix_matches_jax():
    """tests/test_ppp_receiver.py::test_receiver_ppp_refines_ls_fix through
    both Receivers: 40 epochs of dual-band rows, the same refined fix
    every epoch (1e-9 relative), within 1 m of the truth at the end."""
    ephs = make_constellation(seed=3)
    rx_pos = llh_to_ecef(*RX_LLH)
    tow = 7350.0
    vis = visible_sats(ephs, rx_pos, tow)[:8]
    jrx, trx = _ppp_receivers(len(vis), fs=FS, num_channels=8,
                              positioning_mode="PPP_Static", earth_tide=1,
                              phwindup=True)
    assert trx.ppp.tide_correction and trx.ppp.phase_windup
    for rx in (jrx, trx):
        rx.ephemerides = {("G", p): ephs[p] for p in vis}
    rng = np.random.default_rng(9)
    for k in range(40):
        t = tow + k
        rows = _rows_at(ephs, vis, rx_pos, t, rng)
        jsol, tsol = _sols(rx_pos + np.array([4.0, -3.0, 5.0]),
                           12.0 / C_LIGHT, len(vis))
        jrx._refine_ppp(jsol, rows, t + 12.0 / C_LIGHT)
        trx._refine_ppp(tsol, _port_rows(rows), t + 12.0 / C_LIGHT)
        np.testing.assert_allclose(tsol.pos_ecef, jsol.pos_ecef, rtol=1e-9)
        assert tsol.lat_rad == pytest.approx(jsol.lat_rad, rel=1e-9)
    assert np.linalg.norm(tsol.pos_ecef - rx_pos) < 1.0
    assert trx.ppp.gps_week == jrx.ppp.gps_week


# chip_smoke.py phase 39's (LS fix, usable rows, ephemerides, t_rx)
# sequence, recorded on an NVIDIA H100 80GB HBM3 (700 W) with the port's
# fixes refined there (``write_ppp_replay``), and phase 39's gates
PPP_REPLAY = Path(__file__).parent / "data" / "l1l5_ppp_replay.json.gz"
PPP_GATES = (6.1, 13.9)


def _replay_ppp(pkg: str, blq_path) -> tuple[np.ndarray, dict]:
    """Phase 39's recorded sequence through ``pkg``'s
    ``Receiver._refine_ppp`` (PPP_Static, earth_tide=2, phwindup, the BLQ
    table read by ``pkg``'s ``read_blq``): the refined fixes, and the
    record."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    with gzip.open(PPP_REPLAY, "rt") as f:
        rec = json.load(f)
    rxm, obs = mod("receiver.receiver"), mod("observables.engine")
    kw = dict(fs=FS, num_channels=5, positioning_mode="PPP_Static",
              earth_tide=2, phwindup=True,
              blq=mod("pvt.tides").read_blq(blq_path, "WTZR"))
    if pkg.endswith("_torch"):
        kw["device"] = "cpu"
    rx = rxm.Receiver(rxm.ReceiverConfig(**kw))
    while len(rx.obs.ch) < len(rec["wavelengths"]):
        rx.obs.ch.append(obs.ChannelObsState())
    for c, w in zip(rx.obs.ch, rec["wavelengths"]):
        c.wavelength_m = w
    ephs = [getattr(mod(m), n)(**f) for m, n, f in rec["ephemerides"]]
    out = []
    for q in rec["epochs"]:
        rx.ephemerides = {(s, p): ephs[i] for s, p, i in q["ephemerides"]}
        sol = mod("pvt.solver").PvtSolution(
            valid=True, pos_ecef=np.array(q["ls_pos"]), vel_ecef=np.zeros(3),
            clock_bias_s=q["clock_bias_s"], clock_drift_ss=0.0)
        rx._refine_ppp(sol, [obs.EpochObservation(**r) for r in q["rows"]],
                       q["t_rx"])
        out.append(sol.pos_ecef.copy())
    return np.array(out), rec


def test_ppp_replay_of_card_run_matches_jax(tmp_path):
    """Phase 39's sequence from the card through both packages'
    ``_refine_ppp``: the refined fixes agree to 1e-9 relative, and the
    port's equal the fixes it refined on the card. Over fixes[3:], the LS
    fixes meet phase 17's gates (mean 2D < 2 m, 3D < 5 m) and the JAX
    package's PPP fixes miss them but meet PPP_GATES: the reference fault
    of ROADMAP section 3 that sets phase 39's gates."""
    blq = tmp_path / "wtzr.blq"
    blq.write_text(BLQ)
    jax_pos, rec = _replay_ppp("gnss_sdr_tpu", blq)
    port_pos, _ = _replay_ppp("gnss_sdr_tpu_torch", blq)
    np.testing.assert_allclose(port_pos, jax_pos, rtol=1e-9, atol=0)
    card = np.array([q["ppp_pos"] for q in rec["epochs"]])
    np.testing.assert_allclose(port_pos, card, rtol=1e-9, atol=0)

    truth = llh_to_ecef(*RX_LLH)

    def mean_errs(pos):
        enu = np.array([ecef_to_enu(p - truth, *RX_LLH[:2])
                        for p in pos[3:]])
        return (np.hypot(enu[:, 0], enu[:, 1]).mean(),
                np.linalg.norm(enu, axis=1).mean())

    ls = mean_errs(np.array([q["ls_pos"] for q in rec["epochs"]]))
    ppp = mean_errs(jax_pos)
    assert len(rec["epochs"]) == 79
    assert ls[0] < 2.0 and ls[1] < 5.0, ls
    assert ppp[0] > 2.0 and ppp[1] > 5.0, ppp
    assert ppp[0] < PPP_GATES[0] and ppp[1] < PPP_GATES[1], ppp


def test_single_mode_has_no_ppp_matches_jax():
    jrx = JReceiver(JConfig(fs=FS, num_channels=4))
    trx = Receiver(ReceiverConfig(fs=FS, num_channels=4, device="cpu"))
    assert trx.ppp is None and jrx.ppp is None
    assert trx.pvt_kf is None and jrx.pvt_kf is None
    assert trx.osnma is None and jrx.osnma is None


def test_ppp_requires_dual_band_rows_matches_jax():
    """With single-frequency rows both PPP hooks leave the fix alone."""
    ephs = make_constellation(seed=3)
    rx_pos = llh_to_ecef(*RX_LLH)
    vis = visible_sats(ephs, rx_pos, 7350.0)[:6]
    jrx, trx = _ppp_receivers(0, fs=FS, num_channels=8,
                              positioning_mode="PPP_Kinematic")
    assert trx.ppp.mode == jrx.ppp.mode == "kinematic"
    rows = [r for r in _rows_at(ephs, vis, rx_pos, 7350.0,
                                np.random.default_rng(1)) if r.channel < 8]
    p0 = rx_pos + 3.0
    jsol, tsol = _sols(p0)
    for rx in (jrx, trx):
        rx.ephemerides = {("G", p): ephs[p] for p in vis}
    jrx._refine_ppp(jsol, rows, 7350.0)
    trx._refine_ppp(tsol, _port_rows(rows), 7350.0)
    np.testing.assert_array_equal(tsol.pos_ecef, p0)
    np.testing.assert_array_equal(jsol.pos_ecef, p0)


def test_pvt_strict_mode_filters_unauthenticated_matches_jax():
    """tests/test_osnma_receiver.py::test_pvt_strict_mode_filters_
    unauthenticated through both Receivers: the same rows kept, strict and
    not."""
    obs = [SimpleNamespace(system="E", prn=12),
           SimpleNamespace(system="E", prn=19),
           SimpleNamespace(system="G", prn=7)]
    kept = []
    for rx in (JReceiver(JConfig(fs=FS, num_channels=2, osnma=True,
                                 osnma_strict=True),
                         plans=[j_gps_l1ca_plan(fs=FS, num_channels=2)]),
               Receiver(ReceiverConfig(fs=FS, num_channels=2, osnma=True,
                                       osnma_strict=True, device="cpu"),
                        plans=[gps_l1ca_plan(fs=FS, num_channels=2)])):
        rx.osnma.auth_ok.add(12)
        strict = rx._filter_osnma(obs)
        rx.cfg.osnma_strict = False
        kept.append(([(o.system, o.prn) for o in strict],
                     len(rx._filter_osnma(obs))))
    assert kept[1] == kept[0] == ([("E", 12), ("G", 7)], 3)


def test_pvt_kf_matches_jax():
    """tests/test_aux.py::test_pvt_kf_smooths_and_resets through both
    filters: the same estimates every update, the reset included."""
    jkf, tkf = JPvtKalmanFilter(), PvtKalmanFilter()
    rng = np.random.default_rng(0)
    pos0 = np.array([6378137.0, 0.0, 0.0])
    vel = np.array([10.0, 0.0, 0.0])
    for k in range(100):
        meas = pos0 + vel * 0.1 * k + rng.normal(scale=2.0, size=3)
        v = vel + rng.normal(scale=0.3, size=3)
        for a, b in zip(jkf.update(0.1 * k, meas, v),
                        tkf.update(0.1 * k, meas, v)):
            np.testing.assert_array_equal(b, a)
    jp, _ = jkf.update(10.1, pos0 + 1000.0, None)
    tp, _ = tkf.update(10.1, pos0 + 1000.0, None)
    np.testing.assert_array_equal(tp, jp)
    assert np.linalg.norm(tp - (pos0 + 1000.0)) < 1.0


def _dump_run(make_rx, make_plan, tmp, x):
    """One Receiver with tracking and acquisition dumps on ``x``: one
    acquisition over PRNs 1-4, then one tracking block of the
    acquisition's first detection (or PRN 1 at delay 0), handed to the
    Receiver's block handler; returns the two loaded dump files."""
    plan = make_plan(fs=FS, num_channels=2, search_prns=(1, 2, 3, 4),
                     steps_per_block=5)
    plan.dump_filename = str(tmp / "trk.npz")
    plan.acq_dump_filename = str(tmp / "acq.npz")
    rx = make_rx(plan)
    rx.feed(x)
    rx.acquire()
    g = rx.groups[0]
    if not g.active_channels():
        g.tracker.start_channel(0, 1, 0, 0.0, 0.0, 0, 0)
    res = g.tracker.process(x[:g.plan.trk_conf.window_samples], 0)
    rx._handle_block(g, res)
    rx.close()
    return np.load(tmp / "trk.npz"), np.load(tmp / "acq.npz")


def test_dumps_match_jax(tmp_path):
    """tests/test_aux.py::test_tracking_dump_written's case (a noise
    window, 5 periods, 2 channels) through both Receivers' glue, with an
    acquisition before it: the same files, keys, shapes and dtypes."""
    rng = np.random.default_rng(0)
    n = 1 << 15
    x = ((rng.normal(size=n) + 1j * rng.normal(size=n))
         .astype(np.complex64))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jt, ja = _dump_run(lambda p: JReceiver(JConfig(fs=FS), plans=[p]),
                       j_gps_l1ca_plan, tmp_path / "j", x)
    tt, ta = _dump_run(lambda p: Receiver(ReceiverConfig(fs=FS,
                                                         device="cpu"),
                                          plans=[p]),
                       gps_l1ca_plan, tmp_path / "t", x)
    assert sorted(tt.files) == sorted(jt.files)
    for k in jt.files:
        assert tt[k].shape == jt[k].shape, k
        assert tt[k].dtype == jt[k].dtype, k
        if jt[k].dtype.kind in "iub":
            np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    assert tt["prompt"].shape == (5, 2)
    scale = np.abs(jt["prompt"]).max()
    assert np.abs(tt["prompt"] - jt["prompt"]).max() < 5e-3 * scale
    assert ta.files == ja.files == ["acquisitions"]
    a, b = ja["acquisitions"], ta["acquisitions"]
    assert b.dtype == a.dtype and len(b) == len(a) == 4
    np.testing.assert_array_equal(b["prn"], a["prn"])
    np.testing.assert_array_equal(b["detected"], a["detected"])
    np.testing.assert_allclose(b["test_statistic"], a["test_statistic"],
                               rtol=1e-3)


# ---------------------------------------------------------------- OSNMA
OSNMA_FS = 4.0e6
SPS = int(OSNMA_FS * 0.004)         # samples per 250 sym/s symbol


def _osnma_scenario(duration_s: float, signer=None, tamper=(),
                    grid_step_s=None):
    """tests/test_osnma_receiver.py's signed scenario (JAX simulator);
    only its I/NAV symbols are used, so a coarse truth grid will do."""
    if signer is None:
        signer = JOsnmaSigner(num_keys=48, seed=11, wn0=1250, tow0_hours=2)
    kw = {} if grid_step_s is None else {"grid_step_s": grid_step_s}
    scen = JGalileoScenario(JGalileoScenarioConfig(
        fs=OSNMA_FS, tow_start_s=7310.0, duration_s=duration_s,
        cn0_dbhz=48.0, max_sats=4, seed=3, osnma_signer=signer,
        osnma_tamper=tamper, **kw))
    return signer, scen


def _run_manager(mgr, decoder, scen):
    """tests/test_osnma_receiver.py::_run_manager with the given manager
    and I/NAV decoder class; returns the fields pushed per satellite."""
    pushed, ephs = {}, {}
    for gch, prn in enumerate(scen.prns):
        syms = scen._signs[prn].astype(np.float64)
        stamps = np.arange(len(syms), dtype=np.int64) * SPS
        dec = decoder(prn)
        for ev in dec.push_symbols(syms, stamps):
            if "tow_s" in ev:
                mgr.anchor(gch, ev["tow_s"], ev["sample_stamp"], OSNMA_FS)
            if ev.get("ephemeris_complete"):
                ephs[prn] = dec.eph
        eph = ephs.get(prn)
        if eph is not None and dec.osnma_fields:
            fields, dec.osnma_fields = dec.osnma_fields, []
            pushed[prn] = [(int(s), np.asarray(f)) for s, f in fields]
            mgr.push_fields(gch, prn, eph.week, eph, fields)
    return pushed


def _manager_state(mgr):
    r = mgr.rx
    return dict(anchor=mgr._anchor,
                buf={k: {s: v.tolist() for s, v in b.items()}
                     for k, b in mgr._buf.items()},
                auth_ok=mgr.auth_ok, auth_fail=mgr.auth_fail,
                reports=[(t.prn, t.subframe_gst, t.ok) for t in r.reports],
                kroot=r.kroot_verified,
                dsm={k: v.tolist() for k, v in r._dsm_blocks.items()},
                dsm_total=r._dsm_total,
                subframes=(r.authenticated_subframes, r.failed_subframes))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_osnma_manager_matches_jax(warm):
    """70 s of the signed scenario's symbols through a JAX and a port
    I/NAV decoder into each package's OsnmaManager: the same fields
    pushed, anchors, subframe buffers, DSM blocks and reports. Cold, the
    DSM-KROOT is still incomplete; warm (``load_chain`` with the signer's
    chain), every satellite authenticates in both."""
    signer, scen = _osnma_scenario(70.0, grid_step_s=5.0)
    jm = JOsnmaManager(public_key=signer.public_key)
    tm = OsnmaManager(public_key=signer.public_key)
    if warm:
        jm.load_chain(signer.params)
        tm.load_chain(ChainParams(**dataclasses.asdict(signer.params)))
    jp = _run_manager(jm, JInavDecoder, scen)
    tp = _run_manager(tm, InavDecoder, scen)
    assert tp.keys() == jp.keys() == set(scen.prns)
    for prn in jp:
        assert [s for s, _ in tp[prn]] == [s for s, _ in jp[prn]]
        for (_, a), (_, b) in zip(jp[prn], tp[prn]):
            np.testing.assert_array_equal(b, a)
    js, ts = _manager_state(jm), _manager_state(tm)
    assert ts == js
    if warm:
        assert ts["auth_ok"] == set(scen.prns) and not ts["auth_fail"]
    else:
        assert not ts["kroot"] and ts["dsm"] and not ts["reports"]


@pytest.mark.slow
def test_osnma_live_path_authenticates_port():
    """tests/test_osnma_receiver.py::test_osnma_live_path_authenticates on
    the port's decoder and manager (420 s of broadcast)."""
    if not _HAVE_CRYPTO:
        pytest.skip("cryptography not available for ECDSA KROOT")
    signer, scen = _osnma_scenario(420.0)
    mgr = OsnmaManager(public_key=signer.public_key)
    _run_manager(mgr, InavDecoder, scen)
    assert mgr.rx.kroot_verified
    for prn in scen.prns:
        assert mgr.authenticated(prn), (
            prn, mgr.rx.authenticated_subframes, mgr.rx.failed_subframes)
    assert mgr.rx.failed_subframes == 0


@pytest.mark.slow
def test_osnma_tampered_satellite_rejected_port():
    """tests/test_osnma_receiver.py::test_osnma_tampered_satellite_rejected
    on the port's decoder and manager."""
    if not _HAVE_CRYPTO:
        pytest.skip("cryptography not available for ECDSA KROOT")
    signer = JOsnmaSigner(num_keys=48, seed=12, wn0=1250, tow0_hours=2)
    _, scen = _osnma_scenario(420.0, signer, tamper=(0,))
    tampered = scen.prns[0]
    _, scen2 = _osnma_scenario(420.0, signer, tamper=(tampered,))
    mgr = OsnmaManager(public_key=signer.public_key)
    _run_manager(mgr, InavDecoder, scen2)
    assert mgr.rx.kroot_verified
    assert tampered in mgr.auth_fail
    assert not mgr.authenticated(tampered)
    for prn in scen2.prns[1:]:
        assert mgr.authenticated(prn)
