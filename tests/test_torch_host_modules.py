"""The port's copies of the last host modules against the originals, on
the JAX package's own test cases: RTK with LAMBDA (tests/test_rtk.py),
RTCM 3 and RTCM 2 (tests/test_rtcm.py, tests/test_rtcm2.py), the RINEX
navigation reader (tests/test_rinex_reader.py), SP3 and ``ppp.py`` with a
precise ephemeris (tests/test_preceph.py), the protobuf monitor wire
format and the UDP sinks (tests/test_protobuf_wire.py,
tests/test_outputs.py), and the port's ``nav_listener`` and ``skyplot``
tools. Each case runs through both packages from the same inputs, and the
results must be equal: the same bytes, the same fields, the same
solutions bit for bit (the copies are the same NumPy code).
"""

import dataclasses
import importlib
import importlib.util
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("gnss_sdr_tpu", "gnss_sdr_tpu_torch")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _fields(obj):
    """A dataclass's fields as a plain dict (arrays as lists), for
    comparing two packages' instances of their own classes."""
    d = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def _both(fn):
    return [fn(pkg) for pkg in PKGS]


# ------------------------------------------------------------------- RTK
def _rtk_run(pkg):
    """tests/test_rtk.py's static RTK case (40 epochs, ~390 m baseline)
    and its LAMBDA case; the per-epoch (position, fixed, ratio) and the
    LAMBDA fix."""
    coords, eph = _m(pkg, "pvt.coords"), _m(pkg, "pvt.ephemeris")
    rtk, lam = _m(pkg, "pvt.rtk"), _m(pkg, "pvt.lambda_ilr")
    const = _m(pkg, "simulate.constellation")
    tow = 7500.0
    wl = eph.C_LIGHT / 1575.42e6
    ephs = const.make_constellation(seed=3, toe=tow)
    base = coords.llh_to_ecef(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0)
    rover = base + np.array([350.0, -120.0, 60.0])
    vis = const.visible_sats(ephs, base, tow, np.deg2rad(5.0))[:8]
    rng = np.random.default_rng(11)
    amb = {prn: int(rng.integers(-30, 30)) for prn in vis}

    def obs_at(pos, t, clock_bias_m):
        out = []
        for prn in vis:
            p, _, _, _ = eph.eph_to_pos_vel_clock(ephs[prn], t)
            rho = float(np.linalg.norm(p - pos))
            out.append(rtk.DiffObs(
                system="G", prn=prn,
                pseudorange_m=rho + clock_bias_m + rng.normal(scale=0.4),
                carrier_phase_cycles=(-rho - clock_bias_m) / wl + amb[prn]
                + rng.normal(scale=0.003 / wl),
                wavelength_m=wl, cn0_dbhz=45.0 + prn % 7))
        return out

    rng = np.random.default_rng(43)
    eng = rtk.RtkEngine(base, mode="static", ratio_threshold=2.5)
    eph_map = {("G", p): ephs[p] for p in vis}
    sols = []
    for k in range(40):
        t = tow + k
        sol = eng.process_epoch(t, obs_at(rover, t, 12.0),
                                obs_at(base, t, 3.0), eph_map)
        sols.append((sol.pos_ecef.tolist(), bool(sol.fixed)))
    r = np.random.default_rng(5)
    a = r.normal(size=(6, 6))
    q = a @ a.T * 2e-4 + np.eye(6) * 1e-4
    truth = r.integers(-15, 15, 6).astype(float)
    fix, ratio = lam.lambda_fix(truth + np.linalg.cholesky(q) @ r.normal(
        size=6), q, ratio_threshold=1.5)
    return sols, fix.tolist(), ratio, rover


def test_rtk_fix_with_lambda_matches_jax():
    (sj, fj, rj, _), (st, ft, rt, rover) = _both(_rtk_run)
    assert st == sj and ft == fj and rt == rj
    fixed = [p for p, f in st if f]
    assert fixed, "RTK never fixed"
    assert np.linalg.norm(np.asarray(fixed[-1]) - rover) < 0.05


# ------------------------------------------------------------------ RTCM
def _rtcm3(pkg):
    r = _m(pkg, "outputs.rtcm")
    const = _m(pkg, "simulate.constellation")
    glo = _m(pkg, "simulate.glonass")
    wl = _m(pkg, "pvt.ephemeris").C_LIGHT / 1575.42e6
    eph = const.make_constellation(seed=2)[7]
    geph = glo.make_glonass_constellation(week=2290,
                                          tb_approx_tow=7500.0)[9]
    rng = np.random.default_rng(0)
    obs = []
    for prn in (2, 5, 13, 21, 30):
        pr = 2.1e7 + rng.uniform(0, 3e6)
        obs.append(r.MsmObservation(
            prn=prn, pseudorange_m=pr,
            carrier_phase_cycles=-pr / wl + rng.integers(-5, 5),
            doppler_hz=rng.uniform(-4000, 4000),
            cn0_dbhz=rng.uniform(35, 50), wavelength_m=wl))
    msgs = [r.encode_1005(77, np.array([4797680.123, 166506.72,
                                        4185447.53])),
            r.encode_1019(eph), r.encode_1020(geph),
            r.encode_msm7("G", 4, 345601.25, obs)]
    stream = b"".join(r.frame(p) for p in msgs)
    decoded = [r.decode_1005(msgs[0]), _fields(r.decode_1019(msgs[1])),
               _fields(r.decode_1020(msgs[2])), r.decode_msm7(msgs[3])]
    return stream, [(n, p) for n, p in r.deframe(stream)], decoded


def _rtcm2(pkg):
    r = _m(pkg, "outputs.rtcm2")
    enc = r.Rtcm2Encoder(staid=321)
    corr = {3: r.DgpsCorrection(prc=12.34, rrc=0.016, iod=45, udre=1),
            17: r.DgpsCorrection(prc=-8.22, rrc=-0.01, iod=46, udre=0),
            32: r.DgpsCorrection(prc=250.0, rrc=0.1, iod=47, udre=2)}
    stream = (enc.type1(corr, zcnt_s=1234.2)
              + enc.type3((4027892.12, -307045.93, 4919478.51),
                          zcnt_s=1234.6)
              + enc.type14(week=2345 % 1024, hour=12, leaps=18,
                           zcnt_s=1235.0))
    dec = r.Rtcm2Decoder(approx_tow_s=1234.0)
    types = dec.push(stream)
    st = dec.state
    return stream, types, (st.staid, st.station_pos, st.week, st.leaps,
                           {k: _fields(v) for k, v in st.dgps.items()})


def test_rtcm3_encode_is_byte_equal():
    (sj, fj, dj), (st, ft, dt) = _both(_rtcm3)
    assert st == sj and ft == fj
    assert [n for n, _ in ft] == [1005, 1019, 1020, 1077]
    assert json.dumps(dt, default=str) == json.dumps(dj, default=str)


def test_rtcm2_encode_is_byte_equal():
    (sj, tj, dj), (st, tt, dt) = _both(_rtcm2)
    assert st == sj and tt == tj and dt == dj
    assert dt[0] == 321 and set(dt[4]) == {3, 17, 32}


# ----------------------------------------------------------- RINEX, SP3
def test_rinex_nav_read_matches_jax(tmp_path):
    """A navigation file written once, read by both readers; and
    ``rinex2assist`` from both into assistance XML."""
    from gnss_sdr_tpu.outputs import RinexNavWriter
    from gnss_sdr_tpu.simulate.constellation import make_constellation
    from gnss_sdr_tpu.telemetry.lnav import GpsIonoUtc

    ephs = make_constellation(seed=3)
    path = tmp_path / "brdc.rnx"
    w = RinexNavWriter(str(path), iono=GpsIonoUtc(
        alpha0=1.2e-8, alpha1=-7.5e-9, alpha2=6.0e-8, alpha3=-6.0e-8,
        beta0=94208.0, beta1=-81920.0, beta2=131072.0, beta3=-131072.0,
        has_iono=True))
    for p in sorted(ephs)[:6]:
        w.write_ephemeris(ephs[p])
    w.close()
    got = []
    for pkg in PKGS:
        rr = _m(pkg, "outputs.rinex_reader")
        nav, iono = rr.read_rinex_nav(path)
        xml = tmp_path / f"{pkg}.xml"
        n = rr.rinex2assist(path, xml)
        got.append(({p: _fields(e) for p, e in nav.items()},
                    _fields(iono), n, xml.read_text()))
    assert got[1] == got[0]
    assert len(got[1][0]) == 6 and got[1][2] == 6


def _sp3_case(pkg, tmp_path):
    """tests/test_preceph.py: an SP3 file from the broadcast orbits,
    written and read back, Neville interpolation, and 12 epochs of
    ``ppp.py`` given the precise ephemeris against corrupted broadcast
    clocks."""
    from dataclasses import replace

    eph = _m(pkg, "pvt.ephemeris")
    pre = _m(pkg, "pvt.preceph")
    ppp = _m(pkg, "pvt.ppp")
    coords = _m(pkg, "pvt.coords")
    const = _m(pkg, "simulate.constellation")
    ephs = const.make_constellation(seed=3)
    rx = coords.llh_to_ecef(np.deg2rad(41.275), np.deg2rad(1.9876), 80.0)
    tow = 7350.0
    vis = const.visible_sats(ephs, rx, tow)[:7]
    data = pre.Sp3Data(week=2200,
                       times=np.array([7200.0 + 300.0 * i
                                       for i in range(12)]))
    for prn in vis:
        pc = [eph.eph_to_pos_vel_clock(ephs[prn], t) for t in data.times]
        data.pos_m[("G", prn)] = np.array([p for p, _, _, _ in pc])
        data.clk_s[("G", prn)] = np.array([c for _, _, c, _ in pc])
    f = tmp_path / f"{pkg}.sp3"
    pre.write_sp3(f, data)
    pe = pre.PreciseEphemeris(pre.read_sp3(f))
    interp = [pe.sat_pos_clock("G", vis[0], t) for t in (7650.0, 8130.0)]
    bad = {p: replace(ephs[p], af0=ephs[p].af0 + 1.7e-8 * p) for p in vis}
    f1, f2 = 1575.42e6, 1176.45e6
    l1, l2 = eph.C_LIGHT / f1, eph.C_LIGHT / f2
    eng = ppp.PppEngine(mode="static")
    sols = []
    for k in range(12):
        t = tow + k
        obs = []
        for prn in vis:
            tau = 0.075
            for _ in range(3):
                sp, _, dts, _ = eph.eph_to_pos_vel_clock(ephs[prn], t - tau)
                th = eph.OMEGA_E * tau
                rot = np.array([[np.cos(th), np.sin(th), 0.0],
                                [-np.sin(th), np.cos(th), 0.0],
                                [0.0, 0.0, 1.0]])
                sp_r = rot @ sp
                tau = np.linalg.norm(sp_r - rx) / eph.C_LIGHT
            rho = float(np.linalg.norm(sp_r - rx))
            clk = 8.0 - eph.C_LIGHT * dts
            obs.append(ppp.DualFreqObs(
                system="G", prn=prn, p1_m=rho + clk, p2_m=rho + clk,
                phi1_cycles=(-rho - clk) / l1, phi2_cycles=(-rho - clk) / l2,
                f1_hz=f1, f2_hz=f2))
        sol = eng.process_epoch(t, obs, {("G", p): bad[p] for p in vis},
                                x0=rx + 10.0, precise=pe)
        sols.append(sol.pos_ecef.tolist())
    return (f.read_bytes(), [(p.tolist(), c) for p, c in interp], sols,
            float(np.linalg.norm(np.asarray(sols[-1]) - rx)))


def test_sp3_and_precise_ppp_match_jax(tmp_path):
    (fj, ij, sj, _), (ft, it, st, err) = [_sp3_case(pkg, tmp_path)
                                          for pkg in PKGS]
    assert ft == fj and it == ij and st == sj
    assert err < 5.0


# ------------------------------------------------- protobuf, UDP sinks
def _synchro(pkg):
    return _m(pkg, "monitor.synchro").GnssSynchro(
        system="E", signal="1B", prn=19, channel_id=3,
        acq_delay_samples=512.25, acq_doppler_hz=-1250.0,
        acq_samplestamp_samples=1234567, fs_hz=4.0e6,
        prompt_i=101.5, prompt_q=-3.25, cn0_db_hz=44.7,
        carrier_doppler_hz=-1248.8, carrier_phase_rads=2.5,
        code_phase_samples=511.75, tracking_sample_counter=99999999,
        flag_valid_symbol_output=True, correlation_length_ms=4,
        flag_valid_word=True, tow_at_current_symbol_ms=7314000,
        pseudorange_m=22123456.789, rx_time_s=7314.08,
        flag_valid_pseudorange=True, interp_tow_ms=7313999.5)


class _Sol:
    tow_s = 7314.2
    pos_ecef = (4027892.1, 307045.9, 4919478.5)
    vel_ecef = (0.1, -0.2, 0.05)
    lat_rad = 0.8863
    lon_rad = 0.0761
    height_m = 181.5
    clock_bias_s = 1.3e-4
    num_sats = 8
    gdop = 2.1
    pdop = 1.8
    hdop = 1.0
    vdop = 1.5


def test_protobuf_wire_bytes_match_jax():
    def wire(pkg):
        pb = _m(pkg, "monitor.protobuf")
        s = _synchro(pkg)
        return (pb.encode_gnss_synchro(s), pb.encode_observables([s, s]),
                pb.encode_monitor_pvt_pb(_Sol(), week=2345),
                pb.encode_message(pb.GNSS_SYNCHRO_FIELDS,
                                  {"channel_id": -5}))

    j, t = _both(wire)
    assert t == j
    pb = _m("gnss_sdr_tpu_torch", "monitor.protobuf")
    assert pb.decode_gnss_synchro(t[0])["prn"] == 19
    assert pb.decode_gnss_synchro(t[3])["channel_id"] == -5


def test_udp_sinks_round_trip_on_localhost():
    """The port's GnssSynchroMonitor (binary and protobuf modes) and
    MonitorPvtUdpSink send to a localhost socket; what arrives equals
    what the JAX package's encoders make."""
    from gnss_sdr_tpu.monitor import encode_synchro as j_encode
    from gnss_sdr_tpu.monitor.protobuf import encode_gnss_synchro
    from gnss_sdr_tpu.monitor.sinks import encode_monitor_pvt
    from gnss_sdr_tpu_torch.monitor import (
        GnssSynchroMonitor,
        MonitorPvtUdpSink,
        decode_monitor_pvt,
    )

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2.0)
    dest = [("127.0.0.1", rx.getsockname()[1])]
    s_t, s_j = _synchro("gnss_sdr_tpu_torch"), _synchro("gnss_sdr_tpu")
    try:
        for mode, want in (("binary", j_encode(s_j)),
                           ("protobuf", encode_gnss_synchro(s_j))):
            mon = GnssSynchroMonitor(dest, mode=mode)
            mon.push(s_t)
            mon.close()
            assert rx.recv(4096) == want, mode
        sink = MonitorPvtUdpSink(dest, week=2340)
        sink.push(_Sol())
        sink.close()
        got = rx.recv(4096)
    finally:
        rx.close()
    assert got == encode_monitor_pvt(_Sol(), week=2340)
    assert decode_monitor_pvt(got)["num_sats"] == 8


# ------------------------------------------------------------------ tools
def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_skyplot_matches_root_tool(tmp_path, capsys):
    """The port's skyplot on an assistance XML prints and draws what the
    root tool does (the root tool reads through the JAX package)."""
    from gnss_sdr_tpu_torch.receiver.assistance import save_assistance
    from gnss_sdr_tpu_torch.simulate.constellation import make_constellation
    from gnss_sdr_tpu_torch.tools import skyplot

    xml = tmp_path / "assist.xml"
    save_assistance(xml, {("G", p): e
                          for p, e in make_constellation(seed=2).items()})
    outs = []
    for i, main in enumerate((_root_tool("skyplot").main, skyplot.main)):
        svg = tmp_path / f"sky{i}.svg"
        assert main(["--assistance", str(xml), "--lat", "41.27", "--lon",
                     "1.99", "--h", "80", "--tow", "7314",
                     "--out", str(svg)]) == 0
        outs.append((capsys.readouterr().out.replace(str(svg), "SVG"),
                     svg.read_text()))
    assert outs[1] == outs[0]
    assert outs[1][0].count(" az ") >= 4


def test_nav_listener_prints_the_channel_table():
    """The port's nav_listener, as a process on a localhost port, prints
    the channel table of the synchro records a sink sends it."""
    from gnss_sdr_tpu_torch.monitor import GnssSynchroMonitor

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "gnss_sdr_tpu_torch.tools.nav_listener",
         "--port", str(port), "--interval", "0.1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        assert proc.stdout.readline().startswith(f"listening on udp/{port}")
        mon = GnssSynchroMonitor([("127.0.0.1", port)])
        lines = []
        deadline = time.time() + 20.0
        while time.time() < deadline and not any(
                "E  19" in ln for ln in lines):
            mon.push(_synchro("gnss_sdr_tpu_torch"))
            lines.append(proc.stdout.readline())
        mon.close()
    finally:
        proc.kill()
        proc.communicate(timeout=10)
    row = next(ln for ln in lines if "E  19" in ln)
    assert row.split()[:4] == ["3", "E", "19", "44.7"]
