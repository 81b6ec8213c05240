"""The CLI's control plane and the tools that drive it, through the port
against the JAX package, on the CPU.

- Assistance XML: a file written by one package loads in the other with
  the same ephemerides and iono/UTC (GPS and Galileo); the Gnss_Synchro
  map XML likewise; the A-GNSS server of one package serves the other's
  client.
- SUPL: the SET's ULP messages encode to the same bytes in both
  packages, and a session against a scripted SLP (its RRLP assistance
  built by the JAX encoder) gives equal assistance and sends equal bytes.
- Telecommand: the TCP server and the command FIFO drive the port's
  Receiver; ``status`` reads only host state and equals the JAX server's
  text; a ``reset`` stops the channels, and a channel restarted after it
  tracks as a fresh one does.
- The CLI builds the same ReceiverConfig as the JAX CLI from a conf with
  the PVT Kalman filter, PPP_Static, earth_tide=2 and a BLQ table.
- Tools: ``front_end_cal.calibrate`` finds the same satellites, Doppler
  and LO offset as the JAX tool; ``bench_micro`` gives the JAX tool's
  rows; the tools raise without a card unless the CPU is asked for.
"""

import dataclasses
import importlib.util
import os
import socket
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gnss_sdr_tpu import main as jmain
from gnss_sdr_tpu.config.configuration import (
    FileConfiguration as JFileConfiguration,
)
from gnss_sdr_tpu.monitor.synchro import GnssSynchro as JGnssSynchro
from gnss_sdr_tpu.receiver import agnss as jagnss
from gnss_sdr_tpu.receiver import assistance as jassist
from gnss_sdr_tpu.receiver import supl as jsupl
from gnss_sdr_tpu.receiver.telecommand import TcpCmdServer as JTcpCmdServer
from gnss_sdr_tpu.simulate.constellation import make_constellation
from gnss_sdr_tpu.simulate.galileo import make_galileo_constellation
from gnss_sdr_tpu.simulate.scenario import GpsScenario, ScenarioConfig
from gnss_sdr_tpu.telemetry.lnav import GpsIonoUtc as JGpsIonoUtc
from gnss_sdr_tpu_torch import main as tmain
from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
from gnss_sdr_tpu_torch.monitor.synchro import GnssSynchro
from gnss_sdr_tpu_torch.receiver import agnss as tagnss
from gnss_sdr_tpu_torch.receiver import assistance as tassist
from gnss_sdr_tpu_torch.receiver import supl as tsupl
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.receiver.telecommand import (
    FifoCmdReader,
    TcpCmdServer,
    dispatch_command,
)
from gnss_sdr_tpu_torch.telemetry.lnav import GpsIonoUtc
from gnss_sdr_tpu_torch.tools import bench_micro, front_end_cal, ttff

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FS = 2.6e6
PKGS = {"jax": (jassist, jagnss), "port": (tassist, tagnss)}
DIRECTIONS = [("jax", "port"), ("port", "jax")]
EPH_FIELDS = ("prn", "sqrt_a", "m0", "af0", "toe", "ecc", "omega0", "week")


def _same_ephemerides(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, eph in want.items():
        for f in EPH_FIELDS:
            if hasattr(eph, f):
                assert getattr(got[k], f) == getattr(eph, f), (k, f)


# ------------------------------------------------------------ assistance
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_assistance_round_trip(tmp_path, writer, reader):
    """tests/test_aux.py::test_assistance_round_trip across packages."""
    ephs = make_constellation(seed=2)
    store = {("G", p): e for p, e in list(ephs.items())[:6]}
    iono = JGpsIonoUtc if writer == "jax" else GpsIonoUtc
    iu = iono(alpha0=1e-8, beta0=96256.0, delta_t_ls=18, has_iono=True,
              has_utc=True)
    path = tmp_path / "assist.xml"
    PKGS[writer][0].save_assistance(path, store, iono_utc=iu)
    data = PKGS[reader][0].load_assistance(path)
    _same_ephemerides(data["ephemerides"], store)
    assert type(data["iono_utc"]).__module__.startswith(
        "gnss_sdr_tpu_torch" if reader == "port" else "gnss_sdr_tpu.")
    assert data["iono_utc"].delta_t_ls == 18 and data["iono_utc"].has_iono
    assert data["iono_utc"].alpha0 == 1e-8


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_assistance_galileo_round_trip(tmp_path, writer, reader):
    ephs = make_galileo_constellation(seed=2)
    store = {("E", p): e for p, e in list(ephs.items())[:3]}
    path = tmp_path / "assist.xml"
    PKGS[writer][0].save_assistance(path, store)
    data = PKGS[reader][0].load_assistance(path)
    _same_ephemerides(data["ephemerides"], store)
    assert all(e.system == "E" for e in data["ephemerides"].values())


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_gnss_synchro_map_xml_round_trip(tmp_path, writer, reader):
    """tests/test_aux.py::test_gnss_synchro_map_xml_round_trip across
    packages: the reloaded records equal the written ones field for
    field."""
    cls = JGnssSynchro if writer == "jax" else GnssSynchro
    m = {
        0: cls(system="G", signal="1C", prn=12, channel_id=0,
               pseudorange_m=21_234_567.89, cn0_db_hz=44.5,
               carrier_doppler_hz=-1234.5, flag_valid_pseudorange=True,
               tow_at_current_symbol_ms=345_600_000),
        3: cls(system="E", signal="1B", prn=5, channel_id=3,
               pseudorange_m=24_111_222.33, rx_time_s=12.34),
    }
    p = tmp_path / "epoch.xml"
    PKGS[writer][0].save_gnss_synchro_map_xml(p, m)
    back = PKGS[reader][0].load_gnss_synchro_map_xml(p)
    assert set(back) == {0, 3}
    for k, rec in m.items():
        assert dataclasses.asdict(back[k]) == dataclasses.asdict(rec)


@pytest.mark.parametrize("server,client", DIRECTIONS)
def test_agnss_server_round_trip(tmp_path, server, client):
    """tests/test_aux.py::test_agnss_server_round_trip across packages."""
    ephs = make_constellation(seed=5)
    path = tmp_path / "assist.xml"
    PKGS[server][0].save_assistance(path, {("G", p): e
                                           for p, e in ephs.items()})
    srv = PKGS[server][1].AgnssServer(port=0)
    try:
        srv.set_assistance_file(path)
        data = PKGS[client][1].fetch_assistance("127.0.0.1", srv.port)
    finally:
        srv.close()
    _same_ephemerides(data["ephemerides"],
                      {("G", p): e for p, e in ephs.items()})


# ------------------------------------------------------------------ SUPL
def test_supl_messages_encode_alike():
    """tests/test_supl.py::test_self_roundtrip_all_messages: the SET's
    messages equal the JAX client's bytes and round-trip in the port."""
    cfg = dict(mcc=244, mnc=5, lac=0x59E2, ci=0x31D2, request=1)
    j = jsupl.SuplClient(jsupl.SuplConfig(**cfg))
    t = tsupl.SuplClient(tsupl.SuplConfig(**cfg))
    for name in ("make_start", "make_pos_init", "make_end"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert t.make_rrlp_ack(3) == j.make_rrlp_ack(3)
    for b in (t.make_start(), t.make_pos_init(), t.make_rrlp_ack(0),
              t.make_end()):
        d = tsupl.decode_ulp(b)
        assert tsupl.encode_ulp({k: v for k, v in d.items()
                                 if k != "length"}) == b


def _golden_rrlp() -> bytes:
    """RRLP assistance data with the values of tests/oracle's golden
    message (reference time 98765.36 s of week 345, PRN 7's navigation
    model, an ionospheric model), encoded by the JAX encoder."""
    eph = {"ephemCodeOnL2": 1, "ephemURA": 2, "ephemSVhealth": 0,
           "ephemIODC": 321, "ephemL2Pflag": 0,
           "ephemSF1Rsvd": {"reserved1": 0, "reserved2": 0,
                            "reserved3": 0, "reserved4": 0},
           "ephemTgd": -3, "ephemToc": 6300, "ephemAF2": 0,
           "ephemAF1": -12, "ephemAF0": 123456, "ephemCrs": 251,
           "ephemDeltaN": 11500, "ephemM0": 1234567890, "ephemCuc": -500,
           "ephemE": 40000000, "ephemCus": 3000,
           "ephemAPowerHalf": 2702000000, "ephemToe": 6300,
           "ephemFitFlag": 0, "ephemAODA": 0, "ephemCic": 20,
           "ephemOmegaA0": -987654321, "ephemCis": -30,
           "ephemI0": 654321987, "ephemCrc": 7000, "ephemW": 123123123,
           "ephemOmegaADot": -22000, "ephemIDot": 100}
    iono = dict(alfa0=10, alfa1=1, alfa2=-1, alfa3=0,
                beta0=80, beta1=-21, beta2=-64, beta3=64)
    header = {"referenceTime": {"gpsTime": {"gpsTOW23b": 1234567,
                                            "gpsWeek": 345},
                                "gsmTime": None, "gpsTowAssist": None},
              "refLocation": None, "dgpsCorrections": None,
              "navigationModel": {"navModelList": [
                  {"satelliteID": 6,
                   "satStatus": ("newSatelliteAndModelUC", eph)}]},
              "ionosphericModel": iono, "utcModel": None, "almanac": None,
              "acquisAssist": None, "realTimeIntegrity": None}
    return jsupl.encode_rrlp({
        "referenceNumber": 2,
        "component": ("assistanceData", {
            "gps-AssistData": {"controlHeader": header},
            "moreAssDataToBeSent": "noMoreMessages"})})


class _MockSlp:
    """tests/test_supl.py's scripted SLP: RESPONSE, one assistance POS
    (more), one final POS, then END; its messages encoded by the JAX
    codecs."""

    def __init__(self, golden: bytes):
        self.golden = golden
        self.sent: list[bytes] = []
        self._step = 0

    def send(self, data: bytes) -> None:
        self.sent.append(data)

    def recv(self) -> bytes:
        self._step += 1
        sid = {"setSessionID": {"sessionId": 1,
                                "setId": ("imsi", b"\x09" * 8)},
               "slpSessionID": {
                   "sessionID": b"\x00\x00\x00\x07",
                   "slpId": ("iPAddress",
                             ("ipv4Address", b"\x7f\x00\x00\x01"))}}
        ver = {"maj": 1, "min": 0, "servind": 0}
        if self._step == 1:
            msg = ("msSUPLRESPONSE", {
                "posMethod": "agpsSETbased", "sLPAddress": None,
                "sETAuthKey": None, "keyIdentity4": None})
        elif self._step in (2, 3):
            payload = self.golden
            if self._step == 2:
                rrlp = jsupl.decode_rrlp(self.golden)
                rrlp["component"][1]["moreAssDataToBeSent"] = (
                    "moreMessagesOnTheWay")
                payload = jsupl.encode_rrlp(rrlp)
            msg = ("msSUPLPOS", {"posPayLoad": ("rrlpPayload", payload),
                                 "velocity": None})
        else:
            msg = ("msSUPLEND", {"position": None, "statusCode": None,
                                 "ver": None})
        return jsupl.encode_ulp({"version": ver, "sessionID": sid,
                                 "message": msg})


def test_supl_session_matches_jax():
    """tests/test_supl.py::test_full_session_flow through both clients:
    the same messages sent (START, POSINIT, ACK, END, byte for byte) and
    the same assistance."""
    golden = _golden_rrlp()
    out = {}
    for name, mod in (("jax", jsupl), ("port", tsupl)):
        slp = _MockSlp(golden)
        client = mod.SuplClient(mod.SuplConfig(request=1), transport=slp)
        out[name] = (client.get_assistance(), slp.sent)
    (ja, jsent), (ta, tsent) = out["jax"], out["port"]
    assert tsent == jsent
    assert [tsupl.decode_ulp(b)["message"][0] for b in tsent] == [
        "msSUPLSTART", "msSUPLPOSINIT", "msSUPLPOS", "msSUPLEND"]
    assert tsupl.decode_ulp(tsent[1])["sessionID"]["slpSessionID"]
    _same_ephemerides(ta["ephemerides"], ja["ephemerides"])
    eph = ta["ephemerides"][("G", 7)]
    assert eph.iodc == 321
    assert eph.sqrt_a == pytest.approx(2702000000 * 2.0 ** -19)
    assert ta["iono"].alpha == ja["iono"].alpha
    assert ta["iono"].beta == ja["iono"].beta
    assert ta["ref_time"] == ja["ref_time"] == pytest.approx((98765.36, 345))


# ----------------------------------------------------------- telecommand
def _receiver(n=2):
    return Receiver(ReceiverConfig(fs=FS, num_channels=n, device="cpu"))


def test_telecommand_server():
    """tests/test_aux.py::test_telecommand_server on the port's Receiver;
    the status text is the one the JAX server renders from the same
    receiver's host state (channel controls, PRNs, fixes)."""
    rx = _receiver()
    rx.groups[0].channel_prn[1] = 7
    rx.groups[0].tracker.ctl[1].cn0_dbhz = 43.2
    srv = TcpCmdServer(rx, port=0)
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=5) as c:
            assert b"telecommand" in c.recv(128)
            c.sendall(b"status\n")
            time.sleep(0.1)
            reply = c.recv(4096).decode()
            assert "channel" in reply and "fix: none" in reply
            assert reply == JTcpCmdServer._status_text(
                SimpleNamespace(receiver=rx))
            assert ["1", "1C", "7", "IDLE", "43.2"] in [
                ln.split() for ln in reply.splitlines()]
            c.sendall(b"coldstart\n")
            time.sleep(0.1)
            assert b"OK" in c.recv(128)
            c.sendall(b"bogus\n")
            time.sleep(0.1)
            assert b"ERROR" in c.recv(128)
        assert srv.apply_pending() == ["coldstart"]
    finally:
        srv.close()
    assert rx.groups[0].channel_prn == [0, 0] and not rx.ephemerides


def test_fifo_command_reader(tmp_path):
    """tests/test_aux.py::test_fifo_command_reader on the port's
    Receiver."""
    rx = _receiver()
    rx.ephemerides[("G", 3)] = object()
    path = str(tmp_path / "cmd.fifo")
    rd = FifoCmdReader(rx, path)
    try:
        assert os.path.exists(path)
        fd = os.open(path, os.O_WRONLY)
        os.write(fd, b"coldstart\nbogus\nstatus\n")
        os.close(fd)
        deadline = time.time() + 5.0
        applied = []
        while time.time() < deadline and len(applied) < 2:
            applied += rd.apply_pending()
            time.sleep(0.02)
        assert applied == ["coldstart", "status"]
    finally:
        rd.close()
    assert not os.path.exists(path)
    assert not rx.ephemerides


def test_reset_leaves_channels_restartable():
    """A ``reset`` between blocks stops every channel (IDLE, PRNs and
    decoders cleared); a channel started again after it tracks the next
    block as a channel started on a fresh tracker does, bit for bit: the
    stop leaves no state the restart does not set."""
    scen = GpsScenario(ScenarioConfig(fs=FS, tow_start_s=7314.0,
                                      duration_s=0.1, cn0_dbhz=46.0,
                                      max_sats=2, seed=1))
    x = scen.generate(0, int(0.06 * FS))
    prn = scen.prns[0]
    start = dict(acq_delay_samples=37.0,
                 acq_doppler_hz=scen.truth_at(prn, 0.0)["doppler_hz"],
                 acq_samplestamp=0, current_abs_sample=0)
    rx = _receiver()
    g = rx.groups[0]
    g.tracker.start_channel(0, prn, prn - 1, **start)
    g.channel_prn[0] = prn
    g.decoders[prn] = g.plan.make_decoder(prn)
    w = x[:g.plan.trk_conf.window_samples]
    g.tracker.process(w, 0)
    dispatch_command(rx, "reset")
    assert g.active_channels() == [] and g.channel_prn == [0, 0]
    assert not g.decoders
    g.tracker.start_channel(0, prn, prn - 1, **start)
    again = g.tracker.process(w, 0)
    fresh = _receiver().groups[0].tracker
    fresh.start_channel(0, prn, prn - 1, **start)
    want = fresh.process(w, 0)
    for k, v in want.outputs.items():      # channel 1 was never started
        np.testing.assert_array_equal(again.outputs[k][:, 0], v[:, 0],
                                      err_msg=k)
    np.testing.assert_array_equal(again.abs_sample_end[:, 0],
                                  want.abs_sample_end[:, 0])


# ------------------------------------------------------------------- CLI
BLQ = """$$ Ocean loading displacement
$$ COMMENT
  WTZR
$$ M2 S2 N2 K2 K1 O1 P1 Q1 MF MM SSA
  .00325 .00112 .00069 .00031 .00117 .00087 .00039 .00017 .00009 .00005 .00004
  .00103 .00036 .00023 .00010 .00026 .00013 .00009 .00003 .00002 .00001 .00001
  .00049 .00017 .00011 .00005 .00052 .00039 .00017 .00008 .00003 .00002 .00001
   -54.3  -27.9  -74.0  -25.5  -58.9  -96.0  -60.8 -131.0    6.1    3.4    1.9
    72.5  105.1   52.1  106.5   43.0   27.0   41.7   17.9 -170.8 -176.3 -179.4
    88.0  118.8   68.7  119.5  -27.4  -54.1  -29.0  -79.7    6.6    1.7    0.8
"""


class _Built(Exception):
    """Raised by a stand-in Receiver once the CLI has built its config."""


def test_cli_builds_receiver_config_as_jax(tmp_path, monkeypatch):
    """``run_from_config(..., device="cpu")`` builds the JAX CLI's
    ReceiverConfig from a conf with PVT.enable_pvt_kf, PPP_Static,
    earth_tide=2, phwindup and PVT.blq_file: every field equal, the
    station's (11, 6) BLQ table included."""
    blq = tmp_path / "ocean.blq"
    blq.write_text(BLQ)
    cap = tmp_path / "cap.dat"
    cap.write_bytes(bytes(20000))
    conf = tmp_path / "rx.conf"
    conf.write_text(f"""[GNSS-SDR]
GNSS-SDR.internal_fs_sps={int(FS)}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={cap}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency={int(FS)}
SignalConditioner.implementation=Pass_Through
Channels_1C.count=4
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
PVT.implementation=RTKLIB_PVT
PVT.enable_pvt_kf=true
PVT.positioning_mode=PPP_Static
PVT.earth_tide=2
PVT.phwindup=true
PVT.blq_file={blq}
PVT.blq_station=WTZR
""")
    cfgs = {}
    for name, mod, make in (("jax", jmain, JFileConfiguration),
                            ("port", tmain, FileConfiguration)):
        def stand_in(cfg, plans=None, _name=name):
            cfgs[_name] = cfg
            raise _Built

        monkeypatch.setattr(mod, "Receiver", stand_in)
        kw = {"device": "cpu"} if name == "port" else {}
        with pytest.raises(_Built):
            mod.run_from_config(make(conf), **kw)
    j = dataclasses.asdict(cfgs["jax"])
    t = dataclasses.asdict(cfgs["port"])
    assert t.pop("device") == "cpu"
    jb, tb = j.pop("blq"), t.pop("blq")
    assert t == j
    assert tb.shape == (11, 6)
    np.testing.assert_array_equal(tb, jb)
    assert (t["enable_pvt_kf"], t["positioning_mode"], t["earth_tide"],
            t["phwindup"]) == (True, "PPP_Static", 2, True)


# ----------------------------------------------------------------- tools
def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_front_end_cal_matches_jax():
    """tests/test_aux.py::test_front_end_cal_estimates_lo_offset's case
    (0.12 s, a 3210 Hz LO error) through both tools: the same satellites
    and Doppler, the same fit, within 60 Hz of the error."""
    scen = GpsScenario(ScenarioConfig(fs=FS, tow_start_s=7314.0,
                                      duration_s=0.2, cn0_dbhz=46.0,
                                      max_sats=8, seed=2))
    x = scen.generate(0, int(0.12 * FS))
    t = np.arange(len(x)) / FS
    x = (x * np.exp(2j * np.pi * 3210.0 * t)).astype(np.complex64)
    want = _jax_tool("front_end_cal").calibrate(x, FS, scen.ephs,
                                                scen.rx_ecef, 7314.0)
    got = front_end_cal.calibrate(x, FS, scen.ephs, scen.rx_ecef, 7314.0,
                                  device="cpu")
    assert got["ok"] and want["ok"]
    assert [r[0] for r in got["rows"]] == [r[0] for r in want["rows"]]
    np.testing.assert_allclose([r[1:] for r in got["rows"]],
                               [r[1:] for r in want["rows"]], atol=1e-6)
    assert got["f_offset_hz"] == pytest.approx(want["f_offset_hz"],
                                               abs=1e-6)
    assert abs(got["f_offset_hz"] - 3210.0) < 60.0
    assert got["resid_rms_hz"] < 60.0


def test_bench_micro_rows_match_jax(capsys):
    """The port's bench_micro gives the JAX tool's rows (names and
    units), each with a positive value, and its detector the peak
    statistic NumPy computes."""
    jtool = _jax_tool("bench_micro")
    want = [(r["bench"], r["unit"]) for b in jtool.ALL for r in b(1)]
    rows = bench_micro.run(reps=1, device="cpu")
    assert [(r["bench"], r["unit"]) for r in rows] == want
    assert len({b.__name__ for b in bench_micro.ALL}) == 7
    assert all(r["value"] > 0 for r in rows)
    grid = np.abs(np.random.default_rng(2).standard_normal(
        (3, 5, 16))).astype(np.float32)
    idx, stat = bench_micro.detect(torch.as_tensor(grid))
    flat = grid.reshape(3, -1)
    np.testing.assert_array_equal(idx.numpy(), flat.argmax(axis=1))
    np.testing.assert_allclose(stat.numpy(),
                               flat.max(axis=1) / flat.mean(axis=1),
                               rtol=1e-6)
    assert len(capsys.readouterr().out.splitlines()) == len(want)


def test_tools_raise_without_cuda():
    """front_end_cal, ttff and bench_micro default to the card and raise
    without one; the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.zeros(int(FS * 0.01), np.complex64)
    for make in (lambda: front_end_cal.calibrate(x, FS, {}, np.zeros(3),
                                                 0.0),
                 lambda: ttff.run_trial(1, 3.0, warm=True),
                 lambda: ttff.main(["--trials", "1"]),
                 lambda: bench_micro.run(reps=1),
                 lambda: bench_micro.main(["--reps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert ttff.main(["--trials", "0", "--device", "cpu"]) == 0
