"""The port's .conf/CLI path against the JAX package's.

One 3 s ``ibyte`` capture (the scenario of tests/test_main_cli.py, cached
through ``cached_capture``) goes through the JAX ``run_from_config`` and
the port's ``run_from_config(..., device="cpu")`` from the same .conf
file. Both must acquire the same satellites with equal Doppler, delays
within one sample, and leave every satellite's channel in the same
tracking phase. The file also holds the port's CLI flag overrides, its
conditioner adapters (bit for bit against the JAX adapters), every input
filter and resampler and the SignalGenerator source (against the JAX
factory's), 0.4 s through both CLIs with conf/gps_l1_gaussian.conf's keys,
the KF tracking and a Freq_Xlating_Fir_Filter, the plans its factory
builds from conf/gps_l1_file.conf and conf/dual_band_gps_gal.conf (field
by field against the JAX factory's) and each control-plane key (the
assistance XML, SUPL, the telecommand server, the command FIFO, the BLQ
table) on 0.5 s of the capture.
"""

import argparse
import dataclasses
import os
import socket
import stat
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import cached_capture
from gnss_sdr_tpu import main as jmain
from gnss_sdr_tpu.conditioner.adapters import ADAPTERS as J_ADAPTERS
from gnss_sdr_tpu.config.configuration import (
    FileConfiguration as JFileConfiguration,
    InMemoryConfiguration as JInMemoryConfiguration,
)
from gnss_sdr_tpu.io import encode_samples
from gnss_sdr_tpu.receiver.factory import (
    get_signal_conditioner as j_conditioner,
    get_signal_plans as j_plans,
    get_signal_source as j_source,
)
from gnss_sdr_tpu.simulate.scenario import GpsScenario, ScenarioConfig
from gnss_sdr_tpu_torch import main as tmain
from gnss_sdr_tpu_torch.conditioner import (
    ADAPTERS as T_ADAPTERS,
    ConditionerConfig,
    SignalConditioner,
)
from gnss_sdr_tpu_torch.config.configuration import (
    FileConfiguration,
    InMemoryConfiguration,
)
from gnss_sdr_tpu_torch.receiver.factory import (
    get_signal_conditioner,
    get_signal_plans,
    get_signal_source,
)
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

from torch_cases import assert_plans_equal

torch.set_num_threads(2)

FS = 2.6e6
ROOT = Path(__file__).resolve().parent.parent


def _capture() -> np.ndarray:
    scen = GpsScenario(ScenarioConfig(
        fs=FS, tow_start_s=7314.0, duration_s=3.0, cn0_dbhz=47.0,
        max_sats=5, seed=1))
    n = int(3.0 * FS)
    return np.concatenate([scen.generate(s, min(1 << 18, n - s))
                           for s in range(0, n, 1 << 18)])


@pytest.fixture(scope="module")
def conf_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    x = cached_capture("torch_main_cli_gps5_3s", _capture)
    cap = d / "cap.dat"
    # scale to int8 range: noise sigma ~= 22 counts
    cap.write_bytes(encode_samples(np.round(x * 16), "ibyte"))
    conf = d / "rx.conf"
    conf.write_text(f"""
[GNSS-SDR]
GNSS-SDR.internal_fs_sps={int(FS)}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={cap}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency={int(FS)}
SignalConditioner.implementation=Signal_Conditioner
DataTypeAdapter.implementation=Ibyte_To_Complex
InputFilter.implementation=Pass_Through
Resampler.implementation=Pass_Through
Channels_1C.count=5
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.doppler_max=5000
Acquisition_1C.doppler_step=250
Acquisition_1C.max_dwells=2
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Tracking_1C.extend_correlation_symbols=20
Tracking_1C.enable_fll_pull_in=true
PVT.implementation=RTKLIB_PVT
PVT.display_rate_ms=1000
""")
    return conf


def _capturing(monkeypatch, module):
    """Record the Receiver that ``module.run_from_config`` builds."""
    made = []
    cls = module.Receiver

    def make(*a, **k):
        made.append(cls(*a, **k))
        return made[-1]

    monkeypatch.setattr(module, "Receiver", make)
    return made


def _phases(rx) -> dict:
    return {prn: int(g.tracker.ctl[ch].phase)
            for g in rx.groups for ch, prn in enumerate(g.channel_prn)
            if prn}


def test_run_from_config_matches_jax(conf_file, monkeypatch, capsys):
    j_made = _capturing(monkeypatch, jmain)
    t_made = _capturing(monkeypatch, tmain)
    js = jmain.run_from_config(JFileConfiguration(conf_file))
    ts = tmain.run_from_config(FileConfiguration(conf_file), device="cpu")
    assert len(js.acquired) >= 4
    assert set(ts.acquired) == set(js.acquired)
    for key, (dop, delay) in js.acquired.items():
        t_dop, t_delay = ts.acquired[key]
        assert t_dop == pytest.approx(dop, abs=1e-6), key
        assert abs(t_delay - delay) <= 1.0, key
    j_ph, t_ph = _phases(j_made[0]), _phases(t_made[0])
    assert t_ph == j_ph
    assert t_made[0]._idle_channel() == j_made[0]._idle_channel()
    # the channel-status table printed from the port's tracker state
    assert "channel status" in capsys.readouterr().out


_ALT_KEYS = {
    # conf/gps_l1_gaussian.conf's keys (below) on the capture
    "gaussian": {},
    "kf": {"Tracking_1C.implementation": "GPS_L1_CA_KF_Tracking"},
    # the capture moved to an IF of +250 kHz, brought back by the filter
    "freq_xlating": {"InputFilter.implementation": "Freq_Xlating_Fir_Filter",
                     "InputFilter.IF": "250000"},
    # the six channels sharded over two devices (two CPU shards in the
    # port, two of conftest's virtual devices in JAX)
    "num_devices": {"GNSS-SDR.num_devices": "2"},
}


@pytest.mark.parametrize("case", list(_ALT_KEYS))
def test_alternate_confs_match_jax(case, tmp_path, monkeypatch):
    """The slice as a whole: 0.4 s of this file's capture through both
    packages' run_from_config with conf/gps_l1_gaussian.conf's keys (the
    CKF loop closer), with GPS_L1_CA_KF_Tracking instead, with a
    Freq_Xlating_Fir_Filter on a copy moved to +250 kHz, and with
    ``GNSS-SDR.num_devices=2`` (a two-shard channel mesh). The first
    acquisitions are equal (Doppler, delays within one sample), and each
    channel ends in the same phase with its Doppler within 0.1 Hz."""
    fs = int(FS)
    x = cached_capture("torch_main_cli_gps5_3s", _capture)[:int(0.4 * FS)]
    if case == "freq_xlating":
        x = x * np.exp(2j * np.pi * 250e3 / FS * np.arange(x.size))
    cap = tmp_path / "capture_l1.dat"
    cap.write_bytes(encode_samples(np.round(x * 16), "ibyte"))
    keys = {"SignalSource.filename": str(cap),
            "SignalSource.sampling_frequency": str(fs),
            "PVT.display_rate_ms": "1000", **_ALT_KEYS[case]}
    j_made = _capturing(monkeypatch, jmain)
    t_made = _capturing(monkeypatch, tmain)
    cfgs = []
    for make in (JFileConfiguration, FileConfiguration):
        cfg = make(ROOT / "conf" / "gps_l1_gaussian.conf")
        for k, v in keys.items():
            cfg.set_property(k, v)
        cfgs.append(cfg)
    js = jmain.run_from_config(cfgs[0])
    ts = tmain.run_from_config(cfgs[1], device="cpu")
    assert len(js.acquired) >= 4
    assert ts.acquired.keys() == js.acquired.keys()
    for key, (dop, delay) in js.acquired.items():
        assert ts.acquired[key][0] == pytest.approx(dop, abs=1e-6), key
        assert abs(ts.acquired[key][1] - delay) <= 1.0, key
    (jg,), (tg,) = j_made[0].groups, t_made[0].groups
    assert tg.plan.trk_engine == jg.plan.trk_engine
    assert tg.plan.trk_conf.kf == (case == "kf")
    shards = 2 if case == "num_devices" else None
    assert (t_made[0].mesh and t_made[0].mesh.size) == shards
    assert (j_made[0].mesh and j_made[0].mesh.devices.size) == shards
    assert _phases(t_made[0]) == _phases(j_made[0])
    act = jg.tracker.active_channels()
    assert act == tg.tracker.active_channels() and act
    dj = np.asarray(jg.tracker.state.carrier_doppler)[act]
    dt = tg.tracker.state.carrier_doppler.numpy()[act]
    assert np.abs(dt - dj).max() < 0.1


def test_idle_channel():
    rx = Receiver(ReceiverConfig(fs=FS, num_channels=3, device="cpu"))
    assert rx._idle_channel() == 0
    g = rx.groups[0]
    for ch in range(2):
        g.tracker.start_channel(ch, prn=ch + 1, code_row=ch,
                                acq_delay_samples=0.0, acq_doppler_hz=0.0,
                                acq_samplestamp=0, current_abs_sample=0)
    assert rx._idle_channel() == 2
    g.tracker.start_channel(2, prn=3, code_row=2, acq_delay_samples=0.0,
                            acq_doppler_hz=0.0, acq_samplestamp=0,
                            current_abs_sample=0)
    assert rx._idle_channel() is None
    g.tracker.stop_channel(1)
    assert rx._idle_channel() == 1


def test_cli_flag_overrides():
    """tests/test_main_cli.py's case: CLI flags override config properties
    for every configured signal group."""
    ns = argparse.Namespace(
        doppler_max=8000, doppler_step=125, pll_bw_hz=25.0, dll_bw_hz=1.5,
        extend_correlation_ms=10, signal_source=None, s="/tmp/cap.dat",
        rinex_version="3.02")
    cfg = InMemoryConfiguration()
    cfg.set_property("Channels_1C.count", "4")
    cfg.set_property("Channels_1B.count", "2")
    tmain.apply_cli_flags(cfg, ns)
    assert cfg.property("Acquisition_1C.doppler_max", 0) == 8000
    assert cfg.property("Acquisition_1B.doppler_max", 0) == 8000
    assert cfg.property("Tracking_1C.extend_correlation_symbols", 0) == 10
    assert cfg.property("Tracking_1B.dll_bw_hz", 0.0) == 1.5
    assert cfg.property("SignalSource.filename", "") == "/tmp/cap.dat"
    assert cfg.property("PVT.rinex_version", "") == "3.02"


@pytest.mark.parametrize("fmt,dtype,shape", [
    ("ibyte", np.int8, (64,)), ("cbyte", np.int8, (64,)),
    ("ishort", np.int16, (64,)), ("cshort", np.int16, (32, 2)),
    ("byte", np.int8, (64,)), ("short", np.int16, (64,)),
    ("passthrough", np.complex64, (32,))])
def test_adapters_bit_exact(fmt, dtype, shape):
    rng = np.random.default_rng(3)
    if dtype == np.complex64:
        raw = (rng.normal(size=shape) + 1j * rng.normal(size=shape)
               ).astype(np.complex64)
    else:
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, info.max, size=shape, endpoint=True,
                           dtype=dtype)
    want = np.asarray(J_ADAPTERS[fmt](jnp.asarray(raw)))
    got = T_ADAPTERS[fmt](torch.as_tensor(raw)).numpy()
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got.view(np.float32),
                                  want.view(np.float32))
    cond = SignalConditioner(ConditionerConfig(input_format=fmt),
                             device="cpu")
    np.testing.assert_array_equal(cond.process(raw).view(np.float32),
                                  want.view(np.float32))


def test_factory_plans_match_jax():
    path = ROOT / "conf" / "gps_l1_file.conf"
    jp = j_plans(JFileConfiguration(path), FS)
    tp = get_signal_plans(FileConfiguration(path), FS)
    assert [p.name for p in tp] == [p.name for p in jp] == ["1C"]
    for a, b in zip(jp, tp):
        assert b.num_channels == a.num_channels
        assert b.search_prns == a.search_prns
        for conf in ("acq_conf", "trk_conf"):
            ja, ta = getattr(a, conf), getattr(b, conf)
            for f in dataclasses.fields(ja):
                assert getattr(ta, f.name) == getattr(ja, f.name), (
                    conf, f.name)


def _cfg(make=InMemoryConfiguration, **props):
    cfg = make()
    for k, v in props.items():
        cfg.set_property(k.replace("__", "."), str(v))
    return cfg


_FILTER_CASES = {
    "fir": dict(InputFilter__implementation="Fir_Filter"),
    "freq_xlating": dict(InputFilter__implementation="Freq_Xlating_Fir_Filter",
                         InputFilter__IF=250000,
                         InputFilter__decimation_factor=2),
    "notch": dict(InputFilter__implementation="Notch_Filter"),
    "notch_lite": dict(InputFilter__implementation="Notch_Filter_Lite"),
    "pulse_blanking": dict(InputFilter__implementation="Pulse_Blanking_Filter"),
    "beamformer": dict(InputFilter__implementation="Beamformer_Filter",
                       InputFilter__number_of_channels=4,
                       InputFilter__steer_deg=20.0),
    "direct": dict(Resampler__implementation="Direct_Resampler",
                   Resampler__sample_freq_out=2.6e6),
    "mmse": dict(Resampler__implementation="Mmse_Resampler",
                 Resampler__sample_freq_out=2.6e6),
}


@pytest.mark.parametrize("case", list(_FILTER_CASES))
def test_filters_match_jax(case):
    """Every InputFilter and Resampler implementation of the JAX factory
    builds in the port's: the same conditioner configuration (the
    beamformer: the same weights), and on two 9001-sample blocks of noise
    with a CW tone and pulses (4 elements for the beamformer) outputs of
    the same length within 1e-5 of the JAX output's largest sample. (These
    raised before the conditioner was ported.)"""
    props = dict(SignalSource__sampling_frequency=4e6, **_FILTER_CASES[case])
    jc = j_conditioner(_cfg(JInMemoryConfiguration, **props))
    tc = get_signal_conditioner(_cfg(**props), device="cpu")
    assert type(tc).__name__ == type(jc).__name__
    if case == "beamformer":
        np.testing.assert_array_equal(tc.beamformer.weights,
                                      jc.beamformer.weights)
    assert dataclasses.asdict(tc.cfg) == dataclasses.asdict(jc.cfg)
    rng = np.random.default_rng(4)
    shape = (4, 9001) if case == "beamformer" else (9001,)
    for _ in range(2):
        x = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
            np.complex64)
        x += 3.0 * np.exp(2j * np.pi * 0.11 * np.arange(shape[-1]))
        x[..., ::997] *= 40.0
        a, b = tc.process(x), jc.process(x)
        assert a.shape == b.shape and a.dtype == np.complex64
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_galileo_group_raises():
    """The two RF chains of conf/dual_band_gps_gal.conf (GPS L1 C/A on L1,
    Galileo E5a, group 5X, on L5), a GPS L5 group, and the groups of
    Galileo E5b (7X), QZSS L1 C/A and L5 (J1, J5), GLONASS L1 and L2 C/A
    (1G, 2G) and BeiDou B1I (B1): both factories build equal plans. (The
    name is from when the B1 group raised; tests/test_torch_last_plans.py
    holds the other groups of the last plans.)"""
    path = ROOT / "conf" / "dual_band_gps_gal.conf"
    rates = {"L1": 2.6e6, "L5": 10.4e6}
    jp = j_plans(JFileConfiguration(path), rates)
    tp = get_signal_plans(FileConfiguration(path), rates)
    assert [(p.name, p.band) for p in tp] == [(p.name, p.band) for p in jp]
    assert [(p.name, p.band) for p in tp] == [("1C", "L1"), ("5X", "L5")]
    for a, b in zip(jp, tp):
        assert_plans_equal(a, b)
    props = dict(Channels_L5__count=3, Acquisition_L5__doppler_max=3000,
                 Tracking_L5__pll_bw_hz=25.0)
    (ja,) = j_plans(_cfg(JInMemoryConfiguration, **props), {"L5": 10.23e6})
    (ta,) = get_signal_plans(_cfg(**props), {"L5": 10.23e6})
    assert_plans_equal(ja, ta)
    assert ta.acq_conf.doppler_max_hz == 3000.0
    for group, band, fs in (("7X", "E5b", 10.23e6), ("J1", "L1", 2.6e6),
                            ("J5", "L5", 10.23e6), ("1G", "G1", 3.6e6),
                            ("2G", "G2", 3.6e6)):
        props = {f"Channels_{group}__count": 2,
                 f"Tracking_{group}__pll_bw_hz": 25.0}
        jps = j_plans(_cfg(JInMemoryConfiguration, **props), {band: fs})
        tps = get_signal_plans(_cfg(**props), {band: fs})
        assert [(p.name, p.band) for p in tps] == [(group, band)]
        assert_plans_equal(jps[0], tps[0])
        assert tps[0].trk_conf.pll_bw_hz == 25.0
    props = dict(Channels_B1__count=2)
    (jb,) = j_plans(_cfg(JInMemoryConfiguration, **props), {"B1": 4e6})
    (tb,) = get_signal_plans(_cfg(**props), {"B1": 4e6})
    assert (tb.name, tb.band, tb.system) == ("B1", "B1", "C")
    assert_plans_equal(jb, tb)


def test_glonass_conf_runs(tmp_path, monkeypatch, capsys):
    """A conf of one RF chain and a Channels_1G group (reference-dialect
    keys, as chip_smoke.py's phase 25 writes them) on a 0.15 s ibyte copy
    of tests/test_glonass.py's scenario (3.6 Msps, seed 0). The JAX CLI
    refuses it: its RF chains feed the L1, L5 and B1 bands only (a
    deliberate difference, ROADMAP section 3). The port's runs it and
    starts the slots that the port's Receiver starts from Python on the
    same samples, at the same Dopplers and delays."""
    from gnss_sdr_tpu_torch.receiver.plans import glonass_l1_ca_plan
    from gnss_sdr_tpu_torch.simulate.glonass import (
        GlonassScenario,
        GlonassScenarioConfig,
    )

    fs = 3_600_000
    scen = GlonassScenario(GlonassScenarioConfig(
        fs=fs, tow_start_s=7335.0, duration_s=28.0, cn0_dbhz=46.0,
        max_sats=6, seed=0))
    raw = np.round(scen.generate(0, int(0.15 * fs)) * 16)
    cap = tmp_path / "capture_glo.dat"
    cap.write_bytes(encode_samples(raw, "ibyte"))
    conf = tmp_path / "glonass_l1_file.conf"
    conf.write_text(f"""
[GNSS-SDR]
GNSS-SDR.internal_fs_sps={fs}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={cap}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency={fs}
SignalConditioner.implementation=Signal_Conditioner
DataTypeAdapter.implementation=Ibyte_To_Complex
InputFilter.implementation=Pass_Through
Resampler.implementation=Pass_Through
Channels_1G.count=6
Acquisition_1G.implementation=GLONASS_L1_CA_PCPS_Acquisition
Acquisition_1G.doppler_max=5000
Acquisition_1G.doppler_step=250
Tracking_1G.implementation=GLONASS_L1_CA_DLL_PLL_Tracking
TelemetryDecoder_1G.implementation=GLONASS_L1_CA_Telemetry_Decoder
PVT.implementation=RTKLIB_PVT
PVT.display_rate_ms=1000
""")
    with pytest.raises(ValueError, match="needs band G1"):
        jmain.run_from_config(JFileConfiguration(conf))
    made = _capturing(monkeypatch, tmain)
    status = tmain.run_from_config(FileConfiguration(conf), device="cpu")
    (g,) = made[0].groups
    assert (g.plan.name, g.plan.band, g.plan.fs) == ("1G", "G1", fs)
    rx = Receiver(ReceiverConfig(fs=fs, num_channels=6, device="cpu"),
                  plans=[glonass_l1_ca_plan(fs, num_channels=6)])
    rx.feed(raw.astype(np.complex64))
    ref = rx.acquire()
    assert len(ref) == 4
    assert status.acquired == ref


def test_signal_generator_matches_jax():
    """SignalSource.implementation=SignalGenerator builds in both
    factories, and the two sources stream the same samples bit for bit
    (the port's copy of simulate/generator.py)."""
    props = dict(SignalSource__implementation="SignalGenerator",
                 SignalSource__sampling_frequency=2.6e6,
                 SignalSource__num_satellites=2, SignalSource__PRN_0=3,
                 SignalSource__PRN_1=17, SignalSource__doppler_Hz_1=-1500.0,
                 SignalSource__delay_chips_1=300.5,
                 SignalSource__duration_s=0.01, SignalSource__seed=5)
    js = j_source(_cfg(JInMemoryConfiguration, **props))
    ts = get_signal_source(_cfg(**props))
    for n in (10000, 20000):
        np.testing.assert_array_equal(ts.read(n), js.read(n))
    assert ts.exhausted() and js.exhausted()


BLQ = """$$ Ocean loading displacement
  WTZR
$$ M2 S2 N2 K2 K1 O1 P1 Q1 MF MM SSA
  .00325 .00112 .00069 .00031 .00117 .00087 .00039 .00017 .00009 .00005 .00004
  .00103 .00036 .00023 .00010 .00026 .00013 .00009 .00003 .00002 .00001 .00001
  .00049 .00017 .00011 .00005 .00052 .00039 .00017 .00008 .00003 .00002 .00001
   -54.3  -27.9  -74.0  -25.5  -58.9  -96.0  -60.8 -131.0    6.1    3.4    1.9
    72.5  105.1   52.1  106.5   43.0   27.0   41.7   17.9 -170.8 -176.3 -179.4
    88.0  118.8   68.7  119.5  -27.4  -54.1  -29.0  -79.7    6.6    1.7    0.8
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _on_first_apply(monkeypatch, cls, action):
    """Run ``action(channel)`` on the main thread at the first
    ``apply_pending`` of ``cls`` (between blocks); returns every command
    applied."""
    applied = []
    orig = cls.apply_pending

    def apply_pending(self):
        if not applied:
            applied.append(action(self))
        cmds = orig(self)
        applied.extend(cmds)
        return cmds

    monkeypatch.setattr(cls, "apply_pending", apply_pending)
    return applied


@pytest.mark.parametrize("key,value", [
    ("GNSS-SDR.telecommand_enabled", "true"),
    ("GNSS-SDR.SUPL_gps_enabled", "true"),
    ("GNSS-SDR.assistance_xml", "gps_assistance.xml"),
    ("GNSS-SDR.command_fifo", "/tmp/gnss_fifo"),
    ("PVT.blq_file", "ocean.blq")])
def test_unported_control_plane_raises(conf_file, tmp_path, monkeypatch,
                                       capsys, key, value):
    """Each control-plane key (the name is from when they raised) runs
    0.5 s of the capture through ``run_from_config(..., device="cpu")``
    with the JAX CLI's effect: the telecommand server answers ``status``
    during the run; SUPL against a closed port prints its failure and the
    run goes on; the assistance XML warm-starts the receiver and is
    written back at the end, loadable by the JAX package; the command
    FIFO exists during the run and a ``standby`` written to it stops the
    channels and re-acquires; the BLQ file gives the JAX CLI's (11, 6)
    table."""
    from gnss_sdr_tpu.receiver.assistance import (
        load_assistance,
        save_assistance,
    )
    from gnss_sdr_tpu.simulate.constellation import make_constellation
    from gnss_sdr_tpu_torch.receiver import telecommand

    cfg = FileConfiguration(conf_file)
    made = _capturing(monkeypatch, tmain)
    path = tmp_path / Path(value).name
    if key == "GNSS-SDR.telecommand_enabled":
        cfg.set_property("GNSS-SDR.telecommand_tcp_port", _free_port())

        def status(srv):
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=5) as c:
                c.recv(128)
                c.sendall(b"status\nexit\n")
                reply = b""
                while not reply.endswith(b"OK\r\n"):
                    reply += c.recv(4096)
            return reply.decode()

        applied = _on_first_apply(monkeypatch, telecommand.TcpCmdServer,
                                  status)
    elif key == "GNSS-SDR.SUPL_gps_enabled":
        cfg.set_property("GNSS-SDR.SUPL_gps_ephemeris_server", "127.0.0.1")
        cfg.set_property("GNSS-SDR.SUPL_gps_ephemeris_port", _free_port())
    elif key == "GNSS-SDR.assistance_xml":
        ephs = make_constellation(seed=2)
        save_assistance(path, {("G", p): e for p, e in ephs.items()})
        value = str(path)
    elif key == "GNSS-SDR.command_fifo":
        value = str(path)

        def standby(rd):
            assert stat.S_ISFIFO(os.stat(rd.path).st_mode)
            fd = os.open(rd.path, os.O_WRONLY)
            os.write(fd, b"standby\n")
            os.close(fd)
            deadline = time.time() + 5.0
            while rd.pending.empty() and time.time() < deadline:
                time.sleep(0.01)
            return "fifo"

        applied = _on_first_apply(monkeypatch, telecommand.FifoCmdReader,
                                  standby)
        acquired = []
        acquire = Receiver.acquire

        def count(self, *a, **kw):
            acquired.append(acquire(self, *a, **kw))
            return acquired[-1]

        monkeypatch.setattr(Receiver, "acquire", count)
    else:
        path.write_text(BLQ)
        value = str(path)
        cfg.set_property("PVT.blq_station", "WTZR")
        cfg.set_property("PVT.positioning_mode", "PPP_Static")
        cfg.set_property("PVT.earth_tide", 2)
    cfg.set_property(key, value)
    status = tmain.run_from_config(cfg, max_seconds=0.5, device="cpu")
    rx = made[0]
    out = capsys.readouterr().out
    assert rx.status is status
    if key == "GNSS-SDR.telecommand_enabled":
        reply = applied[0]
        assert reply.startswith("channel  signal")
        assert reply.count(f"  {rx.groups[0].plan.name:>6}  ") == 5
        assert "fix: none" in reply
    elif key == "GNSS-SDR.SUPL_gps_enabled":
        assert "SUPL assistance failed:" in out
        assert rx.groups[0].active_channels()
    elif key == "GNSS-SDR.assistance_xml":
        assert {k for k in rx.ephemerides if k[0] == "G"} >= {
            ("G", p) for p in ephs}
        back = load_assistance(path)
        assert set(back["ephemerides"]) == set(rx.ephemerides)
    elif key == "GNSS-SDR.command_fifo":
        assert applied[:2] == ["fifo", "standby"]
        assert len(acquired) >= 2 and acquired[1]
        assert not os.path.exists(path)
    else:
        want = jmain._load_blq(cfg)
        assert rx.cfg.blq.shape == (11, 6)
        np.testing.assert_array_equal(rx.cfg.blq, want)
        assert rx.ppp is not None and rx.ppp.oload is rx.cfg.blq


def test_main_needs_cuda_unless_asked(conf_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["-c", str(conf_file), "--max_seconds", "0.5"])
