"""Channel sharding in the port against the JAX package's, on the CPU.

The port's mesh is a tuple of devices, here several shards on the CPU;
the JAX mesh is that many of conftest's eight virtual CPU devices.

- The sharded Tracker (2 and 4 shards) against the JAX Tracker on a 2- and
  4-device mesh, from the same starts on the same window, at the eager
  parity tolerances of tests/test_torch_dll_pll.py (period lengths, end
  positions and boundaries equal; Doppler within 0.1 Hz, the median prompt
  within 5e-3 relative, carrier phase within 1e-3 rad, code phase within
  1e-3 chips).
- Sharded and unsharded runs of the port are bit-equal, in the eager
  engine and in the fused one forced on (K1's plain version): channels
  share no arithmetic.
- Sharded PCPS against JAX's sharded PCPS on a batch of 5 rows over 4
  shards (the padding path), at tests/test_torch_acquisition.py's
  tolerances (same verdicts, statistic within 1e-3 relative, the same
  Doppler and the delay within one sample where detected), and bit-equal
  to the port's unsharded PCPS; the fine-Doppler, Tong and assisted
  engines sharded bit-equal to unsharded.
- The sharded Receiver is in tests/test_torch_sharded_receiver.py.
- The port's two deliberate differences from the JAX package: the fused
  engine (K1) runs once per shard, where JAX keeps a mesh on its XLA scan;
  and ``num_devices`` beyond the card count raises, where JAX's
  ``jax.devices()[:n]`` shrinks the mesh.
"""

import jax
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.acquisition import AcqConfig as JAcqConf
from gnss_sdr_tpu.acquisition import PcpsAcquisition as JPcps
from gnss_sdr_tpu.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu.parallel.sharding import make_channel_mesh as jmesh
from gnss_sdr_tpu.tracking.conf import DllPllConf as JConf
from gnss_sdr_tpu.tracking.tracker import Tracker as JTracker
from gnss_sdr_tpu_torch.acquisition import AcqConfig as TAcqConf
from gnss_sdr_tpu_torch.acquisition import (
    AssistedAcquisition,
    FineDopplerAcquisition,
    PcpsAcquisition,
    TongAcquisition,
)
from gnss_sdr_tpu_torch.parallel import device_mesh, make_channel_mesh
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.simulate import SatelliteSignalParams, generate_baseband
from gnss_sdr_tpu_torch.tracking import Tracker, fused
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf as TConf

torch.set_num_threads(2)

FS = 2.6e6
C = 4
DOPS = [1200.0, -2500.0, 3400.0, -400.0]
DELAYS = [37.0 + 311.0 * c for c in range(C)]
TBL = gps_l1_ca_code_table().astype(np.float32)


def _signal(n, seed=1):
    """C GPS channels at DOPS and DELAYS, no data bits, light noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / FS
    sig = np.zeros(n, np.complex64)
    for c in range(C):
        cph = (1.023e6 * (1 + DOPS[c] / 1575.42e6)) * (tt - DELAYS[c] / FS)
        chips = TBL[c][np.floor(cph).astype(np.int64) % 1023]
        sig += (0.5 * chips * np.exp(2j * np.pi * DOPS[c] * tt + 0.3j * c)
                ).astype(np.complex64)
    sig += ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.05)
    return sig.astype(np.complex64)


SIG = _signal(120_000)


def _conf_kw(**kw):
    return dict(fs=FS, code_length_chips=1023, code_rate_cps=1.023e6,
                carrier_freq_hz=1575.42e6, max_channels=C,
                steps_per_block=10, **kw)


def _start(trk):
    for ch in range(C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=DELAYS[ch],
                          acq_doppler_hz=DOPS[ch] + 30.0,
                          acq_samplestamp=0, current_abs_sample=0)
    return trk


def _blocks(trk, n):
    outs = []
    for _ in range(n):
        base, length = trk.window_request()
        outs.append(trk.process(SIG[base:base + length], base).outputs)
    return outs


def _port_tracker(shards, **kw):
    mesh = make_channel_mesh(["cpu"] * shards) if shards else None
    return _start(Tracker(TConf(**_conf_kw(**kw)), TBL, device="cpu",
                          mesh=mesh))


def _assert_match(a, b):
    """tests/test_torch_dll_pll.py's assert_match."""
    for k in ("n_samples", "pos_end", "boundary"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < 0.1
    pa, pb = a["prompt"], b["prompt"]
    assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3
    assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
    assert np.abs(a["rem_code_phase"] - b["rem_code_phase"]).max() < 1e-3


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_tracker_matches_jax(shards):
    jconf = JConf(**_conf_kw(pallas_correlator=False, fused_tracker=False))
    jt = _start(JTracker(jconf, TBL,
                         mesh=jmesh(jax.devices()[:shards])))
    tt = _port_tracker(shards)
    assert tt.mesh.size == shards and not tt._block.fused
    for a, b in zip(_blocks(jt, 2), _blocks(tt, 2)):
        _assert_match(a, b)
    np.testing.assert_array_equal(jt.pos_abs, tt.pos_abs)


@pytest.mark.parametrize("fused_tracker", [False, True],
                         ids=["eager", "fused_plain"])
def test_sharded_equals_unsharded(fused_tracker):
    ref = _blocks(_port_tracker(0, fused_tracker=fused_tracker), 3)
    for shards in (2, 4):
        trk = _port_tracker(shards, fused_tracker=fused_tracker)
        assert trk._block.fused == fused_tracker
        for a, b in zip(ref, _blocks(trk, 3)):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_indivisible_channels_raise():
    """C % shards raises ValueError with the same message in both."""
    with pytest.raises(ValueError, match="4 channels do not divide over 3 "
                                         "devices"):
        JTracker(JConf(**_conf_kw()), TBL, mesh=jmesh(jax.devices()[:3]))
    with pytest.raises(ValueError, match="4 channels do not divide over 3 "
                                         "devices"):
        Tracker(TConf(**_conf_kw()), TBL, device="cpu",
                mesh=make_channel_mesh(["cpu"] * 3))


ACQ_FS = 2.046e6
ACQ_KW = dict(fs=ACQ_FS, code_length_chips=1023, code_rate_cps=1.023e6,
              doppler_max_hz=5000.0, doppler_step_hz=250.0, max_dwells=2,
              pfa=1e-3)


def _acq_batch(n_in):
    """tests/test_acquisition.py's known signal (PRNs 7 and 12) as 5
    hypotheses: two of them the signal's PRNs."""
    sats = [SatelliteSignalParams(prn=7, cn0_dbhz=46.0, doppler_hz=1000.0,
                                  delay_chips=300.25),
            SatelliteSignalParams(prn=12, cn0_dbhz=46.0, doppler_hz=-2750.0,
                                  delay_chips=911.0)]
    x = generate_baseband(sats, ACQ_FS, n_in, seed=1)
    return np.stack([x] * 5), np.array([6, 11, 19, 2, 30])


def test_sharded_pcps_matches_jax():
    prns = list(range(1, 33))
    j = JPcps(JAcqConf(**ACQ_KW), TBL, prns, mesh=jmesh(jax.devices()[:4]))
    mesh = make_channel_mesh(["cpu"] * 4)
    t = PcpsAcquisition(TAcqConf(**ACQ_KW), TBL, prns, mesh=mesh,
                        device="cpu")
    t1 = PcpsAcquisition(TAcqConf(**ACQ_KW), TBL, prns, device="cpu")
    x, rows = _acq_batch(t.conf.input_samples)
    rj, rt, r1 = j.acquire(x, rows), t.acquire(x, rows), t1.acquire(x, rows)
    assert rt.detected.tolist() == [True, True, False, False, False]
    np.testing.assert_array_equal(rj.detected, rt.detected)
    rel = np.abs(rj.test_statistic - rt.test_statistic) / rj.test_statistic
    assert rel.max() < 1e-3, rel
    d = rj.detected
    np.testing.assert_array_equal(rj.doppler_hz[d], rt.doppler_hz[d])
    assert np.abs(rj.delay_samples[d] - rt.delay_samples[d]).max() <= 1.0
    for f in ("detected", "test_statistic", "delay_samples", "doppler_hz",
              "input_power"):
        np.testing.assert_array_equal(getattr(r1, f), getattr(rt, f),
                                      err_msg=f)


@pytest.mark.parametrize("engine", ["fine_doppler", "tong", "assisted"])
def test_sharded_engines_equal_unsharded(engine):
    """The three PCPS schedulers take the mesh to their inner PCPS; the
    sharded results equal the unsharded ones."""
    prns = list(range(1, 33))
    conf = TAcqConf(**ACQ_KW)
    mesh = make_channel_mesh(["cpu"] * 2)

    def build(m):
        if engine == "fine_doppler":
            return FineDopplerAcquisition(conf, TBL, prns, iterations=2,
                                          mesh=m, device="cpu")
        if engine == "tong":
            return TongAcquisition(conf, TBL, prns, tong_max=2,
                                   max_attempts=2, mesh=m, device="cpu")
        eng = AssistedAcquisition(conf, TBL, prns, {}, mesh=m, device="cpu")
        offsets = np.zeros(32)
        offsets[[6, 11]] = [1100.0, -2800.0]
        eng.set_predicted_doppler(offsets)
        return eng

    sharded, plain = build(mesh), build(None)
    assert sharded.inner.mesh is mesh
    x, rows = _acq_batch(sharded.conf.input_samples)
    a, b = plain.acquire(x, rows), sharded.acquire(x, rows)
    assert a.detected[:2].all()
    for f in ("detected", "test_statistic", "delay_samples", "doppler_hz",
              "input_power"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def test_fused_engine_runs_once_per_shard(monkeypatch):
    """Deliberate difference 1: where JAX's ``fused_eligible(conf, mesh)``
    keeps a mesh on the XLA scan, the port runs the fused engine (K1, the
    plain version here) once per shard each block."""
    calls = []
    run = fused.track_blocked

    def counted(window, codes, *a, **kw):
        calls.append(codes.shape[0])
        return run(window, codes, *a, **kw)

    monkeypatch.setattr(fused, "track_blocked", counted)
    trk = _port_tracker(2, fused_tracker=True)
    _blocks(trk, 2)
    assert trk._block.fused and trk._block.spec.kernel != "track_full"
    assert calls == [C // 2] * 4


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_fused_shards_pack_once(monkeypatch, shards):
    """The sharded fused engine packs the whole state once a block and
    unpacks the shards' concatenated rows once, whatever the shard count:
    per shard it adds one launch on its slice of the packed block."""
    from gnss_sdr_tpu_torch.parallel import sharding

    counts = {"pack": 0, "unpack": 0}
    pack, unpack = fused._pack_scalars, fused.unpack_rows

    def packed(*a):
        counts["pack"] += 1
        return pack(*a)

    def unpacked(*a):
        counts["unpack"] += 1
        return unpack(*a)

    monkeypatch.setattr(fused, "_pack_scalars", packed)
    monkeypatch.setattr(fused, "unpack_rows", unpacked)
    monkeypatch.setattr(sharding, "_pack_scalars", packed)
    monkeypatch.setattr(sharding, "unpack_rows", unpacked)
    _blocks(_port_tracker(shards, fused_tracker=True), 2)
    assert counts == {"pack": 2, "unpack": 2}


def test_num_devices_beyond_cards_raises(monkeypatch):
    """Deliberate difference 2: ``num_devices`` beyond the card count
    raises RuntimeError (JAX's ``jax.devices()[:n]`` shrinks the mesh)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="num_devices=2 but 1 CUDA"):
        Receiver(ReceiverConfig(num_devices=2, device="cuda"))
    mesh = device_mesh(1, "cuda")
    assert mesh.devices == (torch.device("cuda", 0),)
    assert device_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    # shards told to share one card stack on it; more cards than the host
    # has raise, in the scaling tool too
    assert device_mesh(4, "cuda", cards=1).devices == (
        torch.device("cuda", 0),) * 4
    with pytest.raises(RuntimeError, match="2 cards asked for but 1 CUDA"):
        device_mesh(4, "cuda", cards=2)
    from gnss_sdr_tpu_torch.tools import scaling

    with pytest.raises(RuntimeError, match="num_devices=2 but 1 CUDA"):
        scaling.run((2,), channels=2, steps=1, iters=1)
