"""The Galileo E1 slice as a whole: the port's plans, factory and Receiver
against the JAX package's.

- Both packages' ``galileo_e1b_plan`` (E1-B, VEML at T = 5) and
  ``galileo_e1bc_plan`` (E1-B+C with the pilot) are equal field by field,
  their tables bit for bit.
- Both factories build equal plans from ``conf/galileo_e1_file.conf``;
  with the Tong, QuickSync or CCCWSR acquisition both Receivers build the
  same engine, and the two agree on a noise window.
- PCPS on the 8184-unit sinBOC table, with the E1 plans' double-length
  FFT (``bit_transition_flag``) and the pilot plan's two-step Doppler
  zoom: the JAX engine's verdicts, Doppler bins, delays within one sample
  and test statistics within 1e-3 (tests/test_torch_acquisition.py's
  bounds).
- A 1 s E1-B capture (tests/test_galileo.py's scenario at 2.6 Msps, cut to
  4 satellites and 1 s) goes through both Receivers with 4 channels on the
  CPU. They must acquire the same satellites with the same Doppler and
  delays within one sample, and agree on the first tracking block within
  tests/test_fused_receiver.py's ``_assert_match`` tolerances (period
  lengths, end stamps and boundaries equal; Doppler within 0.1 Hz, prompt
  median relative difference below 5e-3, carrier phase and code phase
  within 1e-3). The 20 s position gates run on the card (chip_smoke.py).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import cached_capture
from gnss_sdr_tpu.acquisition import PcpsAcquisition as JPcps
from gnss_sdr_tpu.config.configuration import (
    FileConfiguration as JFileConfiguration,
)
from gnss_sdr_tpu.receiver import plans as jplans
from gnss_sdr_tpu.receiver.factory import get_signal_plans as j_plans
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu_torch.acquisition import PcpsAcquisition as TPcps
from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
from gnss_sdr_tpu_torch.receiver import plans as tplans
from gnss_sdr_tpu_torch.receiver.factory import get_signal_plans
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.simulate.galileo import (
    GalileoScenario,
    GalileoScenarioConfig,
)

torch.set_num_threads(2)

FS = 2.6e6
ROOT = Path(__file__).resolve().parent.parent


def assert_plans_equal(a, b):
    """Every field of two SignalPlans equal: arrays bit for bit, the
    engine confs field by field, the decoders of one kind."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("make_decoder", "prn_row"):
            continue
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, f.name
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        elif dataclasses.is_dataclass(va):
            for g in dataclasses.fields(va):
                assert getattr(vb, g.name) == getattr(va, g.name), (
                    f.name, g.name)
        elif f.name == "acq_engine_params":
            assert va.keys() == vb.keys()
            for k in va:
                np.testing.assert_array_equal(va[k], vb[k], err_msg=k)
        else:
            assert va == vb, f.name
    for prn in (1, 11):
        assert b.prn_row(prn) == a.prn_row(prn)
        da, db = a.make_decoder(prn), b.make_decoder(prn)
        assert type(db).__name__ == type(da).__name__ == "InavDecoder"
        assert vars(db).keys() == vars(da).keys()
        assert db.rs_enabled == da.rs_enabled


@pytest.mark.parametrize("name,kw", [
    ("galileo_e1b_plan", dict(fs=2.6e6, num_channels=6,
                              enable_reed_solomon=True)),
    ("galileo_e1b_plan", dict(fs=4.0e6, num_channels=8,
                              steps_per_block=250)),
    ("galileo_e1bc_plan", dict(fs=4.0e6, num_channels=6)),
], ids=["e1b_rs", "e1b_gal8", "e1bc"])
def test_plans_match_jax(name, kw):
    a, b = getattr(jplans, name)(**kw), getattr(tplans, name)(**kw)
    assert_plans_equal(a, b)
    assert b.trk_conf.num_taps == 5


def test_factory_plans_match_jax_on_galileo_conf():
    path = ROOT / "conf" / "galileo_e1_file.conf"
    jp = j_plans(JFileConfiguration(path), 4e6)
    tp = get_signal_plans(FileConfiguration(path), 4e6)
    assert [p.name for p in tp] == [p.name for p in jp] == ["1B"]
    assert_plans_equal(jp[0], tp[0])
    assert tp[0].acq_conf.make_two_steps
    assert tp[0].acq_conf.bit_transition_flag


@pytest.mark.parametrize("impl", [
    "Galileo_E1_PCPS_Tong_Ambiguous_Acquisition",
    "Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition",
    "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition"])
def test_other_acquisition_engines_match_jax(impl):
    """The E1 group builds with the Tong, QuickSync and CCCWSR
    implementations the JAX factory accepts; both Receivers build the same
    engine from it, and the two engines give equal verdicts, Dopplers and
    delays, and statistics within 1e-4, on one noise window (PRNs 1-2)."""
    def plan(pkg_cfg, plans_fn):
        cfg = pkg_cfg(ROOT / "conf" / "galileo_e1_file.conf")
        cfg.set_property("Acquisition_1B.implementation", impl)
        (p,) = plans_fn(cfg, 4e6)
        p.search_prns = [1, 2]
        return p

    tp, jp = plan(FileConfiguration, get_signal_plans), plan(
        JFileConfiguration, j_plans)
    assert tp.acq_engine == jp.acq_engine != "pcps"
    ja = JReceiver(JConfig(fs=4e6), plans=[jp]).groups[0].acq
    ta = Receiver(ReceiverConfig(fs=4e6, device="cpu"),
                  plans=[tp]).groups[0].acq
    assert type(ta).__name__ == type(ja).__name__
    n = getattr(ta, "win", None) or ta.conf.input_samples
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(
        np.complex64)
    rows = np.array([tp.prn_row(1), tp.prn_row(2)])
    rj, rt = ja.acquire(x, rows), ta.acquire(x, rows)
    np.testing.assert_array_equal(rt.detected, rj.detected)
    np.testing.assert_array_equal(rt.delay_samples, rj.delay_samples)
    np.testing.assert_array_equal(rt.doppler_hz, rj.doppler_hz)
    np.testing.assert_allclose(rt.test_statistic, rj.test_statistic,
                               rtol=1e-4)


def scenario():
    return GalileoScenario(GalileoScenarioConfig(
        fs=FS, tow_start_s=7310.0, duration_s=1.0, cn0_dbhz=46.0,
        rx_clock_bias_s=1.7e-4, max_sats=4, min_elevation_deg=15.0,
        seed=3))


def capture():
    scen = scenario()
    return scen, cached_capture("torch_galileo_e1b_1s",
                                lambda: scen.generate(0, scen.total_samples))


def test_pcps_e1_two_step_matches_jax():
    scen, x = capture()
    jp = jplans.galileo_e1bc_plan(fs=FS, num_channels=4)
    tp = tplans.galileo_e1bc_plan(fs=FS, num_channels=4)
    assert tp.acq_conf.make_two_steps and tp.acq_conf.bit_transition_flag
    prns = list(scen.prns) + [30]            # four in view, one absent
    je = JPcps(jp.acq_conf, jp.acq_code_table, prns)
    te = TPcps(tp.acq_conf, tp.acq_code_table, prns, device="cpu")
    n = je.conf.input_samples
    xb = np.broadcast_to(x[:n], (len(prns), n))
    rows = np.array([p - 1 for p in prns])
    j, t = je.acquire(xb, rows), te.acquire(xb, rows)
    np.testing.assert_array_equal(j.detected, t.detected)
    assert t.detected[:4].all() and not t.detected[4]
    rel = np.abs(j.test_statistic - t.test_statistic) / j.test_statistic
    assert rel.max() < 1e-3, rel
    d = j.detected
    np.testing.assert_array_equal(j.doppler_hz[d], t.doppler_hz[d])
    assert np.abs(j.delay_samples[d] - t.delay_samples[d]).max() <= 1.0


def first_block(rx, x):
    """Feed the capture, acquire, run one block; that block's result."""
    first = []
    tracker = rx.groups[0].tracker
    process = tracker.process_device

    def record(*args):
        result = process(*args)
        first.append(result)
        return result

    tracker.process_device = record
    rx.feed(x)
    rx.acquire()
    rx.run(max_blocks=1)
    return first[0]


def test_receiver_matches_jax_on_1s_e1b_capture():
    scen, x = capture()
    prns = tuple(scen.prns)
    assert len(prns) == 4
    rxs = []
    for rcls, ccls, plans, kw in (
            (JReceiver, JConfig, jplans, {}),
            (Receiver, ReceiverConfig, tplans, {"device": "cpu"})):
        plan = plans.galileo_e1b_plan(fs=FS, num_channels=4,
                                      search_prns=prns)
        rxs.append(rcls(ccls(fs=FS, num_channels=4, **kw), plans=[plan]))
    ja, ta = (first_block(rx, x) for rx in rxs)
    jacq, tacq = rxs[0].status.acquired, rxs[1].status.acquired
    assert len(tacq) == 4 and jacq.keys() == tacq.keys()
    for key, (dop, delay) in jacq.items():
        assert tacq[key][0] == dop, key
        assert abs(tacq[key][1] - delay) <= 1.0, key
    a, b = ja.outputs, ta.outputs
    for k in ("n_samples", "boundary"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(ja.abs_sample_end, ta.abs_sample_end)
    assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < 0.1
    pa, pb = a["prompt"], b["prompt"]
    assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3
    assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
    assert np.abs(a["rem_code_phase"] - b["rem_code_phase"]).max() < 1e-3
    # VEML: five taps a period, the prompt in the middle
    assert b["taps"].shape[-1] == 5
    np.testing.assert_array_equal(b["taps"][..., 2], pb)
