"""The last plans of the JAX factory through the port: BeiDou B1I and B3I
(D1 with NH20, and the GEO plans with D2), GPS L2C, SBAS L1 and Galileo
E6B, against the JAX package.

- Every plan equals JAX's field for field, built directly and by each
  package's factory from a ``Channels_XX`` group (B1, B1G, B3, B3G, 2S,
  SBAS, E6).
- Both CLIs refuse the groups whose band neither band order names (2S on
  L2, B3 on B3, E6 on E6), with the same message.
- K1's plain version against the JAX blocked kernel (Pallas, interpret
  mode), with bounds of 5e-5 relative over the first two periods and 2e-3
  over the block, lanes 10 and 17 exact:
  - at L2C's 20 ms period (52000 samples at 2.6 Msps): C = 2, K = 3;
  - in BeiDou's D1 mode (the data code equal to the pilot code, NH20 on
    both, the Costas discriminator kept, 20-period integration started
    mid-symbol) at B1I's 2.6 Msps: C = 2, K = 40 periods from counters at
    7 and 19 (one period before a symbol edge), so each channel closes
    two integrations and two data symbols, the loop-update, symbol and
    secondary lanes equal. K2's wrapper runs the same plain version.
- PCPS parity on one synthetic satellite each for E6B
  (tests/test_e6.py::test_e6_acquisition's case), SBAS
  (tests/test_sbas_qzss.py::test_sbas_l1_acquisition's), L2C with its
  two-step Doppler zoom and B3I: the same verdict, the statistic within
  1e-3 relative, the same Doppler and a delay within one sample, and the
  truth within those tests' tolerances (L2C: one fine bin of 8 Hz; B3I:
  one bin of 250 Hz).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu import main as jmain
from gnss_sdr_tpu.acquisition import PcpsAcquisition as JPcps
from gnss_sdr_tpu.config.configuration import (
    InMemoryConfiguration as JInMemoryConfiguration,
)
from gnss_sdr_tpu.io import encode_samples
from gnss_sdr_tpu.ops.track_kernel_blocked import make_fused_tracker_blocked
from gnss_sdr_tpu.receiver import plans as jplans
from gnss_sdr_tpu.receiver.factory import get_signal_plans as j_plans
from gnss_sdr_tpu_torch import main as tmain
from gnss_sdr_tpu_torch.acquisition import PcpsAcquisition as TPcps
from gnss_sdr_tpu_torch.config.configuration import InMemoryConfiguration
from gnss_sdr_tpu_torch.ops import track_kernel as tk
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as tkb
from gnss_sdr_tpu_torch.receiver import plans as tplans
from gnss_sdr_tpu_torch.receiver.factory import get_signal_plans

from torch_cases import (
    B1I_KW,
    B1I_LEN,
    B1I_NMAX,
    D1_SECS,
    L2C_KW,
    L2C_LEN,
    L2C_NMAX,
    TAPS,
    assert_plans_equal,
    assert_rows_close,
    check_lanes,
    d1_inputs,
    pilot_inputs,
    run_tracker,
)

torch.set_num_threads(2)

# group -> (plan function, band, system, a rate of that band)
GROUPS = {
    "B1": ("beidou_b1i_plan", "B1", "C", 2.6e6),
    "B1G": ("beidou_b1i_geo_plan", "B1", "C", 4.092e6),
    "B3": ("beidou_b3i_plan", "B3", "C", 12.5e6),
    "B3G": ("beidou_b3i_geo_plan", "B3", "C", 12.5e6),
    "2S": ("gps_l2c_plan", "L2", "G", 2.6e6),
    "SBAS": ("sbas_l1_plan", "L1", "S", 2.6e6),
    "E6": ("galileo_e6b_plan", "E6", "E", 10.23e6),
}


def _cfg(cls, **props):
    cfg = cls()
    for k, v in props.items():
        cfg.set_property(k.replace("__", "."), str(v))
    return cfg


@pytest.mark.parametrize("group", list(GROUPS))
def test_plans_match_jax(group):
    name, band, system, fs = GROUPS[group]
    a = getattr(jplans, name)(fs, num_channels=3)
    b = getattr(tplans, name)(fs, num_channels=3)
    assert_plans_equal(a, b)
    assert (b.band, b.system) == (band, system)
    props = {f"Channels_{group}__count": 2,
             f"Acquisition_{group}__doppler_max": 3000}
    (ja,) = j_plans(_cfg(JInMemoryConfiguration, **props), {band: fs})
    (ta,) = get_signal_plans(_cfg(InMemoryConfiguration, **props),
                             {band: fs})
    assert_plans_equal(ja, ta)
    assert ta.acq_conf.doppler_max_hz == 3000.0 and ta.num_channels == 2


@pytest.mark.parametrize("group", ["2S", "B3", "E6"])
def test_clis_refuse_a_band_without_chain(group, tmp_path):
    """Neither CLI's band order names L2, B3 or E6, so a conf of one RF
    chain and such a group is refused by both, naming the band."""
    band = GROUPS[group][1]
    cap = tmp_path / "cap.dat"
    cap.write_bytes(encode_samples(np.zeros(4096, np.complex64), "ibyte"))
    props = dict(
        SignalSource__implementation="File_Signal_Source",
        SignalSource__filename=cap, SignalSource__item_type="ibyte",
        SignalSource__sampling_frequency=4_000_000,
        SignalConditioner__implementation="Pass_Through",
        **{f"Channels_{group}__count": 2})
    for run, cls, kw in ((jmain.run_from_config, JInMemoryConfiguration, {}),
                         (tmain.run_from_config, InMemoryConfiguration,
                          {"device": "cpu"})):
        with pytest.raises(ValueError, match=f"needs band {band}"):
            run(_cfg(cls, **props), **kw)


def test_plain_matches_jax_blocked_kernel_l2c():
    C, K = 2, 3
    jk = make_fused_tracker_blocked(K, L2C_NMAX, L2C_LEN, 3,
                                    np.asarray(TAPS, np.float32),
                                    interpret=True, **L2C_KW)
    codes, _, wr, wi, scal, _, _ = pilot_inputs(
        C, K, L2C_NMAX, TAPS, False, 1, 1, 1, extend=1, seed=4,
        code_len=L2C_LEN)
    o_jax = np.asarray(jk(jnp.asarray(wr), jnp.asarray(wi),
                          jnp.asarray(jk.pack(codes)), jnp.asarray(scal)))
    spec = tkb.make_blocked_spec(K, L2C_NMAX, L2C_LEN, TAPS, **L2C_KW)
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    o_port = run_tracker(tkb.track_blocked, spec, window, codes, scal, 1,
                         "cpu")
    assert o_port.shape == o_jax.shape == (C, K, 128)
    # ~52000 samples a period, a loop update after each
    assert (np.abs(o_port[:, :, 10] - 52000) <= 2).all()
    np.testing.assert_array_equal(o_port[:, :, 20], np.ones((C, K)))
    lanes = check_lanes(3)
    assert_rows_close(o_jax[:, :2], o_port[:, :2], tol=5e-5, lanes=lanes)
    assert_rows_close(o_jax, o_port, tol=2e-3, lanes=lanes)


SEC0 = [7, 19]


def test_plain_matches_jax_blocked_kernel_d1():
    C, K = len(SEC0), 40
    jk = make_fused_tracker_blocked(K, B1I_NMAX, B1I_LEN, 3,
                                    np.asarray(TAPS, np.float32),
                                    interpret=True, **B1I_KW, **D1_SECS)
    codes, dcodes, wr, wi, scal, secp, secd = d1_inputs(
        C, K, B1I_NMAX, B1I_LEN, SEC0, seed=3)
    o_jax = np.asarray(jk(
        jnp.asarray(wr), jnp.asarray(wi), jnp.asarray(jk.pack(codes)),
        jnp.asarray(scal), jnp.asarray(jk.pack(dcodes)), jnp.asarray(secp),
        jnp.asarray(secd)))

    spec = tkb.make_blocked_spec(K, B1I_NMAX, B1I_LEN, TAPS, **B1I_KW,
                                 **D1_SECS)
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    tables = (dcodes, secp, secd)
    o_port = run_tracker(tkb.track_blocked, spec, window, codes, scal, 1,
                         "cpu", tables)
    assert o_port.shape == o_jax.shape == (C, K, 128)
    lanes = check_lanes(3)
    assert_rows_close(o_jax[:, :2], o_port[:, :2], tol=5e-5, lanes=lanes)
    assert_rows_close(o_jax, o_port, tol=2e-3, lanes=lanes)
    # two loop updates (lane 20) and two data symbols (lane 34) a channel,
    # the first after 20 - SEC0[c] periods
    for lane in (20, 34, 36, 37):
        np.testing.assert_array_equal(o_jax[:, :, lane], o_port[:, :, lane])
    np.testing.assert_array_equal(o_port[:, :, 20].sum(axis=1), [2, 2])
    np.testing.assert_array_equal(np.argmax(o_port[:, :, 34], axis=1),
                                  [19 - s for s in SEC0])
    spec2 = tk.make_full_spec(K, B1I_NMAX, B1I_LEN, TAPS, **B1I_KW,
                              **D1_SECS)
    o_k2 = run_tracker(tk.track_full, spec2, window, codes, scal, 1, "cpu",
                       tables)
    np.testing.assert_array_equal(o_k2, o_port)


# name -> (plan function, plan kwargs, PRN, Doppler Hz, delay chips,
#          C/N0 dB-Hz, Doppler and delay (samples) tolerances)
ACQ_CASES = {
    "e6b": ("galileo_e6b_plan", dict(fs=10.23e6, doppler_max_hz=3000.0,
                                     doppler_step_hz=500.0,
                                     search_prns=(11,)),
            11, 1200.0, 1000.5, 47.0, 250.0, 2.0),
    "sbas": ("sbas_l1_plan", dict(fs=2.046e6, search_prns=(131,)),
             131, -300.0, 700.5, 46.0, 125.0, 1.5),
    "l2c_two_step": ("gps_l2c_plan", dict(fs=1.023e6, doppler_max_hz=600.0,
                                          search_prns=(5,)),
                     5, 217.0, 3100.25, 44.0, 8.0, 1.5),
    "b3i": ("beidou_b3i_plan", dict(fs=10.23e6, doppler_max_hz=2000.0,
                                    search_prns=(14,)),
            14, -1060.0, 4321.5, 47.0, 250.0, 1.5),
}


@pytest.mark.parametrize("case", list(ACQ_CASES))
def test_pcps_matches_jax(case):
    name, kw, prn, dop, delay, cn0, dop_tol, delay_tol = ACQ_CASES[case]
    plan = getattr(tplans, name)(**kw)
    conf = plan.acq_conf
    table = (plan.acq_code_table if plan.acq_code_table is not None
             else plan.code_table)
    row = plan.prn_row(prn)
    rng = np.random.default_rng(4)
    n = conf.input_samples
    t = np.arange(n) / conf.fs
    chip = np.floor((t - delay / conf.code_rate_cps)
                    * conf.code_rate_cps).astype(np.int64)
    x = np.sqrt(10 ** (cn0 / 10) / conf.fs) * table[row][
        chip % conf.code_length_chips] * np.exp(2j * np.pi * dop * t)
    x = (x + rng.normal(scale=np.sqrt(0.5), size=n)
         + 1j * rng.normal(scale=np.sqrt(0.5), size=n)).astype(np.complex64)
    jplan = getattr(jplans, name)(**kw)
    j = JPcps(jplan.acq_conf, table, list(plan.search_prns)).acquire(
        x[None], np.array([row]))
    r = TPcps(conf, table, list(plan.search_prns), device="cpu").acquire(
        x[None], np.array([row]))
    assert j.detected[0] and r.detected[0]
    assert abs(r.test_statistic[0] - j.test_statistic[0]) < (
        1e-3 * j.test_statistic[0])
    assert r.doppler_hz[0] == j.doppler_hz[0]
    assert abs(r.delay_samples[0] - j.delay_samples[0]) <= 1.0
    assert abs(r.doppler_hz[0] - dop) <= dop_tol
    sps = conf.fs / conf.code_rate_cps
    assert abs(r.delay_samples[0] - delay * sps) <= delay_tol
