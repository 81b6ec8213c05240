"""Simple fused tracker K4: the port's ``track_simple`` on the CPU (its plain
version) against the JAX kernel ``make_fused_tracker`` (Pallas, interpret
mode), on the same seeded numpy inputs.

The JAX side reads its own packed tables (``pack_code_table`` for the
qloop replica, ``pack_code_table_ext`` for window2) and the window as
[rows, 128] re/im planes; the port reads the plain [C, L] chip table and a
complex64 window. Tolerance: 5e-5 relative on lanes 0..2T-1 and 10-19 over
the first two periods, 2e-3 over all periods (``torch_cases``'s rule for
the fused trackers: the two differ in reduction order and in atan/sincos
implementations, which the closed loop amplifies slowly); the period
length (lane 10) and position (lane 17) exact; lanes 20-127 zero. The
kernel itself is held against its plain version in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu.ops.correlator import pack_code_table
from gnss_sdr_tpu.ops.track_kernel import (
    fused_scalars_from_state as jax_fused_scalars,
    make_fused_tracker,
    pack_code_table_ext,
)
from gnss_sdr_tpu.tracking import dll_pll as jdll
from gnss_sdr_tpu.tracking.conf import DllPllConf as JConf
from gnss_sdr_tpu_torch.ops import track_kernel as tk
from gnss_sdr_tpu_torch.tracking import dll_pll as tdll
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf as TConf

from torch_cases import FS, assert_rows_close, run_simple, simple_carry

torch.set_num_threads(2)

KW = dict(fs=FS, code_rate_cps=1.023e6, carrier_freq_hz=1575.42e6)
TAPS3 = [-0.25, 0.0, 0.25]
TAPS5 = [-0.5, -0.25, 0.0, 0.25, 0.5]


def simple_lanes(num_taps):
    return list(range(2 * num_taps)) + list(range(10, 20))


def simple_inputs(C, K, L, nmax, launches, seed):
    """codes [C, L], window re/im [rows, 128] and a [C, 10] scalar block."""
    rng = np.random.default_rng(seed)
    codes = np.sign(rng.normal(size=(C, L))).astype(np.float32)
    codes[codes == 0] = 1.0
    wrows = (nmax * (K * launches + 2)) // 128 + 64
    wr = rng.normal(size=(wrows, 128)).astype(np.float32)
    wi = rng.normal(size=(wrows, 128)).astype(np.float32)
    scal = np.zeros((C, 10), np.float32)
    scal[:, 0] = np.arange(C) * 37 + 5
    scal[:, 1] = 0.2
    scal[:, 3] = 0.5
    scal[:, 4] = np.linspace(-2500, 2500, C)
    scal[:, 7] = 1
    return codes, wr, wi, scal


def run_jax(K, nmax, L, taps, codes, wr, wi, scal, launches, replica, **kw):
    jk = make_fused_tracker(K, nmax, L, len(taps),
                            np.asarray(taps, np.float32), replica=replica,
                            interpret=True, **kw)
    if replica == "auto":         # the JAX kernel's own choice (:140-144)
        replica = "qloop" if (L + 127) // 128 <= 16 else "window2"
    pack = pack_code_table_ext if replica == "window2" else pack_code_table
    cq = jnp.asarray(pack(codes))
    outs, s = [], scal
    for _ in range(launches):
        o = np.asarray(jk(jnp.asarray(wr), jnp.asarray(wi), cq,
                          jnp.asarray(s)))
        outs.append(o)
        s = simple_carry(s, o)
    return np.concatenate(outs, axis=1)


def run_port(spec, codes, wr, wi, scal, launches):
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    return run_simple(tk.track_simple, spec, window, codes, scal, launches,
                      "cpu")


def assert_simple_close(o_jax, o_port, num_taps):
    lanes = simple_lanes(num_taps)
    assert_rows_close(o_jax[:, :2], o_port[:, :2], tol=5e-5, lanes=lanes)
    assert_rows_close(o_jax, o_port, tol=2e-3, lanes=lanes)
    assert np.all(o_port[:, :, 20:] == 0.0)
    assert np.all(o_port[:, :, 2 * num_taps:10] == 0.0)


@pytest.mark.parametrize(
    "C,K,L,launches,taps,orders,replica,seed,edit", [
        (4, 12, 1023, 1, TAPS3, (2, 2), "qloop", 0, None),
        (4, 12, 1023, 1, TAPS3, (2, 2), "window2", 0, None),
        (3, 10, 1023, 1, TAPS5, (2, 2), "qloop", 1, None),
        (3, 10, 1023, 1, TAPS3, (1, 1), "qloop", 2, None),
        (3, 10, 1023, 1, TAPS3, (3, 3), "qloop", 3, "i2"),
        (3, 8, 1023, 2, TAPS3, (3, 2), "qloop", 4, "seam"),
        (3, 10, 1023, 1, TAPS3, (2, 2), "qloop", 5, "disable"),
        (2, 4, 10230, 1, TAPS3, (2, 2), "auto", 6, None),
    ], ids=["gps_qloop", "gps_window2", "veml_t5", "order1", "order3_i2",
            "two_launch_seam", "disabled_channel", "code_10230"])
def test_track_simple_matches_jax_kernel(C, K, L, launches, taps, orders,
                                         replica, seed, edit):
    nmax = int(np.ceil(FS * L / 1.023e6)) + 64
    kw = dict(KW, pll_bw_hz=25.0, dll_bw_hz=2.0, pll_order=orders[0],
              dll_order=orders[1])
    codes, wr, wi, scal = simple_inputs(C, K, L, nmax, launches, seed)
    if edit == "i2":
        scal[:, 8] = [3.0, -2.0, 1.5][:C]       # pll_i2
        scal[:, 9] = [0.4, -0.3, 0.2][:C]       # dll_i2
    if edit == "seam":
        scal[:, 5] = [10.0, -20.0, 5.0][:C]     # pll_i1 at the seam
        scal[:, 6] = [3.0, -1.5, 2.0][:C]       # dll_i1
    if edit == "disable":
        scal[1, 7] = 0.0

    o_jax = run_jax(K, nmax, L, taps, codes, wr, wi, scal, launches,
                    replica, **kw)
    spec = tk.make_simple_spec(K, nmax, L, taps, **kw)
    o_port = run_port(spec, codes, wr, wi, scal, launches)
    assert o_port.shape == o_jax.shape == (C, K * launches, 128)
    assert_simple_close(o_jax, o_port, len(taps))
    if edit == "disable":
        # K4 has no enabled gating: the disabled channel advances
        n = o_port[1, :, 10]
        np.testing.assert_array_equal(o_port[1, :, 17],
                                      scal[1, 0] + np.cumsum(n))
        assert np.all(n > 2000)
    if edit == "i2":
        assert np.all(o_port[:, 0, 18] != scal[:, 8])


def test_track_simple_glitch_input():
    """tests/test_track_kernel.py:175-210's input (rem 0, dcode -0.01 Hz:
    the true period length a hair above 2600 samples) in both packages: the
    same rows, n within one sample of nominal and rem in [0, 1)."""
    conf = TConf(fs=FS, code_length_chips=1023, code_rate_cps=1.023e6,
                 carrier_freq_hz=1575.42e6, max_channels=1,
                 steps_per_block=10)
    kw = dict(KW, pll_bw_hz=conf.pll_bw_hz, dll_bw_hz=conf.dll_bw_hz,
              pll_order=conf.pll_filter_order,
              dll_order=conf.dll_filter_order, interp_code=conf.interp_code)
    n_win = conf.window_samples
    npadw = ((n_win + 127) // 128 + 4) * 128
    wr = np.zeros((npadw // 128, 128), np.float32)
    codes = gps_l1_ca_code_table()[:1].astype(np.float32)
    scal = np.zeros((1, 10), np.float32)
    scal[0, 2] = -0.01
    scal[0, 7] = 1.0
    taps = np.asarray(tdll.tap_offsets_chips(conf))
    o_jax = run_jax(10, conf.max_step_samples, 1023, taps, codes, wr, wr,
                    scal, 1, "qloop", **kw)
    spec = tk.make_simple_spec(10, conf.max_step_samples, 1023, taps, **kw)
    o_port = run_port(spec, codes, wr, wr, scal, 1)
    assert_simple_close(o_jax, o_port, 3)
    n, rem = o_port[0, :, 10], o_port[0, :, 13]
    assert np.all((n >= 2600) & (n <= 2601)), n
    assert np.all((rem >= 0.0) & (rem < 1.0)), rem


@pytest.mark.parametrize("pos,en,why", [
    (5.5, 1.0, "non-integral position"),
    (float(1 << 24), 0.0, "position at 2^24"),
    (-1.0, 0.0, "negative position"),
    (40_000.0, 1.0, "window overrun"),
])
def test_track_simple_rejects(pos, en, why):
    spec = tk.make_simple_spec(4, 2666, 1023, TAPS3, pll_bw_hz=25.0,
                               dll_bw_hz=2.0, **KW)
    codes = torch.ones((2, 1023), dtype=torch.float32)
    window = torch.zeros(4 * 2666 + 39_999, dtype=torch.complex64)
    scal = torch.zeros((2, 10), dtype=torch.float32)
    scal[:, 7] = 1.0
    scal[1, 0] = pos
    scal[1, 7] = en
    with pytest.raises(ValueError):
        tk.track_simple(window, codes, scal, spec)
    # the same channel at position 0 is accepted
    scal[1, 0] = 0.0
    assert tk.track_simple(window, codes, scal, spec).shape == (2, 4, 128)


def test_make_simple_spec_rejects():
    with pytest.raises(ValueError):
        tk.make_simple_spec(4, 2666, 1023, [0.0, 0.1], pll_bw_hz=25.0,
                            dll_bw_hz=2.0, **KW)
    with pytest.raises(ValueError):
        tk.make_simple_spec(4, 2666, 1023, TAPS3, pll_bw_hz=25.0,
                            dll_bw_hz=2.0, pll_order=4, **KW)


def test_fused_scalars_from_state_matches_jax():
    kw = dict(fs=FS, code_length_chips=1023, code_rate_cps=1.023e6,
              carrier_freq_hz=1575.42e6, max_channels=4, steps_per_block=8)
    jconf, tconf = JConf(**kw), TConf(**kw)
    s = jdll.init_state(jconf)
    s = s._replace(
        enabled=jnp.asarray([True, False, True, True]),
        pos=jnp.asarray([5, 1000, 77777, 3], s.pos.dtype),
        rem_code_phase=jnp.asarray([0.21, 0.52, 0.83, 0.0],
                                   s.rem_code_phase.dtype),
        code_freq=jnp.asarray(1.023e6 + np.array([0.5, -1.25, 3.0, 0.0]),
                              s.code_freq.dtype),
        carrier_phase=jnp.asarray([-7.5, 100.25, 3.0, 13.0],
                                  s.carrier_phase.dtype),
        carrier_doppler=jnp.asarray([1200.0, -2500.0, 400.0, 3100.0],
                                    s.carrier_doppler.dtype),
        pll_state=jnp.asarray([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0],
                               [7.0, 8.0]], s.pll_state.dtype),
        dll_state=jnp.asarray([[0.1, 0.2], [0.3, 0.4], [0.5, 0.6],
                               [0.7, 0.8]], s.dll_state.dtype),
    )
    want = np.asarray(jax_fused_scalars(s, jconf))
    st = tdll.state_from_numpy({k: np.asarray(v)
                                for k, v in s._asdict().items()}, "cpu")
    got = tk.fused_scalars_from_state(st, tconf).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 10)
    np.testing.assert_array_equal(got, want)
