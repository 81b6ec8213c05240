"""Per-channel fused tracker K2: the port's ``track_full`` on the CPU (its
plain version, which is K1's) against the JAX per-channel kernel
``make_fused_tracker_full`` (Pallas, interpret mode).

The same random inputs (numpy, from a seed) go to both packages: a complex
window (as [rows, 128] re/im planes for JAX), +-1 code tables (packed for
JAX by its own ``pack_code_table``) and a scalar block in the slot layout
of ``ops/slots.py``; the port takes the float ``S_POS`` slot as int32
positions (``torch_cases.run_tracker``). Tolerance: 5e-5 relative on the
checked lanes (the JAX suite's bound between its kernels, which differ in
reduction order and in atan/sincos implementations); period length
(lane 10) and position (lane 17) exact. The kernel itself is held against
its plain version in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu.ops.correlator import pack_code_table
from gnss_sdr_tpu.ops.track_kernel import make_fused_tracker_full
from gnss_sdr_tpu_torch.ops import track_kernel as tk
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as tkb
from gnss_sdr_tpu_torch.ops.slots import S_ACC0
from gnss_sdr_tpu_torch.tracking import fused
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
from gnss_sdr_tpu_torch.tracking.tracker import Tracker

from torch_cases import (
    C as C2,
    DOPS,
    FS,
    SD,
    SP,
    TAPS,
    assert_rows_close,
    carry,
    check_lanes,
    conf_kw,
    make_signal,
    pilot_inputs,
    run_tracker,
    tracker_inputs,
)

torch.set_num_threads(2)

KW = dict(fs=FS, code_rate_cps=1.023e6, carrier_freq_hz=1575.42e6)


@pytest.mark.parametrize("C,K,launches,extend,order,seed,flags", [
    (4, 8, 1, 1, 2, 0, {}),                   # plain GPS
    (3, 6, 2, 2, 2, 0, {}),                   # two-launch carry, integ_len 2
    (4, 8, 1, 1, 3, 7, {}),                   # order-3 PLL and DLL
    (5, 4, 1, 1, 2, 9, {}),                   # odd channel count
    (3, 8, 1, 1, 2, 3, {15: 1.0, 16: 1.0}),   # atan2 and FLL flags on
    (3, 6, 1, 1, 2, 5, {"disable": 1}),       # one disabled channel
], ids=["gps", "two_launch_carry", "order3", "odd_channels", "fll_atan2",
        "disabled_channel"])
def test_track_full_matches_jax_full_kernel(C, K, launches, extend, order,
                                            seed, flags):
    L = 1023
    nmax = int(np.ceil(FS * L / 1.023e6)) + 64
    kw = dict(KW, pll_order=order, dll_order=order)
    codes, wr, wi, scal = tracker_inputs(C, K, L, nmax, launches, extend,
                                         seed)
    for slot, v in flags.items():
        if slot == "disable":
            scal[v, 7] = 0.0
        else:
            scal[:, slot] = v

    jk = make_fused_tracker_full(K, nmax, L, 3, np.asarray(TAPS, np.float32),
                                 interpret=True, **kw)
    cq = jnp.asarray(pack_code_table(codes))
    outs, s = [], scal
    for _ in range(launches):
        o = np.asarray(jk(jnp.asarray(wr), jnp.asarray(wi), cq,
                          jnp.asarray(s)))
        outs.append(o)
        s = carry(s, o)
    o_jax = np.concatenate(outs, axis=1)

    spec = tk.make_full_spec(K, nmax, L, TAPS, **kw)
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    o_port = run_tracker(tk.track_full, spec, window, codes, scal, launches,
                         "cpu")
    assert o_port.shape == o_jax.shape == (C, K * launches, 128)
    assert_rows_close(o_jax, o_port)
    if "disable" in flags:
        ch = flags["disable"]
        # a disabled channel holds its position and NCO state
        assert np.all(o_port[ch, :, 17] == scal[ch, 0])
        assert np.all(o_port[ch, :, 13] == scal[ch, 1])


def test_unsupported_modes_raise():
    """FDMA builds and runs, with or without the pilot mode: at a zero slot
    offset its block is the CDMA block within float32 rounding, at an
    offset it is another (the JAX parity of the FDMA mode:
    tests/test_torch_fdma_kernels.py). A tap count other than 3 or 5 and a
    secondary code longer than a 128-chip table row are refused (T = 5 and
    the pilot mode run: tests/test_torch_galileo_kernels.py)."""
    for pilot in (False, True):
        kw = dict(track_pilot=True, sec_len_pilot=SP, sec_len_data=SD,
                  sec_lcm=SP * SD) if pilot else {}
        spec = tk.make_full_spec(4, 2666, 1023, TAPS, fdma=True, **kw, **KW)
        assert spec.fdma and spec.track_pilot == pilot
        codes, dcodes, wr, wi, scal, secp, secd = pilot_inputs(
            3, 4, 2666, TAPS, pilot, SP, SD, SP * SD, 1, 3, code_len=1023)
        window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
        tables = (dcodes, secp, secd) if pilot else ()
        o_cdma = run_tracker(tk.track_full, tk.make_full_spec(
            4, 2666, 1023, TAPS, **kw, **KW), window, codes, scal, 1, "cpu",
            tables)
        o_zero = run_tracker(tk.track_full, spec, window, codes, scal, 1,
                             "cpu", tables)
        assert_rows_close(o_cdma, o_zero, lanes=check_lanes(3))
        scal[:, S_ACC0 + 6] = [-3.0, 0.4, 2.5]
        o_fdma = run_tracker(tk.track_full, spec, window, codes, scal, 1,
                             "cpu", tables)
        assert np.isfinite(o_fdma).all()
        assert ((o_fdma[:, :, 14] >= 0.0)
                & (o_fdma[:, :, 14] < 2 * np.pi)).all()
        assert not np.allclose(o_fdma[:, :, :6], o_zero[:, :, :6])
    with pytest.raises(ValueError, match="3 or 5 taps"):
        tk.make_full_spec(4, 2666, 1023, [-0.5, -0.25, 0.25, 0.5], **KW)
    with pytest.raises(ValueError, match="secondary"):
        tk.make_full_spec(4, 2666, 1023, TAPS, track_pilot=True,
                          sec_len_pilot=129, sec_lcm=129, **KW)


def test_window_overrun_raises():
    spec = tk.make_full_spec(4, 2666, 1023, TAPS, **KW)
    codes, _, _, scal = tracker_inputs(2, 4, 1023, 2666, 1, 1, 0)
    window = torch.zeros(4 * 2666, dtype=torch.complex64)
    pos = torch.tensor([0, 5], dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.track_full(window, torch.as_tensor(codes), torch.as_tensor(scal),
                      pos, spec)


@pytest.mark.parametrize("env,want", [("perchannel", "track_full"),
                                      ("blocked", "track_blocked"),
                                      (None, "track_blocked")])
def test_env_selects_fused_kernel(monkeypatch, env, want):
    """GNSS_SDR_TPU_FUSED=perchannel makes the fused engine run K2 (and
    only K2); any other value, or none, runs K1."""
    if env is None:
        monkeypatch.delenv("GNSS_SDR_TPU_FUSED", raising=False)
    else:
        monkeypatch.setenv("GNSS_SDR_TPU_FUSED", env)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused, "track_full",
                        spy("track_full", tk.track_full))
    monkeypatch.setattr(fused, "track_blocked",
                        spy("track_blocked", tkb.track_blocked))
    tbl = gps_l1_ca_code_table()[:C2].astype(np.float32)
    trk = Tracker(DllPllConf(**conf_kw(fused_tracker=True)), tbl,
                  device="cpu")
    assert trk._block.spec.kernel == want
    for ch in range(C2):
        trk.start_channel(ch, prn=ch + 1, code_row=ch, acq_delay_samples=0.0,
                          acq_doppler_hz=DOPS[ch], acq_samplestamp=0,
                          current_abs_sample=0)
    trk.process(make_signal(tbl, 100_000), 0)
    trk.process(make_signal(tbl, 200_000), 0)
    assert calls == [want, want]
