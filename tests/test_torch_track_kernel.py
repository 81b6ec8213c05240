"""Fused tracker K1: the port's plain version against the JAX blocked
kernel (Pallas, interpret mode).

Same random inputs (numpy, from a seed) go to both packages: a complex
window, +-1 code tables and a scalar block in the slot layout of
``ops/slots.py``. The cases are the GPS ones of
``tests/test_track_kernel_blocked.py``. Tolerance: 5e-5 relative on the
checked lanes (the JAX suite's own bound between its two kernels, which
also differ in reduction order and in atan/sincos implementations); the
period length (lane 10) and position (lane 17) must agree exactly. The
kernel itself is held against the plain version in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.ops.track_kernel_blocked import make_fused_tracker_blocked
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as tkb
from gnss_sdr_tpu_torch.ops.slots import S_ACC0

from torch_cases import (
    FS,
    SD,
    SP,
    TAPS,
    assert_rows_close,
    carry,
    check_lanes,
    pilot_inputs,
    run_tracker,
    tracker_inputs,
)

torch.set_num_threads(2)

KW = dict(fs=FS, code_rate_cps=1.023e6, carrier_freq_hz=1575.42e6)


@pytest.mark.parametrize("C,K,launches,extend,order,seed", [
    (6, 8, 1, 1, 2, 0),     # plain GPS
    (5, 6, 2, 2, 2, 0),     # two-launch carry, extended integration
    (6, 8, 1, 1, 3, 7),     # order-3 PLL and DLL
    (5, 4, 1, 1, 2, 9),     # odd channel count
], ids=["gps", "two_launch_carry", "order3", "odd_channels"])
def test_plain_matches_jax_blocked_kernel(C, K, launches, extend, order,
                                          seed):
    L = 1023
    nmax = int(np.ceil(FS * L / 1.023e6)) + 64
    kw = dict(KW, pll_order=order, dll_order=order)
    jk = make_fused_tracker_blocked(K, nmax, L, 3,
                                    np.asarray(TAPS, np.float32),
                                    interpret=True, **kw)
    codes, wr, wi, scal = tracker_inputs(C, K, L, nmax, launches, extend,
                                         seed)
    cb = jnp.asarray(jk.pack(codes))
    outs, s = [], scal
    for _ in range(launches):
        o = np.asarray(jk(jnp.asarray(wr), jnp.asarray(wi), cb,
                          jnp.asarray(s)))
        outs.append(o)
        s = carry(s, o)
    o_jax = np.concatenate(outs, axis=1)

    spec = tkb.make_blocked_spec(K, nmax, L, TAPS, **kw)
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    o_port = run_tracker(tkb.track_blocked, spec, window, codes, scal,
                         launches, "cpu")
    assert o_port.shape == o_jax.shape == (C, K * launches, 128)
    assert_rows_close(o_jax, o_port)


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
        spec = tkb.make_blocked_spec(4, 2666, 1023, TAPS, fdma=True, **kw, **KW)
        assert spec.fdma and spec.track_pilot == pilot
        codes, dcodes, wr, wi, scal, secp, secd = pilot_inputs(
            3, 4, 2666, TAPS, pilot, SP, SD, SP * SD, 1, 3, code_len=1023)
        window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
        tables = (dcodes, secp, secd) if pilot else ()
        o_cdma = run_tracker(tkb.track_blocked, tkb.make_blocked_spec(
            4, 2666, 1023, TAPS, **kw, **KW), window, codes, scal, 1, "cpu",
            tables)
        o_zero = run_tracker(tkb.track_blocked, spec, window, codes, scal, 1,
                             "cpu", tables)
        assert_rows_close(o_cdma, o_zero, lanes=check_lanes(3))
        scal[:, S_ACC0 + 6] = [-3.0, 0.4, 2.5]
        o_fdma = run_tracker(tkb.track_blocked, spec, window, codes, scal, 1,
                             "cpu", tables)
        assert np.isfinite(o_fdma).all()
        assert ((o_fdma[:, :, 14] >= 0.0)
                & (o_fdma[:, :, 14] < 2 * np.pi)).all()
        assert not np.allclose(o_fdma[:, :, :6], o_zero[:, :, :6])
    with pytest.raises(ValueError, match="3 or 5 taps"):
        tkb.make_blocked_spec(4, 2666, 1023, [-0.5, -0.25, 0.25, 0.5], **KW)
    with pytest.raises(ValueError, match="secondary"):
        tkb.make_blocked_spec(4, 2666, 1023, TAPS, track_pilot=True,
                              sec_len_pilot=129, sec_lcm=129, **KW)


def test_window_overrun_raises():
    spec = tkb.make_blocked_spec(4, 2666, 1023, TAPS, **KW)
    codes, _, _, scal = tracker_inputs(2, 4, 1023, 2666, 1, 1, 0)
    window = torch.zeros(4 * 2666, dtype=torch.complex64)
    pos = torch.tensor([0, 5], dtype=torch.int32)
    with pytest.raises(ValueError):
        tkb.track_blocked(window, torch.as_tensor(codes),
                          torch.as_tensor(scal), pos, spec)
