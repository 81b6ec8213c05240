"""Fused tracker K1 at the long-code shape of GPS L5 and Galileo E5a: the
port's plain version against the JAX blocked kernel (Pallas, interpret
mode).

10230-chip pilot and data codes at 10.4 Msps (n_max 10402 samples, as
the plans give it), T = 3 with the pilot: the secondary engaged, atan2,
20-period integration, C = 2, with E5a's secondary lengths (CS100 on the
pilot, 20 on the data, the counter modulo 100) and L5's (NH20, NH10,
modulo 20). The integration counters start two periods
short of their boundary and the secondary counters one and two chips
short of a data-symbol boundary, so the K = 4 periods close one
integration (the loop update) and one data symbol on each channel.
Tolerance: the JAX suite's long-code bounds between its two kernels,
2e-4 relative over the first two periods and 2e-3 over the run, with the
period length (lane 10) and position (lane 17) exact, on every tap, the
tap and data accumulators and the secondary lanes. K2's wrapper runs the
same plain version on the CPU; both kernels are held to it on the card
in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.ops.track_kernel_blocked import make_fused_tracker_blocked
from gnss_sdr_tpu_torch.ops import track_kernel as tk
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as tkb
from gnss_sdr_tpu_torch.ops.slots import S_INTEG_CNT, S_SEC_IDX

from torch_cases import (
    L5_KW,
    L5_LEN,
    L5_NMAX,
    TAPS,
    assert_rows_close,
    check_lanes,
    pilot_inputs,
    run_tracker,
)

torch.set_num_threads(2)

C, K, EXTEND = 2, 4, 20


@pytest.mark.parametrize("SP,SD,LCM", [(100, 20, 100), (20, 10, 20)],
                         ids=["e5a_cs100", "l5_nh20"])
def test_plain_matches_jax_blocked_kernel_long_code(SP, SD, LCM):
    kw = dict(track_pilot=True, sec_len_pilot=SP, sec_len_data=SD,
              sec_lcm=LCM)
    jk = make_fused_tracker_blocked(K, L5_NMAX, L5_LEN, 3,
                                    np.asarray(TAPS, np.float32),
                                    interpret=True, **L5_KW, **kw)
    codes, dcodes, wr, wi, scal, secp, secd = pilot_inputs(
        C, K, L5_NMAX, TAPS, True, SP, SD, LCM, extend=EXTEND, seed=5,
        code_len=L5_LEN)
    scal[:, S_INTEG_CNT] = EXTEND - 2
    scal[:, S_SEC_IDX] = [SD - 1, 2 * SD - 2]
    args = [jnp.asarray(wr), jnp.asarray(wi), jnp.asarray(jk.pack(codes)),
            jnp.asarray(scal), jnp.asarray(jk.pack(dcodes)),
            jnp.asarray(secp), jnp.asarray(secd)]
    o_jax = np.asarray(jk(*args))

    spec = tkb.make_blocked_spec(K, L5_NMAX, L5_LEN, TAPS, **L5_KW, **kw)
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    tables = (dcodes, secp, secd)
    o_port = run_tracker(tkb.track_blocked, spec, window, codes, scal, 1,
                         "cpu", tables)
    assert o_port.shape == o_jax.shape == (C, K, 128)
    lanes = check_lanes(3)
    assert_rows_close(o_jax[:, :2], o_port[:, :2], tol=2e-4, lanes=lanes)
    assert_rows_close(o_jax, o_port, tol=2e-3, lanes=lanes)
    # one loop update (lane 20) and one data symbol (lane 34) a channel
    for lane in (20, 34):
        np.testing.assert_array_equal(o_jax[:, :, lane], o_port[:, :, lane])
        np.testing.assert_array_equal(o_port[:, :, lane].sum(axis=1), [1, 1])
    np.testing.assert_array_equal(o_jax[:, :, 36], o_port[:, :, 36])
    spec2 = tk.make_full_spec(K, L5_NMAX, L5_LEN, TAPS, **L5_KW, **kw)
    o_k2 = run_tracker(tk.track_full, spec2, window, codes, scal, 1, "cpu",
                       tables)
    np.testing.assert_array_equal(o_k2, o_port)
