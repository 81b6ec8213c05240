"""Fused trackers K1 and K2 in the Galileo E1 modes: the port's plain
version against the JAX blocked kernel (Pallas, interpret mode).

The cases are smaller versions of tests/test_track_kernel_blocked.py's
E1 B+C case (8184-unit codes at 4 Msps, T = 5, VEML): C = 2 channels,
K = 6 periods, with the pilot and data secondaries of lengths 25 and 4
(counter modulo 100) and 4-period integration, and the same shape without
the pilot. Tolerance: the JAX suite's long-code bounds between its two
kernels, 2e-4 relative over the first two periods and 2e-3 over the run,
with the period length (lane 10) and position (lane 17) exact. K2's plain
version is K1's; the kernels are held to it on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.ops.track_kernel_blocked import make_fused_tracker_blocked
from gnss_sdr_tpu_torch.ops import track_kernel as tk
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as tkb

from torch_cases import (
    E1_FS,
    E1_KW,
    E1_LEN,
    assert_rows_close,
    check_lanes,
    pilot_inputs,
    run_tracker,
)

torch.set_num_threads(2)

TAPS5 = [-0.5, -0.25, 0.0, 0.25, 0.5]
C, K = 2, 6
NMAX = int(np.ceil(E1_FS * E1_LEN / 2.046e6)) + 64


@pytest.mark.parametrize("pilot,sp,sd,lcm", [
    (True, 25, 4, 100), (False, 1, 1, 1)], ids=["e1bc_pilot_veml", "veml"])
def test_plain_matches_jax_blocked_kernel_e1(pilot, sp, sd, lcm):
    kw = dict(track_pilot=True, sec_len_pilot=sp, sec_len_data=sd,
              sec_lcm=lcm) if pilot else {}
    jk = make_fused_tracker_blocked(K, NMAX, E1_LEN, 5,
                                    np.asarray(TAPS5, np.float32),
                                    interpret=True, **E1_KW, **kw)
    codes, dcodes, wr, wi, scal, secp, secd = pilot_inputs(
        C, K, NMAX, TAPS5, pilot, sp, sd, lcm, extend=4, seed=0)
    args = [jnp.asarray(wr), jnp.asarray(wi), jnp.asarray(jk.pack(codes)),
            jnp.asarray(scal)]
    if pilot:
        args += [jnp.asarray(jk.pack(dcodes)), jnp.asarray(secp),
                 jnp.asarray(secd)]
    o_jax = np.asarray(jk(*args))

    spec = tkb.make_blocked_spec(K, NMAX, E1_LEN, TAPS5, **E1_KW, **kw)
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    tables = (dcodes, secp, secd) if pilot else ()
    o_port = run_tracker(tkb.track_blocked, spec, window, codes, scal, 1,
                         "cpu", tables)
    assert o_port.shape == o_jax.shape == (C, K, 128)
    lanes = check_lanes(5)
    assert_rows_close(o_jax[:, :2], o_port[:, :2], tol=2e-4, lanes=lanes)
    assert_rows_close(o_jax, o_port, tol=2e-3, lanes=lanes)
    if pilot:
        # the data accumulator closed a symbol on every 4th secondary chip
        assert o_port[:, :, 34].sum() > 0
        np.testing.assert_array_equal(o_jax[:, :, 36], o_port[:, :, 36])
    # K2's wrapper runs the same plain version on the CPU
    spec2 = tk.make_full_spec(K, NMAX, E1_LEN, TAPS5, **E1_KW, **kw)
    o_k2 = run_tracker(tk.track_full, spec2, window, codes, scal, 1, "cpu",
                       tables)
    np.testing.assert_array_equal(o_k2, o_port)


def test_pilot_tables_checked():
    """A pilot spec needs its tables, of the spec's secondary lengths; a
    spec without the pilot refuses them."""
    spec = tkb.make_blocked_spec(2, 2666, 1023, TAPS5, fs=2.6e6,
                                 code_rate_cps=1.023e6,
                                 carrier_freq_hz=1575.42e6, track_pilot=True,
                                 sec_len_pilot=25, sec_len_data=4,
                                 sec_lcm=100)
    window = torch.zeros(8 * 2666, dtype=torch.complex64)
    codes = torch.ones(2, 1023)
    scal = torch.zeros(2, spec.num_scalars)
    pos = torch.zeros(2, dtype=torch.int32)
    good = (torch.ones(2, 1023), torch.ones(2, 25), torch.ones(2, 4))
    assert tkb.track_blocked(window, codes, scal, pos, spec,
                             *good).shape == (2, 2, 128)
    for bad in ((), (good[0], torch.ones(2, 24), good[2]),
                (good[0], good[1], torch.ones(2, 129)),
                (torch.ones(2, 1022), good[1], good[2])):
        with pytest.raises(ValueError):
            tkb.track_blocked(window, codes, scal, pos, spec, *bad)
    plain = tkb.make_blocked_spec(2, 2666, 1023, TAPS5, fs=2.6e6,
                                  code_rate_cps=1.023e6,
                                  carrier_freq_hz=1575.42e6)
    with pytest.raises(ValueError, match="without track_pilot"):
        tkb.track_blocked(window, codes, torch.zeros(2, plain.num_scalars),
                          pos, plain, *good)
