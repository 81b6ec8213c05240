"""The hard code replica's chip edge, on the channels where the noise window
of seed 44 parts a kernel from its plain version.

``tests/fused_noise_divergence.py 44`` parts K2 from the plain version at
C = 33, channel 24, period 5, and K4 at C = 33 (T = 5), channel 9, period
37 and at C = 140, channel 84, period 14, all with the hard replica
(``interp_code=False``): a tap jumps by one sample's weight (about 1 in a
sum of about 50), and the closed loop carries the jump on. That replica
takes ``code[floor(phase)]``, a step function of the code phase, and on
these channels one sample's float32 code phase lies within an ulp or two
of a chip boundary: the two sides' remnants (lane 13) differ by one or two
ulps after a few periods of sums taken in another order, and the sample
lands on the neighbouring chip. This is a deliberate difference, not a
fault of either side: the JAX kernel (interpret mode) sits on the same
edge. On each channel, extracted as a C = 1 case: the plain version holds
to the JAX kernel period by period up to K2's event; from the state that
reaches the event, the plain version's tap jumps within a few ulps of
the remnant, and the JAX kernel gives the plain version's taps on both
sides of the jump.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.ops.correlator import pack_code_table
from gnss_sdr_tpu.ops.track_kernel import (
    make_fused_tracker,
    make_fused_tracker_full,
)
from gnss_sdr_tpu_torch.ops import track_kernel as tk
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as tkb

from torch_cases import (
    FS,
    TAPS,
    TAPS5,
    assert_rows_close,
    carry,
    fused_noise_case,
    run_simple,
    run_tracker,
    simple_carry,
    simple_noise_case,
)

torch.set_num_threads(2)

KW = dict(fs=FS, code_rate_cps=1.023e6, carrier_freq_hz=1575.42e6,
          pll_order=3, dll_order=2, interp_code=False)
SIMPLE_KW = dict(KW, pll_bw_hz=25.0, dll_bw_hz=2.0)
NUDGES = range(-3, 4)            # ulps of the remnant around the event


def planes(window):
    return (jnp.asarray(np.ascontiguousarray(window.real.reshape(-1, 128))),
            jnp.asarray(np.ascontiguousarray(window.imag.reshape(-1, 128))))


def nudged(scal, ulps):
    """``scal`` with the remnant (slot 1) moved by ``ulps`` float32 ulps."""
    s = scal.copy()
    s[0, 1] = s[0, 1] + ulps * np.spacing(s[0, 1])
    return s


def fused_case(C, ch):
    """Channel ``ch`` of fused_noise_case(C, hard, seed 44) as a C = 1
    case: one-period steppers of the JAX kernel and of the plain version,
    the carry between periods and the seed scalars."""
    spec, window, codes, scal, _ = fused_noise_case(
        C, False, tkb.make_blocked_spec, 44)
    codes, scal = codes[ch:ch + 1], scal[ch:ch + 1]
    wr, wi = planes(window)
    jk = make_fused_tracker_full(1, spec.n_max, 1023, 3,
                                 np.asarray(TAPS, np.float32),
                                 interpret=True, **KW)
    cq = jnp.asarray(pack_code_table(codes))
    sp = tkb.make_blocked_spec(1, spec.n_max, 1023, TAPS, **KW)
    return (lambda s: np.asarray(jk(wr, wi, cq, jnp.asarray(s))),
            lambda s: run_tracker(tkb.track_blocked_plain, sp, window, codes,
                                  s, 1, "cpu"),
            carry, scal)


def simple_case(C, ch, taps):
    """As ``fused_case`` for K4 (simple_noise_case, hard, seed 44)."""
    spec, window, codes, scal, _ = simple_noise_case(
        C, False, taps, tk.make_simple_spec, seed=44)
    codes, scal = codes[ch:ch + 1], scal[ch:ch + 1]
    wr, wi = planes(window)
    jk = make_fused_tracker(1, spec.n_max, 1023, len(taps),
                            np.asarray(taps, np.float32), replica="qloop",
                            interpret=True, **SIMPLE_KW)
    cq = jnp.asarray(pack_code_table(codes))
    sp = tk.make_simple_spec(1, spec.n_max, 1023, taps, **SIMPLE_KW)
    return (lambda s: np.asarray(jk(wr, wi, cq, jnp.asarray(s))),
            lambda s: run_simple(tk.track_simple_plain, sp, window, codes, s,
                                 1, "cpu"),
            simple_carry, scal)


# (kernel, C, channel, event period, taps, JAX periods before the event):
# the JAX kernel runs up to K2's event (5 periods); K4's events come after
# 37 and 14 periods, which the plain version runs alone
EDGES = [("K2", 33, 24, 5, TAPS, 5), ("K4", 33, 9, 37, TAPS5, 0),
         ("K4", 140, 84, 14, TAPS, 0)]


@pytest.mark.parametrize("kernel,C,ch,k,taps,run_up", EDGES,
                         ids=["K2_C33_ch24", "K4_T5_C33_ch9", "K4_C140_ch84"])
def test_hard_replica_chip_edge_matches_jax(kernel, C, ch, k, taps, run_up):
    T = len(taps)
    # K4's rows fill the taps and lanes 10-19 (test_torch_track_kernel_simple)
    kw = dict(lanes=list(range(2 * T)) + list(range(10, 20))) \
        if kernel == "K4" else {}
    jax_step, port_step, next_scal, state = (
        fused_case(C, ch) if kernel == "K2" else simple_case(C, ch, taps))
    # period by period up to the event: the plain version holds to the JAX
    # kernel from the same state, and carries on from its own
    for i in range(k):
        o_port = port_step(state)
        if i < run_up:
            assert_rows_close(jax_step(state), o_port, **kw)
        state = next_scal(state, o_port)
    # the event period at a few ulps of the remnant around the state: within
    # them one tap moves by one sample's weight (about 1: 2 x a
    # unit-variance sample), the others stay put
    got = {u: port_step(nudged(state, u))[0, 0, :2 * T] for u in NUDGES}
    jumps = {u: np.abs(got[u] - got[0]) for u in NUDGES}
    edge = min((u for u in NUDGES if jumps[u].max() > 0.2), key=abs)
    assert np.sum(jumps[edge] > 1e-3) <= 4, jumps[edge]
    # and the JAX kernel takes the plain version's side on both
    for u in (0, edge):
        s = nudged(state, u)
        assert_rows_close(jax_step(s), port_step(s), **kw)
