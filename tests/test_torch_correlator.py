"""Correlator K3: the port's plain version against the JAX Pallas kernel
(interpret mode), on the case of tests/test_pallas_correlator.py (C=4,
N=2544 padded to 2560, L=1023, T=3) and its 10230-chip variant,
with that test's bound: relative error below 2e-3. The kernel itself is
held against the plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.ops.correlator import make_correlator
from gnss_sdr_tpu_torch.ops import correlator as k3

from torch_cases import TAPS, correlator_inputs, correlator_rel_err

torch.set_num_threads(2)

C, N, L = 4, 2544, 1023


@pytest.mark.parametrize("code_len,interp,pilot", [
    (L, True, False), (L, False, False), (L, True, True), (10230, True, False),
], ids=["interp", "nearest_chip", "data_prompt", "code_10230"])
def test_plain_matches_jax_correlator(code_len, interp, pilot):
    """The plain version, whose ramps multiply by the reciprocal code step,
    against the JAX kernel, which divides by the step."""
    t = len(TAPS)
    jfn = make_correlator(N, code_len, t, np.asarray(TAPS, np.float32),
                          track_pilot=pilot, interp_code=interp,
                          interpret=True)
    codes, x, sc = correlator_inputs(C, jfn.npad, code_len, 2542, 0)
    dcodes = -codes[:, ::-1].copy()
    cq, dq = k3.pack_code_table(codes), k3.pack_code_table(dcodes)
    ref = np.asarray(jfn(jnp.asarray(x.real), jnp.asarray(x.imag),
                         jnp.asarray(cq), jnp.asarray(dq), jnp.asarray(sc)))
    got = k3.correlator(torch.as_tensor(x), torch.as_tensor(cq),
                        torch.as_tensor(dq), torch.as_tensor(sc), TAPS,
                        code_len=code_len, interp_code=interp,
                        track_pilot=pilot).numpy()
    assert got.shape == ref.shape == (C, 1, 128)
    nt = t + 1 if pilot else t
    assert correlator_rel_err(got, ref, nt) < 2e-3
    assert np.all(got[:, 0, 2 * nt:] == 0.0)


def test_wrapper_checks_inputs():
    codes, x, sc = correlator_inputs(2, 256, L, 200, 1)
    cq = torch.as_tensor(k3.pack_code_table(codes))
    xt, st = torch.as_tensor(x), torch.as_tensor(sc)
    with pytest.raises(ValueError):
        k3.correlator(xt.to(torch.complex128), cq, cq, st, TAPS, code_len=L)
    with pytest.raises(ValueError):
        k3.correlator(xt, cq, cq, st[:, :6].contiguous(), TAPS, code_len=L)
    with pytest.raises(ValueError):
        k3.correlator(xt, cq, cq, st, [0.0, 0.5], code_len=L)
    before = k3.correlator.launches
    k3.correlator(xt, cq, cq, st, TAPS, code_len=L)
    assert k3.correlator.launches == before     # the CPU runs no kernel
