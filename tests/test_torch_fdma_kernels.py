"""FDMA (GLONASS) in the port's fused and eager engines against the JAX
package.

K1's plain version with FDMA against the JAX blocked kernel
(``make_fused_tracker_blocked(..., fdma=True)``, Pallas interpret mode) on
``tests/test_track_kernel_blocked.py::test_blocked_matches_full_fdma``'s
case: C = 6, K = 8, the 511-chip shape at 3.6 Msps, seed 5, the slot
offsets w_off from -0.5 to 0.5 rad/sample, and a second case with offsets
across [-pi, pi). Tolerance: that file's 5e-5 relative on every lane of
``check_lanes(3)``, the period length (lane 10) and position (lane 17)
exact, and the NCO phase (lane 14) exact: the plain version rounds the
carrier step, the ramp's reduction mod 2 pi and the NCO advance each as
one fused multiply-add, as XLA contracts them in the JAX kernel. K2's
wrapper runs the same plain version.

Then the port's eager engine (the samples wiped off in float64 before K3's
plain version) and fused engine (K1's plain version) against the JAX
engine's XLA path on ``tests/test_fused_receiver.py::
test_fused_matches_xla_fdma``'s signal, shortened to two blocks of 10
periods: 8 Msps, slot offsets +562.5 kHz and -1125 kHz, with that test's
tolerances (equal period lengths, Doppler within 0.5 Hz, median prompt
relative difference under 2e-2, accumulated carrier phase within 0.1 rad).
The kernels themselves are held to the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnss_sdr_tpu.codes.glonass_ca import glonass_ca_code
from gnss_sdr_tpu.ops.track_kernel_blocked import make_fused_tracker_blocked
from gnss_sdr_tpu.tracking.conf import DllPllConf as JConf
from gnss_sdr_tpu.tracking.tracker import Tracker as JTracker
from gnss_sdr_tpu_torch.ops import track_kernel as tk
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as tkb
from gnss_sdr_tpu_torch.ops.slots import S_ACC0
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf as TConf
from gnss_sdr_tpu_torch.tracking.tracker import Tracker as TTracker

from torch_cases import (
    C,
    DOPS,
    GLO_FS,
    GLO_LEN,
    TAPS,
    assert_rows_close,
    check_lanes,
    run_tracker,
)

torch.set_num_threads(2)


# that case's loop constants: the 511-chip table at GPS's chip rate
KW = dict(fs=GLO_FS, code_rate_cps=1.023e6, carrier_freq_hz=1575.42e6)


@pytest.mark.parametrize("wide", [False, True], ids=["half_rad", "pi"])
def test_plain_matches_jax_blocked_kernel_fdma(wide):
    C6, K = 6, 8
    nmax = int(np.ceil(GLO_FS * GLO_LEN / 1.023e6)) + 64
    jk = make_fused_tracker_blocked(K, nmax, GLO_LEN, 3,
                                    np.asarray(TAPS, np.float32),
                                    interpret=True, fdma=True, **KW)
    # tests/test_track_kernel_blocked.py's _run_pair draws, seed 5
    rng = np.random.default_rng(5)
    codes = np.sign(rng.normal(size=(C6, GLO_LEN))).astype(np.float32)
    codes[codes == 0] = 1.0
    rng.normal(size=(C6, GLO_LEN))
    wrows = (nmax * (K + 2)) // 128 + jk.pad_rows + 8
    wr = rng.normal(size=(wrows, 128)).astype(np.float32)
    wi = rng.normal(size=(wrows, 128)).astype(np.float32)
    scal = np.zeros((C6, S_ACC0 + 7), np.float32)
    scal[:, 0] = np.arange(C6) * 37 + 5
    scal[:, 1] = 0.2
    scal[:, 3] = 0.5
    scal[:, 4] = np.linspace(-2500, 2500, C6)
    scal[:, 7] = 1
    scal[:, 10] = 1
    scal[:, 16] = 1
    scal[:, 17] = 25.0
    scal[:, 18] = 2.0
    scal[:, S_ACC0 + 6] = (np.linspace(-np.pi, 0.999 * np.pi, C6) if wide
                           else np.linspace(-0.5, 0.5, C6))
    o_jax = np.asarray(jk(jnp.asarray(wr), jnp.asarray(wi),
                          jnp.asarray(jk.pack(codes)), jnp.asarray(scal)))

    kw = dict(KW, fdma=True)
    spec = tkb.make_blocked_spec(K, nmax, GLO_LEN, TAPS, **kw)
    assert spec.fdma
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    o_port = run_tracker(tkb.track_blocked, spec, window, codes, scal, 1,
                         "cpu")
    assert o_port.shape == o_jax.shape == (C6, K, 128)
    assert_rows_close(o_jax, o_port, lanes=check_lanes(3))
    np.testing.assert_array_equal(o_jax[:, :, 14], o_port[:, :, 14])
    o_k2 = run_tracker(tk.track_full,
                       tk.make_full_spec(K, nmax, GLO_LEN, TAPS, **kw),
                       window, codes, scal, 1, "cpu")
    np.testing.assert_array_equal(o_k2, o_port)


FS8 = 8.0e6
OFFS = [562.5e3, -1125.0e3]


def _fdma_signal(n):
    """tests/test_fused_receiver.py::test_fused_matches_xla_fdma's signal."""
    code = np.tile(glonass_ca_code().astype(np.float32), (C, 1))
    tt = np.arange(n) / FS8
    sig = np.zeros(n, np.complex64)
    for c in range(C):
        cph = (0.511e6 * (1 + DOPS[c] / 1.602e9)) * tt
        chips = code[c][np.floor(cph).astype(np.int64) % 511]
        sig += 0.5 * chips * np.exp(
            2j * np.pi * (DOPS[c] + OFFS[c]) * tt + 0.3j * c)
    rng = np.random.default_rng(5)
    sig = (sig + (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.05
           ).astype(np.complex64)
    return code, sig


def _started(trk):
    for ch in range(C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=0.0,
                          acq_doppler_hz=DOPS[ch] + 20.0,
                          acq_samplestamp=0, current_abs_sample=0,
                          carrier_offset_hz=OFFS[ch])
    return trk


def _assert_fdma_match(a, b):
    """test_fused_matches_xla_fdma's tolerances on two output dicts."""
    np.testing.assert_array_equal(a["n_samples"], b["n_samples"])
    assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < 0.5
    pa, pb = a["prompt"], b["prompt"]
    assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 2e-2
    # the accumulated phase includes the slot offset in every engine
    assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 0.1


def test_engines_match_jax_xla_fdma():
    """The port's eager and fused engines, each in its Tracker, against
    the JAX engine's XLA path and against the JAX engine of the same kind
    (the fused one on its blocked kernel in interpret mode) over two
    blocks; the second block is held to test_fused_matches_xla_fdma's
    tolerances."""
    code, sig = _fdma_signal(180_000)
    kw = dict(fs=FS8, code_length_chips=511, code_rate_cps=0.511e6,
              carrier_freq_hz=1.602e9, max_channels=C, steps_per_block=10,
              fdma=True)
    ref = {}
    for fused in (False, True):
        jt = _started(JTracker(JConf(**kw, pallas_correlator=False,
                                     fused_tracker=fused), code))
        ref[fused] = [jt.process(sig, 0) for _ in range(2)][1].outputs
    for fused in (False, True):
        tt = _started(TTracker(TConf(**kw, fused_tracker=fused), code,
                               device="cpu"))
        assert tt._block.fused == fused
        got = [tt.process(sig, 0) for _ in range(2)][1].outputs
        _assert_fdma_match(ref[False], got)
        _assert_fdma_match(ref[fused], got)
