"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one. The file imports no
JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu_torch.ops import correlator as k3
from gnss_sdr_tpu_torch.ops import track_kernel as k2
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
from gnss_sdr_tpu_torch.ops.correlator import pack_code_table
from gnss_sdr_tpu_torch.tools import mosaic_probe as p1

from torch_cases import (
    FS,
    TAPS,
    assert_rows_close,
    correlator_inputs,
    correlator_rel_err,
    fused_noise_case,
    run_tracker,
    tracker_inputs,
)

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# K1 and K2 at every cluster size of K1 (R = 8, 8, 4, 2, 1 on an H100 SXM;
# C = 140 puts more CTAs than SMs), both replica forms, on the noise window
# of fused_noise_case: varied positions and Dopplers, extended integration
# with FLL, the atan2 flag on one channel, from C = 3 a disabled channel
# whose periods run past the end of the window (it reads zeros there) and
# from C = 5 one inside it. tests/fused_noise_divergence.py prints the same comparisons
# period by period.
FUSED_CASES = [(c, interp) for c in (1, 8, 33, 60, 140)
               for interp in (True, False)]
FUSED_IDS = [f"C{c}_{'interp' if i else 'nointerp'}" for c, i in FUSED_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("C,interp", FUSED_CASES, ids=FUSED_IDS)
def test_track_blocked_kernel_matches_plain_cuda(cuda, C, interp):
    """K1 against its plain version over two launches of K = 20: 5e-5
    relative over the first two periods, 2e-3 over all, lanes 10 and 17
    exact; launched with the cluster size of ``cluster_shape``."""
    spec, window, codes, scal, disabled = fused_noise_case(
        C, interp, k1.make_blocked_spec)
    before = k1.track_blocked.launches
    o_k = run_tracker(k1.track_blocked, spec, window, codes, scal, 2, cuda)
    torch.cuda.synchronize()
    assert k1.track_blocked.launches == before + 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert k1.track_blocked.cluster == k1.cluster_shape(C, spec.n_max, sms)[0]
    o_p = run_tracker(k1.track_blocked_plain, spec, window, codes, scal, 2,
                      cuda)
    # first two periods at the f32 bound, all 2K at the long-horizon bound
    # (reduction order differs; the closed loop amplifies it slowly)
    assert_rows_close(o_p[:, :2], o_k[:, :2], tol=5e-5)
    assert_rows_close(o_p, o_k, tol=2e-3)
    for ch in disabled:
        assert np.all(o_k[ch, :, 17] == scal[ch, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("C,interp", FUSED_CASES, ids=FUSED_IDS)
def test_track_full_kernel_matches_plain_cuda(cuda, C, interp):
    """K2 against its plain version (K1's) and against K1, at the same
    tolerances."""
    spec, window, codes, scal, disabled = fused_noise_case(
        C, interp, k2.make_full_spec)
    before = k2.track_full.launches
    o_k = run_tracker(k2.track_full, spec, window, codes, scal, 2, cuda)
    torch.cuda.synchronize()
    assert k2.track_full.launches == before + 2
    o_p = run_tracker(k2.track_full_plain, spec, window, codes, scal, 2,
                      cuda)
    assert_rows_close(o_p[:, :2], o_k[:, :2], tol=5e-5)
    assert_rows_close(o_p, o_k, tol=2e-3)
    spec1, *_ = fused_noise_case(C, interp, k1.make_blocked_spec)
    o_1 = run_tracker(k1.track_blocked, spec1, window, codes, scal, 2, cuda)
    assert_rows_close(o_1[:, :2], o_k[:, :2], tol=5e-5)
    assert_rows_close(o_1, o_k, tol=2e-3)
    for ch in disabled:
        assert np.all(o_k[ch, :, 17] == scal[ch, 0])


@pytest.mark.cuda
def test_correlator_kernel_matches_plain_cuda(cuda):
    C, N, L = 8, 2688, 1023
    codes, x, sc = correlator_inputs(C, N, L, 2602, 0)
    cq = torch.as_tensor(pack_code_table(codes), device=cuda)
    args = (torch.as_tensor(x, device=cuda), cq, cq,
            torch.as_tensor(sc, device=cuda), TAPS)
    before = k3.correlator.launches
    got = k3.correlator(*args, code_len=L).cpu().numpy()
    assert k3.correlator.launches == before + 1
    ref = k3.correlator_plain(*args, code_len=L).cpu().numpy()
    assert correlator_rel_err(got, ref, 3) < 2e-3
    assert np.all(got[:, 0, 6:] == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("taps,orders,disable", [
    (TAPS, (2, 2), None),
    ([-0.5, -0.25, 0.0, 0.25, 0.5], (3, 3), None),
    (TAPS, (3, 2), 3),
], ids=["t3_order2", "t5_order3", "disabled_channel"])
def test_track_simple_kernel_matches_plain_cuda(cuda, taps, orders, disable):
    """K4 against its plain version: 5e-5 relative over the first two
    periods, 2e-3 over all, lanes 10 and 17 exact, lanes 20-127 zero."""
    C, K, L = 8, 20, 1023
    nmax = int(np.ceil(FS * L / 1.023e6)) + 2
    spec = k2.make_simple_spec(
        K, nmax, L, taps, fs=FS, code_rate_cps=1.023e6,
        carrier_freq_hz=1575.42e6, pll_bw_hz=25.0, dll_bw_hz=2.0,
        pll_order=orders[0], dll_order=orders[1])
    codes, wr, wi, scal = tracker_inputs(C, K, L, nmax, 1, 1, 17)
    scal = np.ascontiguousarray(scal[:, :10])
    scal[:, 8] = 0.5
    if disable is not None:
        scal[disable, 7] = 0.0
    window = torch.as_tensor((wr.ravel() + 1j * wi.ravel()).astype(
        np.complex64), device=cuda)
    args = (window, torch.as_tensor(codes, device=cuda),
            torch.as_tensor(scal, device=cuda), spec)
    before = k2.track_simple.launches
    o_k = k2.track_simple(*args).cpu().numpy()
    torch.cuda.synchronize()
    assert k2.track_simple.launches == before + 1
    o_p = k2.track_simple_plain(*args).cpu().numpy()
    lanes = list(range(2 * len(taps))) + list(range(10, 20))
    assert_rows_close(o_p[:, :2], o_k[:, :2], tol=5e-5, lanes=lanes)
    assert_rows_close(o_p, o_k, tol=2e-3, lanes=lanes)
    assert np.all(o_k[:, :, 20:] == 0.0)
    if disable is not None:
        assert np.all(np.diff(o_k[disable, :, 17]) > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", p1.VARIANTS)
def test_probe_kernel_matches_plain_cuda(cuda, variant):
    """Each P1 variant against its plain version over K = 16 periods: the
    per-channel sums at the first and the last period within
    ``p1.SUMS_TOL`` (float32 sums of the same terms in another order), the
    (8, 128) output and the out-store buffer exact."""
    x = p1.probe_input(cuda)
    k = 16
    before = p1.probe.launches
    out, sums, big = p1.probe(variant, x, k)
    torch.cuda.synchronize()
    assert p1.probe.launches == before + 1
    w_out, w_sums, w_big = p1.probe_plain(variant, x, k)
    assert p1.sums_err(sums, w_sums) < p1.SUMS_TOL
    assert torch.equal(out, w_out)
    if variant == "out store":
        assert torch.equal(big, w_big)
