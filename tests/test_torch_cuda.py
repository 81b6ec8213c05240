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
from gnss_sdr_tpu_torch.ops.slots import S_INTEG_CNT, S_SEC_IDX
from gnss_sdr_tpu_torch.tools import mosaic_probe as p1

from torch_cases import (
    B1I_FS,
    B1I_KW,
    B1I_LEN,
    B1I_NMAX,
    C as PILOT_C,
    CHECK_LANES,
    D1_SECS,
    DOPS,
    E1_KW,
    E1_LEN,
    FS,
    GLO_FS,
    GLO_KW,
    GLO_LEN,
    GLO_NMAX,
    L5_FS,
    L5_KW,
    L5_LEN,
    L5_NMAX,
    L2C_KW,
    L2C_LEN,
    L2C_NMAX,
    SD,
    SP,
    TAPS,
    TAPS5,
    assert_rows_close,
    assert_split_at_chip_edge,
    carry,
    check_lanes,
    correlator_inputs,
    correlator_rel_err,
    conf_kw,
    d1_block,
    d1_inputs,
    d1_signal,
    e1b_cboc_baseband,
    fdma_noise_inputs,
    fused_noise_case,
    glonass_block,
    glonass_signal,
    long_code_block,
    long_code_signal,
    make_signal,
    pilot_inputs,
    pilot_signal,
    pilot_tables,
    run_simple,
    run_tracker,
    simple_carry,
    simple_noise_case,
)

torch.set_num_threads(2)

# the loop constants of torch_cases' noise-window cases
FUSED_KW = dict(fs=FS, code_rate_cps=1.023e6, carrier_freq_hz=1575.42e6,
                pll_order=3, dll_order=2)
SIMPLE_KW = dict(FUSED_KW, pll_bw_hz=25.0, dll_bw_hz=2.0)


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


# seed 44's noise window at C = 33 (R = 4), where the hard replica meets a
# chip edge: every channel of K1, K2 and K4 within 2e-3 of the plain
# version, lanes 10 and 17 exact, except where the split is that edge
# (torch_cases.assert_split_at_chip_edge). On the card K2 parts there at
# channel 24 (T = 3) and K4 at channel 9 (T = 5); the JAX kernel sits on the
# same edges (tests/test_torch_hard_replica_edge.py).
SEED44_CASES = [(k, 3, i) for k in ("K1", "K2") for i in (True, False)] + [
    ("K4", t, i) for t in (3, 5) for i in (True, False)]
SEED44_IDS = [f"{k}_T{t}_{'interp' if i else 'nointerp'}"
              for k, t, i in SEED44_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,T,interp", SEED44_CASES, ids=SEED44_IDS)
def test_seed44_noise_window_cuda(cuda, kernel, T, interp):
    C = 33
    if kernel == "K4":
        taps = TAPS if T == 3 else TAPS5
        spec, window, codes, scal, _ = simple_noise_case(
            C, interp, taps, k2.make_simple_spec, seed=44)
        o_k = run_simple(k2.track_simple, spec, window, codes, scal, 2, cuda)
        o_p = run_simple(k2.track_simple_plain, spec, window, codes, scal, 2,
                         cuda)
        spec1 = k2.make_simple_spec(1, spec.n_max, spec.code_len, taps,
                                    **SIMPLE_KW, interp_code=interp)

        def step(ch, rows):
            s = simple_carry(scal[ch:ch + 1], rows[None])
            return run_simple(k2.track_simple_plain, spec1, window,
                              codes[ch:ch + 1], s, 1, cuda)[0, 0]
    else:
        make = k1.make_blocked_spec if kernel == "K1" else k2.make_full_spec
        spec, window, codes, scal, _ = fused_noise_case(C, interp, make, 44)
        fn = k1.track_blocked if kernel == "K1" else k2.track_full
        o_k = run_tracker(fn, spec, window, codes, scal, 2, cuda)
        o_p = run_tracker(k1.track_blocked_plain, spec, window, codes, scal,
                          2, cuda)
        spec1 = k1.make_blocked_spec(1, spec.n_max, spec.code_len, TAPS,
                                     **FUSED_KW, interp_code=interp)

        def step(ch, rows):
            s = carry(scal[ch:ch + 1], rows[None])
            return run_tracker(k1.track_blocked_plain, spec1, window,
                               codes[ch:ch + 1], s, 1, cuda)[0, 0]
    lanes = (list(range(2 * T)) + list(range(10, 20)) if kernel == "K4"
             else CHECK_LANES)
    assert_rows_close(o_p[:, :2], o_k[:, :2], tol=5e-5, lanes=lanes)
    split = assert_split_at_chip_edge(o_p, o_k, step, T,
                                      2 * float(np.abs(window).max()))
    assert interp is False or split == []
    keep = [c for c in range(C) if c not in split]
    assert_rows_close(o_p[keep], o_k[keep], tol=2e-3, lanes=lanes)


# K3 at every cluster size (R = 8, 8, 4, 1 at C = 1, 8, 33, 140 on an H100
# SXM), T = 3 and 5, then the nearest-chip replica, the data prompt, rows of
# an odd length (not 16-byte aligned: the float2 loads) and a 10230-chip
# code: (C, T, interp, pilot, N, L)
CORR_CASES = ([(c, t, True, False, 2688, 1023) for c in (1, 8, 33, 140)
               for t in (3, 5)]
              + [(8, 3, False, False, 2688, 1023),
                 (8, 5, True, True, 2688, 1023),
                 (8, 3, True, False, 2601, 1023),
                 (8, 3, True, True, 26112, 10230),
                 (8, 3, True, True, 10402, 10230)])
CORR_IDS = ([f"C{c}_T{t}" for c in (1, 8, 33, 140) for t in (3, 5)]
            + ["nearest_chip", "data_prompt_t5", "odd_rows", "code_10230",
               "l5_e5a_period"])


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,interp,pilot,N,L", CORR_CASES, ids=CORR_IDS)
def test_correlator_kernel_matches_plain_cuda(cuda, C, T, interp, pilot, N,
                                              L):
    """K3 against its plain version within 2e-3 (the JAX test's measure),
    zeros past the 2T (+2) sums; launched with the cluster size of
    ``cluster_shape``."""
    taps = TAPS if T == 3 else TAPS5
    codes, x, sc = correlator_inputs(C, N, L, N - 86, 0)
    dcodes = -codes[:, ::-1].copy()
    args = (torch.as_tensor(x, device=cuda),
            torch.as_tensor(pack_code_table(codes), device=cuda),
            torch.as_tensor(pack_code_table(dcodes), device=cuda),
            torch.as_tensor(sc, device=cuda), taps)
    kw = dict(code_len=L, interp_code=interp, track_pilot=pilot)
    before = k3.correlator.launches
    got = k3.correlator(*args, **kw).cpu().numpy()
    assert k3.correlator.launches == before + 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert k3.correlator.cluster == k1.cluster_shape(C, N, sms)[0]
    ref = k3.correlator_plain(*args, **kw).cpu().numpy()
    nt = T + 1 if pilot else T
    assert correlator_rel_err(got, ref, nt) < 2e-3
    assert np.all(got[:, 0, 2 * nt:] == 0.0)


# K4 on the noise window at every cluster size of K1's rule, T = 3 (NELP)
# and 5 (VEML), both replica forms, and one 10230-chip code: (C, T, interp,
# L)
SIMPLE_CASES = ([(c, t, i, 1023) for c in (1, 8, 33, 140) for t in (3, 5)
                 for i in (True, False)] + [(8, 3, True, 10230)])
SIMPLE_IDS = [f"C{c}_T{t}_{'interp' if i else 'nointerp'}_L{n}"
              for c, t, i, n in SIMPLE_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,interp,L", SIMPLE_CASES, ids=SIMPLE_IDS)
def test_track_simple_kernel_matches_plain_cuda(cuda, C, T, interp, L):
    """K4 against its plain version over two launches of K = 20: 5e-5
    relative over the first two periods, 2e-3 over all, lanes 10 and 17
    exact, the other lanes zero; disabled channels advance; launched with
    the cluster size of ``cluster_shape``."""
    spec, window, codes, scal, disabled = simple_noise_case(
        C, interp, TAPS if T == 3 else TAPS5, k2.make_simple_spec, L)
    before = k2.track_simple.launches
    o_k = run_simple(k2.track_simple, spec, window, codes, scal, 2, cuda)
    torch.cuda.synchronize()
    assert k2.track_simple.launches == before + 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert k2.track_simple.cluster == k1.cluster_shape(C, spec.n_max, sms)[0]
    o_p = run_simple(k2.track_simple_plain, spec, window, codes, scal, 2,
                     cuda)
    lanes = list(range(2 * T)) + list(range(10, 20))
    assert_rows_close(o_p[:, :2], o_k[:, :2], tol=5e-5, lanes=lanes)
    assert_rows_close(o_p, o_k, tol=2e-3, lanes=lanes)
    assert np.all(o_k[:, :, 20:] == 0.0)
    assert np.all(o_k[:, :, 2 * T:10] == 0.0)
    for ch in disabled:
        assert np.all(np.diff(o_k[ch, :, 17]) > 0)


# P1 at the trackers' cluster size (R = 4 at C = 32 on an H100 SXM) and at
# every other R it accepts: 1 (one CTA of eight warps), 2 and 8 (64 warp
# partials a period, two for each lane of the consume)
PROBE_CASES = [(v, r) for r in (None, 1, 2, 4, 8) for v in p1.VARIANTS]
PROBE_IDS = [f"{v.replace(' ', '_')}_R{r or 'rule'}" for v, r in PROBE_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,ranks", PROBE_CASES, ids=PROBE_IDS)
def test_probe_kernel_matches_plain_cuda(cuda, variant, ranks):
    """Each P1 variant against its plain version over K = 16 periods: the
    per-channel sums at the first and the last period within
    ``p1.SUMS_TOL`` (float32 sums of the same terms in another order), the
    (8, 128) output and the out-store buffer exact; launched with the
    cluster size asked for, or the rule's."""
    x = p1.probe_input(cuda)
    k = 16
    before = p1.probe.launches
    out, sums, big = p1.probe(variant, x, k, ranks=ranks)
    torch.cuda.synchronize()
    assert p1.probe.launches == before + 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert p1.probe.cluster == (ranks or p1.ranks_for(sms))
    w_out, w_sums, w_big = p1.probe_plain(variant, x, k)
    assert p1.sums_err(sums, w_sums) < p1.SUMS_TOL
    assert torch.equal(out, w_out)
    if variant == "out store":
        assert torch.equal(big, w_big)


@pytest.mark.cuda
def test_probe_rejects_cluster_size_cuda(cuda):
    x = p1.probe_input(cuda)
    before = p1.probe.launches
    for bad in (3, 16, 0):
        with pytest.raises(ValueError):
            p1.probe("baseline", x, 4, ranks=bad)
    assert p1.probe.launches == before


# K1 and K2 in the Galileo E1 modes at the E1 shape (8184-unit codes at
# 4 Msps, n_max 16002, T = 5), on pilot_inputs' noise window: VEML alone,
# and with the pilot (secondaries of 25 and 4 chips, counter modulo 100,
# the secondary engaged, atan2, 4-period integration); K1 at R = 8, 8, 4
# and 1 (C = 1, 8, 33, 140) and K2 one CTA a channel with the whole period
# in its ring.
E1_FUSED_CASES = [(c, pilot) for c in (1, 8, 33, 140)
                  for pilot in (False, True)]
E1_FUSED_IDS = [f"C{c}_{'pilot' if p else 'veml'}" for c, p in E1_FUSED_CASES]
E1_NMAX = 16002


@pytest.mark.cuda
@pytest.mark.parametrize("C,pilot", E1_FUSED_CASES, ids=E1_FUSED_IDS)
def test_e1_fused_kernels_match_plain_cuda(cuda, C, pilot):
    """K1 and K2 against their plain version over two launches of K = 10:
    the long-code bounds, 2e-4 relative over the first two periods and
    2e-3 over all (tests/test_track_kernel_blocked.py), lanes 10 and 17
    exact."""
    K = 10
    kw = dict(track_pilot=True, sec_len_pilot=25, sec_len_data=4,
              sec_lcm=100) if pilot else {}
    codes, dcodes, wr, wi, scal, secp, secd = pilot_inputs(
        C, K, E1_NMAX, TAPS5, pilot, 25, 4, 100, extend=4, seed=3,
        launches=2)
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    tables = (dcodes, secp, secd) if pilot else ()
    spec = k1.make_blocked_spec(K, E1_NMAX, E1_LEN, TAPS5, **E1_KW, **kw)
    o_p = run_tracker(k1.track_blocked_plain, spec, window, codes, scal, 2,
                      cuda, tables)
    for make, fn, counter in ((k1.make_blocked_spec, k1.track_blocked,
                               k1.track_blocked),
                              (k2.make_full_spec, k2.track_full,
                               k2.track_full)):
        before = counter.launches
        o_k = run_tracker(fn, make(K, E1_NMAX, E1_LEN, TAPS5, **E1_KW, **kw),
                          window, codes, scal, 2, cuda, tables)
        torch.cuda.synchronize()
        assert counter.launches == before + 2
        assert_rows_close(o_p[:, :2], o_k[:, :2], tol=2e-4,
                          lanes=check_lanes(5))
        assert_rows_close(o_p, o_k, tol=2e-3, lanes=check_lanes(5))


# K1 and K2 at the GPS L5 / Galileo E5a shape (10230-chip codes at
# 10.4 Msps, n_max 10402, T = 3 with the pilot, 20-period integration), on
# pilot_inputs' noise window with L5's secondaries (20 and 10 chips,
# counter modulo 20) and E5a's (100 and 20, modulo 100): K1 at R = 8, 8
# and 4 (C = 1, 8, 33), two launches of K = 20. The integration and
# secondary counters start short of their boundaries, as
# tests/test_torch_long_code_kernels.py starts them. (On noise the closed
# loops wander, and rounding differences grow past a few hundred periods:
# the K = 500 blocks run on a signal, below.)
LONG_SECS = {"l5": (20, 10, 20), "e5a": (100, 20, 100)}
LONG_CASES = [(c, sig) for c in (1, 8, 33) for sig in LONG_SECS]
LONG_IDS = [f"C{c}_{sig}" for c, sig in LONG_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("C,sig", LONG_CASES, ids=LONG_IDS)
def test_long_code_fused_kernels_match_plain_cuda(cuda, C, sig):
    """K1 and K2 against their plain version over two launches of K = 20,
    every channel closing its integration and its data symbol: the
    long-code bounds, 2e-4 relative over the first two periods and 2e-3
    over all (tests/test_track_kernel_blocked.py), lanes 10 and 17
    exact."""
    K = 20
    sp, sd, lcm = LONG_SECS[sig]
    kw = dict(L5_KW, track_pilot=True, sec_len_pilot=sp, sec_len_data=sd,
              sec_lcm=lcm)
    codes, dcodes, wr, wi, scal, secp, secd = pilot_inputs(
        C, K, L5_NMAX, TAPS, True, sp, sd, lcm, extend=20, seed=6,
        launches=2, code_len=L5_LEN)
    scal[:, S_INTEG_CNT] = 18
    scal[:, S_SEC_IDX] = (np.arange(C) * 7 + sd - 1) % lcm
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    tables = (dcodes, secp, secd)
    spec = k1.make_blocked_spec(K, L5_NMAX, L5_LEN, TAPS, **kw)
    o_p = run_tracker(k1.track_blocked_plain, spec, window, codes, scal, 2,
                      cuda, tables)
    assert (o_p[:, :, 20].sum(axis=1) >= 1).all()
    assert (o_p[:, :, 34].sum(axis=1) >= 1).all()
    for make, fn, counter in ((k1.make_blocked_spec, k1.track_blocked,
                               k1.track_blocked),
                              (k2.make_full_spec, k2.track_full,
                               k2.track_full)):
        before = counter.launches
        o_k = run_tracker(fn, make(K, L5_NMAX, L5_LEN, TAPS, **kw), window,
                          codes, scal, 2, cuda, tables)
        torch.cuda.synchronize()
        assert counter.launches == before + 2
        assert_rows_close(o_p[:, :2], o_k[:, :2], tol=2e-4,
                          lanes=check_lanes(3))
        assert_rows_close(o_p, o_k, tol=2e-3, lanes=check_lanes(3))


@pytest.mark.cuda
@pytest.mark.parametrize("plan_name", ["gps_l5_plan", "galileo_e5a_plan"],
                         ids=["l5", "e5a"])
def test_long_code_block_k500_matches_plain_cuda(cuda, plan_name):
    """One block of K = 500 periods (bench.py's dual16 E5a block) of eight
    channels of the plan tracking long_code_signal's channels, as the
    tracker packs it (secondary engaged, atan2, 20-period integration): K1
    and K2 against their plain version within the long-code bounds."""
    from gnss_sdr_tpu_torch.receiver import plans

    C, K = 8, 500
    plan = getattr(plans, plan_name)(L5_FS, num_channels=C)
    dops = [1200.0, -2500.0, 3400.0, -400.0, 150.0, -3900.0, 2600.0,
            -1700.0]
    delays = [37.0 + 1301.0 * c for c in range(C)]
    sig = long_code_signal(plan, int(L5_FS * 0.53), dops, delays, seed=5)
    (window, codes, scal, pos, spec), tabs = long_code_block(
        plan, K, dops, delays, sig, cuda)
    o_p = k1.track_blocked_plain(window, codes, scal, pos, spec,
                                 *tabs).cpu().numpy()
    assert (o_p[:, :, 20].sum(axis=1) >= K // 20 - 1).all()
    for fn, counter in ((k1.track_blocked, k1.track_blocked),
                        (k2.track_full, k2.track_full)):
        before = counter.launches
        o_k = fn(window, codes, scal, pos, spec, *tabs).cpu().numpy()
        assert counter.launches == before + 1
        assert_rows_close(o_p[:, :2], o_k[:, :2], tol=2e-4,
                          lanes=check_lanes(3))
        assert_rows_close(o_p, o_k, tol=2e-3, lanes=check_lanes(3))


# K1 and K2 with FDMA at the GLONASS shape (the 511-chip code at 3.6 Msps,
# n_max 3602, 10-period integration), each channel on one of the
# frequency channels k = -7..+6, whose slot offsets (up to 3.9 MHz) alias
# past fs / 2: two launches of K = 20 on fdma_noise_inputs' noise window at
# C = 1, 8 and 33, and one block of K = 200 on a signal of the code.
FDMA_CASES = [1, 8, 33]


@pytest.mark.cuda
@pytest.mark.parametrize("C", FDMA_CASES, ids=[f"C{c}" for c in FDMA_CASES])
def test_fdma_fused_kernels_match_plain_cuda(cuda, C):
    """K1 and K2 with FDMA against their plain version over two launches
    of K = 20 on noise: 5e-5 relative over the first two periods and 2e-3
    over all (the JAX suite's bounds between its two kernels), lanes 10
    and 17 exact."""
    K = 20
    codes, window, scal = fdma_noise_inputs(C, K, 2, seed=8)
    spec = k1.make_blocked_spec(K, GLO_NMAX, GLO_LEN, TAPS, fdma=True,
                                **GLO_KW)
    o_p = run_tracker(k1.track_blocked_plain, spec, window, codes, scal, 2,
                      cuda)
    for make, fn in ((k1.make_blocked_spec, k1.track_blocked),
                     (k2.make_full_spec, k2.track_full)):
        before = fn.launches
        o_k = run_tracker(fn, make(K, GLO_NMAX, GLO_LEN, TAPS, fdma=True,
                                   **GLO_KW), window, codes, scal, 2, cuda)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert_rows_close(o_p[:, :2], o_k[:, :2], lanes=check_lanes(3))
        assert_rows_close(o_p, o_k, tol=2e-3, lanes=check_lanes(3))


@pytest.mark.cuda
def test_fdma_block_k200_matches_plain_cuda(cuda):
    """One block of K = 200 periods of eight glonass_l1_ca_plan channels
    (k = -7 .. +6) tracking glonass_signal's channels, as the tracker
    packs it: K1 and K2 against their plain version, 5e-5 relative over
    the first two periods and 2e-3 over all, lanes 10 and 17 exact."""
    C, K = 8, 200
    dops = [1200.0, -2500.0, 3400.0, -400.0, 150.0, -3900.0, 2600.0,
            -1700.0]
    delays = [37.0 + 431.0 * c for c in range(C)]
    ks = [-7, -5, -3, -1, 0, 2, 4, 6]
    sig = glonass_signal(int(GLO_FS * (K + 3) * 1e-3), dops, delays, ks, 5)
    window, codes, scal, pos, spec = glonass_block(K, dops, delays, ks, sig,
                                                   cuda)
    assert spec.fdma
    o_p = k1.track_blocked_plain(window, codes, scal, pos, spec).cpu().numpy()
    assert (o_p[:, :, 20].sum(axis=1) == K // 10).all()
    for fn in (k1.track_blocked, k2.track_full):
        before = fn.launches
        o_k = fn(window, codes, scal, pos, spec).cpu().numpy()
        assert fn.launches == before + 1
        assert_rows_close(o_p[:, :2], o_k[:, :2], lanes=check_lanes(3))
        assert_rows_close(o_p, o_k, tol=2e-3, lanes=check_lanes(3))


@pytest.mark.cuda
def test_tracker_past_shared_memory_raises_cuda(cuda):
    """A CTA that needs more shared memory than the card has (16000-unit
    pilot and data tables, 128 KB, beside a ring of two 8000-sample slots)
    is refused with ValueError by K2, and by K1 where its rule gives one
    CTA a channel (C = 140); no other path runs it."""
    n_max, L, C = 40000, 16000, 140
    kw = dict(fs=20e6, code_rate_cps=10.23e6, carrier_freq_hz=1176.45e6,
              track_pilot=True, sec_len_pilot=10, sec_len_data=10,
              sec_lcm=10)
    window = torch.zeros(3 * n_max, dtype=torch.complex64, device=cuda)
    codes = torch.ones(C, L, device=cuda)
    tables = (torch.ones(C, L, device=cuda), torch.ones(C, 10, device=cuda),
              torch.ones(C, 10, device=cuda))
    pos = torch.zeros(C, dtype=torch.int32, device=cuda)
    for make, fn in ((k2.make_full_spec, k2.track_full),
                     (k1.make_blocked_spec, k1.track_blocked)):
        spec = make(1, n_max, L, TAPS, **kw)
        scal = torch.zeros(C, spec.num_scalars, device=cuda)
        with pytest.raises(ValueError, match="shared memory"):
            fn(window, codes, scal, pos, spec, *tables)


@pytest.mark.cuda
def test_eager_pilot_engine_on_k3_matches_plain_cuda(cuda):
    """The eager engine with the pilot on the card (K3 with the data
    prompt, once a period) against the same engine on the CPU (K3's plain
    version), from one state with the secondary engaged, over two blocks:
    tests/test_fused_receiver.py's _assert_match tolerances."""
    from gnss_sdr_tpu_torch.tracking import dll_pll as tdll
    from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    sig = pilot_signal(200_000)
    tbl, dtbl, sec_p, sec_d = pilot_tables()
    conf = DllPllConf(**dict(conf_kw(fused_tracker=False), track_pilot=True,
                             sec_len_pilot=SP, sec_len_data=SD,
                             extend_correlation_symbols=5,
                             steps_per_block=20))
    trk = Tracker(conf, tbl, dtbl, sec_p, sec_d, device="cpu")
    for ch in range(PILOT_C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=0.0,
                          acq_doppler_hz=DOPS[ch] + 30.0,
                          acq_samplestamp=0, current_abs_sample=0)
    trk.process(sig, 0)
    for ch in range(PILOT_C):
        trk._engage_secondary(ch, p0=0, k0=0, polarity=1.0)
    state = tdll.state_to_numpy(trk.state.replace(pos=torch.as_tensor(
        trk.pos_abs.astype(np.int32))))
    tabs = (trk.codes, trk.data_codes, trk.sec_pilot, trk.sec_data)
    outs = {}
    for dev in ("cpu", cuda):
        st = tdll.state_from_numpy(state, dev)
        t = [torch.as_tensor(a, device=dev) for a in tabs]
        w = torch.as_tensor(sig, device=dev)
        before = k3.correlator.launches
        outs[str(dev)] = []
        for _ in range(2):
            st, o = tdll.track_block(conf, st, w, *t)
            outs[str(dev)].append({k: v.cpu().numpy() for k, v in o.items()})
        if dev != "cpu":
            assert k3.correlator.launches == before + 2 * 20
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        for k in ("n_samples", "pos_end", "boundary", "data_boundary",
                  "data_count"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < 0.1
        for k in ("prompt", "data_prompt"):
            pa, pb = a[k], b[k]
            assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3
        assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
        assert np.abs(a["rem_code_phase"] - b["rem_code_phase"]).max() < 1e-3


# The last plans' shapes (name -> K, n_max, code length, loop constants,
# D1 mode): BeiDou B1I in the D1 mode at 2.6 Msps; B3I in the D1 mode at
# 16.368 Msps (n_max 16370: K2 streams a period in two chunks of 8186
# samples and holds two 10230-unit tables beside them, ~214 KB, the
# nearest any plan comes to the card's 232448 B); GPS L2C's 20 ms period at
# 2.6 Msps (n_max 52002: seven chunks a period); Galileo E6B's 5115 chips
# at 10.23 Msps.
LAST_SHAPES = {
    "b1i_d1": (20, B1I_NMAX, B1I_LEN, B1I_KW, True),
    "b3i_d1": (20, 16370, 10230, dict(fs=16.368e6, code_rate_cps=10.23e6,
                                      carrier_freq_hz=1268.52e6), True),
    "l2c": (4, L2C_NMAX, L2C_LEN, L2C_KW, False),
    "e6b": (20, 10232, 5115, dict(fs=10.23e6, code_rate_cps=5.115e6,
                                  carrier_freq_hz=1278.75e6), False),
}
LAST_CASES = [(c, shape) for shape in LAST_SHAPES for c in (1, 8)]
LAST_IDS = [f"C{c}_{shape}" for c, shape in LAST_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("C,shape", LAST_CASES, ids=LAST_IDS)
def test_last_plans_fused_kernels_match_plain_cuda(cuda, C, shape):
    """K1 and K2 at each shape against their plain version over two
    launches on noise: 5e-5 relative over the first two periods and 2e-3
    over all, lanes 10 and 17 exact. In the D1 mode the channels start
    mid-symbol (counters at 7 + 5c mod 20) with atan2 off, and each closes
    an integration and a data symbol."""
    K, nmax, length, kw, d1 = LAST_SHAPES[shape]
    if d1:
        sec0 = [(7 + 5 * c) % 20 for c in range(C)]
        codes, dcodes, wr, wi, scal, secp, secd = d1_inputs(
            C, K, nmax, length, sec0, seed=9, launches=2)
        kw = dict(kw, **D1_SECS)
        tables = (dcodes, secp, secd)
    else:
        codes, _, wr, wi, scal, _, _ = pilot_inputs(
            C, K, nmax, TAPS, False, 1, 1, 1, extend=1, seed=9, launches=2,
            code_len=length)
        tables = ()
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    o_p = run_tracker(k1.track_blocked_plain,
                      k1.make_blocked_spec(K, nmax, length, TAPS, **kw),
                      window, codes, scal, 2, cuda, tables)
    assert (o_p[:, :, 20].sum(axis=1) >= 1).all()
    if d1:
        assert (o_p[:, :, 34].sum(axis=1) >= 1).all()
    for make, fn in ((k1.make_blocked_spec, k1.track_blocked),
                     (k2.make_full_spec, k2.track_full)):
        before = fn.launches
        o_k = run_tracker(fn, make(K, nmax, length, TAPS, **kw), window,
                          codes, scal, 2, cuda, tables)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert_rows_close(o_p[:, :2], o_k[:, :2], lanes=check_lanes(3))
        assert_rows_close(o_p, o_k, tol=2e-3, lanes=check_lanes(3))


@pytest.mark.cuda
@pytest.mark.parametrize("plan_name,fs", [("beidou_b1i_plan", B1I_FS),
                                          ("beidou_b3i_plan", 16.368e6)],
                         ids=["b1i", "b3i"])
def test_d1_block_k200_matches_plain_cuda(cuda, plan_name, fs):
    """One block of K = 200 periods of eight channels of the plan tracking
    d1_signal's channels (NH20 and navigation bits), as the tracker packs
    them past the NH20 lock, mid-symbol (Costas kept, 20-period
    integration): K1 and K2 against their plain version, 5e-5 relative
    over the first two periods and 2e-3 over all, lanes 10 and 17
    exact."""
    from gnss_sdr_tpu_torch.receiver import plans

    C, K = 8, 200
    plan = getattr(plans, plan_name)(fs, num_channels=C)
    dops = [1200.0, -2500.0, 3400.0, -400.0, 150.0, -3900.0, 2600.0,
            -1700.0]
    delays = [37.0 + 0.131 * fs * c / 1e3 for c in range(C)]
    sec0 = [(3 + 7 * c) % 20 for c in range(C)]
    sig = d1_signal(plan, int(fs * (K + 3) * 1e-3), dops, delays, sec0, 5)
    (window, codes, scal, pos, spec), tabs = d1_block(
        plan, K, dops, delays, sec0, sig, cuda)
    o_p = k1.track_blocked_plain(window, codes, scal, pos, spec,
                                 *tabs).cpu().numpy()
    assert (o_p[:, :, 20].sum(axis=1) >= K // 20 - 1).all()
    assert (o_p[:, :, 34].sum(axis=1) >= K // 20 - 1).all()
    for fn in (k1.track_blocked, k2.track_full):
        before = fn.launches
        o_k = fn(window, codes, scal, pos, spec, *tabs).cpu().numpy()
        assert fn.launches == before + 1
        assert_rows_close(o_p[:, :2], o_k[:, :2], lanes=check_lanes(3))
        assert_rows_close(o_p, o_k, tol=2e-3, lanes=check_lanes(3))


# K3 on one period of each last plan's shape: (N, L, data prompt)
LAST_CORR = {"b1i_d1": (2688, B1I_LEN, True), "b3i_d1": (16384, 10230, True),
             "l2c": (52096, L2C_LEN, False), "e6b": (10240, 5115, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(LAST_CORR))
def test_last_plans_correlator_matches_plain_cuda(cuda, shape):
    """K3 at C = 8 on one period of each shape against its plain version
    within 2e-3 (the JAX test's measure); in the D1 mode the data prompt
    runs on a data table equal to the code table, as the D1 plans give
    it."""
    n, length, pilot = LAST_CORR[shape]
    codes, x, sc = correlator_inputs(8, n, length, n - 86, 1)
    args = (torch.as_tensor(x, device=cuda),
            torch.as_tensor(pack_code_table(codes), device=cuda),
            torch.as_tensor(pack_code_table(codes), device=cuda),
            torch.as_tensor(sc, device=cuda), TAPS)
    kw = dict(code_len=length, interp_code=True, track_pilot=pilot)
    before = k3.correlator.launches
    got = k3.correlator(*args, **kw).cpu().numpy()
    assert k3.correlator.launches == before + 1
    ref = k3.correlator_plain(*args, **kw).cpu().numpy()
    nt = 4 if pilot else 3
    assert correlator_rel_err(got, ref, nt) < 2e-3
    if pilot:
        # the data prompt of an equal table is the prompt tap
        scale = max(1.0, float(np.abs(got[:, 0, 2:4]).max()))
        np.testing.assert_allclose(got[:, 0, 6:8], got[:, 0, 2:4], rtol=0,
                                   atol=2e-3 * scale)


# ---- the acquisition engines, the Kalman mode and the conditioner on the
# card against the same calls on the CPU (none of them holds a hand
# kernel but K3 under the Kalman mode; the others are torch.fft and
# elementwise torch ops on the card)
def _acq_case(engine, device):
    """(engine, samples, rows) of tests/test_torch_acq_engines.py's cases,
    the engine built on ``device``."""
    from gnss_sdr_tpu_torch import acquisition as acq
    from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1b_code
    from gnss_sdr_tpu_torch.codes.galileo_e5a import (
        galileo_e5ai_code,
        galileo_e5aq_code,
    )
    from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
    from gnss_sdr_tpu_torch.simulate import (
        SatelliteSignalParams,
        generate_baseband,
    )

    gps = dict(fs=2.046e6, code_length_chips=1023, code_rate_cps=1.023e6,
               doppler_max_hz=5000.0, doppler_step_hz=250.0, pfa=1e-3)
    prns = list(range(1, 33))
    if engine == "fine_doppler":
        conf = acq.AcqConfig(**dict(gps, doppler_step_hz=500.0,
                                    coherent_integration_periods=4))
        eng = acq.FineDopplerAcquisition(conf, gps_l1_ca_code_table(), prns,
                                         device=device)
        sat = SatelliteSignalParams(prn=9, cn0_dbhz=48.0, doppler_hz=1337.0,
                                    delay_chips=222.5)
        x = generate_baseband([sat], conf.fs, conf.input_samples, seed=11)
        return eng, x[None], np.array([8])
    if engine in ("tong", "quicksync"):
        conf = acq.AcqConfig(**gps)
        if engine == "tong":
            eng = acq.TongAcquisition(conf, gps_l1_ca_code_table(), prns,
                                      tong_max=3, max_attempts=10,
                                      device=device)
            n = eng.inner.conf.input_samples * 10
        else:
            eng = acq.QuickSyncAcquisition(conf, gps_l1_ca_code_table(),
                                           prns, device=device)
            n = eng.win
        sat = SatelliteSignalParams(prn=17, cn0_dbhz=47.0, doppler_hz=-800.0,
                                    delay_chips=700.0)
        x = generate_baseband([sat], conf.fs, n, seed=12)
        return eng, np.stack([x, x]), np.array([16, 3])
    if engine == "cccwsr":
        conf = acq.AcqConfig(fs=4.092e6, code_length_chips=4092,
                             code_rate_cps=1.023e6, doppler_max_hz=4000.0,
                             doppler_step_hz=125.0, pfa=1e-3)
        chips = np.stack([galileo_e1b_code(p) for p in range(1, 11)])
        eng = acq.CccwsrAcquisition(conf, chips, list(range(1, 11)),
                                    device=device)
        x = e1b_cboc_baseband(5, conf.fs, eng.win, 48.0, 750.0, 1000.25,
                              seed=16)
        return eng, np.stack([x, x]), np.array([4, 7])
    conf = acq.AcqConfig(fs=12.0e6, code_length_chips=10230,
                         code_rate_cps=10.23e6, doppler_max_hz=3000.0,
                         doppler_step_hz=250.0, pfa=1e-3)
    data = np.stack([galileo_e5ai_code(p) for p in range(1, 9)])
    pilot = np.stack([galileo_e5aq_code(p) for p in range(1, 9)])
    eng = acq.NoncoherentIQAcquisition(conf, data.astype(np.float32),
                                       pilot.astype(np.float32),
                                       list(range(1, 9)), device=device)
    sat = SatelliteSignalParams(prn=4, system="E", signal="5X",
                                cn0_dbhz=49.0, doppler_hz=-1200.0,
                                delay_chips=4000.5)
    x = generate_baseband([sat], conf.fs, eng.win, seed=21)
    return eng, np.stack([x, x]), np.array([3, 6])


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["fine_doppler", "tong", "quicksync",
                                    "cccwsr", "noncoh_iq"])
def test_acquisition_engine_cpu_vs_cuda(cuda, engine):
    """Each engine variant on the card against itself on the CPU: equal
    verdicts, Dopplers and delays, statistics within 1e-4 relative."""
    res = {}
    for dev in ("cpu", cuda):
        eng, x, rows = _acq_case(engine, dev)
        res[str(dev)] = eng.acquire(x, rows)
    a, b = res["cpu"], res[str(cuda)]
    np.testing.assert_array_equal(b.detected, a.detected)
    np.testing.assert_array_equal(b.delay_samples, a.delay_samples)
    np.testing.assert_array_equal(b.doppler_hz, a.doppler_hz)
    np.testing.assert_allclose(b.test_statistic, a.test_statistic, rtol=1e-4)
    assert a.detected[0]


@pytest.mark.cuda
def test_kf_eager_block_on_k3_matches_plain_cuda(cuda):
    """The Kalman mode of the eager engine on the card (K3 once a period)
    against the same engine on the CPU (K3's plain version), from one
    started state with FLL pull-in, over two blocks: _assert_match's
    tolerances on the outputs, kf_P and kf_pc within 1e-5 relative (they
    follow the integration times alone), kf_x within 1e-3."""
    from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
    from gnss_sdr_tpu_torch.tracking import dll_pll as tdll
    from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    tbl = gps_l1_ca_code_table()[:PILOT_C].astype(np.float32)
    sig = make_signal(tbl, 200_000)
    conf = DllPllConf(**dict(conf_kw(kf=True, enable_fll_pull_in=True),
                             steps_per_block=20))
    trk = Tracker(conf, tbl, device="cpu")
    for ch in range(PILOT_C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=0.0,
                          acq_doppler_hz=DOPS[ch] + 30.0,
                          acq_samplestamp=0, current_abs_sample=0)
    state = tdll.state_to_numpy(trk.state.replace(pos=torch.as_tensor(
        trk.pos_abs.astype(np.int32))))
    outs, ends = {}, {}
    for dev in ("cpu", cuda):
        st = tdll.state_from_numpy(state, dev)
        w = torch.as_tensor(sig, device=dev)
        codes = torch.as_tensor(trk.codes, device=dev)
        before = k3.correlator.launches
        outs[str(dev)] = []
        for _ in range(2):
            st, o = tdll.track_block(conf, st, w, codes)
            outs[str(dev)].append({k: v.cpu().numpy() for k, v in o.items()})
        ends[str(dev)] = tdll.state_to_numpy(st)
        if dev != "cpu":
            assert k3.correlator.launches == before + 2 * 20
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        for k in ("n_samples", "pos_end", "boundary"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.abs(a["carrier_doppler"] - b["carrier_doppler"]).max() < 0.1
        pa, pb = a["prompt"], b["prompt"]
        assert np.median(np.abs(pa - pb) / (np.abs(pa) + 1e-9)) < 5e-3
        assert np.abs(a["carrier_phase"] - b["carrier_phase"]).max() < 1e-3
        assert np.abs(a["rem_code_phase"] - b["rem_code_phase"]).max() < 1e-3
    a, b = ends["cpu"], ends[str(cuda)]
    for k, tol in (("kf_P", 1e-5), ("kf_pc", 1e-5), ("kf_x", 1e-3)):
        np.testing.assert_allclose(b[k], a[k], rtol=tol, atol=0, err_msg=k)


def _noise(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["fir_decim2", "freq_xlating", "notch",
                                   "pulse_blanking", "direct", "polyphase",
                                   "beamformer", "streaming"])
def test_conditioner_stage_cpu_vs_cuda(cuda, stage):
    """Each conditioner stage on the card against the same call on the CPU,
    on noise with a CW tone and pulses: within 1e-5 of the CPU output's
    largest sample (the direct resampler and pulse blanking: equal)."""
    from gnss_sdr_tpu_torch import conditioner as tc

    rng = np.random.default_rng(5)
    x = _noise(rng, 65536)
    x += 3.0 * np.exp(2j * np.pi * 0.11 * np.arange(x.size)).astype(
        np.complex64)
    x[::997] *= 40.0
    taps = tc.design_fir(65, 4e6, (0.0, 1.6e6)).astype(np.float32)

    def run(dev):
        xt = torch.as_tensor(x, device=dev)
        tt = torch.as_tensor(taps, device=dev)
        if stage == "fir_decim2":
            return tc.fir_apply(xt, tt, 2)
        if stage == "freq_xlating":
            return tc.freq_xlating_fir_apply(xt, tt, 0.3, 4e6, 2.5e5, 2)[0]
        if stage == "notch":
            return tc.notch_filter_block(xt)
        if stage == "pulse_blanking":
            return tc.pulse_blanking_block(xt)
        if stage == "direct":
            return tc.direct_resample(xt, 4e6 / 2.6e6, 40000, 0.7)
        if stage == "polyphase":
            return tc.polyphase_resample(xt, 4e6 / 2.6e6, 40000, 4.3)
        if stage == "beamformer":
            w = tc.steering_weights(4, 0.5, 20.0)
            xs = np.stack([x, np.roll(x, 1), np.roll(x, 2), np.roll(x, 3)])
            return tc.Beamformer(w, device=dev).process(xs)
        cond = tc.SignalConditioner(tc.ConditionerConfig(
            fs_in=4e6, if_freq_hz=2.5e5, fir_taps=65, decimation=2,
            enable_notch=True, enable_pulse_blanking=True, fs_out=1.6e6),
            device=dev)
        return np.concatenate([cond.process(x[i:i + n]) for i, n in (
            (0, 30001), (30001, 17), (30018, 35518))])

    a, b = (np.asarray(torch.as_tensor(run(d)).cpu()) for d in ("cpu", cuda))
    assert a.shape == b.shape
    if stage in ("direct", "pulse_blanking"):
        np.testing.assert_array_equal(b, a)
    else:
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cubature", "unscented"])
def test_gaussian_run_carry_cpu_vs_cuda(cuda, kind):
    """The CKF/UKF over 40 periods of prompts on the card (float64)
    against the CPU, each output within 1e-9 of its largest element (the
    unscented weights at alpha = 1e-2 are about +-1e4 and cancel, so an
    element near zero carries the rounding of the large ones, summed in
    another order on the card)."""
    from gnss_sdr_tpu_torch.tracking.gaussian import GaussianCarrierTracker

    rng = np.random.default_rng(5)
    t = np.arange(40)[:, None]
    p = 20.0 * np.exp(1j * (0.3 + 0.044 * t + np.array([0.0, 1.0]))) + (
        rng.normal(size=(40, 2)) + 1j * rng.normal(size=(40, 2)))
    x0 = np.array([[0.3, 0.04, 0.0], [1.3, 0.05, 0.0]])
    P0 = np.tile(np.diag([1.0, 1e-3, 1e-6]), (2, 1, 1))
    a, b = (GaussianCarrierTracker(2, kind=kind, device=d).run_carry(
        p, x0, P0) for d in ("cpu", cuda))
    for u, v in zip(a, b):
        assert np.abs(v - u).max() <= 1e-9 * np.abs(u).max()
