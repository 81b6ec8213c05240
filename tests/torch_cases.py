"""Inputs and checks shared by the port's tests.

No JAX here: the CUDA tests import this module on a machine that has only
PyTorch.
"""

import dataclasses

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops.slots import S_ACC0, S_POS

FS = 2.6e6
TAPS = [-0.25, 0.0, 0.25]
TAPS5 = [-0.5, -0.25, 0.0, 0.25, 0.5]
# two GPS channels of tests/test_fused_receiver.py's tracker setups
C = 2
DOPS = [1200.0, -2500.0]
# lanes compared between two fused trackers (tests/test_track_kernel_blocked.py)
CHECK_LANES = [0, 1, 2, 3, 10, 11, 12, 13, 14, 17, 20, 21, 22, 23,
               32, 33, 34, 35, 36, 37]
EXACT_LANES = [10, 17]          # period length and position


def check_lanes(num_taps: int) -> list[int]:
    """Lanes compared between two fused trackers with ``num_taps`` taps:
    every tap, lanes 10-14, 17, 20 and 21, every tap accumulator, and the
    data and secondary lanes 32-37 (CHECK_LANES, the T = 3 choice, leaves
    out the late tap and its accumulators)."""
    return (list(range(2 * num_taps)) + [10, 11, 12, 13, 14, 17, 20, 21]
            + list(range(22, 22 + 2 * num_taps)) + list(range(32, 38)))


def tracker_inputs(C, K, L, nmax, launches, extend, seed):
    """codes [C, L], window re/im [rows, 128] and a scalar block, as
    tests/test_track_kernel_blocked.py builds them."""
    rng = np.random.default_rng(seed)
    codes = np.sign(rng.normal(size=(C, L))).astype(np.float32)
    codes[codes == 0] = 1.0
    wrows = (nmax * (K * launches + 2)) // 128 + 64
    wr = rng.normal(size=(wrows, 128)).astype(np.float32)
    wi = rng.normal(size=(wrows, 128)).astype(np.float32)
    ns = S_ACC0 + 2 * 3 + 1
    scal = np.zeros((C, ns), np.float32)
    scal[:, 0] = np.arange(C) * 37 + 5
    scal[:, 1] = 0.2
    scal[:, 3] = 0.5
    scal[:, 4] = np.linspace(-2500, 2500, C)
    scal[:, 7] = 1
    scal[:, 10] = extend
    scal[:, 16] = 1
    scal[:, 17] = 25.0
    scal[:, 18] = 2.0
    return codes, wr, wi, scal


def fused_noise_case(C, interp, spec_fn, seed=11):
    """K1/K2 inputs on a noise window (``tracker_inputs`` at K = 20, two
    launches, 2-period integration with FLL): random codes, positions
    5 + 37 c, Dopplers from -2500 to 2500 Hz, the atan2 flag on channel
    min(4, C - 1), from C = 3 the last channel disabled and placed so that
    its periods run past the end of the window, and from C = 5 channel 2
    disabled where it is. Returns spec, window, codes, scalars and the
    disabled channels."""
    K, L = 20, 1023
    nmax = int(np.ceil(FS * L / 1.023e6)) + 2
    spec = spec_fn(K, nmax, L, TAPS, fs=FS, code_rate_cps=1.023e6,
                   carrier_freq_hz=1575.42e6, pll_order=3, dll_order=2,
                   interp_code=interp)
    codes, wr, wi, scal = tracker_inputs(C, K, L, nmax, 2, 2, seed)
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    scal[min(4, C - 1), 15] = 1.0
    disabled = ([2] if C >= 5 else []) + ([C - 1] if C >= 3 else [])
    scal[disabled, 7] = 0.0
    if C >= 3:
        scal[C - 1, 0] = window.size - nmax // 2
    return spec, window, codes, scal, disabled


def simple_noise_case(C, interp, taps, spec_fn, code_len=1023, seed=11):
    """K4 inputs on ``fused_noise_case``'s noise window (``tracker_inputs``
    at K = 20, two launches): random codes of ``code_len`` chips, positions
    5 + 37 c, Dopplers from -2500 to 2500 Hz, PLL order 3 and DLL order 2 at
    25 and 2 Hz, ``taps`` (3: NELP, 5: VEML); from C = 3 the last channel
    disabled and placed so that its periods run past the end of the window
    (K4 advances it all the same, reading zeros there), and from C = 5
    channel 2 disabled where it is. Returns spec, window, codes, the [C, 10]
    scalars and the disabled channels."""
    K = 20
    nmax = int(np.ceil(FS * code_len / 1.023e6)) + 2
    spec = spec_fn(K, nmax, code_len, taps, fs=FS, code_rate_cps=1.023e6,
                   carrier_freq_hz=1575.42e6, pll_bw_hz=25.0, dll_bw_hz=2.0,
                   pll_order=3, dll_order=2, interp_code=interp)
    codes, wr, wi, scal = tracker_inputs(C, K, code_len, nmax, 2, 2, seed)
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    scal = np.ascontiguousarray(scal[:, :10])
    disabled = ([2] if C >= 5 else []) + ([C - 1] if C >= 3 else [])
    scal[disabled, 7] = 0.0
    if C >= 3:
        scal[C - 1, 0] = window.size - nmax // 2
    return spec, window, codes, scal, disabled


def simple_carry(scal, o):
    """K4's next scalars from the last row, as
    tests/test_track_kernel.py:164-168 repacks them."""
    last = o[:, -1, :]
    return np.stack([
        last[:, 17], last[:, 13], last[:, 12], last[:, 14], last[:, 11],
        last[:, 15], last[:, 16], scal[:, 7], last[:, 18], last[:, 19],
    ], axis=1).astype(np.float32)


def run_simple(fn, spec, window, codes, scal, launches, device):
    """``launches`` back-to-back calls of K4 or its plain version; [C,
    K*launches, 128] numpy rows."""
    w = torch.as_tensor(window, device=device)
    cd = torch.as_tensor(codes, device=device)
    outs, s = [], scal
    for _ in range(launches):
        o = fn(w, cd, torch.as_tensor(s, device=device), spec).cpu().numpy()
        outs.append(o)
        s = simple_carry(s, o)
    return np.concatenate(outs, axis=1)


def carry(prev, o, ntaps=3):
    """Next launch's scalar block from the last row (the fused engine's
    fold, as tests/test_track_kernel_blocked.py writes it)."""
    last = o[:, -1, :]
    s = prev.copy()
    s[:, 0] = last[:, 17]
    s[:, 1] = last[:, 13]
    s[:, 2] = last[:, 12]
    s[:, 3] = last[:, 14]
    s[:, 4] = last[:, 11]
    s[:, 5] = last[:, 15]
    s[:, 6] = last[:, 16]
    s[:, 8] = last[:, 18]
    s[:, 9] = last[:, 19]
    s[:, 11] = last[:, 37]
    s[:, 12] = last[:, 21] * (1.0 - last[:, 20])
    s[:, 13] = last[:, 36]
    s[:, 19] = last[:, 38]
    s[:, 20] = last[:, 39]
    s[:, 21] = last[:, 32] * (1.0 - last[:, 34])
    s[:, 22] = last[:, 33] * (1.0 - last[:, 34])
    s[:, 23] = last[:, 35] * (1.0 - last[:, 34])
    for ti in range(ntaps):
        s[:, S_ACC0 + 2 * ti] = last[:, 22 + 2 * ti] * (1.0 - last[:, 20])
        s[:, S_ACC0 + 2 * ti + 1] = (
            last[:, 22 + 2 * ti + 1] * (1.0 - last[:, 20]))
    return s


def run_tracker(fn, spec, window, codes, scal, launches, device,
                tables=()):
    """``launches`` back-to-back calls of a fused tracker (with the pilot
    ``tables`` (dcodes, sec_p, sec_d) in pilot mode); [C, K*launches, 128]
    numpy rows."""
    w = torch.as_tensor(window, device=device)
    cd = torch.as_tensor(codes, device=device)
    tabs = [torch.as_tensor(t, device=device) for t in tables]
    outs, s = [], scal
    for _ in range(launches):
        pos = torch.as_tensor(s[:, S_POS].astype(np.int32), device=device)
        o = fn(w, cd, torch.as_tensor(s, device=device), pos, spec, *tabs)
        o = o.cpu().numpy()
        outs.append(o)
        s = carry(s, o, spec.num_taps)
    return np.concatenate(outs, axis=1)


# Galileo E1 at 4 Msps: the 8184-unit sinBOC tables at 2.046 Munits/s
E1_FS = 4.0e6
E1_KW = dict(fs=E1_FS, code_rate_cps=2.046e6, carrier_freq_hz=1575.42e6)
E1_LEN = 8184
# GPS L5 and Galileo E5a at 10.4 Msps: 10230-chip codes at 10.23 Mchip/s,
# n_max as the receiver's plans give it (samples per code + 2)
L5_FS = 10.4e6
L5_KW = dict(fs=L5_FS, code_rate_cps=10.23e6, carrier_freq_hz=1176.45e6)
L5_LEN = 10230
L5_NMAX = 10402


def pilot_inputs(C, K, nmax, taps, pilot, sp, sd, lcm, extend, seed,
                 launches=1, code_len=E1_LEN):
    """tests/test_track_kernel_blocked.py's pilot inputs: +-1 pilot and
    data codes [C, L], a noise window re/im [rows, 128], a scalar block
    for ``len(taps)`` taps (the secondary index at c mod lcm, the
    secondary engaged and atan2 on in pilot mode, ``extend``-period
    integration, FLL) and +-1 secondary rows [C, sp] and [C, sd]."""
    rng = np.random.default_rng(seed)
    codes = np.sign(rng.normal(size=(C, code_len))).astype(np.float32)
    codes[codes == 0] = 1.0
    dcodes = np.sign(rng.normal(size=(C, code_len))).astype(np.float32)
    dcodes[dcodes == 0] = 1.0
    wrows = (nmax * (K * launches + 2)) // 128 + 64
    wr = rng.normal(size=(wrows, 128)).astype(np.float32)
    wi = rng.normal(size=(wrows, 128)).astype(np.float32)
    scal = np.zeros((C, S_ACC0 + 2 * len(taps) + 1), np.float32)
    scal[:, 0] = np.arange(C) * 37 + 5
    scal[:, 1] = 0.2
    scal[:, 3] = 0.5
    scal[:, 4] = np.linspace(-2500, 2500, C)
    scal[:, 7] = 1
    scal[:, 10] = extend
    scal[:, 13] = np.arange(C) % max(1, lcm)
    scal[:, 14] = 1 if pilot else 0
    scal[:, 15] = 1 if pilot else 0
    scal[:, 16] = 1
    scal[:, 17] = 25.0
    scal[:, 18] = 2.0
    secp = np.sign(rng.normal(size=(C, sp))).astype(np.float32)
    secd = np.sign(rng.normal(size=(C, sd))).astype(np.float32)
    return codes, dcodes, wr, wi, scal, secp, secd


def assert_rows_close(o1, o2, tol=5e-5, exact=True, lanes=CHECK_LANES):
    """Relative difference per checked lane below ``tol``; the period
    length and position lanes equal."""
    for ln in lanes:
        a, b = o1[:, :, ln], o2[:, :, ln]
        scale = max(1e-6, float(np.abs(a).max()))
        rel = float(np.abs(a - b).max()) / scale
        assert rel < tol, f"lane {ln}: rel diff {rel:.3e}"
    if exact:
        for ln in EXACT_LANES:
            np.testing.assert_array_equal(o1[:, :, ln], o2[:, :, ln])


def assert_split_at_chip_edge(ref, got, step, taps, weight, tol=2e-3):
    """Rows ``got`` of a fused tracker against ``ref``, its plain version's:
    lanes 10 and 17 equal; a channel whose taps part by more than ``tol``
    (relative to each lane's largest value) must part at the hard
    replica's chip edge. That is, at its first such period k: the states
    before it agree within float32 rounding (Doppler, code rate and phase
    within 1e-5, the remnant within 4 ulps); at most 4 tap lanes part,
    none by more than ``weight`` (the most one sample can move a tap: twice
    the window's largest magnitude); and one period of the plain version
    from each state, ``step(channel, rows[:k])``, gives that side's taps
    (tests/test_torch_hard_replica_edge.py). Returns the channels split
    so."""
    for ln in EXACT_LANES:
        np.testing.assert_array_equal(ref[:, :, ln], got[:, :, ln])
    scale = np.maximum(np.abs(ref[:, :, :2 * taps]).max(axis=(0, 1)), 1e-6)
    rel = (np.abs(ref[:, :, :2 * taps] - got[:, :, :2 * taps])
           / scale).max(axis=2)
    split = [int(c) for c in np.nonzero((rel > tol).any(axis=1))[0]]
    for ch in split:
        k = int(np.argmax(rel[ch] > tol))
        assert k >= 1, (ch, k)
        np.testing.assert_allclose(got[ch, k - 1, 11:15], ref[ch, k - 1, 11:15],
                                   rtol=1e-5, atol=1e-6)
        rem = ref[ch, k - 1, 13]
        assert abs(got[ch, k - 1, 13] - rem) <= 4 * np.spacing(abs(rem)), ch
        gap = np.abs(ref[ch, k, :2 * taps] - got[ch, k, :2 * taps])
        assert np.sum(gap > 1e-3) <= 4 and gap.max() <= weight, (ch, gap)
        for rows in (ref, got):
            again = step(ch, rows[ch, :k])[:2 * taps]
            np.testing.assert_allclose(again, rows[ch, k, :2 * taps],
                                       rtol=0, atol=5e-5 * scale.max())
    return split


def correlator_inputs(C, N, L, n_valid, seed):
    """The case of tests/test_pallas_correlator.py: random samples, chips
    and NCO scalars."""
    rng = np.random.default_rng(seed)
    codes = rng.choice([-1.0, 1.0], (C, L)).astype(np.float32)
    x = (rng.normal(size=(C, N))
         + 1j * rng.normal(size=(C, N))).astype(np.complex64)
    sc = np.zeros((C, 8), np.float32)
    sc[:, 0] = rng.uniform(0, 1023, C).astype(np.float32)
    sc[:, 1] = np.float32(0.39346)
    sc[:, 2] = rng.uniform(0, 6.28, C).astype(np.float32)
    sc[:, 3] = rng.uniform(-0.01, 0.01, C).astype(np.float32)
    sc[:, 4] = n_valid
    return codes, x, sc


def correlator_rel_err(got, ref, num_taps):
    """Max over taps of |got - ref| / max(|ref|, 1), the JAX test's
    measure."""
    g = got[:, 0, 0:2 * num_taps:2] + 1j * got[:, 0, 1:2 * num_taps:2]
    r = ref[:, 0, 0:2 * num_taps:2] + 1j * ref[:, 0, 1:2 * num_taps:2]
    return float((np.abs(g - r) / np.maximum(np.abs(r), 1.0)).max())


def make_signal(tbl, n, seed=1, offs=(0.0, 0.0)):
    """Two GPS channels at DOPS, no data bits, light noise (the signal of
    tests/test_fused_receiver.py); with ``offs`` each carrier also moved by
    its FDMA slot offset (Hz)."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / FS
    sig = np.zeros(n, np.complex64)
    for c in range(C):
        cph = (1.023e6 * (1 + DOPS[c] / 1575.42e6)) * tt
        chips = tbl[c][np.floor(cph).astype(np.int64) % 1023]
        sig += 0.5 * chips * np.exp(2j * np.pi * (DOPS[c] + offs[c]) * tt
                                    + 0.3j * c)
    sig = sig + (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.05
    return sig.astype(np.complex64)


def conf_kw(**kw):
    """DllPllConf arguments of tests/test_fused_receiver.py's setups."""
    return dict(fs=FS, code_length_chips=1023, code_rate_cps=1.023e6,
                carrier_freq_hz=1575.42e6, max_channels=C,
                steps_per_block=30, **kw)


# tests/test_fused_receiver.py's pilot case: pilot secondary of 25 chips,
# data secondary of 4, on GPS-shaped codes
SP, SD = 25, 4


def pilot_tables():
    """The pilot case's pilot and data codes [C, 1023] and secondaries
    [C, SP] and [SD]."""
    from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table

    rng = np.random.default_rng(7)
    sec_p = np.where(rng.integers(0, 2, size=(C, SP)) > 0, 1.0,
                     -1.0).astype(np.float32)
    sec_d = np.where(rng.integers(0, 2, size=SD) > 0, 1.0,
                     -1.0).astype(np.float32)
    tbl = gps_l1_ca_code_table()[:C].astype(np.float32)
    dtbl = gps_l1_ca_code_table()[C:2 * C].astype(np.float32)
    return tbl, dtbl, sec_p, sec_d


def pilot_signal(n, offs=(0.0, 0.0)):
    """The pilot case's composite pilot + data signal, both secondaries
    from period 0; with ``offs`` each carrier also moved by its FDMA slot
    offset (Hz)."""
    tbl, dtbl, sec_p, sec_d = pilot_tables()
    tt = np.arange(n) / FS
    sig = np.zeros(n, np.complex64)
    for c in range(C):
        cph = (1.023e6 * (1 + DOPS[c] / 1575.42e6)) * tt
        ci = np.floor(cph).astype(np.int64)
        per = ci // 1023
        pil = tbl[c][ci % 1023] * sec_p[c][per % SP]
        dat = dtbl[c][ci % 1023] * sec_d[per % SD]
        sig += 0.35 * (pil + dat) * np.exp(
            2j * np.pi * (DOPS[c] + offs[c]) * tt + 0.3j * c)
    rng = np.random.default_rng(1)
    return (sig + (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.05
            ).astype(np.complex64)


def assert_plans_equal(a, b):
    """Every field of two SignalPlans equal: arrays bit for bit (dtype
    too), the engine confs field by field, the PRN-to-row map, and decoders
    of one kind with the same fields."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("make_decoder", "prn_row"):
            continue
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, f.name
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        elif dataclasses.is_dataclass(va):
            for g in dataclasses.fields(va):
                assert getattr(vb, g.name) == getattr(va, g.name), (
                    f.name, g.name)
        else:
            assert va == vb, f.name
    for prn in a.search_prns:
        assert b.prn_row(prn) == a.prn_row(prn)
    da, db = a.make_decoder(1), b.make_decoder(1)
    assert type(db).__name__ == type(da).__name__
    assert vars(db).keys() == vars(da).keys()


def long_code_signal(plan, n, dops, delays, seed):
    """Channels c of a GPS L5 or Galileo E5a ``plan`` (its table rows c) at
    L5_FS: the pilot code times its secondary on the quadrature axis, the
    data code times the data secondary and a random symbol a secondary
    period on the in-phase axis (secondary chip 0 on the period that starts
    at the channel's delay, in samples), at the given Dopplers, with
    noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / L5_FS
    sig = np.zeros(n, np.complex64)
    sd = plan.sec_data_levels
    for c, (dop, dly) in enumerate(zip(dops, delays)):
        u = np.floor((10.23e6 * (1 + dop / 1176.45e6)) * (tt - dly / L5_FS)
                     ).astype(np.int64)
        per = np.floor_divide(u, L5_LEN)
        idx = u - per * L5_LEN
        sym_i = np.floor_divide(per, len(sd))
        sym = np.where(rng.random(int(sym_i.max() - sym_i.min()) + 1) < 0.5,
                       1.0, -1.0)[sym_i - sym_i.min()]
        sp = plan.sec_pilot_table[c]
        comp = (plan.data_code_table[c][idx] * sd[per % len(sd)] * sym
                + 1j * plan.code_table[c][idx] * sp[per % len(sp)])
        sig += (0.35 * comp * np.exp(2j * np.pi * dop * tt + 0.3j * c)
                ).astype(np.complex64)
    noise = rng.normal(size=(n, 2)).astype(np.float32) * 0.05
    return (sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


def long_code_block(plan, K, dops, delays, window, device):
    """The fused engine's inputs for one block of K periods of ``plan``'s
    channels on ``window`` (long_code_signal's), as the tracker builds
    them: each channel started at its delay 3 Hz off its Doppler, with the
    secondary engaged at its true phase, atan2 and 20-period integration.
    Returns (window, codes, scalars, pos, spec) and the pilot tables."""
    import dataclasses

    from gnss_sdr_tpu_torch.tracking.fused import (
        _pack_scalars,
        build_fused_engine,
    )
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    conf = dataclasses.replace(plan.trk_conf, steps_per_block=K)
    trk = Tracker(conf, plan.code_table, plan.data_code_table,
                  plan.sec_pilot_table, plan.sec_data_levels, device=device)
    for ch in range(len(dops)):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=delays[ch],
                          acq_doppler_hz=dops[ch] + 3.0,
                          acq_samplestamp=0, current_abs_sample=0)
    on = torch.ones(len(dops), dtype=torch.bool, device=device)
    st = trk.state.replace(
        pos=torch.as_tensor(trk.pos_abs.astype(np.int32), device=device),
        sec_active=on, use_atan2=on, narrow=on, fll_active=~on,
        integ_len=torch.full((len(dops),), 20, dtype=torch.int32,
                             device=device))
    tabs = tuple(torch.as_tensor(t, device=device) for t in (
        trk.data_codes, trk.sec_pilot, trk.sec_data))
    return ((torch.as_tensor(window, device=device),
             torch.as_tensor(trk.codes, device=device),
             _pack_scalars(conf, st), st.pos, build_fused_engine(conf)),
            tabs)


# GLONASS L1 C/A at 3.6 Msps: the 511-chip code at 0.511 Mchip/s, n_max as
# glonass_l1_ca_plan gives it, FDMA offsets k * 562.5 kHz for k = -7..+6
GLO_FS = 3.6e6
GLO_KW = dict(fs=GLO_FS, code_rate_cps=0.511e6, carrier_freq_hz=1.602e9)
GLO_LEN = 511
GLO_NMAX = 3602
GLO_KS = list(range(-7, 7))


def fdma_w_off(ks, fs=GLO_FS):
    """The FDMA scalar slot of channels on frequency channels ``ks``: the
    offset k * 562.5 kHz in rad/sample, reduced to [-pi, pi) in float64 as
    tracking/fused.py packs it."""
    w = 2.0 * np.pi * np.asarray(ks, np.float64) * 562.5e3 / fs
    return (np.remainder(w + np.pi, 2.0 * np.pi) - np.pi).astype(np.float32)


def fdma_noise_inputs(C, K, launches, seed):
    """tracker_inputs' noise window and scalars at the GLONASS shape (511
    chips, GLO_NMAX, 10-period integration), channel c on frequency
    channel GLO_KS[c mod 14]."""
    codes, wr, wi, scal = tracker_inputs(C, K, GLO_LEN, GLO_NMAX, launches,
                                         10, seed)
    scal[:, S_ACC0 + 6] = fdma_w_off([GLO_KS[c % 14] for c in range(C)])
    window = (wr.ravel() + 1j * wi.ravel()).astype(np.complex64)
    return codes, window, scal


def glonass_signal(n, dops, delays, ks, seed):
    """Channels c of the GLONASS C/A code at GLO_FS on frequency channels
    ks[c] at Dopplers dops[c] (Hz) and code delays delays[c] (samples), no
    data bits, with noise."""
    from gnss_sdr_tpu_torch.codes.glonass_ca import glonass_ca_code

    rng = np.random.default_rng(seed)
    code = glonass_ca_code().astype(np.float32)
    tt = np.arange(n) / GLO_FS
    sig = np.zeros(n, np.complex64)
    for c, (dop, dly, k) in enumerate(zip(dops, delays, ks)):
        u = np.floor((0.511e6 * (1 + dop / 1.602e9)) * (tt - dly / GLO_FS)
                     ).astype(np.int64)
        sig += (0.35 * code[u % GLO_LEN] * np.exp(
            2j * np.pi * (dop + k * 562.5e3) * tt + 0.3j * c)
        ).astype(np.complex64)
    noise = rng.normal(size=(n, 2)).astype(np.float32) * 0.05
    return (sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


def glonass_block(K, dops, delays, ks, window, device):
    """The fused engine's inputs for one block of K periods of
    glonass_l1_ca_plan's channels on ``window`` (glonass_signal's), as the
    tracker packs them: each channel started at its delay 3 Hz off its
    Doppler with its slot offset, narrow bandwidths and 10-period
    integration. Returns (window, codes, scalars, pos, spec)."""
    import dataclasses

    from gnss_sdr_tpu_torch.receiver.plans import glonass_l1_ca_plan
    from gnss_sdr_tpu_torch.tracking.fused import (
        _pack_scalars,
        build_fused_engine,
    )
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    plan = glonass_l1_ca_plan(GLO_FS, num_channels=len(dops))
    conf = dataclasses.replace(plan.trk_conf, steps_per_block=K)
    trk = Tracker(conf, plan.code_table, device=device)
    for ch in range(len(dops)):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=delays[ch],
                          acq_doppler_hz=dops[ch] + 3.0,
                          acq_samplestamp=0, current_abs_sample=0,
                          carrier_offset_hz=ks[ch] * 562.5e3)
    on = torch.ones(len(dops), dtype=torch.bool, device=device)
    st = trk.state.replace(
        pos=torch.as_tensor(trk.pos_abs.astype(np.int32), device=device),
        narrow=on, fll_active=~on,
        integ_len=torch.full((len(dops),), 10, dtype=torch.int32,
                             device=device))
    return (torch.as_tensor(window, device=device),
            torch.as_tensor(trk.codes, device=device),
            _pack_scalars(conf, st), st.pos, build_fused_engine(conf))


# BeiDou B1I at 2.6 Msps (tests/test_beidou.py's rate): 2046 chips at
# 2.046 Mchip/s, n_max as beidou_b1i_plan gives it; the D1 mode: the NH20
# secondary on both tables of the one data component (counter modulo 20)
B1I_FS = 2.6e6
B1I_KW = dict(fs=B1I_FS, code_rate_cps=2.046e6, carrier_freq_hz=1561.098e6)
B1I_LEN = 2046
B1I_NMAX = 2602
D1_SECS = dict(track_pilot=True, sec_len_pilot=20, sec_len_data=20,
               sec_lcm=20)
# GPS L2C (CM) at 2.6 Msps: the 10230-chip, 20 ms code at 511.5 kchip/s
L2C_KW = dict(fs=2.6e6, code_rate_cps=0.5115e6, carrier_freq_hz=1227.6e6)
L2C_LEN = 10230
L2C_NMAX = 52002


def d1_inputs(C, K, nmax, code_len, sec0, seed, launches=1):
    """pilot_inputs in the D1 mode: the data code equal to the pilot code,
    both secondary rows NH20-long and equal, the Costas discriminator kept
    (atan2 off), 20-period integration, and channel c started mid-symbol:
    its integration and secondary counters at ``sec0[c]``."""
    from gnss_sdr_tpu_torch.ops.slots import S_ATAN2, S_INTEG_CNT, S_SEC_IDX

    codes, _, wr, wi, scal, _, secd = pilot_inputs(
        C, K, nmax, TAPS, True, 20, 20, 20, extend=20, seed=seed,
        launches=launches, code_len=code_len)
    secd[:] = secd[0]
    scal[:, S_ATAN2] = 0
    scal[:, S_SEC_IDX] = sec0
    scal[:, S_INTEG_CNT] = sec0
    return codes, codes.copy(), wr, wi, scal, secd.copy(), secd


def d1_signal(plan, n, dops, delays, sec0, seed):
    """Channels c of a BeiDou D1 ``plan`` (its table rows c) at its rate:
    the code times NH20 times a random navigation bit each 20 periods, on
    the in-phase axis, secondary chip ``sec0[c]`` on the period that starts
    at the channel's delay (samples), at the given Dopplers, with noise."""
    rng = np.random.default_rng(seed)
    fs, length = plan.fs, plan.table_length
    tt = np.arange(n) / fs
    sig = np.zeros(n, np.complex64)
    nh = plan.sec_data_levels
    for c, (dop, dly, s0) in enumerate(zip(dops, delays, sec0)):
        u = np.floor((plan.table_rate_cps
                      * (1 + dop / plan.carrier_freq_hz))
                     * (tt - dly / fs)).astype(np.int64)
        per = np.floor_divide(u, length) + s0
        bit_i = np.floor_divide(per, 20)
        bits = np.where(rng.random(int(bit_i.max() - bit_i.min()) + 1)
                        < 0.5, 1.0, -1.0)[bit_i - bit_i.min()]
        chips = plan.code_table[c][u - np.floor_divide(u, length) * length]
        sig += (0.35 * chips * nh[per % 20] * bits
                * np.exp(2j * np.pi * dop * tt + 0.3j * c)).astype(
                    np.complex64)
    noise = rng.normal(size=(n, 2)).astype(np.float32) * 0.05
    return (sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


def d1_block(plan, K, dops, delays, sec0, window, device):
    """The fused engine's inputs for one block of K periods of a BeiDou D1
    ``plan``'s channels on ``window`` (d1_signal's), as the tracker packs
    them: each channel started at its delay 3 Hz off its Doppler, then
    past the NH20 lock as ``Tracker._engage_secondary`` leaves it,
    mid-symbol: the secondary engaged at chip ``sec0[c]``, the Costas
    discriminator kept, narrow bandwidths, 20-period integration with the
    counter at ``sec0[c]``. Returns (window, codes, scalars, pos, spec)
    and the pilot tables."""
    from gnss_sdr_tpu_torch.tracking.fused import (
        _pack_scalars,
        build_fused_engine,
    )
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    conf = dataclasses.replace(plan.trk_conf, steps_per_block=K)
    trk = Tracker(conf, plan.code_table, plan.data_code_table,
                  plan.sec_pilot_table, plan.sec_data_levels, device=device)
    for ch in range(len(dops)):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=delays[ch],
                          acq_doppler_hz=dops[ch] + 3.0,
                          acq_samplestamp=0, current_abs_sample=0)
    c = len(sec0)
    on = torch.ones(c, dtype=torch.bool, device=device)
    idx = torch.as_tensor(np.asarray(sec0, np.int32), device=device)
    st = trk.state.replace(
        pos=torch.as_tensor(trk.pos_abs.astype(np.int32), device=device),
        sec_active=on, use_atan2=~on, narrow=on, fll_active=~on,
        integ_len=torch.full((c,), 20, dtype=torch.int32, device=device),
        integ_count=idx.clone(), sec_idx=idx.clone())
    tabs = tuple(torch.as_tensor(t, device=device) for t in (
        trk.data_codes, trk.sec_pilot, trk.sec_data))
    return ((torch.as_tensor(window, device=device),
             torch.as_tensor(trk.codes, device=device),
             _pack_scalars(conf, st), st.pos, build_fused_engine(conf)),
            tabs)


def e1b_cboc_baseband(prn, fs, n, cn0_dbhz, doppler_hz, delay_chips, seed):
    """tests/test_acq_engines.py's Galileo E1-B CBOC(6,1,1/11) baseband:
    subchips at 12x the code rate, unit-power complex noise."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import (
        cboc_expand,
        galileo_e1b_code,
    )

    sub = cboc_expand(galileo_e1b_code(prn)).astype(np.float64)
    t = np.arange(n, dtype=np.float64) / fs
    ph = (t * 1.023e6 - delay_chips) * 12.0
    s = sub[np.floor(ph).astype(np.int64) % len(sub)]
    amp = np.sqrt(10.0 ** (cn0_dbhz / 10.0) / fs)
    rng = np.random.default_rng(seed)
    x = amp * s * np.exp(2j * np.pi * doppler_hz * t)
    x += rng.normal(scale=np.sqrt(0.5), size=n) + 1j * rng.normal(
        scale=np.sqrt(0.5), size=n)
    return x.astype(np.complex64)
