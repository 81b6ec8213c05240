"""Batched DLL/PLL(/FLL) tracking engine, eager.

Counterpart of ``gnss_sdr_tpu/tracking/dll_pll.py``. The reference's
universal tracker (dll_pll_veml_tracking.cc) runs one block per channel and
closes the code and carrier loops every code period; here all channels are
one batch:

- per-channel state lives in a ``TrackingState`` dataclass of [C]-shaped
  tensors on one device;
- ``track_block`` runs ``conf.steps_per_block`` code periods as an eager
  loop, vectorised over channels. Each period reads ``max_step_samples``
  samples per channel from the shared window at the channel's position and
  masks the tail beyond the period's true length;
- the correlation of each period (wipeoff, soft replica, tap sums) is one
  call of ``ops.correlator.correlator``: kernel K3 on a CUDA device, its
  plain version on the CPU;
- extended coherent integration runs through per-channel accumulators, with
  loop updates only at integration boundaries;
- carrier phase, code phase and code frequency are float64.

Idle (disabled) channels consume ``max_step_samples`` per period without
advancing, as in the JAX engine; the fused engine (``tracking/fused.py``)
instead holds them still. Each engine keeps its own behaviour.

Modes: CDMA, 3 or 5 taps, interpolated or nearest-chip replica, PLL/DLL
orders 1-3, FLL assist, extended integration, and pilot/secondary tracking
(the taps correlate the pilot code, K3's data prompt the data code; once
the host engages the secondary, the pilot taps and the data prompt are
wiped by their secondary chips at the channel's secondary index), and
FDMA (GLONASS): the per-channel slot offset ``carrier_offset`` rides on
the Doppler. As in the JAX engine (which keeps FDMA off its Pallas
correlator), the wipeoff phase is computed per sample in float64, reduced
mod 2 pi, cast to float32 and applied to the samples in torch; K3 then
runs with a zero phase and step, which leaves each sample as it is.

The Kalman mode (``conf.kf``, reference kf_tracking.cc) replaces the
carrier loop filter with an error-state EKF over [phase error (cycles),
frequency error (Hz), frequency-rate error (Hz/s)] (``kf_x``, covariance
``kf_P``) and the DLL filter with a scalar Kalman gain on the
discriminator (variance ``kf_pc``), updated at integration boundaries in
float32 in the JAX engine's order of operations. The fused engine does not
carry it (``tracking/fused.py::fused_eligible``), so every Kalman period
is one K3 launch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops.correlator import correlator
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
from gnss_sdr_tpu_torch.tracking.discriminators import (
    dll_nelp,
    dll_veml,
    fll_atan,
    pll_atan2,
    pll_costas_atan,
)
from gnss_sdr_tpu_torch.tracking.loop_filter import loop_filter_step

LANES = 128


@dataclass
class TrackingState:
    """Per-channel tracking state ([C]-shaped tensors on one device)."""

    enabled: torch.Tensor           # bool: channel active
    pos: torch.Tensor               # int32: next-step start, window-relative
    rem_code_phase: torch.Tensor    # f64: chips into the code at `pos`
    code_freq: torch.Tensor         # f64: chips/s
    carrier_phase: torch.Tensor     # f64: accumulated rad
    carrier_doppler: torch.Tensor   # f32: Hz
    carrier_offset: torch.Tensor    # f64: Hz, per-channel FDMA offset
    pll_state: torch.Tensor         # [C, 2] f32 loop-filter integrators
    dll_state: torch.Tensor         # [C, 2] f32
    prev_prompt: torch.Tensor       # c64: last boundary prompt (FLL)
    fll_active: torch.Tensor        # bool
    narrow: torch.Tensor            # bool: narrow-bandwidth mode
    use_atan2: torch.Tensor         # bool: four-quadrant PLL
    integ_len: torch.Tensor         # int32: code periods per loop update
    integ_count: torch.Tensor       # int32
    acc_taps: torch.Tensor          # [C, T] c64 coherent accumulators
    acc_samples: torch.Tensor       # int32: samples in current integration
    sec_idx: torch.Tensor           # int32: period index in secondary epoch
    sec_active: torch.Tensor        # bool: secondary wipeoff engaged
    acc_data: torch.Tensor          # c64: data-component accumulator
    acc_data_count: torch.Tensor    # int32: periods in the data accumulator
    # Kalman tracking mode (conf.kf; reference kf_tracking.cc)
    kf_x: torch.Tensor              # [C, 3] f32: phase cyc, freq Hz, Hz/s
    kf_P: torch.Tensor              # [C, 3, 3] f32 carrier state covariance
    kf_pc: torch.Tensor             # f32: code-delay error variance (chips^2)

    def replace(self, **changes) -> TrackingState:
        return dataclasses.replace(self, **changes)


_DTYPES = {
    "enabled": torch.bool, "pos": torch.int32,
    "rem_code_phase": torch.float64, "code_freq": torch.float64,
    "carrier_phase": torch.float64, "carrier_doppler": torch.float32,
    "carrier_offset": torch.float64, "pll_state": torch.float32,
    "dll_state": torch.float32, "prev_prompt": torch.complex64,
    "fll_active": torch.bool, "narrow": torch.bool, "use_atan2": torch.bool,
    "integ_len": torch.int32, "integ_count": torch.int32,
    "acc_taps": torch.complex64, "acc_samples": torch.int32,
    "sec_idx": torch.int32, "sec_active": torch.bool,
    "acc_data": torch.complex64, "acc_data_count": torch.int32,
    "kf_x": torch.float32, "kf_P": torch.float32, "kf_pc": torch.float32,
}

# the Kalman mode's initial carrier covariance and code-delay variance
KF_P0 = np.diag(np.array([0.01, 2500.0, 100.0], np.float32))
KF_PC0 = 0.25


def init_state(conf: DllPllConf, device) -> TrackingState:
    c, t = conf.max_channels, conf.num_taps

    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TrackingState(
        enabled=z(c, dtype=torch.bool),
        pos=z(c, dtype=torch.int32),
        rem_code_phase=z(c, dtype=torch.float64),
        code_freq=torch.full((c,), conf.code_rate_cps, dtype=torch.float64,
                             device=device),
        carrier_phase=z(c, dtype=torch.float64),
        carrier_doppler=z(c, dtype=torch.float32),
        carrier_offset=z(c, dtype=torch.float64),
        pll_state=z(c, 2, dtype=torch.float32),
        dll_state=z(c, 2, dtype=torch.float32),
        prev_prompt=z(c, dtype=torch.complex64),
        fll_active=z(c, dtype=torch.bool),
        narrow=z(c, dtype=torch.bool),
        use_atan2=z(c, dtype=torch.bool),
        integ_len=torch.ones(c, dtype=torch.int32, device=device),
        integ_count=z(c, dtype=torch.int32),
        acc_taps=z(c, t, dtype=torch.complex64),
        acc_samples=z(c, dtype=torch.int32),
        sec_idx=z(c, dtype=torch.int32),
        sec_active=z(c, dtype=torch.bool),
        acc_data=z(c, dtype=torch.complex64),
        acc_data_count=z(c, dtype=torch.int32),
        kf_x=z(c, 3, dtype=torch.float32),
        kf_P=torch.tensor(np.tile(KF_P0, (c, 1, 1)), device=device),
        kf_pc=torch.full((c,), KF_PC0, dtype=torch.float32, device=device),
    )


def state_from_numpy(d: dict, device) -> TrackingState:
    """A state from numpy arrays in the JAX package's layout (complex
    leaves as float32 [..., 2] re/im lanes)."""
    leaves = {}
    for name, dtype in _DTYPES.items():
        a = np.asarray(d[name])
        if dtype == torch.complex64:
            a = (a[..., 0] + 1j * a[..., 1]).astype(np.complex64)
        leaves[name] = torch.tensor(a, device=device).to(dtype)
    return TrackingState(**leaves)


def state_to_numpy(state: TrackingState) -> dict:
    """The state as numpy arrays in the JAX package's layout."""
    out = {}
    for name in _DTYPES:
        v = getattr(state, name).detach().cpu()
        if v.is_complex():
            v = torch.view_as_real(v)
        out[name] = v.numpy()
    return out


def tap_offsets_chips(conf: DllPllConf) -> np.ndarray:
    """Correlator tap offsets in chips, prompt in the middle."""
    d = conf.early_late_spacing_chips / 2.0
    if conf.num_taps == 5:
        v = conf.very_early_late_spacing_chips / 2.0
        return np.array([-v, -d, 0.0, d, v], dtype=np.float32)
    return np.array([-d, 0.0, d], dtype=np.float32)


def fdma_wipe(x: torch.Tensor, st: TrackingState, fs: float) -> torch.Tensor:
    """The samples [C, N] wiped off at each channel's FDMA carrier: the
    phase ``mod(carrier_phase, 2 pi) + (2 pi / fs) * (carrier_offset +
    doppler) * k`` in float64, reduced mod 2 pi and cast to float32 before
    the sine and cosine (at a slot offset of several MHz the phase sweeps
    ~1e4 rad a period, far past float32's absolute precision); the JAX
    engine's :269-283."""
    k64 = torch.arange(x.shape[1], dtype=torch.float64, device=x.device)
    freq = st.carrier_offset + st.carrier_doppler.to(torch.float64)
    ph64 = (torch.remainder(st.carrier_phase, 2.0 * np.pi)[:, None]
            + (2.0 * np.pi / fs) * freq[:, None] * k64[None, :])
    ph = torch.remainder(ph64, 2.0 * np.pi).to(torch.float32)
    return x * torch.complex(torch.cos(ph), -torch.sin(ph))


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """[C, L] chips -> [C, Q, 128] zero-padded table (the correlator's
    input layout, ``ops.correlator.pack_code_table``)."""
    c, length = codes.shape
    lpad = -(-length // LANES) * LANES
    return torch.nn.functional.pad(codes, (0, lpad - length)).reshape(
        c, lpad // LANES, LANES).contiguous()


def track_block(
    conf: DllPllConf,
    state: TrackingState,
    window: torch.Tensor,       # [W] complex64 shared sample window
    codes: torch.Tensor,        # [C, L] float32 per-channel PRN chips
                                #   (the PILOT code when conf.track_pilot)
    data_codes: torch.Tensor | None = None,  # [C, L] data code (pilot)
    sec_pilot: torch.Tensor | None = None,   # [C, sec_len_pilot] +-1
    sec_data: torch.Tensor | None = None,    # [C, sec_len_data] +-1
) -> tuple[TrackingState, dict]:
    """Run ``conf.steps_per_block`` code periods for all channels; returns
    the new state and a dict of per-period outputs ([S, C]-shaped)."""
    dev = window.device
    n_max = conf.max_step_samples
    code_len = float(conf.code_length_chips)
    fs = float(conf.fs)
    two_pi = np.float32(2.0 * np.pi)
    offsets = tap_offsets_chips(conf)
    t = conf.num_taps
    p_idx = t // 2
    w_len = window.shape[0]
    ki = torch.arange(n_max, dtype=torch.int64, device=dev)
    codes_q = pack_codes(codes.to(torch.float32))
    pilot = conf.track_pilot
    dcodes_q = pack_codes(data_codes.to(torch.float32)) if pilot else codes_q
    sp, sd = conf.sec_len_pilot, conf.sec_len_data
    w0f = np.float32(conf.fll_bw_hz / 0.53)

    def const(v) -> torch.Tensor:
        # 0-dim float32 device tensors: float32 arithmetic, true division
        return torch.tensor(np.float32(v), dtype=torch.float32, device=dev)

    zero, two_pi_t, fs_t = const(0.0), const(two_pi), const(fs)
    ph_rate = const(two_pi / np.float32(fs))
    w0f2 = const(w0f * w0f)
    pll_bws = const(conf.pll_bw_narrow_hz), const(conf.pll_bw_hz)
    dll_bws = const(conf.dll_bw_narrow_hz), const(conf.dll_bw_hz)
    if conf.kf:
        kf_consts = _kf_constants(conf, const)
    st = state
    steps = []
    for _ in range(conf.steps_per_block):
        # ---- period geometry from the current NCO frequencies ------------
        code_step = st.code_freq / fs                           # f64
        n_f = (code_len - st.rem_code_phase) / code_step
        n = torch.clamp(torch.ceil(n_f).to(torch.int32), 1, n_max)
        n = torch.where(st.enabled, n, n_max)       # idle channels burn max

        # ---- the period's samples per channel (start clamped into the
        # window, as a dynamic slice clamps it) ----------------------------
        start = torch.clamp(st.pos.to(torch.int64), 0, max(w_len - n_max, 0))
        x = window[(start[:, None] + ki[None, :]).clamp(max=w_len - 1)]

        # ---- correlation: K3 on CUDA, its plain version on the CPU; with
        # FDMA on samples already wiped off, at a zero phase and step ------
        if conf.fdma:
            x = fdma_wipe(x, st, fs)
            phase0 = torch.zeros_like(st.carrier_doppler)
            ph_step = phase0
        else:
            phase0 = torch.remainder(st.carrier_phase, 2.0 * np.pi).to(
                torch.float32)
            ph_step = ph_rate * st.carrier_doppler
        scalars = torch.stack([
            st.rem_code_phase.to(torch.float32),
            code_step.to(torch.float32),
            phase0,
            ph_step,
            n.to(torch.float32),
            torch.zeros_like(phase0),
            torch.zeros_like(phase0),
            torch.zeros_like(phase0),
        ], dim=1).contiguous()
        lanes = correlator(x, codes_q, dcodes_q, scalars, offsets,
                           code_len=conf.code_length_chips,
                           interp_code=conf.interp_code,
                           track_pilot=pilot)[:, 0, :]
        corr = torch.complex(lanes[:, 0:2 * t:2], lanes[:, 1:2 * t:2])
        if pilot:
            # the data code's prompt (reference d_correlator_data_cpu)
            corr_data = torch.complex(lanes[:, 2 * t], lanes[:, 2 * t + 1])
        else:
            corr_data = corr[:, p_idx]

        # ---- secondary-code wipeoff (once the host locks the sequence);
        # the per-period outputs keep the unwiped taps --------------------
        corr_acc = corr
        if pilot and sp > 1:
            chip_p = torch.gather(sec_pilot, 1, (st.sec_idx % sp).to(
                torch.int64)[:, None])[:, 0]
            corr_acc = corr * torch.where(st.sec_active, chip_p, 1.0)[:, None]
        if pilot and sd > 1:
            chip_d = torch.gather(sec_data, 1, (st.sec_idx % sd).to(
                torch.int64)[:, None])[:, 0]
            corr_data = corr_data * torch.where(st.sec_active, chip_d, 1.0)

        # ---- coherent accumulation ---------------------------------------
        acc_taps = st.acc_taps + corr_acc
        acc_samples = st.acc_samples + n
        integ_count = torch.where(st.enabled, st.integ_count + 1, 0).to(
            torch.int32)
        boundary = (integ_count >= st.integ_len) & st.enabled
        # data-symbol accumulation: one symbol spans sec_len_data periods
        acc_data = st.acc_data + corr_data
        acc_data_count = st.acc_data_count + 1
        data_boundary = ((st.sec_idx % conf.sec_len_data)
                         == conf.sec_len_data - 1) & st.enabled
        sec_idx_next = torch.where(
            st.enabled, (st.sec_idx + 1) % conf.sec_lcm, st.sec_idx).to(
            torch.int32)

        # ---- loop update at integration boundaries -----------------------
        t_int = acc_samples.to(torch.float32) / fs_t
        prompt_acc = acc_taps[:, p_idx]
        e_acc = acc_taps[:, p_idx - 1]
        l_acc = acc_taps[:, p_idx + 1]
        carr_err = torch.where(
            st.use_atan2,
            pll_atan2(prompt_acc.real, prompt_acc.imag),
            pll_costas_atan(prompt_acc.real, prompt_acc.imag),
        ) / two_pi_t                                           # cycles
        freq_err = fll_atan(st.prev_prompt, prompt_acc, t_int)  # Hz
        pll_bw = torch.where(st.narrow, *pll_bws)
        dll_bw = torch.where(st.narrow, *dll_bws)
        # FLL assist feeds the PLL integrator (only while fll_active)
        pll_st = torch.stack([
            st.pll_state[:, 0] + torch.where(
                boundary & st.fll_active, w0f2 * freq_err * t_int, zero),
            st.pll_state[:, 1]], dim=1)
        pll_st_new, pll_out = loop_filter_step(
            pll_st, carr_err, pll_bw, t_int, conf.pll_filter_order)
        if t == 5:
            code_err = dll_veml(acc_taps[:, 0], e_acc, l_acc, acc_taps[:, 4])
        else:
            code_err = dll_nelp(e_acc.real, e_acc.imag, l_acc.real,
                                l_acc.imag, conf.early_late_spacing_chips)
        dll_st_new, dll_out = loop_filter_step(
            st.dll_state, code_err, dll_bw, t_int, conf.dll_filter_order)
        if conf.kf:
            (doppler_new, code_freq_new, kf_phase_corr, kf_x_new, kf_P_new,
             kf_pc_new) = _kf_update(conf, kf_consts, st, boundary, t_int,
                                     carr_err, freq_err, code_err)
        else:
            doppler_new = torch.where(boundary, pll_out, st.carrier_doppler)
            # carrier-aided code NCO (reference run_dll_pll code freq update)
            aid = doppler_new.to(torch.float64) * (
                conf.code_rate_cps / conf.carrier_freq_hz)
            code_freq_new = torch.where(
                boundary,
                conf.code_rate_cps + aid - dll_out.to(torch.float64),
                st.code_freq)
            kf_x_new, kf_P_new, kf_pc_new = st.kf_x, st.kf_P, st.kf_pc

        # ---- advance the NCO state by the consumed period ----------------
        nf64 = n.to(torch.float64)
        nco_freq = st.carrier_doppler.to(torch.float64)
        if conf.fdma:
            nco_freq = nco_freq + st.carrier_offset
        carrier_phase = st.carrier_phase + (2.0 * np.pi / fs) * nco_freq * nf64
        if conf.kf:
            carrier_phase = carrier_phase + kf_phase_corr
        rem_new = st.rem_code_phase + nf64 * code_step - code_len
        rem_new = torch.where(rem_new < 0.0, rem_new + code_len, rem_new)

        en = st.enabled
        upd_bnd = (boundary & en)[:, None]
        new_state = st.replace(
            pos=torch.where(en, st.pos + n, st.pos),
            rem_code_phase=torch.where(en, rem_new, st.rem_code_phase),
            code_freq=torch.where(en, code_freq_new, st.code_freq),
            carrier_phase=torch.where(en, carrier_phase, st.carrier_phase),
            carrier_doppler=torch.where(en, doppler_new, st.carrier_doppler),
            pll_state=torch.where(upd_bnd, pll_st_new, st.pll_state),
            dll_state=torch.where(upd_bnd, dll_st_new, st.dll_state),
            prev_prompt=torch.where(boundary, prompt_acc, st.prev_prompt),
            integ_count=torch.where(boundary, 0, integ_count).to(
                torch.int32),
            acc_taps=torch.where(boundary[:, None], 0, acc_taps),
            acc_samples=torch.where(boundary, 0, acc_samples).to(
                torch.int32),
            sec_idx=sec_idx_next,
            acc_data=torch.where(data_boundary, 0, acc_data),
            acc_data_count=torch.where(data_boundary, 0,
                                       acc_data_count).to(torch.int32),
            kf_x=kf_x_new,
            kf_P=kf_P_new,
            kf_pc=kf_pc_new,
        )
        steps.append({
            "prompt": corr[:, p_idx],
            "taps": corr,
            "boundary": boundary,
            "acc_prompt": prompt_acc,
            "acc_samples": acc_samples,
            "carrier_doppler": doppler_new,
            "code_freq": code_freq_new,
            "carrier_phase": carrier_phase,
            "rem_code_phase": rem_new,
            "pos_end": st.pos + n,
            "n_samples": n,
            "data_prompt": acc_data,
            "data_boundary": data_boundary,
            "data_count": acc_data_count,
        })
        st = new_state
    outs = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    return st, outs


def _kf_constants(conf: DllPllConf, const) -> dict:
    """The Kalman mode's float32 noise constants as 0-dim device tensors."""
    return {
        "t_min": const(1e-6),
        "q": const(conf.kf_accel_std_hz_s2 ** 2),
        "r_phase": const(conf.kf_meas_std_cycles ** 2),
        "r_freq": const(conf.kf_freq_meas_std_hz ** 2),
        "r_off": (const(1e9), const(1e12)),
        "qc": const(conf.kf_code_process_std_chips ** 2),
        "rc": const(conf.kf_code_meas_std_chips ** 2),
        "two_pi": const(2.0 * np.pi),
    }


def _kf_update(conf: DllPllConf, k: dict, st: TrackingState,
               boundary: torch.Tensor, t_int: torch.Tensor,
               carr_err: torch.Tensor, freq_err: torch.Tensor,
               code_err: torch.Tensor):
    """Kalman carrier and code update at integration boundaries (the JAX
    engine's ``conf.kf`` branch, reference kf_tracking.cc).

    Error-state EKF: x = [phase err (cycles), freq err (Hz), freq-rate err
    (Hz/s)] relative to the commanded NCO. The PLL discriminator measures
    x0; the FLL discriminator measures x1 (enabled while fll_active via its
    R). After the update the frequency-error estimate moves into the NCO
    frequency and the phase-error estimate into the NCO phase, which zeroes
    those error states; the covariance is unchanged by that transfer. The
    code loop is a scalar Kalman gain on the DLL discriminator plus carrier
    aiding. Returns (Doppler, code frequency, float64 phase correction,
    kf_x, kf_P, kf_pc), each already selected by ``boundary``."""
    T = torch.maximum(t_int, k["t_min"])                        # [C]
    one = torch.ones_like(T)
    zero = torch.zeros_like(T)
    F = torch.stack([
        torch.stack([one, T, 0.5 * T * T], -1),
        torch.stack([zero, one, T], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=-2)                                                  # [C, 3, 3]
    T2 = T * T
    T3 = T2 * T
    Q = k["q"] * torch.stack([
        torch.stack([T3 * T2 / 20, T2 * T2 / 8, T3 / 6], -1),
        torch.stack([T2 * T2 / 8, T3 / 3, T2 / 2], -1),
        torch.stack([T3 / 6, T2 / 2, T], -1),
    ], dim=-2)                                                  # [C, 3, 3]
    x_pred = torch.einsum("cij,cj->ci", F, st.kf_x)
    P_pred = torch.einsum("cik,clk->cil",
                          torch.einsum("cij,cjk->cik", F, st.kf_P), F) + Q
    # update 1: phase discriminator, gated off during FLL pull-in (the
    # Costas atan wraps every 1/4 cycle; chasing wraps while the frequency
    # error is still tens of Hz drives false locks)
    r1 = torch.where(st.fll_active, k["r_off"][0], k["r_phase"])
    s1 = P_pred[:, 0, 0] + r1
    k1 = P_pred[:, :, 0] / s1[:, None]                          # [C, 3]
    x_up = x_pred + k1 * (carr_err - x_pred[:, 0])[:, None]
    P_up = P_pred - k1[:, :, None] * P_pred[:, None, 0, :]
    # update 2: frequency discriminator (pull-in only)
    r2 = torch.where(st.fll_active, k["r_freq"], k["r_off"][1])
    s2 = P_up[:, 1, 1] + r2
    k2 = P_up[:, :, 1] / s2[:, None]
    x_up = x_up + k2 * (freq_err - x_up[:, 1])[:, None]
    P_up = P_up - k2[:, :, None] * P_up[:, None, 1, :]
    doppler_new = torch.where(boundary, st.carrier_doppler + x_up[:, 1],
                              st.carrier_doppler)
    phase_corr = torch.where(boundary, k["two_pi"] * x_up[:, 0],
                             zero).to(torch.float64)
    kf_x = torch.where(boundary[:, None],
                       torch.stack([zero, zero, x_up[:, 2]], -1), st.kf_x)
    kf_P = torch.where(boundary[:, None, None], P_up, st.kf_P)
    # code: scalar Kalman gain on the DLL discriminator + carrier aiding
    pc_pred = st.kf_pc + k["qc"]
    kc = pc_pred / (pc_pred + k["rc"])
    aid = doppler_new.to(torch.float64) * (
        conf.code_rate_cps / conf.carrier_freq_hz)
    code_freq = torch.where(
        boundary,
        conf.code_rate_cps + aid - (kc * code_err / T).to(torch.float64),
        st.code_freq)
    kf_pc = torch.where(boundary, (1.0 - kc) * pc_pred, st.kf_pc)
    return doppler_new, code_freq, phase_corr, kf_x, kf_P, kf_pc
