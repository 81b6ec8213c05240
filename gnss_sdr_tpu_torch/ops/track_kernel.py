"""Fused trackers of ``gnss_sdr_tpu/ops/track_kernel.py``: K2 and K4.

**K2**, the per-channel fused tracker, is the counterpart of
``make_fused_tracker_full`` (``track_kernel.py:476-959``): one launch runs
K code periods of closed-loop DLL/PLL(/FLL) tracking for C channels, one
CTA per channel (``csrc/track_full.cu``). Its semantics, inputs and
output rows are K1's (``ops/track_kernel_blocked.py``): a complex64 window
[W], the float32 chip table [C, L], the float32 scalar block
[C, 24 + 2T + 1] of ``ops/slots.py`` and int32 positions [C]; the output
is float32 [C, K, 128]. Only the mapping of the loop onto the card
differs, so K2's plain version is K1's, ``track_blocked_plain``.
``tracking/fused.py`` selects K2 when ``GNSS_SDR_TPU_FUSED=perchannel``.
Modes: K1's: T = 3 or 5 taps, PLL/DLL orders 1-3, FLL assist, the atan2
flag, extended integration, both replica forms, the pilot mode with its
data code and secondary tables, and FDMA (the carrier offset in scalar slot
``S_ACC0 + 2T``). A CTA holds a whole period's ring and the tables in shared memory; a
shape past the card's limit raises ``ValueError``.

**K4**, the simple fused tracker, is the counterpart of
``make_fused_tracker`` (``track_kernel.py:107-432``): K periods of the
one-period CDMA loop (Costas PLL, NELP DLL at T = 3 or VEML at T = 5,
loop filters of order 1-3 with bandwidths fixed at build time, the
carrier-aided code NCO), run by K1's kernel with K4's own loop state and
closure (``csrc/track_simple.cu``): a thread-block cluster of R CTAs per
channel, R from ``cluster_shape`` as for K1.
Inputs: the complex64 window [W], the float32 chip table [C, L] (the
TPU's qloop/window2 table layouts have no counterpart) and the float32
scalar block [C, 10] ``[pos, rem, dcode, phase, doppler, pll_i1, dll_i1,
enabled, pll_i2, dll_i2]``. The position is float32 in slot 0 and in
output lane 17, as in the TPU kernel, and must be an integer below 2^24.
K4 never reads slot 7: every channel advances. Output rows: lanes
0..2T-1 the tap sums, lanes 10-19 the ``LANE_*`` fields, lanes 20-127
zero. K4 is not in the receiver; ``tools/kbench.py`` drives it.

``track_full`` and ``track_simple`` launch their kernels for CUDA tensors
and run their plain versions for CPU tensors; they never fall back from
one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import ClassVar

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import _build
from gnss_sdr_tpu_torch.ops.slots import (
    LANE_DCODE,
    LANE_DLL_I1,
    LANE_DLL_I2,
    LANE_DOPPLER,
    LANE_N,
    LANE_PHASE,
    LANE_PLL_I1,
    LANE_PLL_I2,
    LANE_POS,
    LANE_REM,
    LANES,
    S_DCODE,
    S_DLL_I1,
    S_DLL_I2,
    S_DOP,
    S_EN,
    S_PHASE,
    S_PLL_I1,
    S_PLL_I2,
    S_POS,
    S_REM,
)
from gnss_sdr_tpu_torch.ops.track_kernel_blocked import (
    BlockedSpec,
    check_inputs,
    check_layout,
    check_smem,
    launch_entry,
    launch_shape,
    make_blocked_spec,
    period_geometry,
    tap_sums,
    track_blocked_plain,
)

# ---------------------------------------------------------------------------
# K2: the per-channel fused tracker
# ---------------------------------------------------------------------------

# K2 computes what K1 computes on the same inputs
track_full_plain = track_blocked_plain


@dataclasses.dataclass(frozen=True)
class FullSpec(BlockedSpec):
    """K1's static configuration, naming the per-channel kernel."""

    kernel: ClassVar[str] = "track_full"


def make_full_spec(n_periods: int, n_max: int, code_len: int, tap_offsets,
                   **kw) -> FullSpec:
    """``make_blocked_spec``'s arguments and checks, for K2."""
    spec = make_blocked_spec(n_periods, n_max, code_len, tap_offsets, **kw)
    return FullSpec(**{f.name: getattr(spec, f.name)
                       for f in dataclasses.fields(spec)})


def track_full(window, codes, scalars, pos, spec: BlockedSpec, dcodes=None,
               sec_p=None, sec_d=None) -> torch.Tensor:
    """K2 on CUDA tensors, the plain version on CPU tensors; the pilot
    tables as for ``track_blocked``."""
    check_inputs(window, codes, scalars, pos, spec, dcodes, sec_p, sec_d)
    if window.device.type == "cpu":
        return track_full_plain(window, codes, scalars, pos, spec, dcodes,
                                sec_p, sec_d)
    if window.device.type != "cuda":
        raise ValueError(f"unsupported device {window.device}")
    out = torch.empty((scalars.shape[0], spec.n_periods, LANES),
                      dtype=torch.float32, device=window.device)
    launch(window, codes, scalars, pos, spec, out, dcodes, sec_p, sec_d)
    return out


def launch(window, codes, scalars, pos, spec: BlockedSpec,
           out: torch.Tensor, dcodes=None, sec_p=None, sec_d=None) -> None:
    """Launch K2 on checked CUDA inputs into ``out`` [C, K, 128], on the
    current stream, without synchronising. Raises ``ValueError`` when a CTA
    needs more shared memory than the card has."""
    check_smem(window.device, "gnss_track_full_smem", spec, spec.n_max)
    launch_entry("gnss_track_full", window, codes, scalars, pos, spec, out,
                 (dcodes, sec_p, sec_d))
    track_full.launches += 1


track_full.launches = 0

# ---------------------------------------------------------------------------
# K4: the simple fused tracker
# ---------------------------------------------------------------------------

SIMPLE_SCALARS = 10          # [pos, rem, dcode, phase, doppler, pll_i1,
                             #  dll_i1, enabled, pll_i2, dll_i2]
POS_LIMIT = 1 << 24          # float32 positions are exact below this


def _loop_div(order: int) -> float:
    """Bandwidth -> natural frequency divisor (``track_kernel.py:164``)."""
    return 0.53 if order == 2 else (0.7845 if order == 3 else 0.25)


def _filter_constants(bw_hz: float, order: int) -> list[np.float32]:
    """One loop filter's float32 constants, each rounded where the TPU
    kernel rounds it (numpy float32 at build time, ``:164-167, :331-350``):
    4 bw, w0^2, 1.414 w0, w0^3, 1.1 w0 w0, 2.4 w0."""
    w0 = np.float32(bw_hz / _loop_div(order))
    return [np.float32(4.0) * np.float32(bw_hz), w0 * w0,
            np.float32(1.414) * w0, w0 ** 3,
            np.float32(1.1) * w0 * w0, np.float32(2.4) * w0]


@dataclasses.dataclass(frozen=True)
class SimpleSpec:
    """Static configuration of K4 (what ``make_fused_tracker`` closes
    over, without its TPU table layouts)."""

    kernel: ClassVar[str] = "track_simple"
    n_periods: int
    n_max: int
    code_len: int
    tap_offsets: tuple
    fs: float
    code_rate_cps: float
    carrier_freq_hz: float
    pll_bw_hz: float
    dll_bw_hz: float
    pll_order: int = 2
    dll_order: int = 2
    interp_code: bool = True

    @property
    def num_taps(self) -> int:
        return len(self.tap_offsets)

    def constants(self) -> dict:
        """The float32 per-launch constants, rounded as the TPU kernel
        rounds them (``track_kernel.py:154-167``)."""
        nominal_step = np.float64(self.code_rate_cps / self.fs)
        spc = float(np.round(self.fs * self.code_len / self.code_rate_cps))
        return dict(
            inv_fs=np.float32(1.0 / self.fs),
            nominal_step=np.float32(nominal_step),
            aid_ratio=np.float32(self.code_rate_cps / self.carrier_freq_hz),
            c0=np.float32(spc * float(nominal_step) - self.code_len),
            spcf=np.float32(spc),
            pll=_filter_constants(self.pll_bw_hz, self.pll_order),
            dll=_filter_constants(self.dll_bw_hz, self.dll_order),
        )


def make_simple_spec(n_periods: int, n_max: int, code_len: int, tap_offsets,
                     *, fs: float, code_rate_cps: float,
                     carrier_freq_hz: float, pll_bw_hz: float,
                     dll_bw_hz: float, pll_order: int = 2,
                     dll_order: int = 2,
                     interp_code: bool = True) -> SimpleSpec:
    """``make_fused_tracker``'s static arguments (the tap count is the
    length of ``tap_offsets``), checked."""
    offs = tuple(float(o) for o in np.asarray(tap_offsets, np.float32))
    if len(offs) not in (3, 5):
        raise ValueError(f"K4 takes 3 or 5 taps, got {len(offs)}")
    for order in (pll_order, dll_order):
        if order not in (1, 2, 3):
            raise ValueError(f"loop filter order must be 1..3, got {order}")
    return SimpleSpec(int(n_periods), int(n_max), int(code_len), offs,
                      float(fs), float(code_rate_cps), float(carrier_freq_hz),
                      float(pll_bw_hz), float(dll_bw_hz), int(pll_order),
                      int(dll_order), bool(interp_code))


def check_simple_inputs(window, codes, scalars, spec: SimpleSpec) -> None:
    """Raise ``ValueError`` unless the inputs are what K4 takes (dtypes,
    shapes, one device, contiguous), every position in slot 0 is an integer
    in [0, 2^24), and every enabled channel's K periods lie inside the
    window."""
    check_layout(window, codes, scalars, spec.code_len, SIMPLE_SCALARS)
    # one device read: bad positions, and the enabled channels' reach
    pos = scalars[:, S_POS].double()
    en = scalars[:, S_EN] > 0.5
    bad, lo, hi = torch.stack([
        (~((pos == torch.floor(pos)) & (pos >= 0) & (pos < POS_LIMIT))
         ).sum().double(),
        torch.where(en, pos, 0.0).min(),
        torch.where(en, pos + spec.n_periods * spec.n_max, 0.0).max(),
    ]).tolist()
    if bad:
        raise ValueError("slot 0 (position) must hold integers in "
                         f"[0, 2^24); {int(bad)} channel(s) do not")
    if lo < 0 or hi > window.shape[0]:
        raise ValueError(f"window of {window.shape[0]} samples does not "
                         f"cover positions {lo:.0f}..{hi:.0f}")


def _filter_step(k, order, err, t_int, i1, i2):
    """One loop filter update in the TPU kernel's float32 order
    (``track_kernel.py:331-350``); ``k`` holds 0-dim constants."""
    k1, w0sq, kp2, w0cu, k3a, k3b = k
    if order == 1:
        return k1 * err, i1, i2
    if order == 2:
        i1 = i1 + w0sq * err * t_int
        return i1 + kp2 * err, i1, i2
    i2 = i2 + w0cu * err * t_int
    i1 = i1 + t_int * (i2 + k3a * err)
    return i1 + k3b * err, i1, i2


def track_simple_plain(window, codes, scalars,
                       spec: SimpleSpec) -> torch.Tensor:
    """Plain PyTorch version of K4: a loop over the K periods, vectorised
    over channels, in the kernel's float32 formulas."""
    dev = window.device
    f32 = torch.float32
    c = scalars.shape[0]
    t = spec.num_taps
    p = t // 2
    kc = spec.constants()

    def const(v) -> torch.Tensor:
        return torch.tensor(np.float32(v), dtype=f32, device=dev)

    inv_fs, nominal_step = const(kc["inv_fs"]), const(kc["nominal_step"])
    aid_ratio, c0, spcf = const(kc["aid_ratio"]), const(kc["c0"]), const(kc["spcf"])
    two_pi = const(2.0 * np.pi)
    dphase_hz = const(np.float32(2.0 * np.pi) * kc["inv_fs"])
    zero, half = const(0.0), const(0.5)
    pll_k = [const(v) for v in kc["pll"]]
    dll_k = [const(v) for v in kc["dll"]]
    offs = [const(o) for o in spec.tap_offsets]

    def col(s):
        return scalars[:, s].clone()

    pos, rem, dcode = col(S_POS), col(S_REM), col(S_DCODE)
    phase0, doppler = col(S_PHASE), col(S_DOP)
    pll_i1, pll_i2 = col(S_PLL_I1), col(S_PLL_I2)
    dll_i1, dll_i2 = col(S_DLL_I1), col(S_DLL_I2)

    out = torch.zeros((c, spec.n_periods, LANES), dtype=f32, device=dev)

    def mag(taps, ti):
        re, im = taps[2 * ti], taps[2 * ti + 1]
        return torch.sqrt(re * re + im * im)

    for i in range(spec.n_periods):
        # ---- period length, then the tap sums (:194-305) -----------------
        delta, code_step, n = period_geometry(rem, dcode, inv_fs, nominal_step,
                                              c0, spcf, spec.n_max)
        taps = tap_sums(window, codes, pos.to(torch.int64), n, rem, code_step,
                        phase0, dphase_hz * doppler, offs, spec.interp_code,
                        spec.n_max)

        # ---- discriminators (:307-327): Costas, NELP / VEML -------------
        p_re, p_im = taps[2 * p], taps[2 * p + 1]
        nz_re = torch.where(p_re.abs() < 1e-20, const(1e-20), p_re)
        carr_err = torch.atan(p_im / nz_re) / two_pi
        e_mag, l_mag = mag(taps, p - 1), mag(taps, p + 1)
        if t == 5:
            ve, vl = mag(taps, 0), mag(taps, 4)
            num = (e_mag + ve) - (l_mag + vl)
            den = (e_mag + ve) + (l_mag + vl)
        else:
            num = e_mag - l_mag
            den = e_mag + l_mag
        code_err = half * num / torch.maximum(den, const(1e-20))

        # ---- loop filters (:329-350), every period ----------------------
        t_int = n * inv_fs
        pll_out, pll_i1, pll_i2 = _filter_step(pll_k, spec.pll_order,
                                               carr_err, t_int, pll_i1, pll_i2)
        dll_out, dll_i1, dll_i2 = _filter_step(dll_k, spec.dll_order,
                                               code_err, t_int, dll_i1, dll_i2)

        # ---- NCO advance at the pre-update Doppler (:352-363) -----------
        phase_new = phase0 + dphase_hz * doppler * n
        phase_new = phase_new - two_pi * torch.floor(phase_new / two_pi)
        dcode_new = pll_out * aid_ratio - dll_out
        rem_new = torch.maximum(
            rem + ((n - spcf) * code_step + c0 + spcf * delta), zero)
        pos_new = pos + n

        row = out[:, i, :]
        for j in range(2 * t):
            row[:, j] = taps[j]
        for lane, v in ((LANE_N, n), (LANE_DOPPLER, pll_out),
                        (LANE_DCODE, dcode_new), (LANE_REM, rem_new),
                        (LANE_PHASE, phase_new), (LANE_PLL_I1, pll_i1),
                        (LANE_DLL_I1, dll_i1), (LANE_POS, pos_new),
                        (LANE_PLL_I2, pll_i2), (LANE_DLL_I2, dll_i2)):
            row[:, lane] = v
        pos, rem, dcode, phase0, doppler = (pos_new, rem_new, dcode_new,
                                            phase_new, pll_out)
    return out


def track_simple(window, codes, scalars, spec: SimpleSpec) -> torch.Tensor:
    """K4 on CUDA tensors, the plain version on CPU tensors."""
    check_simple_inputs(window, codes, scalars, spec)
    if window.device.type == "cpu":
        return track_simple_plain(window, codes, scalars, spec)
    if window.device.type != "cuda":
        raise ValueError(f"unsupported device {window.device}")
    out = torch.empty((scalars.shape[0], spec.n_periods, LANES),
                      dtype=torch.float32, device=window.device)
    launch_simple(window, codes, scalars, spec, out)
    return out


def simple_launch_shape(device: torch.device, c: int,
                        spec: SimpleSpec) -> tuple[int, int]:
    """K4's (R, S) on ``device``: K1's rule (``cluster_shape``), with the
    occupancy query taken on K4's shared memory (the sample ring and its
    ``code_len``-chip table) and tap count."""
    return launch_shape(device, c, spec.n_max,
                        "gnss_track_simple_max_clusters", c, spec.code_len,
                        spec.n_max, int(spec.interp_code), spec.num_taps)


def launch_simple(window, codes, scalars, spec: SimpleSpec,
                  out: torch.Tensor) -> None:
    """Launch K4 on checked CUDA inputs into ``out`` [C, K, 128], on the
    current stream, without synchronising; raises if the launch fails.
    ``track_simple.cluster`` keeps the cluster size R of the last launch."""
    k = spec.constants()
    c = scalars.shape[0]
    r, width = simple_launch_shape(window.device, c, spec)
    # host float32[32]: K1's layout in 0..7 (inv_fs, nominal_step,
    # aid_ratio, -, -, -, c0, spcf), tap offsets in 8..12, then the PLL's
    # and the DLL's filter constants in 16..21 and 22..27
    params = [0.0] * 32
    params[0:8] = [k["inv_fs"], k["nominal_step"], k["aid_ratio"], 0.0, 0.0,
                   0.0, k["c0"], k["spcf"]]
    params[8:8 + spec.num_taps] = spec.tap_offsets
    params[16:22] = k["pll"]
    params[22:28] = k["dll"]
    hp = (ctypes.c_float * 32)(*[float(v) for v in params])
    fn = _build.library().gnss_track_simple
    with torch.cuda.device(window.device):
        stream = torch.cuda.current_stream(window.device).cuda_stream
        rc = fn(window.data_ptr(), window.shape[0], codes.data_ptr(),
                spec.code_len, scalars.data_ptr(), out.data_ptr(), c,
                spec.n_periods, spec.n_max, hp, spec.num_taps,
                spec.pll_order, spec.dll_order, int(spec.interp_code), r,
                width, stream)
    _build.check(rc, "gnss_track_simple")
    track_simple.cluster = r
    track_simple.launches += 1


track_simple.launches = 0
track_simple.cluster = None


def fused_scalars_from_state(state, conf) -> torch.Tensor:
    """Pack a ``TrackingState`` into K4's [C, 10] scalar block
    (``track_kernel.py:962-975``)."""
    return torch.stack([
        state.pos.to(torch.float32),
        state.rem_code_phase.to(torch.float32),
        (state.code_freq - conf.code_rate_cps).to(torch.float32),
        torch.remainder(state.carrier_phase, 2.0 * np.pi).to(torch.float32),
        state.carrier_doppler.to(torch.float32),
        state.pll_state[:, 0].to(torch.float32),
        state.dll_state[:, 0].to(torch.float32),
        state.enabled.to(torch.float32),
        state.pll_state[:, 1].to(torch.float32),
        state.dll_state[:, 1].to(torch.float32),
    ], dim=1)
