"""K-period fused tracker (kernel K1) and its plain version.

Counterpart of ``gnss_sdr_tpu/ops/track_kernel_blocked.py``
(``make_fused_tracker_blocked``): one launch runs K code periods of
closed-loop DLL/PLL(/FLL) tracking for C channels. Per period and channel:
the period length from the code NCO, carrier wipeoff, the
soft-interpolated replica at T taps, coherent accumulation over
``integ_len`` periods, and at each integration boundary the Costas/atan2
PLL with FLL assist, the early-minus-late DLL (NELP at T = 3, VEML at
T = 5), order 1-3 loop filters with per-channel bandwidths, and the
carrier-aided code NCO. The scalar input slots and output lanes are those
of ``ops/slots.py``; the output is float32 [C, K, 128], one row per
channel and period.

Pilot mode (``track_pilot``, the TPU kernel's :483-529): the chip table is
the pilot code; a data code table [C, L] feeds one more correlation at
offset 0, the data prompt; once a channel's secondary is engaged (slot
``S_SEC_ACT``) each period's taps are wiped by the pilot secondary chip
``sec_p[c, sec_idx mod sec_len_pilot]`` and the data prompt by
``sec_d[c, sec_idx mod sec_len_data]``; the secondary index runs modulo
``sec_lcm`` and the data accumulator (lanes 32-35) closes a symbol every
``sec_len_data`` periods. ``sec_p`` and ``sec_d`` are float32 [C, w] with
the sequence's length <= w <= 128.

``track_blocked`` launches ``csrc/track_blocked.cu`` for CUDA tensors and
runs ``track_blocked_plain`` for CPU tensors; it never falls back from one
to the other. On the card each channel is a thread-block cluster of R CTAs,
each taking a slice of S samples of every period; ``cluster_shape`` is the
rule that picks R and S from the channel count.

Inputs differ from the TPU kernel's where those were TPU layouts: the
window is the sample stream itself (complex64 [W]), the code table is the
plain [C, L] chip table, and positions are int32 [C] rather than a float
scalar slot (slot ``S_POS`` is ignored). Each channel's samples are read
directly at ``pos + k``, so no channel padding, bit packing or limit on the
spread of positions applies. Lane ``LANE_POS`` still carries the position
as float32, as in the TPU kernel; the fused engine takes positions from the
exact per-period counts in lane ``LANE_N`` instead.

FDMA mode (``fdma``, the TPU kernel's :308, :386-399 and :597-600): each
channel's carrier offset rides in scalar slot ``S_ACC0 + 2T`` as w_off,
rad/sample reduced to [-pi, pi) on the host (``tracking/fused.py``). The
per-sample carrier step is ``(2 pi / fs) * doppler + w_off``, the phase
``ph0 + step * k`` is reduced as ``ph - 2 pi floor(ph / 2 pi)`` before the
sine and cosine (the ramp reaches about n_max * pi rad, where a float32
ulp is ~1e-3 rad), and the NCO advances by ``step * n``. XLA on the CPU
contracts each of these sums with its product into one fused multiply-add,
so the plain version and the kernels round each once (``_fma``).

Modes: T = 3 or 5 taps, PLL/DLL orders 1-3, FLL assist, the atan2 flag,
extended integration, both replica forms, the pilot mode and FDMA. A
shape whose CTA needs more shared memory than the card has (the ring, the
code tables and, in pilot mode, the secondary rows) raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import _build
from gnss_sdr_tpu_torch.ops.slots import (
    LANE_ACC0,
    LANE_ACC_N,
    LANE_BOUND,
    LANE_DATA_BOUND,
    LANE_DATA_CNT,
    LANE_DATA_IM,
    LANE_DATA_RE,
    LANE_DCODE,
    LANE_DLL_I1,
    LANE_DLL_I2,
    LANE_DOPPLER,
    LANE_ICOUNT,
    LANE_N,
    LANE_PHASE,
    LANE_PLL_I1,
    LANE_PLL_I2,
    LANE_POS,
    LANE_PREV_IM,
    LANE_PREV_RE,
    LANE_REM,
    LANE_SEC_IDX,
    LANES,
    S_ACC0,
    S_ACCD_CNT,
    S_ACCD_IM,
    S_ACCD_RE,
    S_ACC_N,
    S_ATAN2,
    S_DCODE,
    S_DLL_BW,
    S_DLL_I1,
    S_DLL_I2,
    S_DOP,
    S_EN,
    S_FLL,
    S_INTEG_CNT,
    S_INTEG_LEN,
    S_PHASE,
    S_PLL_BW,
    S_PLL_I1,
    S_PLL_I2,
    S_PREV_IM,
    S_PREV_RE,
    S_REM,
    S_SEC_ACT,
    S_SEC_IDX,
    num_scalars,
)

SEC_MAX = 128          # secondary chips a table row may hold


@dataclass(frozen=True)
class BlockedSpec:
    """Static configuration of one fused tracker (what the TPU package's
    ``make_fused_tracker_blocked`` closes over)."""

    kernel: ClassVar[str] = "track_blocked"
    n_periods: int
    n_max: int
    code_len: int
    tap_offsets: tuple
    fs: float
    code_rate_cps: float
    carrier_freq_hz: float
    pll_order: int = 2
    dll_order: int = 2
    fll_bw_hz: float = 4.0
    interp_code: bool = True
    track_pilot: bool = False
    sec_len_pilot: int = 1
    sec_len_data: int = 1
    sec_lcm: int = 1
    fdma: bool = False

    @property
    def num_taps(self) -> int:
        return len(self.tap_offsets)

    @property
    def num_scalars(self) -> int:
        return num_scalars(self.num_taps)

    def constants(self) -> dict[str, np.float32]:
        """The float32 per-launch constants, rounded as the TPU kernel
        rounds them (``track_kernel_blocked.py:198-210``)."""
        nominal_step = np.float64(self.code_rate_cps / self.fs)
        spc = float(np.round(self.fs * self.code_len / self.code_rate_cps))
        return dict(
            inv_fs=np.float32(1.0 / self.fs),
            nominal_step=np.float32(nominal_step),
            aid_ratio=np.float32(self.code_rate_cps / self.carrier_freq_hz),
            w0f=np.float32(self.fll_bw_hz / 0.53),
            pll_div=np.float32(0.53 if self.pll_order == 2 else 0.7845),
            dll_div=np.float32(0.53 if self.dll_order == 2 else 0.7845),
            c0=np.float32(spc * float(nominal_step) - self.code_len),
            spcf=np.float32(spc),
        )


def make_blocked_spec(n_periods: int, n_max: int, code_len: int,
                      tap_offsets, *, fs: float, code_rate_cps: float,
                      carrier_freq_hz: float, pll_order: int = 2,
                      dll_order: int = 2, fll_bw_hz: float = 4.0,
                      interp_code: bool = True, track_pilot: bool = False,
                      sec_len_pilot: int = 1, sec_len_data: int = 1,
                      sec_lcm: int = 1, fdma: bool = False) -> BlockedSpec:
    offs = tuple(float(o) for o in np.asarray(tap_offsets, np.float32))
    if len(offs) not in (3, 5):
        raise ValueError(f"fused tracker: 3 or 5 taps, got {len(offs)}")
    for order in (pll_order, dll_order):
        if order not in (1, 2, 3):
            raise ValueError(f"loop filter order must be 1..3, got {order}")
    sec = (int(sec_len_pilot), int(sec_len_data), int(sec_lcm))
    if track_pilot and not (1 <= sec[0] <= SEC_MAX and 1 <= sec[1] <= SEC_MAX
                            and sec[2] >= 1):
        raise ValueError(f"secondary lengths must be 1..{SEC_MAX}, got {sec}")
    if not track_pilot:
        sec = (1, 1, 1)
    return BlockedSpec(int(n_periods), int(n_max), int(code_len), offs,
                       float(fs), float(code_rate_cps), float(carrier_freq_hz),
                       int(pll_order), int(dll_order), float(fll_bw_hz),
                       bool(interp_code), bool(track_pilot), *sec,
                       bool(fdma))


def check_layout(window, codes, scalars, code_len: int, num_scalars: int,
                 *others) -> None:
    """Raise unless the window is complex64 [W], the chip table float32
    [C, code_len] and the scalar block float32 [C, num_scalars], all of
    them (and ``others``) on one device and contiguous."""
    dev = window.device
    if window.dtype != torch.complex64 or window.dim() != 1:
        raise ValueError("window must be complex64 [W]")
    if (scalars.dtype != torch.float32 or scalars.dim() != 2
            or scalars.shape[1] != num_scalars):
        raise ValueError(f"scalars must be float32 [C, {num_scalars}]")
    c = scalars.shape[0]
    if codes.dtype != torch.float32 or tuple(codes.shape) != (c, code_len):
        raise ValueError(f"codes must be float32 [C, {code_len}]")
    for t in (window, codes, scalars, *others):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def check_pilot(codes, spec: BlockedSpec, dcodes, sec_p, sec_d) -> None:
    """Raise unless the pilot tables are what ``spec`` takes: with
    ``track_pilot`` the data code float32 [C, L] like ``codes`` and the
    secondary rows float32 [C, w], sec_len <= w <= 128, on its device and
    contiguous; without, none."""
    tables = (dcodes, sec_p, sec_d)
    if not spec.track_pilot:
        if any(t is not None for t in tables):
            raise ValueError("pilot tables given to a spec without "
                             "track_pilot")
        return
    if any(t is None for t in tables):
        raise ValueError("track_pilot needs dcodes, sec_p and sec_d")
    c = codes.shape[0]
    if dcodes.dtype != torch.float32 or dcodes.shape != codes.shape:
        raise ValueError(f"dcodes must be float32 [C, {spec.code_len}]")
    for name, t, n in (("sec_p", sec_p, spec.sec_len_pilot),
                       ("sec_d", sec_d, spec.sec_len_data)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != c
                or not n <= t.shape[1] <= SEC_MAX):
            raise ValueError(f"{name} must be float32 [C, w], "
                             f"{n} <= w <= {SEC_MAX}")
    for t in tables:
        if t.device != codes.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def check_inputs(window, codes, scalars, pos, spec: BlockedSpec,
                 dcodes=None, sec_p=None, sec_d=None) -> None:
    """Raise unless the inputs are what K1 and K2 take (dtypes, shapes,
    one device, contiguous, the pilot tables with ``track_pilot``) and
    every enabled channel's K periods lie inside the window."""
    c = scalars.shape[0]
    if pos.dtype != torch.int32 or tuple(pos.shape) != (c,):
        raise ValueError("pos must be int32 [C]")
    check_layout(window, codes, scalars, spec.code_len, spec.num_scalars, pos)
    check_pilot(codes, spec, dcodes, sec_p, sec_d)
    # enabled channels read up to pos + K * n_max (one device read)
    en = scalars[:, S_EN] > 0.5
    p = pos.to(torch.int64)
    lo, hi = torch.stack([
        torch.where(en, p, 0).min(),
        torch.where(en, p + spec.n_periods * spec.n_max, 0).max()]).tolist()
    if lo < 0 or hi > window.shape[0]:
        raise ValueError(f"window of {window.shape[0]} samples does not "
                         f"cover positions {lo}..{hi}")


MAX_CLUSTER = 8        # the portable thread-block cluster size
COPY_ALIGN = 2         # samples: a 16-byte bulk copy holds two complex64


def cluster_shape(c: int, n_max: int, sms: int,
                  max_clusters=None) -> tuple[int, int]:
    """K1's launch shape for ``c`` channels of at most ``n_max`` samples a
    period on a card of ``sms`` multiprocessors (132 on an H100 SXM): (R,
    S), R CTAs per channel (one cluster) each taking S samples of every
    period. R is the largest power of two <= 8 with R * c <= sms, or 1;
    then, if ``max_clusters(R, S)`` (the card's count of such
    clusters resident at once) is below ``c``, R halves until they fit or
    R = 1. S is ceil(n_max / R) rounded up to the copy alignment, so CTA r
    covers [r * S, (r + 1) * S) and the R slices cover [0, n_max)."""
    def width(r: int) -> int:
        s = -(-n_max // r)
        return -(-s // COPY_ALIGN) * COPY_ALIGN

    r = MAX_CLUSTER
    while r > 1 and r * c > sms:
        r //= 2
    while r > 1 and max_clusters is not None and max_clusters(r, width(r)) < c:
        r //= 2
    return r, width(r)


def wrap_code_index(m: torch.Tensor, code_len: int) -> torch.Tensor:
    """``m % code_len`` as the kernels compute it
    (``csrc/track_loop.cuh::wrap_index``): one conditional add or subtract
    for an index in [-code_len, 2 code_len), ``%`` beyond."""
    r = torch.where(m < 0, m + code_len,
                    torch.where(m >= code_len, m - code_len, m))
    return torch.where((r < 0) | (r >= code_len), m % code_len, r)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add rounds it (the
    product of two float32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


TWO_PI = np.float32(2.0 * np.pi)
INV_TWO_PI = np.float32(1.0 / (2.0 * np.pi))


def reduce_phase(ph: torch.Tensor) -> torch.Tensor:
    """The FDMA ramp's ``ph - 2 pi floor(ph / 2 pi)`` as the TPU kernel
    rounds it (:398-399 under XLA's contraction): the quotient by a
    product with float32(1 / 2 pi), the difference in one fused
    multiply-add."""
    q = torch.floor(ph * torch.tensor(INV_TWO_PI, device=ph.device))
    return _fma(torch.tensor(-TWO_PI, device=ph.device), q, ph)


def period_geometry(rem, dcode, inv_fs, nominal_step, c0, spcf, n_max: int):
    """The period length from the code NCO: round, then correct a negative
    remnant (``csrc/track_loop.cuh::period_geometry``). Takes and returns
    float32 [C] (the constants as 0-dim tensors): delta, code_step, n."""
    delta = dcode * inv_fs
    code_step = nominal_step + delta
    small = rem + c0 + spcf * delta
    n_f = spcf - small / code_step
    n0 = torch.floor(n_f + 0.5)
    rem0 = rem + ((n0 - spcf) * code_step + c0 + spcf * delta)
    n = torch.clamp(n0 + (rem0 < 0.0).to(torch.float32), 1.0, float(n_max))
    return delta, code_step, n


def tap_sums(window, codes, posi, n, rem, code_step, phase0, dstep, offs,
             interp_code: bool, n_max: int, dcodes=None,
             fdma: bool = False) -> list:
    """One period's tap sums [re_0, im_0, re_1, ...] per channel
    (``csrc/track_loop.cuh::accumulate_staged``): the samples at
    ``posi + k`` for k < n (zeros outside the window), wiped off at the
    carrier phase ``phase0 + dstep * k``, times the soft replica at the
    code phase ``rem + code_step * k + offs[t]``; both ramps rounded once.
    With ``fdma`` the carrier phase is first reduced mod 2 pi
    (``reduce_phase``).
    The replica's ramp weight multiplies by ``1 / code_step``, computed once
    a period, as the kernels do, where the TPU kernels divide by the step
    per tap. With ``dcodes`` two more sums follow: the data code's replica
    at offset 0 (the data prompt)."""
    dev = window.device
    f32 = torch.float32
    w_len = window.shape[0]
    length = codes.shape[1]
    zero = torch.zeros((), dtype=f32, device=dev)
    kf = torch.arange(n_max, dtype=f32, device=dev)
    ki = torch.arange(n_max, dtype=torch.int64, device=dev)
    ni = n.to(torch.int64)
    idx = posi[:, None] + ki[None, :]
    valid = ki[None, :] < ni[:, None]
    inside = valid & (idx >= 0) & (idx < w_len)
    x = window[idx.clamp(0, w_len - 1)]
    mask = valid.to(f32)
    xr = torch.where(inside, x.real, zero)
    xi = torch.where(inside, x.imag, zero)
    ph = _fma(dstep[:, None], kf[None, :], phase0[:, None])
    if fdma:
        ph = reduce_phase(ph)
    sw, cw = torch.sin(ph), torch.cos(ph)
    wr = (xr * cw + xi * sw) * mask
    wi = (xi * cw - xr * sw) * mask
    cph = _fma(code_step[:, None], kf[None, :], rem[:, None])
    inv_step = (1.0 / code_step)[:, None]

    def replica(table, tap_ph):
        if interp_code:
            fl = torch.floor(tap_ph + 0.5)
            m = wrap_code_index(fl.to(torch.int64), length)
            cur = torch.gather(table, 1, m)
            prev = torch.gather(table, 1, torch.where(m == 0, length - 1,
                                                      m - 1))
            wgt = torch.clamp((tap_ph - fl) * inv_step + 0.5, 0.0, 1.0)
            return prev + (cur - prev) * wgt
        m = wrap_code_index(torch.floor(tap_ph).to(torch.int64), length)
        return torch.gather(table, 1, m)

    taps = []
    for table, tap_ph in ([(codes, cph + off) for off in offs]
                          + ([(dcodes, cph)] if dcodes is not None else [])):
        v = replica(table, tap_ph)
        taps.append((wr * v).sum(1))
        taps.append((wi * v).sum(1))
    return taps


def fmod_period(x: torch.Tensor, m: int) -> torch.Tensor:
    """x mod m for the float32 secondary counter, as the kernels compute it
    (``x - m * floor(x / m)``, ``csrc/track_loop.cuh::fmod_period``)."""
    mf = torch.tensor(np.float32(m), device=x.device)
    return x - mf * torch.floor(x / mf)


def secondary_chip(table: torch.Tensor, sec_idx: torch.Tensor,
                   period: int) -> torch.Tensor:
    """Each channel's secondary chip ``table[c, sec_idx mod period]``."""
    idx = fmod_period(sec_idx, period).to(torch.int64)
    return torch.gather(table, 1, idx[:, None])[:, 0]


def track_blocked_plain(window, codes, scalars, pos, spec: BlockedSpec,
                        dcodes=None, sec_p=None,
                        sec_d=None) -> torch.Tensor:
    """Plain PyTorch version of K1: a loop over the K periods, vectorised
    over channels, in the kernel's float32 formulas."""
    dev = window.device
    f32 = torch.float32
    c = scalars.shape[0]
    t = spec.num_taps
    p = t // 2
    n_max = spec.n_max
    k_const = spec.constants()

    def const(v) -> torch.Tensor:
        # 0-dim device tensors: float32 arithmetic with true division
        return torch.tensor(np.float32(v), dtype=f32, device=dev)

    inv_fs, nominal_step = const(k_const["inv_fs"]), const(k_const["nominal_step"])
    aid_ratio = const(k_const["aid_ratio"])
    c0, spcf = const(k_const["c0"]), const(k_const["spcf"])
    two_pi = const(2.0 * np.pi)
    dphase_hz = const(np.float32(2.0 * np.pi) * k_const["inv_fs"])
    w0f2 = const(k_const["w0f"] * k_const["w0f"])
    zero = const(0.0)
    offs = [const(o) for o in spec.tap_offsets]

    def col(s):
        return scalars[:, s].clone()

    eng = scalars[:, S_EN] > 0.5
    sec_act = scalars[:, S_SEC_ACT] > 0.5
    one = const(1.0)
    integ_len = col(S_INTEG_LEN)
    atan2_on = scalars[:, S_ATAN2] > 0.5
    fll_on = scalars[:, S_FLL] > 0.5
    pll_bw, dll_bw = col(S_PLL_BW), col(S_DLL_BW)
    w0p = pll_bw / const(k_const["pll_div"])
    w0d = dll_bw / const(k_const["dll_div"])

    posi = pos.to(torch.int64)
    rem, dcode, phase0, doppler = (col(S_REM), col(S_DCODE), col(S_PHASE),
                                   col(S_DOP))
    pll_i1, pll_i2 = col(S_PLL_I1), col(S_PLL_I2)
    dll_i1, dll_i2 = col(S_DLL_I1), col(S_DLL_I2)
    icount, acc_n, sec_idx = col(S_INTEG_CNT), col(S_ACC_N), col(S_SEC_IDX)
    prev_re, prev_im = col(S_PREV_RE), col(S_PREV_IM)
    accd_re, accd_im, accd_cnt = col(S_ACCD_RE), col(S_ACCD_IM), col(S_ACCD_CNT)
    acc = [col(S_ACC0 + j) for j in range(2 * t)]
    w_off = col(S_ACC0 + 2 * t) if spec.fdma else None

    out = torch.zeros((c, spec.n_periods, LANES), dtype=f32, device=dev)

    def nz(x):
        return torch.where(x.abs() < 1e-20, const(1e-20), x)

    for i in range(spec.n_periods):
        delta, code_step, n = period_geometry(rem, dcode, inv_fs,
                                              nominal_step, c0, spcf, n_max)
        ni = n.to(torch.int64)
        # the carrier step in force during the period (FDMA: plus w_off)
        dstep = (_fma(dphase_hz, doppler, w_off) if spec.fdma
                 else dphase_hz * doppler)
        taps = tap_sums(window, codes, posi, n, rem, code_step, phase0,
                        dstep, offs, spec.interp_code, n_max,
                        dcodes if spec.track_pilot else None, spec.fdma)

        # ---- coherent accumulation (secondary wipeoff in pilot mode) ----
        if spec.track_pilot:
            sp, sd = spec.sec_len_pilot, spec.sec_len_data
            wipe_p = (torch.where(sec_act, secondary_chip(sec_p, sec_idx, sp),
                                  one) if sp > 1 else one)
            wipe_d = (torch.where(sec_act, secondary_chip(sec_d, sec_idx, sd),
                                  one) if sd > 1 else one)
            d_re, d_im = taps[2 * t] * wipe_d, taps[2 * t + 1] * wipe_d
            acc = [a + tv * wipe_p for a, tv in zip(acc, taps[:2 * t])]
            data_boundary = ((fmod_period(sec_idx, sd) == float(sd - 1)) & eng
                             if sd > 1 else eng)
            sec_next = torch.where(eng, fmod_period(sec_idx + 1.0,
                                                    spec.sec_lcm), sec_idx)
        else:
            d_re, d_im = taps[2 * p], taps[2 * p + 1]
            acc = [a + tv for a, tv in zip(acc, taps)]
            data_boundary = eng
            sec_n = sec_idx + 1.0
            sec_next = torch.where(eng, sec_n - torch.floor(sec_n), sec_idx)
        acc_n_new = acc_n + n
        icount_new = torch.where(eng, icount + 1.0, zero)
        boundary = (icount_new >= integ_len) & eng
        bf = boundary.to(f32)
        accd_re_new = accd_re + d_re
        accd_im_new = accd_im + d_im
        accd_cnt_new = accd_cnt + 1.0
        dbf = data_boundary.to(f32)

        # ---- discriminators on the accumulated taps ---------------------
        t_int = acc_n_new * inv_fs
        p_re, p_im = acc[2 * p], acc[2 * p + 1]
        costas = torch.atan(p_im / nz(p_re))
        carr_err = torch.where(atan2_on, torch.atan2(p_im, p_re),
                               costas) / two_pi
        cross = prev_re * p_im - prev_im * p_re
        dot = prev_re * p_re + prev_im * p_im
        freq_err = torch.atan(cross / nz(dot)) / (
            two_pi * torch.maximum(t_int, const(1e-20)))
        e_re, e_im = acc[2 * (p - 1)], acc[2 * (p - 1) + 1]
        l_re, l_im = acc[2 * (p + 1)], acc[2 * (p + 1) + 1]
        e_mag = torch.sqrt(e_re * e_re + e_im * e_im)
        l_mag = torch.sqrt(l_re * l_re + l_im * l_im)
        if t == 5:
            # VEML: the very early and very late taps join the early and
            # late ones
            e_mag = e_mag + torch.sqrt(acc[0] * acc[0] + acc[1] * acc[1])
            l_mag = l_mag + torch.sqrt(acc[8] * acc[8] + acc[9] * acc[9])
        code_err = const(0.5) * (e_mag - l_mag) / torch.maximum(
            e_mag + l_mag, const(1e-20))

        # ---- loop filters (boundary-gated) ------------------------------
        pll_i1_a = pll_i1 + torch.where(boundary & fll_on,
                                        w0f2 * freq_err * t_int, zero)
        if spec.pll_order == 1:
            pll_i1_u, pll_i2_u = pll_i1_a, pll_i2
            pll_out = const(4.0) * pll_bw * carr_err
        elif spec.pll_order == 2:
            pll_i1_u = pll_i1_a + w0p * w0p * carr_err * t_int
            pll_i2_u = pll_i2
            pll_out = pll_i1_u + const(1.414) * w0p * carr_err
        else:
            pll_i2_u = pll_i2 + (w0p * w0p * w0p) * carr_err * t_int
            pll_i1_u = pll_i1_a + t_int * (
                pll_i2_u + const(1.1) * w0p * w0p * carr_err)
            pll_out = pll_i1_u + const(2.4) * w0p * carr_err
        if spec.dll_order == 1:
            dll_i1_u, dll_i2_u = dll_i1, dll_i2
            dll_out = const(4.0) * dll_bw * code_err
        elif spec.dll_order == 2:
            dll_i1_u = dll_i1 + w0d * w0d * code_err * t_int
            dll_i2_u = dll_i2
            dll_out = dll_i1_u + const(1.414) * w0d * code_err
        else:
            dll_i2_u = dll_i2 + (w0d * w0d * w0d) * code_err * t_int
            dll_i1_u = dll_i1 + t_int * (
                dll_i2_u + const(1.1) * w0d * w0d * code_err)
            dll_out = dll_i1_u + const(2.4) * w0d * code_err

        pll_i1_n = torch.where(boundary, pll_i1_u, pll_i1)
        pll_i2_n = torch.where(boundary, pll_i2_u, pll_i2)
        dll_i1_n = torch.where(boundary, dll_i1_u, dll_i1)
        dll_i2_n = torch.where(boundary, dll_i2_u, dll_i2)
        doppler_new = torch.where(boundary, pll_out, doppler)
        dcode_new = torch.where(boundary, doppler_new * aid_ratio - dll_out,
                                dcode)

        # ---- NCO advance over the consumed period -----------------------
        if spec.fdma:
            phase_adv = _fma(dstep, n, phase0)
            phase_adv = _fma(-two_pi, torch.floor(phase_adv / two_pi),
                             phase_adv)
        else:
            phase_adv = phase0 + dstep * n
            phase_adv = phase_adv - two_pi * torch.floor(phase_adv / two_pi)
        rem_adv = torch.maximum(
            rem + ((n - spcf) * code_step + c0 + spcf * delta), zero)
        posi = torch.where(eng, posi + ni, posi)
        rem_new = torch.where(eng, rem_adv, rem)
        phase_new = torch.where(eng, phase_adv, phase0)
        dop_out = torch.where(eng, doppler_new, doppler)
        dcode_out = torch.where(eng, dcode_new, dcode)
        prev_re_n = torch.where(boundary, p_re, prev_re)
        prev_im_n = torch.where(boundary, p_im, prev_im)
        icount_out = torch.where(boundary, zero, icount_new)

        # ---- the period's row -------------------------------------------
        row = out[:, i, :]
        for j in range(2 * t):
            row[:, j] = taps[j]
            row[:, LANE_ACC0 + j] = acc[j]
        for lane, v in (
            (LANE_N, n), (LANE_DOPPLER, dop_out), (LANE_DCODE, dcode_out),
            (LANE_REM, rem_new), (LANE_PHASE, phase_new),
            (LANE_PLL_I1, pll_i1_n), (LANE_DLL_I1, dll_i1_n),
            (LANE_POS, posi.to(f32)), (LANE_PLL_I2, pll_i2_n),
            (LANE_DLL_I2, dll_i2_n), (LANE_BOUND, bf),
            (LANE_ACC_N, acc_n_new), (LANE_DATA_RE, accd_re_new),
            (LANE_DATA_IM, accd_im_new), (LANE_DATA_BOUND, dbf),
            (LANE_DATA_CNT, accd_cnt_new), (LANE_SEC_IDX, sec_next),
            (LANE_ICOUNT, icount_out), (LANE_PREV_RE, prev_re_n),
            (LANE_PREV_IM, prev_im_n),
        ):
            row[:, lane] = v

        # ---- carry ------------------------------------------------------
        acc = [torch.where(boundary, zero, a) for a in acc]
        rem, dcode, phase0, doppler = rem_new, dcode_out, phase_new, dop_out
        pll_i1, pll_i2, dll_i1, dll_i2 = pll_i1_n, pll_i2_n, dll_i1_n, dll_i2_n
        icount = icount_out
        acc_n = torch.where(boundary, zero, acc_n_new)
        sec_idx, prev_re, prev_im = sec_next, prev_re_n, prev_im_n
        accd_re = torch.where(data_boundary, zero, accd_re_new)
        accd_im = torch.where(data_boundary, zero, accd_im_new)
        accd_cnt = torch.where(data_boundary, zero, accd_cnt_new)
    return out


def track_blocked(window, codes, scalars, pos, spec: BlockedSpec,
                  dcodes=None, sec_p=None, sec_d=None) -> torch.Tensor:
    """K1 on CUDA tensors, the plain version on CPU tensors; the pilot
    tables (``dcodes``, ``sec_p``, ``sec_d``) with ``spec.track_pilot``."""
    check_inputs(window, codes, scalars, pos, spec, dcodes, sec_p, sec_d)
    if window.device.type == "cpu":
        return track_blocked_plain(window, codes, scalars, pos, spec, dcodes,
                                   sec_p, sec_d)
    if window.device.type != "cuda":
        raise ValueError(f"unsupported device {window.device}")
    out = torch.empty((scalars.shape[0], spec.n_periods, LANES),
                      dtype=torch.float32, device=window.device)
    launch(window, codes, scalars, pos, spec, out, dcodes, sec_p, sec_d)
    return out


def launch(window, codes, scalars, pos, spec: BlockedSpec,
           out: torch.Tensor, dcodes=None, sec_p=None, sec_d=None) -> None:
    """Launch K1 on checked CUDA inputs into ``out`` [C, K, 128], on the
    current stream, without synchronising; ``track_blocked.cluster`` keeps
    the cluster size R of the last launch. Raises ``ValueError`` when a CTA
    of the chosen shape needs more shared memory than the card has."""
    c = scalars.shape[0]
    mode = (spec.code_len, spec.n_max, int(spec.interp_code), spec.num_taps,
            int(spec.track_pilot), int(spec.fdma))
    r, width = launch_shape(window.device, c, spec.n_max,
                            "gnss_track_blocked_max_clusters", c, *mode)
    check_smem(window.device, "gnss_track_blocked_smem", spec, width)
    launch_entry("gnss_track_blocked", window, codes, scalars, pos, spec, out,
                 (dcodes, sec_p, sec_d), r, width)
    track_blocked.cluster = r
    track_blocked.launches += 1


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """The multiprocessor count of a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=128)
def _max_clusters(entry: str, device: torch.device, *args: int) -> int:
    """The card's count of clusters resident at once, as the C entry point
    ``entry`` answers it for ``args`` (``cudaOccupancyMaxActiveClusters``;
    0 when a CTA does not fit)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(_build.library(), entry)(*args, ctypes.byref(n))
    _build.check(rc, entry)
    return n.value


@functools.lru_cache(maxsize=128)
def smem_need(entry: str, device: torch.device, *args: int) -> tuple[int, int]:
    """(bytes of shared memory one CTA needs, the card's limit per block),
    as the C entry point ``entry`` answers them for ``args``."""
    need, limit = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(_build.library(), entry)(*args, ctypes.byref(need),
                                              ctypes.byref(limit))
    if rc != 0 and not 0 < limit.value < need.value:
        _build.check(rc, entry)
    return need.value, limit.value


def check_smem(device: torch.device, entry: str, spec: BlockedSpec,
               extent: int) -> None:
    """Raise ``ValueError`` unless one CTA of K1 (slices of ``extent``
    samples) or K2 (periods of ``extent`` samples) fits the card's shared
    memory: the ring, the code table and, in pilot mode, the data code and
    the secondary rows."""
    need, limit = smem_need(entry, device, spec.code_len,
                            int(spec.interp_code), spec.num_taps,
                            int(spec.track_pilot), int(spec.fdma), extent)
    if need > limit:
        raise ValueError(
            f"{entry}: a CTA needs {need} B of shared memory for "
            f"{extent} samples and {spec.code_len}-unit tables"
            f"{' (pilot)' if spec.track_pilot else ''}; the card has {limit}")


def launch_shape(device: torch.device, c: int, n_max: int, entry: str,
                 *query: int) -> tuple[int, int]:
    """The (R, S) that a cluster tracker (K1, K4) launches with on
    ``device``: ``cluster_shape`` on the card's SM count, asking the
    occupancy entry point ``entry`` (with ``query``, then R and S) whether
    the C clusters fit at once."""
    return cluster_shape(
        c, n_max, sm_count(device),
        lambda r, s: _max_clusters(entry, device, *query, r, s))


def launch_entry(entry: str, window, codes, scalars, pos,
                 spec: BlockedSpec, out: torch.Tensor, pilot=(None,) * 3,
                 *shape: int) -> None:
    """Call the C entry point ``entry`` of the kernel library (K2's
    ``gnss_track_full``, or K1's ``gnss_track_blocked``, which also takes
    its cluster ``shape``, (R, S)), with the pilot tables ``pilot`` =
    (dcodes, sec_p, sec_d) in pilot mode; raises if the launch fails."""
    c = scalars.shape[0]
    k = spec.constants()
    params = [k["inv_fs"], k["nominal_step"], k["aid_ratio"], k["w0f"],
              k["pll_div"], k["dll_div"], k["c0"], k["spcf"],
              *spec.tap_offsets]
    params += [0.0] * (16 - len(params))
    hp = (ctypes.c_float * 16)(*[float(v) for v in params])
    dcodes, sec_p, sec_d = pilot
    tables = [0, 0, 0]
    sec = (ctypes.c_int * 5)(1, 1, 1, 1, 1)
    if spec.track_pilot:
        tables = [dcodes.data_ptr(), sec_p.data_ptr(), sec_d.data_ptr()]
        sec = (ctypes.c_int * 5)(sec_p.shape[1], sec_d.shape[1],
                                 spec.sec_len_pilot, spec.sec_len_data,
                                 spec.sec_lcm)
    fn = getattr(_build.library(), entry)
    with torch.cuda.device(window.device):
        stream = torch.cuda.current_stream(window.device).cuda_stream
        rc = fn(window.data_ptr(), window.shape[0], codes.data_ptr(),
                spec.code_len, scalars.data_ptr(), spec.num_scalars,
                pos.data_ptr(), out.data_ptr(), c, spec.n_periods,
                spec.n_max, hp, spec.num_taps, spec.pll_order,
                spec.dll_order, int(spec.interp_code),
                int(spec.track_pilot), int(spec.fdma), *tables, sec, *shape,
                stream)
    _build.check(rc, entry)


track_blocked.launches = 0
track_blocked.cluster = None
