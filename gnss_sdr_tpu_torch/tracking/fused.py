"""Fused tracking engine: the receiver's hot path on the card.

Counterpart of ``gnss_sdr_tpu/tracking/fused.py``. It wraps a fused
kernel (the whole K-period DLL/PLL loop in one launch) behind the same
contract as the eager engine (``tracking/dll_pll.track_block``: state in,
per-period outputs out), so ``tracking/tracker.py`` swaps engines without
touching the host FSM, observables or telemetry. The kernel is K1
(``ops/track_kernel_blocked.track_blocked``) unless
``GNSS_SDR_TPU_FUSED=perchannel``, which selects K2
(``ops/track_kernel.track_full``); both take the same inputs and return
the same rows.

Beyond the launch it

- packs the ``TrackingState`` into the kernel's [C, 24 + 2T + 1] scalar
  block, with per-channel wide/narrow bandwidths and the FLL/atan2/
  secondary flags; pilot plans also hand the kernel the data code table
  and the per-channel secondary rows (``sec_p`` [C, sec_len_pilot],
  ``sec_d`` [C, sec_len_data]);
- rebuilds the float64 bookkeeping the observables need: the accumulated
  carrier phase as a float64 cumulative sum over the per-period (Doppler
  in force during the period, length) pairs, since the kernel carries the
  phase mod 2 pi in float32, and the end positions as exact integer sums
  of the period lengths;
- folds the kernel's last row back into the ``TrackingState``.

The code phase rides in float32 inside the kernel (about 6e-5 chips of
resolution at 1023 chips, a few millimetres of pseudorange). Positions are
int32 throughout and each channel's samples are read directly, so the
TPU engine's limits on the window length and on the spread of channel
positions do not apply; the kernels' wrappers raise if a channel would
read past the end of the window.
"""

from __future__ import annotations

import os

import numpy as np
import torch

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
    LANE_PLL_I1,
    LANE_PLL_I2,
    LANE_PREV_IM,
    LANE_PREV_RE,
    LANE_REM,
    LANE_SEC_IDX,
)
from gnss_sdr_tpu_torch.ops.track_kernel import make_full_spec, track_full
from gnss_sdr_tpu_torch.ops.track_kernel_blocked import (
    BlockedSpec,
    make_blocked_spec,
    track_blocked,
)
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
from gnss_sdr_tpu_torch.tracking.dll_pll import (
    TrackingState,
    tap_offsets_chips,
)
from gnss_sdr_tpu_torch.utils import trace


def fused_eligible(conf: DllPllConf) -> bool:
    """Plans the fused kernel covers (FDMA among them); the Kalman mode
    keeps the eager engine."""
    return not conf.kf


def build_fused_engine(conf: DllPllConf) -> BlockedSpec:
    """The kernel's static configuration for this plan; its ``kernel``
    names the engine: K1 by default, K2 when ``GNSS_SDR_TPU_FUSED`` is
    ``perchannel`` (read here, as the JAX package reads it). The kernels
    read the plain [C, L] +-1 chip table, so no packed table is built."""
    make = (make_full_spec
            if os.environ.get("GNSS_SDR_TPU_FUSED", "blocked") == "perchannel"
            else make_blocked_spec)
    return make(
        conf.steps_per_block, conf.max_step_samples,
        conf.code_length_chips, tap_offsets_chips(conf),
        fs=conf.fs, code_rate_cps=conf.code_rate_cps,
        carrier_freq_hz=conf.carrier_freq_hz,
        pll_order=conf.pll_filter_order, dll_order=conf.dll_filter_order,
        fll_bw_hz=conf.fll_bw_hz, interp_code=conf.interp_code,
        track_pilot=conf.track_pilot, sec_len_pilot=conf.sec_len_pilot,
        sec_len_data=conf.sec_len_data, sec_lcm=conf.sec_lcm,
        fdma=conf.fdma)


def _pack_scalars(conf: DllPllConf, state: TrackingState) -> torch.Tensor:
    """TrackingState -> [C, 24 + 2T + 1] float32 scalar block."""
    with trace.span("track.pack"):
        f32 = torch.float32
        dev = state.pos.device

        def const(v):
            trace.count("h2d.track.copies")
            trace.count("h2d.track.bytes", 4)
            return torch.tensor(np.float32(v), dtype=f32, device=dev)

        narrow = state.narrow
        pll_bw = torch.where(narrow, const(conf.pll_bw_narrow_hz),
                             const(conf.pll_bw_hz))
        dll_bw = torch.where(narrow, const(conf.dll_bw_narrow_hz),
                             const(conf.dll_bw_hz))
        cols = [
            state.pos,
            state.rem_code_phase,
            state.code_freq - conf.code_rate_cps,
            torch.remainder(state.carrier_phase, 2.0 * np.pi),
            state.carrier_doppler,
            state.pll_state[:, 0],
            state.dll_state[:, 0],
            state.enabled,
            state.pll_state[:, 1],
            state.dll_state[:, 1],
            state.integ_len,
            state.integ_count,
            state.acc_samples,
            state.sec_idx,
            state.sec_active,
            state.use_atan2,
            state.fll_active,
            pll_bw,
            dll_bw,
            state.prev_prompt.real,
            state.prev_prompt.imag,
            state.acc_data.real,
            state.acc_data.imag,
            state.acc_data_count,
        ]
        for ti in range(conf.num_taps):
            cols.append(state.acc_taps[:, ti].real)
            cols.append(state.acc_taps[:, ti].imag)
        # FDMA slot offset, reduced to [-pi, pi) rad/sample in float64 first
        w = 2.0 * np.pi * state.carrier_offset / float(conf.fs)
        cols.append(torch.remainder(w + np.pi, 2.0 * np.pi) - np.pi)
        return torch.stack([c.to(f32) for c in cols], dim=1).contiguous()


def fused_track_block(
    conf: DllPllConf,
    spec: BlockedSpec,
    state: TrackingState,
    window: torch.Tensor,       # [W] complex64 stream window
    codes: torch.Tensor,        # [C, L] float32 chip table (the pilot's
                                #   in pilot plans)
    data_codes: torch.Tensor | None = None,  # [C, L] data code (pilot)
    sec_pilot: torch.Tensor | None = None,   # [C, sec_len_pilot] +-1
    sec_data: torch.Tensor | None = None,    # [C, sec_len_data] +-1
) -> tuple[TrackingState, dict]:
    """One fused block: the same contract as ``dll_pll.track_block``, with
    the K-period loop inside a single launch of the spec's kernel."""
    rows = launch_fused(spec, window, codes, _pack_scalars(conf, state),
                        state.pos, data_codes, sec_pilot, sec_data)
    return unpack_rows(conf, state, rows)


def launch_fused(spec: BlockedSpec, window: torch.Tensor,
                 codes: torch.Tensor, scalars: torch.Tensor,
                 pos: torch.Tensor, *tables) -> torch.Tensor:
    """The spec's kernel (K1, or K2 for ``spec.kernel == "track_full"``)
    on one packed block: the [C, K, 128] rows."""
    with trace.span("track.launch"):
        run = track_full if spec.kernel == "track_full" else track_blocked
        return run(window, codes, scalars, pos, spec, *tables)


def unpack_rows(conf: DllPllConf, state: TrackingState,
                rows: torch.Tensor) -> tuple[TrackingState, dict]:
    """The kernel's [C, K, 128] rows of a block started from ``state`` as
    ``dll_pll.track_block``'s (new state, [S, C] outputs)."""
    with trace.span("track.unpack"):
        t = conf.num_taps
        p_idx = t // 2

        def col(lane):
            return rows[:, :, lane].T                             # [S, C]

        en = state.enabled
        n = col(LANE_N)
        n_i = n.to(torch.int32)
        dop = col(LANE_DOPPLER)
        # float64 accumulated carrier phase for the observables, at the Doppler
        # in force during each period (enabled gating happens at the fold);
        # FDMA: the NCO frequency includes the slot offset (the eager engine's
        # doppler + carrier_offset)
        dop_pre = torch.cat([state.carrier_doppler[None, :], dop[:-1]], dim=0)
        nco = dop_pre.to(torch.float64)
        if conf.fdma:
            nco = nco + state.carrier_offset[None, :]
        dphi = (2.0 * np.pi / float(conf.fs)) * nco * n.to(torch.float64)
        phase = state.carrier_phase[None, :] + torch.cumsum(dphi, dim=0)
        # disabled channels hold their position
        pos_end = (state.pos[None, :].to(torch.int64)
                   + torch.cumsum(n_i.to(torch.int64) * en, dim=0)).to(
            torch.int32)

        def cplx(lane_re, lane_im):
            return torch.complex(col(lane_re), col(lane_im))

        outs = {
            "prompt": cplx(2 * p_idx, 2 * p_idx + 1),
            "taps": torch.stack([cplx(2 * ti, 2 * ti + 1) for ti in range(t)],
                                dim=-1),
            "boundary": col(LANE_BOUND) > 0.5,
            "acc_prompt": cplx(LANE_ACC0 + 2 * p_idx,
                               LANE_ACC0 + 2 * p_idx + 1),
            "acc_samples": col(LANE_ACC_N).to(torch.int32),
            "carrier_doppler": dop,
            "code_freq": (conf.code_rate_cps
                          + col(LANE_DCODE).to(torch.float64)),
            "carrier_phase": phase,
            "rem_code_phase": col(LANE_REM).to(torch.float64),
            "pos_end": pos_end,
            "n_samples": n_i,
            "data_prompt": cplx(LANE_DATA_RE, LANE_DATA_IM),
            "data_boundary": col(LANE_DATA_BOUND) > 0.5,
            "data_count": col(LANE_DATA_CNT).to(torch.int32),
        }

        # ---- fold the final row back into the TrackingState --------------
        last = rows[:, -1, :]                                     # [C, 128]
        keep_acc = 1.0 - last[:, LANE_BOUND]
        keep_data = 1.0 - last[:, LANE_DATA_BOUND]

        def g(new, old):
            return torch.where(en.reshape((-1,) + (1,) * (old.dim() - 1)),
                               new.to(old.dtype), old)

        acc_taps = torch.stack([
            torch.complex(last[:, LANE_ACC0 + 2 * ti] * keep_acc,
                          last[:, LANE_ACC0 + 2 * ti + 1] * keep_acc)
            for ti in range(t)], dim=1)                           # [C, T]
        new_state = state.replace(
            pos=g(pos_end[-1], state.pos),
            rem_code_phase=g(last[:, LANE_REM], state.rem_code_phase),
            code_freq=g(conf.code_rate_cps + last[:, LANE_DCODE].to(
                torch.float64), state.code_freq),
            carrier_phase=g(phase[-1], state.carrier_phase),
            carrier_doppler=g(last[:, LANE_DOPPLER], state.carrier_doppler),
            pll_state=g(torch.stack([last[:, LANE_PLL_I1],
                                     last[:, LANE_PLL_I2]], dim=-1),
                        state.pll_state),
            dll_state=g(torch.stack([last[:, LANE_DLL_I1],
                                     last[:, LANE_DLL_I2]], dim=-1),
                        state.dll_state),
            prev_prompt=g(torch.complex(last[:, LANE_PREV_RE],
                                        last[:, LANE_PREV_IM]),
                          state.prev_prompt),
            integ_count=g(last[:, LANE_ICOUNT], state.integ_count),
            acc_taps=g(acc_taps, state.acc_taps),
            acc_samples=g(last[:, LANE_ACC_N] * keep_acc, state.acc_samples),
            sec_idx=g(last[:, LANE_SEC_IDX], state.sec_idx),
            acc_data=g(torch.complex(last[:, LANE_DATA_RE] * keep_data,
                                     last[:, LANE_DATA_IM] * keep_data),
                       state.acc_data),
            acc_data_count=g(last[:, LANE_DATA_CNT] * keep_data,
                             state.acc_data_count),
        )
        return new_state, outs
