"""Host-side tracking controller around the batched device engines.

Counterpart of ``gnss_sdr_tpu/tracking/tracker.py``. It plays the role of
the reference's per-channel state machine (dll_pll_veml_tracking.cc
general_work states 0-4) and the tracking side of the channel FSM, as
block-wise control: the device advances all channels ``steps_per_block``
code periods per call; between calls the host

- moves the block's per-period outputs to the host in one transfer,
- runs bit synchronisation (histogram of prompt sign flips),
- estimates C/N0 and carrier lock and counts lock failures,
- switches channels to narrow-bandwidth extended integration after sync,
  or flags loss of lock for the receiver;
- on pilot plans, acquires the pilot's secondary code from the prompt
  signs and engages its wipeoff, the four-quadrant PLL and extended
  integration on the device (reference acquire_secondary).

Engines: the fused engine (``tracking/fused.py``, kernel K1, or K2 under
``GNSS_SDR_TPU_FUSED=perchannel``) and the eager engine
(``tracking/dll_pll.py``, kernel K3 per period). With
``conf.fused_tracker=None`` the fused engine runs on CUDA and the eager one
on the CPU; ``True`` or ``False`` forces one (``True`` on the CPU runs K1's
plain version). ``DllPllConf`` is a verbatim copy of the TPU package's,
whose comments describe that package's automatic choices; here
``pallas_correlator`` is not read (the eager engine always correlates
through K3 or its plain version). FDMA plans (GLONASS) run in both
engines, each channel's slot offset set by ``start_channel``'s
``carrier_offset_hz``. The Kalman mode (``conf.kf``) runs on the eager
engine only, so its every period is one K3 launch.

With a ``mesh`` (``parallel/sharding.py``) the channels split over
shards: the state stays whole on the Tracker's device and each block runs
the engine once per shard, by the same rule as on one device (so K1 on the
card). The TPU package keeps a mesh on its XLA scan instead.

The TPU package falls back from its fused kernel when window positions
would pass 2^24 (float32 sample positions) or when channel positions
spread beyond one DMA block. K1 here carries positions as int32 and reads
each channel's samples directly, so neither limit exists and neither
check is made; ``ops.track_kernel_blocked.track_blocked`` raises if an
enabled channel would read past the end of the window.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
from gnss_sdr_tpu_torch.tracking.dll_pll import (
    KF_P0,
    KF_PC0,
    TrackingState,
    init_state,
)
from gnss_sdr_tpu_torch.tracking.lock_detectors import (
    carrier_lock_detector,
    cn0_svn_estimator,
)
from gnss_sdr_tpu_torch.utils import trace


class ChannelPhase(IntEnum):
    IDLE = 0
    WIDE = 1        # 1-period integration, wide bandwidths (+ optional FLL)
    NARROW = 2      # bit-synced, extended integration, narrow bandwidths
    LOST = 3        # loss of lock flagged; awaiting receiver action


@dataclass
class ChannelControl:
    phase: ChannelPhase = ChannelPhase.IDLE
    prn: int = 0
    total_periods: int = 0           # code periods processed since start
    bit_hist: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    transitions: int = 0
    last_sign: float = 0.0
    bit_phase: int = -1              # period index (mod codes_per_bit) of bit edge
    prompt_hist: list = field(default_factory=list)
    hist_n: int = 0                  # samples per prompt in the history
    cn0_dbhz: float = 0.0
    carrier_lock: float = 0.0
    lock_fail_blocks: int = 0
    # pilot secondary-code sync (reference acquire_secondary)
    sec_hist: list = field(default_factory=list)   # per-period prompt signs
    sec_hist_start: int = 0          # period index of sec_hist[0]
    sec_locked: bool = False
    # no loss-of-lock verdicts before this period index: mode switches
    # restart the transient clock (the reference resets its fail counters
    # on state transitions)
    warmup_until_period: int = 0
    # TOW-aided tracking (reference telemetry_to_trk message path): last
    # TOW received from the telemetry decoder and its projection to the
    # channel's current sample
    tow_ms_received: float = -1.0
    tow_wn_received: int = 0
    tow_sample_stamp: int = 0
    tow_from_telemetry_ms: float = -1.0
    wn_from_telemetry: int = 0
    # telemetry fault (tlm_event == 1): force loss-of-lock next block
    telemetry_fault: bool = False


@dataclass
class BlockResult:
    """Host copies of one block's outputs plus bookkeeping."""

    outputs: dict                    # str -> np.ndarray [S, C]
    abs_sample_end: np.ndarray       # [S, C] i64 absolute sample stamps
    events: list                     # (channel, "loss_of_lock" | "bit_sync")


def output_dtypes(num_taps: int) -> dict:
    """Per-period output names -> (trailing shape, host dtype)."""
    return {
        "prompt": ((), np.complex64),
        "taps": ((num_taps,), np.complex64),
        "boundary": ((), np.bool_),
        "acc_prompt": ((), np.complex64),
        "acc_samples": ((), np.int32),
        "carrier_doppler": ((), np.float32),
        "code_freq": ((), np.float64),
        "carrier_phase": ((), np.float64),
        "rem_code_phase": ((), np.float64),
        "pos_end": ((), np.int32),
        "n_samples": ((), np.int32),
        "data_prompt": ((), np.complex64),
        "data_boundary": ((), np.bool_),
        "data_count": ((), np.int32),
    }


def outputs_to_host(outs: dict, num_taps: int) -> dict:
    """The block's [S, C, ...] device outputs as host numpy arrays, moved
    in one transfer: every leaf goes into one float64 tensor (exact for
    float32, complex64 parts, int32 and bool values) and is split back on
    the host."""
    with trace.span("track.to_host"):
        spec = output_dtypes(num_taps)
        parts, widths = [], []
        for name in spec:
            v = outs[name]
            s, c = v.shape[:2]
            v = torch.view_as_real(v) if v.is_complex() else v[..., None]
            v = v.reshape(s, c, -1).to(torch.float64)
            parts.append(v)
            widths.append(v.shape[-1])
        flat = torch.cat(parts, dim=-1).cpu().numpy()
        host, off = {}, 0
        for (name, (trail, dtype)), w in zip(spec.items(), widths):
            v = flat[..., off:off + w]
            off += w
            if np.issubdtype(dtype, np.complexfloating):
                v = (v[..., 0::2] + 1j * v[..., 1::2]).astype(dtype)
            else:
                v = v.astype(dtype)
            host[name] = v.reshape(v.shape[:2] + trail)
        return host


def _write_channel(values: list, zero: list = ()) -> None:
    """Set each (view, value) pair of one channel's state fields and zero
    the views in ``zero``, on the state's device: one host-to-device copy
    and one multi-tensor copy per dtype, one multi-tensor zero; nothing is
    read back."""
    groups: dict = {}
    for dst, v in values:
        groups.setdefault(dst.dtype, []).append((dst, v))
    for dtype, pairs in groups.items():
        src = torch.tensor([v for _, v in pairs], dtype=dtype,
                           device=pairs[0][0].device)
        torch._foreach_copy_([d for d, _ in pairs], list(src.unbind()))
    torch._foreach_zero_(list(zero))


class Tracker:
    """Batched multi-channel tracker with host FSM."""

    def __init__(self, conf: DllPllConf, code_table: np.ndarray,
                 data_code_table: np.ndarray | None = None,
                 sec_pilot_table: np.ndarray | None = None,
                 sec_data_levels: np.ndarray | None = None, *,
                 device: str | torch.device = "cuda", mesh=None) -> None:
        """code_table: [P, L] PRN chip levels (the PILOT component when
        conf.track_pilot). Pilot plans also give the data-code table, the
        per-PRN pilot secondary table [P, sec_len_pilot] and the shared
        data secondary [sec_len_data]. ``device`` holds the state and runs
        the engines; "cuda" raises without a card.

        ``mesh``: an optional ``parallel.sharding.ChannelMesh``. The state
        stays whole on ``device``, so the host FSM writes one state; each
        block runs the engine once per shard on the shard's device and
        gathers the new state and the outputs back. Without a mesh the
        engine runs once on ``device``. Both go through
        ``parallel.sharding.ShardedTrackBlock``, which also picks the
        engine. conf.max_channels must divide evenly over the shards."""
        self.device = resolve_device(device)
        self.conf = conf
        self.code_table = np.asarray(code_table, dtype=np.float32)
        self.state: TrackingState = init_state(conf, self.device)
        c = conf.max_channels
        self.codes = np.zeros((c, code_table.shape[1]), dtype=np.float32)
        self._codes_dev = None         # device copies of code/sec tables
        self.pos_abs = np.zeros(c, dtype=np.int64)    # absolute next sample
        self.ctl = [ChannelControl() for _ in range(c)]
        for ch in self.ctl:
            ch.bit_hist = np.zeros(conf.codes_per_bit, dtype=np.int64)
        if conf.track_pilot:
            if data_code_table is None or sec_pilot_table is None:
                raise ValueError("a pilot plan needs the data-code and "
                                 "pilot secondary tables")
            self.data_code_table = np.asarray(data_code_table, np.float32)
            self.sec_pilot_table = np.asarray(sec_pilot_table, np.float32)
            self.data_codes = np.zeros_like(self.codes)
            self.sec_pilot = np.ones((c, conf.sec_len_pilot), np.float32)
            self.sec_data = np.ones((c, conf.sec_len_data), np.float32)
            if sec_data_levels is not None:
                self.sec_data[:] = np.asarray(sec_data_levels, np.float32)
            self._sec_data_base = self.sec_data[0].copy()
        else:
            self.data_code_table = None
            self.data_codes = None
            self.sec_pilot = None
            self.sec_data = None
        # imported here: parallel.sharding imports this package's engines
        from gnss_sdr_tpu_torch.parallel.sharding import (
            make_channel_mesh,
            make_sharded_track_block,
        )

        self.mesh = mesh
        self._block = make_sharded_track_block(
            conf, mesh if mesh is not None else make_channel_mesh(
                [self.device]))

    # ----------------------------------------------------------------- setup
    def start_channel(
        self,
        ch: int,
        prn: int,
        code_row: int,
        acq_delay_samples: float,
        acq_doppler_hz: float,
        acq_samplestamp: int,
        current_abs_sample: int,
        carrier_offset_hz: float = 0.0,
    ) -> None:
        """Pull-in: align to the first code boundary at/after the stream head
        (reference state 1, dll_pll_veml_tracking.cc:1949-1982).

        The projection uses the Doppler-corrected code period: projecting
        far ahead with the nominal period accumulates code-Doppler slip
        (~4 samples per second at 5 kHz Doppler)."""
        conf = self.conf
        fd0 = float(acq_doppler_hz)
        period = conf.samples_per_code / (1.0 + fd0 / conf.carrier_freq_hz)
        boundary = acq_samplestamp + acq_delay_samples
        if boundary < current_abs_sample:
            k = int(np.ceil((current_abs_sample - boundary) / period))
            boundary += k * period
        # first integer sample at/after the code boundary; the sub-sample
        # remainder becomes the initial code phase in chips
        start = int(np.ceil(boundary))
        rem0 = (start - boundary) * conf.code_rate_cps / conf.fs

        self.codes[ch] = self.code_table[code_row]
        self._codes_dev = None         # code tables changed
        if conf.track_pilot:
            self.data_codes[ch] = self.data_code_table[code_row]
            self.sec_pilot[ch] = self.sec_pilot_table[code_row]
            self.sec_data[ch] = self._sec_data_base
        self.pos_abs[ch] = start
        self.ctl[ch] = ChannelControl(phase=ChannelPhase.WIDE, prn=prn)
        self.ctl[ch].bit_hist = np.zeros(conf.codes_per_bit, dtype=np.int64)
        self.ctl[ch].warmup_until_period = int(
            conf.lock_warmup_s / conf.code_period_s
        )

        fd = float(acq_doppler_hz)
        code_freq = conf.code_rate_cps * (1.0 + fd / conf.carrier_freq_hz)
        s = self.state
        s.enabled[ch] = True
        s.pos[ch] = 0
        s.rem_code_phase[ch] = rem0
        s.code_freq[ch] = code_freq
        s.carrier_phase[ch] = 0.0
        s.carrier_doppler[ch] = fd
        s.carrier_offset[ch] = float(carrier_offset_hz)
        s.pll_state[ch] = torch.tensor(
            [fd if conf.pll_filter_order >= 2 else 0.0, 0.0])
        s.dll_state[ch] = 0.0
        s.prev_prompt[ch] = 0.0
        s.fll_active[ch] = bool(conf.enable_fll_pull_in)
        s.narrow[ch] = False
        s.use_atan2[ch] = False
        s.integ_len[ch] = 1
        s.integ_count[ch] = 0
        s.acc_taps[ch] = 0.0
        s.acc_samples[ch] = 0
        s.sec_idx[ch] = 0
        s.sec_active[ch] = False
        s.acc_data[ch] = 0.0
        s.acc_data_count[ch] = 0
        s.kf_x[ch] = 0.0
        s.kf_P[ch] = torch.from_numpy(KF_P0)
        s.kf_pc[ch] = KF_PC0

    def stop_channel(self, ch: int) -> None:
        self.state.enabled[ch] = False
        self.ctl[ch].phase = ChannelPhase.IDLE

    def active_channels(self) -> list[int]:
        return [i for i, c in enumerate(self.ctl)
                if c.phase in (ChannelPhase.WIDE, ChannelPhase.NARROW)]

    # --------------------------------------------------------------- windows
    def window_request(self) -> tuple[int, int]:
        """(absolute start sample, length) of the next window to feed."""
        act = self.active_channels()
        base = int(min(self.pos_abs[i] for i in act)) if act else 0
        return base, self.conf.window_samples

    # --------------------------------------------------------------- process
    def process(self, window: np.ndarray, abs_base: int) -> BlockResult:
        """Advance all active channels one block through the given host
        window (uploads it; prefer process_device for streaming use)."""
        w = torch.as_tensor(np.asarray(window, np.complex64),
                            device=self.device)
        return self._process(w, abs_base, len(window))

    def process_device(self, window: torch.Tensor, abs_base: int,
                       window_len: int) -> BlockResult:
        """Advance one block against a device-resident complex64 sample
        buffer (``io.device_stream.DeviceStream.window``)."""
        return self._process(window, abs_base, window_len)

    def _process(self, window: torch.Tensor, abs_base: int,
                 window_len: int) -> BlockResult:
        with trace.span("track"):
            trace.count("track.blocks")
            conf = self.conf
            act = self.active_channels()
            rel = self.pos_abs - abs_base
            if act:
                if int(rel[act].min()) < 0:
                    raise ValueError(
                        "window too short: channel behind the buffer base "
                        f"(rel {int(rel[act].min())})"
                    )
                spread = int(rel[act].max())
                need = spread + conf.steps_per_block * conf.max_step_samples
                if need > window_len:
                    raise ValueError(
                        f"window too short: need {need}, got {window_len} "
                        f"(channel spread {spread})"
                    )
            with trace.span("track.pack"):
                pos = np.maximum(rel, 0).astype(np.int32)
                st = self.state.replace(pos=torch.as_tensor(
                    pos, device=self.device))
                trace.count("h2d.track.copies")
                trace.count("h2d.track.bytes", pos.nbytes)
                # per-channel code/secondary tables live on the device,
                # uploaded again only when start_channel or a secondary
                # engage rewrites rows
                if self._codes_dev is None:
                    tables = [self.codes]
                    if conf.track_pilot:
                        tables += [self.data_codes, self.sec_pilot,
                                   self.sec_data]
                    self._codes_dev = tuple(torch.tensor(t, device=self.device)
                                            for t in tables)
                    trace.count("h2d.track.copies", len(tables))
                    trace.count("h2d.track.bytes",
                                sum(t.nbytes for t in tables))
            new_state, outs = self._block(st, window, *self._codes_dev)
            self.state = new_state
            host = outputs_to_host(outs, conf.num_taps)
            abs_end = host["pos_end"].astype(np.int64) + abs_base
            for i in act:
                self.pos_abs[i] = abs_end[-1, i]

            events = []
            with trace.span("track.fsm"):
                for i in act:
                    evs = self._update_channel_control(i, host)
                    events.extend((i, e) for e in evs)
            return BlockResult(outputs=host, abs_sample_end=abs_end,
                               events=events)

    # ------------------------------------------------- telemetry_to_trk
    def set_tow_from_telemetry(self, ch: int, tow_ms: float, wn: int,
                               sample_stamp: int) -> None:
        """Async TOW from the telemetry decoder (reference TOW_to_trk
        message, dll_pll_veml_tracking.cc:771-777)."""
        ctl = self.ctl[ch]
        ctl.tow_ms_received = float(tow_ms)
        ctl.tow_wn_received = int(wn)
        ctl.tow_sample_stamp = int(sample_stamp)

    def notify_telemetry_fault(self, ch: int) -> None:
        """Telemetry fault (tlm_event == 1): force loss-of-lock
        (reference sets d_carrier_lock_fail_counter = 200000)."""
        self.ctl[ch].telemetry_fault = True

    def _project_tow(self, ch: int) -> None:
        """Project the received TOW to the channel's current sample
        (reference dll_pll_veml_tracking.cc:1921-1937)."""
        conf = self.conf
        ctl = self.ctl[ch]
        if ctl.tow_ms_received < 0:
            return
        diff_ms = float(
            (int(self.pos_abs[ch]) - ctl.tow_sample_stamp)
            * 1000.0 / conf.fs)
        tow = (ctl.tow_ms_received + diff_ms) % 604800000.0
        ctl.wn_from_telemetry = ctl.tow_wn_received + (
            1 if tow < ctl.tow_ms_received else 0)
        ctl.tow_from_telemetry_ms = tow

    # ------------------------------------------------------------------- fsm
    def _update_channel_control(self, ch: int, host: dict) -> list[str]:
        conf = self.conf
        ctl = self.ctl[ch]
        events: list[str] = []
        if ctl.telemetry_fault:
            ctl.telemetry_fault = False
            self.stop_channel(ch)
            self.ctl[ch].phase = ChannelPhase.LOST
            return ["loss_of_lock"]
        self._project_tow(ch)
        prompts = host["prompt"][:, ch]                    # [S] per-period
        signs = np.sign(prompts.real)
        first_period = ctl.total_periods
        ctl.total_periods += len(signs)

        # FLL assist only during pull-in (reference pull_in_time_s), then
        # pure PLL to avoid FLL/PLL steady-state contention
        if conf.enable_fll_pull_in and ctl.phase == ChannelPhase.WIDE:
            pull_in_periods = conf.pull_in_time_s / conf.code_period_s
            if first_period < pull_in_periods <= ctl.total_periods:
                self.state.fll_active[ch] = False

        # Pilot plans: acquire the secondary code from per-period prompt
        # signs (reference acquire_secondary, dll_pll_veml_tracking.cc:1120)
        # once the Costas loop has settled after the FLL hands over
        sec_start_s = conf.pull_in_time_s + 0.15
        if (
            conf.track_pilot
            and conf.sec_len_pilot > 1
            and ctl.phase == ChannelPhase.WIDE
            and not ctl.sec_locked
            and ctl.total_periods * conf.code_period_s > sec_start_s
        ):
            if not ctl.sec_hist:
                ctl.sec_hist_start = first_period
            ctl.sec_hist.extend(signs.tolist())
            sp = conf.sec_len_pilot
            if len(ctl.sec_hist) >= sp:
                w = np.asarray(ctl.sec_hist[-sp:], dtype=np.float64)
                p0 = ctl.sec_hist_start + len(ctl.sec_hist) - sp
                sec = self.sec_pilot[ch].astype(np.float64)
                # cyclic correlation of the sign window against the sequence
                shifts = np.array([
                    np.dot(w, np.roll(sec, -k)) for k in range(sp)
                ])
                k0 = int(np.argmax(np.abs(shifts)))
                if abs(shifts[k0]) == sp:          # perfect match required
                    polarity = 1.0 if shifts[k0] > 0 else -1.0
                    self._engage_secondary(ch, p0, k0, polarity)
                    events.append("secondary_sync")
                elif len(ctl.sec_hist) > 4 * sp:
                    ctl.sec_hist = ctl.sec_hist[-sp:]
                    ctl.sec_hist_start = p0

        # Symbol-rate signals (one telemetry symbol per code period, e.g.
        # Galileo E1-B) cannot extend integration across symbols without
        # the pilot; narrow the loops on a timer instead of on bit sync
        if (
            not conf.track_pilot
            and ctl.phase == ChannelPhase.WIDE
            and conf.extend_correlation_symbols == 1
            and ctl.total_periods * conf.code_period_s
            > conf.pull_in_time_s + 0.5
        ):
            ctl.phase = ChannelPhase.NARROW
            ctl.prompt_hist = []
            ctl.warmup_until_period = ctl.total_periods + int(
                max(conf.lock_warmup_s, 8.0 / conf.pll_bw_narrow_hz)
                / conf.code_period_s
            )
            self.state.narrow[ch] = True
            self.state.fll_active[ch] = False
            events.append("bit_sync")

        if (not conf.track_pilot and ctl.phase == ChannelPhase.WIDE
                and conf.extend_correlation_symbols > 1
                and ctl.total_periods * conf.code_period_s
                > conf.pull_in_time_s + conf.bit_sync_delay_s):
            for s_i in range(len(signs)):
                period = first_period + s_i
                if ctl.last_sign != 0.0 and signs[s_i] != ctl.last_sign:
                    ctl.bit_hist[period % conf.codes_per_bit] += 1
                    ctl.transitions += 1
                ctl.last_sign = signs[s_i]
            if ctl.transitions >= conf.bit_sync_transitions:
                top = int(ctl.bit_hist.argmax())
                if ctl.bit_hist[top] >= 0.8 * ctl.transitions:
                    ctl.bit_phase = top
                    self._engage_extended(ch)
                    events.append("bit_sync")
                else:
                    # ambiguous histogram: restart the vote
                    ctl.bit_hist[:] = 0
                    ctl.transitions = 0

        # C/N0 + carrier lock from boundary prompts of this block. The
        # history only ever holds prompts of one coherent length: when the
        # integration length changes the estimate restarts, as the
        # reference does on state transitions.
        b = host["boundary"][:, ch]
        if b.any():
            acc = host["acc_prompt"][b, ch]
            n_acc = host["acc_samples"][b, ch]
            t_coh = float(n_acc[-1]) / conf.fs
            keep = n_acc > 0.9 * n_acc[-1]
            if ctl.hist_n and abs(ctl.hist_n - int(n_acc[-1])) > 0.1 * ctl.hist_n:
                ctl.prompt_hist = []
            ctl.hist_n = int(n_acc[-1])
            ctl.prompt_hist.extend(acc[keep].tolist())
            max_hist = conf.cn0_estimation_blocks
            if len(ctl.prompt_hist) > max_hist:
                ctl.prompt_hist = ctl.prompt_hist[-max_hist:]
            if len(ctl.prompt_hist) >= max_hist:
                ph = np.asarray(ctl.prompt_hist)
                ctl.cn0_dbhz = cn0_svn_estimator(ph, t_coh)
                ctl.carrier_lock = carrier_lock_detector(ph)
                bad = (
                    ctl.cn0_dbhz < conf.cn0_min_dbhz
                    or ctl.carrier_lock < conf.carrier_lock_threshold
                )
                in_warmup = ctl.total_periods < ctl.warmup_until_period
                ctl.lock_fail_blocks = (
                    0 if (in_warmup or not bad) else ctl.lock_fail_blocks + 1
                )
                if ctl.lock_fail_blocks >= conf.max_lock_fail_blocks:
                    self.stop_channel(ch)
                    self.ctl[ch].phase = ChannelPhase.LOST
                    events.append("loss_of_lock")
        return events

    def _engage_secondary(self, ch: int, p0: int, k0: int,
                          polarity: float) -> None:
        """Secondary sequence locked: the prompt of period p0 + i matched
        secondary chip (i + k0) mod sp with the given polarity. Engage the
        on-device wipeoff of both components, switch the PLL to
        four-quadrant atan2 and extend coherent integration (reference
        post-acquire_secondary state switch). The channel's fields are
        written by ``_write_channel``; nothing is read back."""
        conf = self.conf
        ctl = self.ctl[ch]
        sp = conf.sec_len_pilot
        # fold the Costas half-cycle ambiguity into the wipe sequences so
        # the wiped pilot prompt comes out real-positive (both components
        # flip together under a pi carrier rotation)
        self.sec_pilot[ch] = self.sec_pilot[ch] * polarity
        self.sec_data[ch] = self._sec_data_base * polarity
        self._codes_dev = None         # secondary tables changed
        # secondary chip index of the NEXT period (the device applies it at
        # the start of the next block, which begins at ctl.total_periods)
        idx_next = (ctl.total_periods - p0 + k0) % sp
        ctl.phase = ChannelPhase.NARROW
        ctl.sec_locked = True
        ctl.sec_hist = []
        ctl.prompt_hist = []
        ctl.warmup_until_period = ctl.total_periods + int(
            max(conf.lock_warmup_s, 8.0 / conf.pll_bw_narrow_hz)
            / conf.code_period_s
        )
        # align integration boundaries with the secondary epoch
        integ_len = int(conf.extend_correlation_symbols)
        s = self.state
        # zero the frequency-rate integrator as in _engage_extended
        _write_channel(
            [(s.sec_idx[ch], idx_next), (s.integ_len[ch], integ_len),
             (s.integ_count[ch], idx_next % integ_len),
             (s.acc_samples[ch], 0), (s.acc_data_count[ch], 0),
             (s.sec_active[ch], True),
             (s.use_atan2[ch], bool(conf.pilot_pll_atan2)),
             (s.narrow[ch], True), (s.fll_active[ch], False)],
            zero=[s.pll_state[ch, 1], s.acc_taps[ch], s.acc_data[ch]])

    def _engage_extended(self, ch: int) -> None:
        """Switch to narrow-band extended integration aligned to bit edges."""
        conf = self.conf
        ctl = self.ctl[ch]
        ctl.phase = ChannelPhase.NARROW
        # the C/N0 history holds 1-period prompts; the coherent length is
        # about to change, so restart the estimate on extended prompts only
        ctl.prompt_hist = []
        ctl.warmup_until_period = ctl.total_periods + int(
            max(conf.lock_warmup_s, 8.0 / conf.pll_bw_narrow_hz)
            / conf.code_period_s
        )
        # periods since the last bit edge, counted at the *next* period
        since_edge = (ctl.total_periods - ctl.bit_phase) % conf.codes_per_bit
        integ_len = int(conf.extend_correlation_symbols)
        s = self.state
        # keep the PLL's frequency state (i1 = Doppler estimate) but zero the
        # frequency-rate integrator: its wide-band random walk would ride
        # into the narrow loop as a Doppler ramp it cannot unwind
        _write_channel(
            [(s.integ_len[ch], integ_len),
             (s.integ_count[ch], since_edge % integ_len),
             (s.acc_samples[ch], 0), (s.narrow[ch], True),
             (s.fll_active[ch], False)],
            zero=[s.pll_state[ch, 1], s.acc_taps[ch]])
