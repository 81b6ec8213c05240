"""End-to-end receiver: acquisition -> tracking -> telemetry -> observables
-> PVT.

Counterpart of ``gnss_sdr_tpu/receiver/receiver.py``, for every plan of
``receiver/plans.py``: GPS L1 C/A, L2C and L5, QZSS L1 C/A and L5, SBAS
L1, Galileo E1 (E1-B data-only, and E1-B+C with pilot tracking), E5a, E5b
and E6B, GLONASS L1 and L2 C/A (FDMA: one detection per frequency channel,
the slot offset in the tracker's NCO, the GNAV slot number re-keying a
channel that acquired an antipodal twin) and BeiDou B1I and B3I (D1 with
the NH20 secondary on the data component, GEO with D2; two groups may
share a band, each searching its own PRNs), with one sample stream per
band. Host-side
orchestration plays the roles of the reference's
ControlThread event loop and GNSSFlowgraph channel management around the
batched device engines:

- signals are grouped by SignalPlan; each plan owns one batched
  acquisition engine (PCPS, fine-Doppler, Tong, QuickSync, CCCWSR or
  noncoherent I/Q, ``plan.acq_engine``) and one batched Tracker (all its
  channels in one device batch); on PCPS plans a satellite already
  tracked on another carrier is searched by a narrow assisted engine
  around its projected Doppler;
- a plan's loop-closure variant (``plan.trk_engine``: the CKF/UKF
  ``GaussianLoopCloser`` or the TCP connector) reads each block's outputs
  and writes the tracker's NCO state before the next block;
- telemetry: per-channel decoders (LNAV, I/NAV, CNAV, F/NAV, GNAV, D1,
  D2, SBAS, the E6B page stream) fed with
  prompt signs, on pilot plans with the data component's symbols once the
  secondary code is locked;
- observables: one shared ObservablesEngine anchored by telemetry TOWs;
- PVT: solve_pvt at a fixed epoch cadence, refined by the dual-frequency
  PPP filter in the PPP positioning modes (with the solid, pole and ocean
  tides and the phase windup) and smoothed by the PVT Kalman filter when
  ``enable_pvt_kf`` is set; OSNMA (``osnma``) routes the I/NAV fields to
  the TESLA engine, and its strict mode keeps only authenticated Galileo
  satellites in the fix;
- dumps: a plan's ``dump_filename`` and ``acq_dump_filename`` collect the
  tracking outputs of every block and the acquisition rows of every
  attempt, written as npz files by ``close``.

The stream is buffered twice with absolute indexing: on the host for
acquisition, and in a rolling device buffer (``io/device_stream.py``) that
the trackers read in place.

Everything runs on ``ReceiverConfig.device`` ("cuda" by default; without a
card that raises unless "cpu" is asked for). ``num_devices = n > 0``
shards every group's channels, and the hypothesis batches of its PCPS,
fine-Doppler, Tong and assisted engines, over a mesh of n devices
(``parallel/sharding.py``): ``cuda:0`` to ``cuda:n-1`` on the card, which
raises ``RuntimeError`` when fewer cards are present (the JAX receiver
takes ``jax.devices()[:n]`` and so shrinks its mesh without a word), or n
shards on the CPU. The state, the sample ring and the host work stay on
``device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device
from gnss_sdr_tpu_torch.acquisition import (
    AssistedAcquisition,
    CccwsrAcquisition,
    FineDopplerAcquisition,
    NoncoherentIQAcquisition,
    PcpsAcquisition,
    QuickSyncAcquisition,
    TongAcquisition,
)
from gnss_sdr_tpu_torch.io.device_stream import DeviceStream
from gnss_sdr_tpu_torch.monitor.dumps import AcquisitionDumper, TrackingDumper
from gnss_sdr_tpu_torch.observables.engine import ObservablesEngine
from gnss_sdr_tpu_torch.parallel.sharding import device_mesh
from gnss_sdr_tpu_torch.pvt.atmosphere import KlobucharParams
from gnss_sdr_tpu_torch.pvt.coords import ecef_to_llh
from gnss_sdr_tpu_torch.pvt.ephemeris import C_LIGHT
from gnss_sdr_tpu_torch.pvt.kf import PvtKalmanFilter
from gnss_sdr_tpu_torch.pvt.ppp import DualFreqObs, PppEngine
from gnss_sdr_tpu_torch.pvt.solver import ObsEpoch, PvtSolution, solve_pvt
from gnss_sdr_tpu_torch.receiver.osnma_rx import OsnmaManager
from gnss_sdr_tpu_torch.receiver.plans import SignalPlan, gps_l1ca_plan
from gnss_sdr_tpu_torch.tracking import ChannelPhase, Tracker
from gnss_sdr_tpu_torch.tracking.tracker import BlockResult
from gnss_sdr_tpu_torch.utils import trace
from gnss_sdr_tpu_torch.utils.log import get_logger

log = get_logger(__name__)


@dataclass
class ReceiverConfig:
    fs: float = 2.6e6
    num_channels: int = 8
    search_prns: tuple = tuple(range(1, 33))
    doppler_max_hz: float = 5000.0
    doppler_step_hz: float = 250.0
    acq_dwells: int = 2
    acq_pfa: float = 1e-3
    obs_interval_ms: int = 20
    pvt_interval_ms: int = 100
    extend_correlation_symbols: int = 20
    pll_bw_hz: float = 35.0
    dll_bw_hz: float = 2.0
    pll_bw_narrow_hz: float = 7.5
    dll_bw_narrow_hz: float = 0.75
    enable_fll_pull_in: bool = True
    fll_bw_hz: float = 4.0
    pull_in_time_s: float = 0.25
    # Hatch window (in obs epochs): DLL noise decorrelates only at ~1/(2*Bn)
    carrier_smoothing_epochs: int = 400
    # model tropo always and iono once Klobuchar parameters arrive
    apply_atmosphere: bool = True
    # shard each group's channels over this many devices (a channel mesh,
    # parallel/sharding.py); 0 = one device, unsharded
    num_devices: int = 0
    # position/velocity Kalman smoothing of the LS fixes (reference
    # Pvt.enable_pvt_kf -> pvt_kf.cc)
    enable_pvt_kf: bool = False
    # upload stream chunks as int8 I/Q and widen on the device
    int8_stream: bool = False
    # slew the rx clock back through observables once PVT's bias estimate
    # exceeds this (reference apply_rx_clock_offset); <= 0 disables
    rx_clock_correction_s: float = 1e-3
    # code periods per tracking call (one K1 launch on the card)
    steps_per_block: int = 20
    # OSNMA (Galileo navigation message authentication): route the I/NAV
    # 40-bit fields to the TESLA engine and keep per-satellite auth state
    # (reference osnma_msg_receiver.cc). `osnma_strict` restricts PVT to
    # authenticated Galileo satellites (rtklib_pvt_gs.cc:1990-2075).
    osnma: bool = False
    osnma_public_key: object = None
    osnma_strict: bool = False
    # positioning engine (reference PVT.positioning_mode): "Single" =
    # iterated LS + RAIM; "PPP_Static"/"PPP_Kinematic" refine the LS fix
    # with the dual-frequency iono-free float PPP filter (pvt/ppp.py)
    # whenever the epoch carries >= 4 satellites observed on two bands
    positioning_mode: str = "Single"
    # earth-tide site displacement for PPP modes (PVT.earth_tide: 0 off,
    # 1 solid, 2 solid + pole + ocean loading when `blq` is given)
    earth_tide: int = 0
    # (11, 6) BLQ ocean-loading table of the station (pvt.tides.read_blq)
    blq: object = None
    # carrier phase windup correction for PPP modes (PVT.phwindup)
    phwindup: bool = False
    # the device that holds the sample ring and runs the engines
    device: str = "cuda"


@dataclass
class ReceiverStatus:
    fixes: list = field(default_factory=list)       # PvtSolution list
    ttff_s: float | None = None
    subframes: int = 0
    acquired: dict = field(default_factory=dict)    # (sys, prn) -> (dop, delay)
    iono_utc: object = None                         # decoded GpsIonoUtc


def _dump_result(result: BlockResult) -> BlockResult:
    """``result`` with its int32 output leaves widened to int64, as the
    JAX tracker's host unpacker gives them, so that a dump file has the
    same dtypes from either package."""
    outputs = {k: v.astype(np.int64) if v.dtype == np.int32 else v
               for k, v in result.outputs.items()}
    return replace(result, outputs=outputs)


def _rows(prns: list[int], res) -> list[tuple]:
    """(prn, detected, statistic, Doppler, delay) for each searched PRN."""
    return [(p, bool(res.detected[i]), float(res.test_statistic[i]),
             float(res.doppler_hz[i]), float(res.delay_samples[i]))
            for i, p in enumerate(prns)]


def _acquisition_engine(plan: SignalPlan, device: torch.device, mesh=None):
    """The plan's batched acquisition engine (``plan.acq_engine``), built
    as the JAX receiver builds it (the mesh only for the PCPS engines)."""
    acq_table = (plan.acq_code_table if plan.acq_code_table is not None
                 else plan.code_table)
    prns = list(plan.search_prns)
    params = dict(plan.acq_engine_params)
    engine = plan.acq_engine
    if engine == "pcps":
        return PcpsAcquisition(plan.acq_conf, acq_table, prns,
                               freq_offset_table=plan.freq_offset_table,
                               mesh=mesh, device=device)
    if engine in ("fine_doppler", "tong"):
        cls = (FineDopplerAcquisition if engine == "fine_doppler"
               else TongAcquisition)
        return cls(plan.acq_conf, acq_table, prns,
                   freq_offset_table=plan.freq_offset_table, mesh=mesh,
                   device=device, **params)
    if engine == "quicksync":
        return QuickSyncAcquisition(plan.acq_conf, acq_table, prns,
                                    device=device, **params)
    if engine == "cccwsr":
        chips = params.pop("chips_table")
        return CccwsrAcquisition(plan.acq_conf, chips, prns, device=device,
                                 **params)
    if engine == "noncoh_iq":
        # the data (I) table is the acquisition table, the pilot (Q) the
        # tracking table on pilot plans
        return NoncoherentIQAcquisition(plan.acq_conf, acq_table,
                                        plan.code_table, prns,
                                        device=device, **params)
    raise ValueError(f"unknown acq_engine {engine!r}")


def _loop_closer(plan: SignalPlan, device: torch.device):
    """The plan's block-cadence loop-closure variant (``plan.trk_engine``),
    or None for the plain DLL/PLL: it reads each block's host outputs and
    writes the tracker's NCO state before the next block."""
    p = dict(plan.trk_engine_params)
    if plan.trk_engine == "gaussian":
        from gnss_sdr_tpu_torch.tracking.gaussian import GaussianLoopCloser

        return GaussianLoopCloser(plan.num_channels,
                                  plan.trk_conf.code_period_s,
                                  device=device, **p)
    if plan.trk_engine == "tcp":
        from gnss_sdr_tpu_torch.tracking.tcp_connector import (
            TcpConnectorTracking,
            TcpLoopClient,
        )

        client = TcpLoopClient(address=p.get("address", "127.0.0.1"),
                               port=int(p.get("port", 2060)))
        return TcpConnectorTracking(None, client,
                                    list(range(plan.num_channels)))
    return None


class SignalGroup:
    """One signal type's engines + per-channel decode state."""

    def __init__(self, plan: SignalPlan, chan_offset: int,
                 device: torch.device, mesh=None) -> None:
        self.plan = plan
        self.offset = chan_offset           # global channel index base
        self.acq = _acquisition_engine(plan, device, mesh)
        self.tracker = Tracker(
            plan.trk_conf, plan.code_table,
            data_code_table=plan.data_code_table,
            sec_pilot_table=plan.sec_pilot_table,
            sec_data_levels=plan.sec_data_levels, device=device, mesh=mesh)
        self.loop_closer = _loop_closer(plan, device)
        # narrow engine for satellites tracked on another band, built on
        # first use (Receiver._assisted_engine)
        self.assisted_acq: AssistedAcquisition | None = None
        self.decoders: dict[int, object] = {}
        self.channel_prn = [0] * plan.num_channels
        # sub-chip code phase by stamp for TOW anchoring
        self.recent_rem: dict[int, dict] = {}
        self.dumper = (TrackingDumper(plan.dump_filename)
                       if plan.dump_filename else None)
        self.acq_dumper = (AcquisitionDumper(plan.acq_dump_filename)
                           if plan.acq_dump_filename else None)

    def idle_channel(self) -> int | None:
        for i in range(self.plan.num_channels):
            if self.tracker.ctl[i].phase in (ChannelPhase.IDLE, ChannelPhase.LOST):
                return i
        return None

    def active_channels(self) -> list[int]:
        return self.tracker.active_channels()


class Receiver:
    def __init__(self, cfg: ReceiverConfig,
                 plans: list[SignalPlan] | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if plans is None:
            plans = [gps_l1ca_plan(
                fs=cfg.fs,
                num_channels=cfg.num_channels,
                doppler_max_hz=cfg.doppler_max_hz,
                doppler_step_hz=cfg.doppler_step_hz,
                acq_dwells=cfg.acq_dwells,
                acq_pfa=cfg.acq_pfa,
                pll_bw_hz=cfg.pll_bw_hz,
                dll_bw_hz=cfg.dll_bw_hz,
                pll_bw_narrow_hz=cfg.pll_bw_narrow_hz,
                dll_bw_narrow_hz=cfg.dll_bw_narrow_hz,
                enable_fll_pull_in=cfg.enable_fll_pull_in,
                fll_bw_hz=cfg.fll_bw_hz,
                pull_in_time_s=cfg.pull_in_time_s,
                extend_correlation_symbols=cfg.extend_correlation_symbols,
                search_prns=cfg.search_prns,
                steps_per_block=cfg.steps_per_block,
            )]
        self.mesh = (device_mesh(cfg.num_devices, self.device)
                     if cfg.num_devices > 0 else None)
        self.groups: list[SignalGroup] = []
        off = 0
        for plan in plans:
            self.groups.append(SignalGroup(plan, off, self.device, self.mesh))
            off += plan.num_channels
        self.total_channels = off

        self.obs = ObservablesEngine(
            cfg.fs, plans[0].code_period_s, self.total_channels,
            code_rate_cps=plans[0].table_rate_cps,
            carrier_freq_hz=plans[0].carrier_freq_hz,
            smoothing_epochs=cfg.carrier_smoothing_epochs,
        )
        self.ephemerides: dict = {}          # (system, prn) -> ephemeris
        self.iono = KlobucharParams()
        self.status = ReceiverStatus()
        self.pvt_kf = PvtKalmanFilter() if cfg.enable_pvt_kf else None
        self._next_epoch_t: float | None = None   # next obs epoch (stream s)
        self._last_pvt_tow: float = -1e9
        self._last_fix: PvtSolution | None = None
        self.osnma = (OsnmaManager(public_key=cfg.osnma_public_key)
                      if cfg.osnma else None)
        self.ppp = None
        if cfg.positioning_mode.startswith("PPP"):
            self.ppp = PppEngine(
                mode=("kinematic" if cfg.positioning_mode == "PPP_Kinematic"
                      else "static"),
                tide_correction=cfg.earth_tide > 0,
                pole_tide=cfg.earth_tide >= 2,
                oload=cfg.blq if cfg.earth_tide >= 2 else None,
                phase_windup=cfg.phwindup,
            )

        # per-band sample stream buffers (absolute indexing; one stream per
        # front-end band)
        self.bands = sorted({p.band for p in plans})
        self._band_fs = {}
        for g in self.groups:
            b = g.plan.band
            prev = self._band_fs.get(b)
            if prev is not None and prev != g.plan.fs:
                raise ValueError(f"band {b}: conflicting sample rates")
            self._band_fs[b] = g.plan.fs
        self._bufs = {b: np.zeros(0, dtype=np.complex64) for b in self.bands}
        self._buf_bases = {b: 0 for b in self.bands}
        self._stream_ends = {b: 0 for b in self.bands}
        # device-resident rolling stream per band: chunks upload once and
        # the trackers read windows in place. Sized to cover the largest
        # window demand plus one ~1 s feed chunk.
        self._dev_streams = {}
        for b in self.bands:
            need = max(
                (g.plan.trk_conf.window_samples for g in self.groups
                 if g.plan.band == b), default=0,
            )
            self._dev_streams[b] = DeviceStream(
                int(self._band_fs[b] * 1.3) + 2 * need, device=self.device)

    # ------------------------------------------------- single-band helpers
    @property
    def acq_conf(self):
        return self.groups[0].plan.acq_conf

    @property
    def trk_conf(self):
        return self.groups[0].plan.trk_conf

    @property
    def tracker(self):
        return self.groups[0].tracker

    @property
    def channel_prn(self):
        return self.groups[0].channel_prn

    @property
    def _stream_end(self) -> int:
        """First band's stream end (single-band compat)."""
        return self._stream_ends[self.bands[0]]

    # ---------------------------------------------------------------- stream
    def feed(self, chunk: np.ndarray, band: str | None = None) -> None:
        """Append samples to a band's stream buffer (default: first band)."""
        trace.follow_profiler()
        with trace.span("feed"):
            b = self.bands[0] if band is None else band
            chunk = np.asarray(chunk, dtype=np.complex64)
            with trace.span("feed.concat"):
                self._bufs[b] = np.concatenate([self._bufs[b], chunk])
            self._stream_ends[b] += len(chunk)
            self._dev_streams[b].append(chunk,
                                        quantize_i8=self.cfg.int8_stream)

    def _slice(self, band: str, start: int, n: int) -> np.ndarray | None:
        if start < self._buf_bases[band] or start + n > self._stream_ends[band]:
            return None
        off = start - self._buf_bases[band]
        return self._bufs[band][off : off + n]

    def _trim(self, band: str, keep_from: int) -> None:
        drop = keep_from - self._buf_bases[band]
        if drop > 0:
            self._bufs[band] = self._bufs[band][drop:]
            self._buf_bases[band] = keep_from

    # ----------------------------------------------------------- acquisition
    def acquire(self, at_sample: int | None = None) -> dict:
        """Batched PCPS over every group's search list; assign detections to
        idle channels and start tracking (cold-start acquisition)."""
        with trace.span("acquire"):
            started = {}
            for g in self.groups:
                started.update(self._acquire_group(g, at_sample))
            self.status.acquired.update(started)
            return started

    def _acquire_group(self, g: SignalGroup, at_sample: int | None) -> dict:
        plan = g.plan
        # engine variants may consume a different window than the base conf
        # (Tong: max_attempts dwells; QuickSync/CCCWSR: their own .win)
        n = getattr(g.acq, "win", None) or g.acq.conf.input_samples
        start = self._buf_bases[plan.band] if at_sample is None else at_sample
        x = self._slice(plan.band, start, n)
        if x is None:
            raise ValueError("not enough samples buffered for acquisition")

        prns = [p for p in plan.search_prns if p not in g.channel_prn]
        if not prns:
            return {}

        # multi-band Doppler projection (GNSSFlowgraph::project_doppler):
        # satellites already tracked on another band get a narrow assisted
        # search seeded with the projected Doppler dop2 = dop1 * f2 / f1
        # instead of the full cold grid
        proj = self._project_doppler(g)
        prns_assist = [p for p in prns if p in proj] if (
            plan.acq_engine == "pcps" and plan.freq_offset_table is None
            and proj) else []
        prns_cold = [p for p in prns if p not in prns_assist]

        results = []                    # (prn, det, stat, dop, delay)
        if prns_cold:
            xb = np.broadcast_to(x, (len(prns_cold), n))
            res = g.acq.acquire(
                xb, np.array([plan.prn_row(p) for p in prns_cold]))
            if g.acq_dumper is not None:
                g.acq_dumper.push(prns_cold, res)
            results += _rows(prns_cold, res)
        if prns_assist:
            assisted = self._assisted_engine(g, proj)
            na = assisted.inner.conf.input_samples
            xa = self._slice(plan.band, start, na)
            if xa is not None:
                xba = np.broadcast_to(xa, (len(prns_assist), na))
                res = assisted.acquire(
                    xba, np.array([plan.prn_row(p) for p in prns_assist]))
                results += _rows(prns_assist, res)

        order = np.argsort([-r[2] for r in results])
        started = {}
        seen_offsets: set[float] = set()
        for idx in order:
            prn, det, stat, dop_hz, delay_sp = results[idx]
            if not det:
                continue
            fdma_off = plan.carrier_offset_hz(prn)
            if plan.freq_offset_table is not None:
                # FDMA: antipodal slots share code AND carrier, so one
                # detection per frequency channel; the GNAV slot number
                # re-keys the channel if the twin guess was wrong
                # (_handle_block)
                if fdma_off in seen_offsets or any(
                    plan.carrier_offset_hz(p) == fdma_off
                    for p in g.channel_prn if p
                ):
                    continue
                seen_offsets.add(fdma_off)
            ch = g.idle_channel()
            if ch is None:
                break
            # pull-in begins at the first code boundary inside the device
            # stream buffer (the acquisition window may have rolled out of
            # the ring by now; start_channel projects the code phase
            # forward by whole periods)
            ds = self._dev_streams[plan.band]
            g.tracker.start_channel(
                ch, prn, plan.prn_row(prn),
                acq_delay_samples=delay_sp,
                acq_doppler_hz=dop_hz,
                acq_samplestamp=start,
                current_abs_sample=max(start, ds.base),
                carrier_offset_hz=fdma_off,
            )
            g.channel_prn[ch] = prn
            g.decoders[prn] = plan.make_decoder(prn)
            if g.loop_closer is not None and hasattr(g.loop_closer,
                                                     "reset_channel"):
                g.loop_closer.reset_channel(ch)
            log.info(
                "acq %s%02d %s: doppler %+.0f Hz delay %.1f -> channel %d",
                plan.system, prn, plan.name, dop_hz, delay_sp,
                g.offset + ch,
            )
            self.obs.configure_channel(
                g.offset + ch, plan.code_period_s, plan.table_rate_cps,
                plan.carrier_freq_hz + fdma_off, plan.system,
                fs=plan.fs, signal=plan.name,
                carrier_offset_hz=fdma_off,
            )
            started[(plan.system, prn)] = (dop_hz, delay_sp)
        return started

    def _project_doppler(self, g: SignalGroup) -> dict[int, float]:
        """prn -> predicted Doppler for g's band, projected from any other
        group tracking the same satellite on a different carrier
        (GNSSFlowgraph::project_doppler analog): dop2 = dop1 * f2 / f1."""
        out: dict[int, float] = {}
        for o in self.groups:
            if o is g or o.plan.system != g.plan.system:
                continue
            if o.plan.carrier_freq_hz == g.plan.carrier_freq_hz:
                continue
            dop_row = None
            for ch, prn in enumerate(o.channel_prn):
                if not prn or prn in g.channel_prn or prn in out:
                    continue
                if o.tracker.ctl[ch].phase == ChannelPhase.IDLE:
                    continue
                if dop_row is None:
                    dop_row = o.tracker.state.carrier_doppler.cpu().numpy()
                out[prn] = float(dop_row[ch]) * (
                    g.plan.carrier_freq_hz / o.plan.carrier_freq_hz)
        return out

    def _assisted_engine(self, g: SignalGroup,
                         proj: dict[int, float]) -> AssistedAcquisition:
        """g's narrow assisted engine, built on first use and cached; its
        per-row predicted Doppler is rewritten on each call, which rebuilds
        nothing."""
        plan = g.plan
        if g.assisted_acq is None:
            table = (plan.acq_code_table if plan.acq_code_table is not None
                     else plan.code_table)
            row_prns = [0] * table.shape[0]
            for p in plan.search_prns:
                row_prns[plan.prn_row(p)] = p
            g.assisted_acq = AssistedAcquisition(
                plan.acq_conf, table, row_prns,
                {p: 0.0 for p in row_prns}, window_hz=500.0,
                mesh=self.mesh, device=self.device)
        assisted = g.assisted_acq
        offsets = np.zeros(len(assisted._offsets_np), np.float64)
        for p, d in proj.items():
            offsets[plan.prn_row(p)] = d
        assisted.set_predicted_doppler(offsets)
        return assisted

    # ------------------------------------------------------------------ main
    def run(self, max_blocks: int | None = None) -> ReceiverStatus:
        """Process as much buffered stream as possible."""
        blocks = 0
        while max_blocks is None or blocks < max_blocks:
            progressed = False
            for g in self.groups:
                if not g.active_channels():
                    continue
                ds = self._dev_streams[g.plan.band]
                act = g.tracker.active_channels()
                head = int(g.tracker.pos_abs[act].max())
                conf = g.plan.trk_conf
                if (head + conf.steps_per_block * conf.max_step_samples
                        + conf.samples_per_code > ds.end):
                    continue              # not enough stream fed yet
                try:
                    result = g.tracker.process_device(
                        ds.window, ds.base, ds.end - ds.base
                    )
                except ValueError:
                    # one stalled channel must not kill the receiver: drop
                    # the laggard (the receiver restarts it via reacquisition)
                    log.warning("%s: window overrun, dropping laggard",
                                g.plan.name)
                    self._drop_laggard(g)
                    continue
                progressed = True
                if g.loop_closer is not None:
                    g.loop_closer.after_block(g.tracker, result)
                self._handle_block(g, result)
            if not progressed:
                break
            blocks += 1
            self._run_epochs()
            for b in self.bands:
                heads = [int(min(g.tracker.pos_abs[g.active_channels()]))
                         for g in self.groups
                         if g.plan.band == b and g.active_channels()]
                if heads:
                    keep = min(heads)
                else:
                    # idle band: retain one acquisition window's worth
                    need = max(g.plan.acq_conf.input_samples
                               for g in self.groups if g.plan.band == b)
                    keep = max(self._buf_bases[b],
                               self._stream_ends[b] - need)
                self._trim(b, keep)
        return self.status

    def _drop_laggard(self, g: SignalGroup) -> None:
        """Stop the furthest-behind channel of a group (its window demand
        exceeded the block size; reference: tracking loss -> FSM standby)."""
        act = g.tracker.active_channels()
        if not act:
            return
        worst = min(act, key=lambda i: g.tracker.pos_abs[i])
        g.tracker.stop_channel(worst)
        self.obs.deanchor_keep_signal(g.offset + worst)

    def _active_head_times(self) -> list[float]:
        """Per-group head positions in stream seconds."""
        return [int(min(g.tracker.pos_abs[g.active_channels()])) / g.plan.fs
                for g in self.groups if g.active_channels()]

    # -------------------------------------------------------------- per block
    def _handle_block(self, g: SignalGroup, result) -> None:
        with trace.span("blocks"):
            plan = g.plan
            conf = plan.trk_conf
            out = result.outputs
            if g.dumper is not None:
                g.dumper.push(_dump_result(result))
            for ch, ev in result.events:
                log.info("%s ch%d prn %d: %s", plan.name, ch,
                         g.channel_prn[ch], ev)
            for ch in range(plan.num_channels):
                ctl = g.tracker.ctl[ch]
                if ctl.phase not in (ChannelPhase.WIDE, ChannelPhase.NARROW):
                    continue
                prn = g.channel_prn[ch]
                gch = g.offset + ch
                # observables: every period's stamp/code-phase/doppler/phase
                self.obs.push_periods(
                    gch,
                    result.abs_sample_end[:, ch],
                    out["rem_code_phase"][:, ch],
                    out["carrier_doppler"][:, ch],
                    out["carrier_phase"][:, ch],
                    cn0_dbhz=ctl.cn0_dbhz,
                )
                # sub-chip code phase by stamp, for anchoring telemetry TOWs
                rem_map = g.recent_rem.setdefault(ch, {})
                for k in range(result.abs_sample_end.shape[0]):
                    rem_map[int(result.abs_sample_end[k, ch])] = float(
                        out["rem_code_phase"][k, ch]
                    )
                if len(rem_map) > 200:
                    for s in sorted(rem_map)[:-100]:
                        del rem_map[s]

                if prn not in g.decoders:
                    continue
                # telemetry symbols: pilot plans take the data component's
                # symbols (one per sec_len_data periods, on the quadrature
                # axis once the pilot PLL holds the carrier: reference
                # track_pilot Prompt_Data); BPSK plans take
                # extended-integration prompts for multi-period bits (GPS
                # LNAV) or every period's prompt for symbol-rate signals
                # (Galileo E1-B, 250 symbols/s)
                if conf.track_pilot:
                    if not ctl.sec_locked:
                        continue
                    db = out["data_boundary"][:, ch]
                    full = db & (out["data_count"][:, ch] == conf.sec_len_data)
                    if not full.any():
                        continue
                    sym = out["data_prompt"][full, ch]
                    signs = np.sign(sym.imag if conf.data_on_quadrature
                                    else sym.real)
                else:
                    b = out["boundary"][:, ch]
                    if conf.extend_correlation_symbols > 1:
                        if ctl.phase != ChannelPhase.NARROW:
                            continue
                        n_acc = out["acc_samples"][:, ch]
                        full = b & (
                            n_acc > conf.samples_per_code
                            * (conf.extend_correlation_symbols - 0.5)
                        )
                    else:
                        full = b
                    if not full.any():
                        continue
                    signs = np.sign(out["acc_prompt"][full, ch].real)
                with trace.span("blocks.telemetry"):
                    self._telemetry(g, ch, prn, signs,
                                    result.abs_sample_end[full, ch])

    def _telemetry(self, g: SignalGroup, ch: int, prn: int,
                   signs: np.ndarray, stamps: np.ndarray) -> None:
        """Push one channel's symbols of a block to its decoder and act on
        the decoder's events: TOW anchors, ephemerides, OSNMA, iono."""
        plan = g.plan
        gch = g.offset + ch
        rem_map = g.recent_rem[ch]
        dec = g.decoders[prn]
        events = (dec.push_symbols(signs, stamps)
                  if hasattr(dec, "push_symbols")
                  else dec.push_bits(signs, stamps))
        for ev in events:
            self.status.subframes += 1
            # FDMA slot identity: antipodal satellites share the
            # frequency channel; the decoded GNAV slot number (string
            # 4 'n') is the authority (reference
            # flag_update_slot_number). Re-key the channel if the
            # acquisition-time guess picked the twin.
            true_prn = prn
            if plan.system == "R" and ev.get("ephemeris_complete"):
                true_prn = getattr(
                    g.decoders[prn].eph, "slot", prn) or prn
            if true_prn != prn:
                if true_prn in g.channel_prn:
                    log.info("R%02d: twin slot already tracked, "
                             "dropping channel %d", true_prn, ch)
                    g.tracker.stop_channel(ch)
                    self.obs.deanchor_keep_signal(gch)
                    del g.decoders[prn]
                    break
                log.info("R%02d -> R%02d: GNAV slot re-key", prn,
                         true_prn)
                g.decoders[true_prn] = g.decoders.pop(prn)
                g.channel_prn[ch] = true_prn
                prn = true_prn
            rem = rem_map.get(int(ev["sample_stamp"]), 0.0)
            self.obs.anchor(
                gch, prn, ev["tow_s"], ev["sample_stamp"],
                rem_code_chips=rem,
            )
            if plan.trk_conf.tow_to_trk:
                # reference telemetry_to_trk message path: TOW +
                # samplestamp back to the tracking channel
                wn = int(getattr(g.decoders[prn].eph, "week", 0) or 0)
                g.tracker.set_tow_from_telemetry(
                    ch, ev["tow_s"] * 1000.0, wn, ev["sample_stamp"])
            if self.osnma is not None and plan.system == "E":
                self.osnma.anchor(gch, ev["tow_s"], ev["sample_stamp"],
                                  plan.trk_conf.fs)
            if ev["ephemeris_complete"]:
                if (plan.system, prn) not in self.ephemerides:
                    log.info("%s%02d: ephemeris complete",
                             plan.system, prn)
                self.ephemerides[(plan.system, prn)] = g.decoders[prn].eph
            elif (getattr(g.decoders[prn], "reduced_ced", None)
                  is not None
                  and (plan.system, prn) not in self.ephemerides):
                # I/NAV word-16 reduced CED as a preliminary ephemeris
                # for a faster first fix (reference get_reduced_ced),
                # replaced by the full CED when it completes
                log.info("%s%02d: reduced CED ephemeris",
                         plan.system, prn)
                self.ephemerides[(plan.system, prn)] = (
                    g.decoders[prn].reduced_ced.compute_eph())
        # OSNMA: drain the decoder's per-page 40-bit fields into the
        # TESLA engine once the ephemeris (the authenticated words and
        # the GST week) is known (reference galileo_telemetry_decoder_gs
        # -> osnma_msg_receiver routing)
        if self.osnma is not None and plan.system == "E":
            dec = g.decoders.get(prn)
            eph = self.ephemerides.get(("E", prn))
            if (dec is not None and eph is not None
                    and getattr(dec, "osnma_fields", None)):
                fields = dec.osnma_fields
                dec.osnma_fields = []
                self.osnma.push_fields(
                    gch, prn, getattr(eph, "week", None), eph, fields)
        # broadcast iono (LNAV SF4 page 18) feeds the solver's
        # Klobuchar model
        if events and plan.system == "G" and not self.iono.valid:
            iu = getattr(g.decoders[prn], "iono_utc", None)
            if iu is not None and iu.has_iono:
                self.iono = KlobucharParams(alpha=iu.alpha, beta=iu.beta)
                self.status.iono_utc = iu

    # ---------------------------------------------------------------- epochs
    def _run_epochs(self) -> None:
        with trace.span("epochs"):
            cfg = self.cfg
            if self.obs.t_rx_tow is None:
                return
            interval = cfg.obs_interval_ms / 1000.0
            if self._next_epoch_t is None:
                self._next_epoch_t = (
                    np.floor(self.obs.rx_ref_time_s / interval) + 2
                ) * interval
            heads = self._active_head_times()
            if not heads:
                return
            horizon = min(heads)
            while self._next_epoch_t + interval < horizon:
                t_ep = self._next_epoch_t
                self._next_epoch_t += interval
                epoch_obs = self.obs.epoch_time(t_ep)
                usable = self._filter_osnma([
                    o for o in epoch_obs
                    if (o.system, o.prn) in self.ephemerides
                ])
                t_rx = self.obs.rx_tow_at_time(t_ep)
                if len(usable) >= 4 and (
                    t_rx - self._last_pvt_tow >= cfg.pvt_interval_ms / 1000.0 - 1e-9
                ):
                    self._last_pvt_tow = t_rx
                    obs_list = [
                        ObsEpoch(
                            prn=o.prn,
                            pseudorange_m=o.pseudorange_smoothed_m,
                            doppler_hz=o.doppler_hz,
                            carrier_phase_cycles=o.carrier_phase_cycles,
                            cn0_dbhz=o.cn0_dbhz,
                            carrier_freq_hz=C_LIGHT / self.obs.ch[o.channel].wavelength_m,
                            system=o.system,
                            signal=o.signal,
                        )
                        for o in usable
                    ]
                    x0 = (
                        self._last_fix.pos_ecef if self._last_fix is not None
                        else None
                    )
                    with trace.span("epochs.pvt"):
                        sol = solve_pvt(
                            obs_list, self.ephemerides, t_rx,
                            iono=(self.iono if self.cfg.apply_atmosphere
                                  else None),
                            x0=x0,
                            apply_atmosphere=self.cfg.apply_atmosphere,
                        )
                        if self.ppp is not None and sol.valid:
                            self._refine_ppp(sol, usable, t_rx)
                    if sol.valid:
                        if not self.status.fixes:
                            log.info(
                                "first fix: lat %.5f lon %.5f h %.0f m "
                                "(%d sats, TTFF %.1f s)",
                                np.degrees(sol.lat_rad),
                                np.degrees(sol.lon_rad),
                                sol.height_m, sol.num_sats, t_ep,
                            )
                        if sol.raim_rejected:
                            log.warning("RAIM rejected: %s", sol.raim_rejected)
                        if self.pvt_kf is not None:
                            pos, vel = self.pvt_kf.update(
                                t_rx, sol.pos_ecef, sol.vel_ecef)
                            sol.pos_ecef = pos
                            sol.vel_ecef = vel
                            sol.lat_rad, sol.lon_rad, sol.height_m = (
                                ecef_to_llh(pos))
                        self._last_fix = sol
                        self.status.fixes.append(sol)
                        if self.status.ttff_s is None:
                            self.status.ttff_s = t_ep
                        # clock feedback loop: keep the free-running rx clock
                        # near GPS time so pseudoranges stay near nominal
                        thr = cfg.rx_clock_correction_s
                        if thr > 0 and abs(sol.clock_bias_s) > thr:
                            log.info("rx clock slew: %.3f ms",
                                     sol.clock_bias_s * 1e3)
                            self.obs.apply_clock_correction(sol.clock_bias_s)
                            self._last_pvt_tow -= sol.clock_bias_s

    def _refine_ppp(self, sol, usable: list, t_rx: float) -> None:
        """PPP_Static/PPP_Kinematic positioning modes: refine the LS fix
        with the dual-frequency iono-free float PPP filter when the epoch
        observes >= 4 satellites on two bands (reference
        PVT.positioning_mode PMODE_PPP_*, rtklib_ppp.cc pppos)."""
        by_sat: dict = {}
        for o in usable:
            f = C_LIGHT / self.obs.ch[o.channel].wavelength_m
            by_sat.setdefault((o.system, o.prn), []).append((f, o))
        duals = []
        for (sys_, prn), lst in by_sat.items():
            if len(lst) < 2:
                continue
            lst.sort(key=lambda x: -x[0])
            (f1, o1), (f2, o2) = lst[0], lst[-1]
            if abs(f1 - f2) < 1e6 or not (
                np.isfinite(o1.carrier_phase_cycles)
                and np.isfinite(o2.carrier_phase_cycles)
            ):
                continue
            duals.append(DualFreqObs(
                system=sys_, prn=prn,
                p1_m=o1.pseudorange_m, p2_m=o2.pseudorange_m,
                phi1_cycles=o1.carrier_phase_cycles,
                phi2_cycles=o2.carrier_phase_cycles,
                f1_hz=f1, f2_hz=f2, cn0_dbhz=o1.cn0_dbhz,
            ))
        if len(duals) < 4:
            return
        if self.ppp.gps_week == 0:
            for eph in self.ephemerides.values():
                wk = int(getattr(eph, "week", 0) or 0)
                if wk:
                    self.ppp.gps_week = wk
                    break
        psol = self.ppp.process_epoch(
            t_rx - sol.clock_bias_s, duals, self.ephemerides,
            x0=sol.pos_ecef)
        if psol.valid:
            sol.pos_ecef = psol.pos_ecef
            sol.lat_rad, sol.lon_rad, sol.height_m = ecef_to_llh(
                psol.pos_ecef)

    def _filter_osnma(self, usable: list) -> list:
        """PVT strict mode: only OSNMA-authenticated Galileo satellites
        contribute to the fix (rtklib_pvt_gs.cc:1990-2075)."""
        if self.osnma is None or not self.cfg.osnma_strict:
            return usable
        return [o for o in usable
                if o.system != "E" or self.osnma.authenticated(o.prn)]

    def close(self) -> None:
        """Flush the dump files (end of run)."""
        for g in self.groups:
            for d in (g.dumper, g.acq_dumper):
                if d is not None:
                    d.close()

    # ------------------------------------------------- compat helper for CLI
    def _idle_channel(self) -> int | None:
        """The first idle (or lost) channel of the first group that has
        one, or None (``main.run_from_config`` re-acquires only then)."""
        for g in self.groups:
            ch = g.idle_channel()
            if ch is not None:
                return ch
        return None
