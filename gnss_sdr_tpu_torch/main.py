"""Command-line receiver entry point.

Counterpart of ``gnss_sdr_tpu/main.py`` (reference src/main/main.cc:108-299:
flag parsing, ControlThread run, run time report). Usage:

    python -m gnss_sdr_tpu_torch.main -c receiver.conf

Builds the role chain from the INI config via the block factory
(SignalSource -> SignalConditioner -> batched channels -> Observables ->
PVT -> writers) and streams the source to completion, on the CUDA card.
``GNSS_SDR_TPU_FUSED=perchannel`` in the environment makes the fused
tracking engine run kernel K2 instead of K1 (``tracking/fused.py``).

``run_from_config`` takes the device ("cuda" by default; "cpu" runs every
kernel's plain version, as the tests do). The CLI has the JAX package's
flags and no device flag. The control plane is the JAX CLI's: the
assistance XML warm start and save (``GNSS-SDR.assistance_xml``), SUPL
A-GNSS assistance (``GNSS-SDR.SUPL_gps_enabled``), the telecommand TCP
server (``GNSS-SDR.telecommand_enabled``), the command FIFO
(``GNSS-SDR.command_fifo``) and the ocean-loading table of the PPP modes
(``PVT.blq_file``, ``PVT.blq_station``). Their servers and readers run on
threads that read only host state; the commands they queue are applied on
the main thread between blocks.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np

from gnss_sdr_tpu_torch.conditioner import SignalConditioner
from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
from gnss_sdr_tpu_torch.receiver.factory import (
    check_observables_impl,
    get_channel_counts,
    get_pvt_outputs,
    get_signal_conditioner,
    get_signal_plans,
    get_signal_source,
)
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.utils.log import get_logger, setup_logging

log = get_logger(__name__)

# RF chain i feeds the i-th band the plans need, in this order. The JAX
# package's order stops at B1, so its CLI refuses the GLONASS (G1, G2) and
# Galileo E5b groups for want of a chain; here they take the next chain.
_BAND_ORDER = ("L1", "L5", "B1", "G1", "G2", "E5b")

def _build_chains(cfg, device="cuda"):
    """One (source, conditioner, conditioned_fs) per RF chain
    (gnss_flowgraph.cc instantiates source+conditioner per RF channel)."""
    n_rf = cfg.property("SignalSource.RF_channels", 1)
    chains = []
    for i in range(n_rf):
        suffix = str(i) if n_rf > 1 else ""
        src_role = f"SignalSource{suffix}" if suffix else "SignalSource"
        cond_role = f"SignalConditioner{suffix}" if suffix else "SignalConditioner"
        source = get_signal_source(cfg, role=src_role)
        conditioner = get_signal_conditioner(cfg, role=cond_role,
                                             suffix=suffix, device=device)
        # sources decode their item format to complex64 already, so the
        # conditioner's dtype adapter must not re-interpret the stream (the
        # adapter stage exists for pipelines that ship raw integers to device)
        if isinstance(conditioner, SignalConditioner) and (
            conditioner.cfg.input_format != "passthrough"
        ):
            conditioner = SignalConditioner(
                replace(conditioner.cfg, input_format="passthrough"),
                device=device)
        if isinstance(conditioner, SignalConditioner):
            ccfg = conditioner.cfg
            fs_out = ccfg.fs_out or ccfg.fs_in / ccfg.decimation
        else:
            fs_out = source.fs
        if n_rf == 1:
            fs_out = cfg.property("GNSS-SDR.internal_fs_sps", fs_out)
        chains.append((source, conditioner, float(fs_out)))
    return chains


def _load_blq(cfg):
    """Optional ocean-loading table: PVT.blq_file + PVT.blq_station
    (an extension over the reference's earth_tide knob, which compiles
    rtklib's otl path but never feeds it a table)."""
    path = cfg.property("PVT.blq_file", "")
    if not path:
        return None
    from gnss_sdr_tpu_torch.pvt.tides import read_blq

    station = cfg.property("PVT.blq_station", "")
    table = read_blq(path, station)
    if table is None:
        raise ValueError(f"station {station!r} not found in {path}")
    return table


class _HostTracker:
    """A tracker as the channel-status table reads it: its channel
    controls, and its state with the Doppler row copied to the host when
    read (``monitor/status.py`` is the JAX package's, which reads that row
    with ``np.asarray``)."""

    def __init__(self, tracker) -> None:
        self._tracker = tracker
        self.ctl = tracker.ctl

    @property
    def state(self):
        return SimpleNamespace(carrier_doppler=(
            self._tracker.state.carrier_doppler.cpu().numpy()))


def _status_view(receiver):
    """The receiver's groups as ``render_channel_status`` reads them."""
    return SimpleNamespace(groups=[
        SimpleNamespace(plan=g.plan, offset=g.offset,
                        channel_prn=g.channel_prn,
                        tracker=_HostTracker(g.tracker))
        for g in receiver.groups])


def run_from_config(cfg, max_seconds: float | None = None,
                    device: str = "cuda"):
    """Run the full receiver from a ConfigurationInterface; returns status.

    Builds one SignalPlan per Channels_XX group; RF chain i feeds the i-th
    band in _BAND_ORDER (gnss_block_factory.cc GetChannels grouping +
    per-RF-channel sources). ``device`` holds the sample ring and runs the
    engines and the conditioner.
    """
    chains = _build_chains(cfg, device)
    # assign chains to bands in canonical order of the bands the plans need
    probe_plans = get_signal_plans(
        cfg, {b: chains[min(i, len(chains) - 1)][2]
              for i, b in enumerate(_BAND_ORDER)})
    bands_needed = sorted({p.band for p in probe_plans},
                          key=_BAND_ORDER.index)
    if len(chains) < len(bands_needed):
        raise ValueError(
            f"config needs {len(bands_needed)} RF chains for bands "
            f"{bands_needed}, got SignalSource.RF_channels={len(chains)}")
    chain_band = {bands_needed[i]: chains[i] for i in range(len(bands_needed))}
    fs_by_band = {b: c[2] for b, c in chain_band.items()}
    plans = get_signal_plans(cfg, fs_by_band)

    fs_ref = fs_by_band[plans[0].band]
    rx_cfg = ReceiverConfig(
        fs=fs_ref,
        num_channels=sum(p.num_channels for p in plans),
        obs_interval_ms=cfg.property("GNSS-SDR.observable_interval_ms", 20),
        pvt_interval_ms=cfg.property("PVT.output_rate_ms", 100),
        enable_pvt_kf=cfg.property("PVT.enable_pvt_kf", False),
        num_devices=cfg.property("GNSS-SDR.num_devices", 0),
        # reference rtklib_pvt.cc adapter keys (same names/semantics);
        # bool default so both `1` and `true` conf spellings parse
        positioning_mode=cfg.property("PVT.positioning_mode", "Single"),
        earth_tide=cfg.property("PVT.earth_tide", 0),
        phwindup=cfg.property("PVT.phwindup", False),
        blq=_load_blq(cfg),
        device=device,
    )
    check_observables_impl(cfg)
    receiver = Receiver(rx_cfg, plans=plans)
    outputs = get_pvt_outputs(cfg)

    # assistance warm start (reference read_assistance_from_XML,
    # control_thread.cc:515): reload saved ephemerides/iono before the run
    assist_xml = cfg.property("GNSS-SDR.assistance_xml", "")
    if assist_xml:
        import os

        from gnss_sdr_tpu_torch.receiver.assistance import load_assistance

        if os.path.exists(assist_xml):
            data = load_assistance(assist_xml)
            receiver.ephemerides.update(data["ephemerides"])
            iu = data["iono_utc"]
            if iu is not None and iu.has_iono:
                from gnss_sdr_tpu_torch.pvt.atmosphere import KlobucharParams

                receiver.iono = KlobucharParams(alpha=iu.alpha, beta=iu.beta)

    # SUPL A-GNSS assistance (reference assist_GNSS,
    # control_thread.cc:743-790: SET-initiated SUPL/RRLP session before
    # the run; same GNSS-SDR.SUPL_* property names)
    if cfg.property("GNSS-SDR.SUPL_gps_enabled", False):
        from gnss_sdr_tpu_torch.receiver.supl import SuplClient, SuplConfig

        supl_cfg = SuplConfig(
            server=cfg.property("GNSS-SDR.SUPL_gps_ephemeris_server",
                                "supl.google.com"),
            port=cfg.property("GNSS-SDR.SUPL_gps_ephemeris_port", 7275),
            mcc=cfg.property("GNSS-SDR.SUPL_MCC", 244),
            mnc=cfg.property("GNSS-SDR.SUPL_MNC", 5),
            lac=cfg.property("GNSS-SDR.SUPL_LAC", 0x59E2),
            ci=cfg.property("GNSS-SDR.SUPL_CI", 0x31D2),
            request=1,
        )
        try:
            assist = SuplClient(supl_cfg).get_assistance()
            receiver.ephemerides.update(assist["ephemerides"])
            if assist["iono"] is not None:
                receiver.iono = assist["iono"]
            print(f"SUPL RRLP GPS assistance: "
                  f"{len(assist['ephemerides'])} ephemerides received")
        except Exception as e:       # network is best-effort, like the ref
            print(f"SUPL assistance failed: {e}")

    # telecommand server (reference TcpCmdInterface,
    # tcp_cmd_interface.cc:49-62); its threads read only host state
    tc_server = None
    if cfg.property("GNSS-SDR.telecommand_enabled", False):
        from gnss_sdr_tpu_torch.receiver.telecommand import TcpCmdServer

        tc_server = TcpCmdServer(
            receiver, port=cfg.property("GNSS-SDR.telecommand_tcp_port", 3333)
        )

    # IPC message-queue command channel (reference ControlThread spawns a
    # sysv/boost message-queue listener, control_thread.cc:428-431): a
    # named FIFO carrying the same line commands
    fifo_reader = None
    fifo_path = cfg.property("GNSS-SDR.command_fifo", "")
    if fifo_path:
        from gnss_sdr_tpu_torch.receiver.telecommand import FifoCmdReader

        fifo_reader = FifoCmdReader(receiver, fifo_path)

    # periodic channel-status console table
    # (channel_status_msg_receiver analog)
    status_display = None
    status_rate_ms = cfg.property("PVT.display_rate_ms", 0)
    if cfg.property("GNSS-SDR.print_channel_status", False) or status_rate_ms:
        from gnss_sdr_tpu_torch.monitor.status import ChannelStatusDisplay

        status_display = ChannelStatusDisplay(
            rate_s=(status_rate_ms or 2000) / 1000.0)

    # keyboard listener (reference ControlThread::keyboard_listener,
    # control_thread.cc:418-426): 'q' + Enter requests a clean stop;
    # only attached when stdin is an interactive terminal
    stop_requested = False
    if cfg.property("GNSS-SDR.keyboard", True):
        import threading

        if sys.stdin is not None and sys.stdin.isatty():
            def _keyboard_listener():
                nonlocal stop_requested
                for line in sys.stdin:
                    if line.strip().lower() == "q":
                        stop_requested = True
                        return

            threading.Thread(target=_keyboard_listener, daemon=True).start()

    chunk = 1 << 17
    acq_done = False
    reacq_t = 0.0
    printed = 0

    def stream_t() -> float:
        return min(receiver._stream_ends[b] / fs_by_band[b]
                   for b in receiver.bands)

    def ready_for_acq() -> bool:
        return all(
            receiver._stream_ends[g.plan.band]
            >= g.plan.acq_conf.input_samples
            for g in receiver.groups
        )

    while True:
        got_any = False
        for b, (source, conditioner, _) in chain_band.items():
            if source.exhausted():
                continue
            raw = source.read(chunk)
            if not len(raw):
                continue
            got_any = True
            x = conditioner.process(raw)
            receiver.feed(x.astype(np.complex64), band=b)
        if not got_any or stop_requested:
            break
        if max_seconds and stream_t() > max_seconds:
            break
        if not acq_done and ready_for_acq():
            receiver.acquire()
            acq_done = True
            reacq_t = stream_t()
        receiver.run()
        # periodic re-acquisition on idle channels (acquisition_manager idle
        # tick analog, gnss_flowgraph.cc:1698)
        if acq_done and stream_t() - reacq_t > 2.0:
            reacq_t = stream_t()
            if receiver._idle_channel() is not None:
                try:
                    receiver.acquire()
                except ValueError:
                    pass  # not enough contiguous samples buffered yet
        # queued commands, applied here on the main thread between blocks;
        # a stop re-arms the first acquisition
        for chan in (tc_server, fifo_reader):
            if chan is not None:
                cmds = chan.apply_pending()
                if any(c in ("standby", "reset", "coldstart") for c in cmds):
                    acq_done = False
        for sol in receiver.status.fixes[printed:]:
            outputs.print_position(sol)
        printed = len(receiver.status.fixes)
        if status_display is not None:
            status_display.tick(_status_view(receiver), stream_t())
    if assist_xml:
        from gnss_sdr_tpu_torch.receiver.assistance import save_assistance

        save_assistance(
            assist_xml, receiver.ephemerides,
            iono_utc=receiver.status.iono_utc,
        )
    if tc_server is not None:
        tc_server.close()
    if fifo_reader is not None:
        fifo_reader.close()
    receiver.close()
    outputs.close()
    return receiver.status


def apply_cli_flags(cfg, args) -> None:
    """Command-line property overrides (reference gnss_sdr_flags.cc:24-65 +
    the per-adapter FLAGS_* intake): selected receiver knobs override the
    config file for every configured signal group."""
    sigs = list(get_channel_counts(cfg))
    per_signal = {
        "doppler_max": ("Acquisition", args.doppler_max),
        "doppler_step": ("Acquisition", args.doppler_step),
        "pll_bw_hz": ("Tracking", args.pll_bw_hz),
        "dll_bw_hz": ("Tracking", args.dll_bw_hz),
        "extend_correlation_symbols": ("Tracking", args.extend_correlation_ms),
    }
    for prop, (role, value) in per_signal.items():
        if value is None:
            continue
        for sig in sigs:
            cfg.set_property(f"{role}_{sig}.{prop}", value)
    if args.signal_source is not None:
        cfg.set_property("SignalSource.filename", args.signal_source)
    if args.s is not None:
        cfg.set_property("SignalSource.filename", args.s)
    if args.rinex_version is not None:
        cfg.set_property("PVT.rinex_version", args.rinex_version)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GNSS-SDR-TPU software receiver")
    ap.add_argument("-c", "--config_file", required=True,
                    help="receiver configuration (.conf INI)")
    ap.add_argument("--max_seconds", type=float, default=None,
                    help="stop after this much signal time")
    ap.add_argument("--log_level", default="INFO",
                    help="logging severity (DEBUG/INFO/WARNING/ERROR)")
    ap.add_argument("--log_file", default=None)
    # reference gnss_sdr_flags.cc property overrides
    ap.add_argument("-s", help="capture file (same as --signal_source)")
    ap.add_argument("--signal_source", default=None,
                    help="override SignalSource.filename")
    ap.add_argument("--doppler_max", type=int, default=None,
                    help="override Acquisition_XX.doppler_max [Hz]")
    ap.add_argument("--doppler_step", type=int, default=None,
                    help="override Acquisition_XX.doppler_step [Hz]")
    ap.add_argument("--pll_bw_hz", type=float, default=None,
                    help="override Tracking_XX.pll_bw_hz")
    ap.add_argument("--dll_bw_hz", type=float, default=None,
                    help="override Tracking_XX.dll_bw_hz")
    ap.add_argument("--extend_correlation_ms", type=int, default=None,
                    help="override Tracking_XX.extend_correlation_symbols")
    ap.add_argument("--RINEX_version", dest="rinex_version", default=None)
    args = ap.parse_args(argv)
    setup_logging(args.log_level, args.log_file)

    t0 = time.time()
    cfg = FileConfiguration(args.config_file)
    apply_cli_flags(cfg, args)
    status = run_from_config(cfg, max_seconds=args.max_seconds)
    dt = time.time() - t0
    n_fix = len(status.fixes)
    print(f"Processed in {dt:.1f} s; {n_fix} fixes; TTFF "
          f"{status.ttff_s if status.ttff_s is not None else 'n/a'} s")
    if status.fixes:
        last = status.fixes[-1]
        print(f"Last fix: lat {np.degrees(last.lat_rad):.6f} "
              f"lon {np.degrees(last.lon_rad):.6f} h {last.height_m:.1f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
