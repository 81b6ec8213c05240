# Copied from gnss_sdr_tpu/receiver/telecommand.py; only the package imports are rewritten.
"""TCP telecommand server (reference: src/core/receiver/tcp_cmd_interface.cc
:49-62): a telnet-style line protocol with commands

    status | standby | reset | coldstart | warmstart | hotstart | exit

Commands queue into the host control loop (the reference pushes
command_event(300, ...) onto the ControlThread queue); the loop applies
them between processing blocks via ``apply_pending`` and replies are sent
immediately from receiver state snapshots.
"""

from __future__ import annotations

import queue
import socket
import threading

from gnss_sdr_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

COMMANDS = ("status", "standby", "reset", "coldstart", "warmstart",
            "hotstart", "exit")


class TcpCmdServer:
    def __init__(self, receiver, host: str = "127.0.0.1",
                 port: int = 3333) -> None:
        self.receiver = receiver
        self.pending: queue.Queue[str] = queue.Queue()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(2)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        log.info("telecommand server on %s:%d", host, self.port)

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # ---------------------------------------------------------------- server
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._client, args=(conn,), daemon=True
            ).start()

    def _client(self, conn: socket.socket) -> None:
        with conn:
            conn.sendall(b"gnss_sdr_tpu telecommand\r\n")
            buf = b""
            while not self._stop.is_set():
                try:
                    data = conn.recv(256)
                except OSError:
                    return
                if not data:
                    return
                buf += data
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    cmd = line.decode(errors="replace").strip().lower()
                    if not cmd:
                        continue
                    if cmd == "exit":
                        conn.sendall(b"OK\r\n")
                        return
                    if cmd == "status":
                        conn.sendall(self._status_text().encode())
                    elif cmd in COMMANDS:
                        self.pending.put(cmd)
                        conn.sendall(b"OK\r\n")
                    else:
                        conn.sendall(b"ERROR: unknown command\r\n")

    # ---------------------------------------------------------------- status
    def _status_text(self) -> str:
        rx = self.receiver
        lines = ["channel  signal  prn  state    cn0"]
        for g in rx.groups:
            for ch in range(g.plan.num_channels):
                ctl = g.tracker.ctl[ch]
                lines.append(
                    f"{g.offset + ch:7d}  {g.plan.name:>6}  "
                    f"{g.channel_prn[ch]:3d}  {ctl.phase.name:<7}  "
                    f"{ctl.cn0_dbhz:5.1f}"
                )
        if rx.status.fixes:
            import numpy as np

            f = rx.status.fixes[-1]
            lines.append(
                f"fix: lat {np.degrees(f.lat_rad):.6f} "
                f"lon {np.degrees(f.lon_rad):.6f} h {f.height_m:.1f} m "
                f"sats {f.num_sats}"
            )
        else:
            lines.append("fix: none")
        return "\r\n".join(lines) + "\r\n"

    # ------------------------------------------------------------- dispatch
    def apply_pending(self) -> list[str]:
        """Apply queued commands to the receiver (call from the host loop
        between blocks — the event_dispatcher analog)."""
        applied = []
        while True:
            try:
                cmd = self.pending.get_nowait()
            except queue.Empty:
                return applied
            dispatch_command(self.receiver, cmd)
            applied.append(cmd)


def dispatch_command(receiver, cmd: str) -> None:
    """Apply one control command to the receiver (the ControlThread
    event_dispatcher analog; shared by the TCP server and the message-queue
    reader)."""
    log.info("telecommand: %s", cmd)
    if cmd in ("standby", "reset", "coldstart"):
        for g in receiver.groups:
            for ch in list(g.tracker.active_channels()):
                g.tracker.stop_channel(ch)
                receiver.obs.deanchor_keep_signal(g.offset + ch)
            g.channel_prn = [0] * g.plan.num_channels
            g.decoders.clear()
    if cmd == "coldstart":
        receiver.ephemerides.clear()
    # warmstart/hotstart: keep ephemerides; channels restart at the
    # next acquisition tick (assistance reload is the CLI's job)


class FifoCmdReader:
    """Message-queue command channel (reference ControlThread spawns a
    boost-IPC message-queue listener, control_thread.cc:428-431
    sysv_queue_listener reading command doubles from 'gnss_sdr_ttff_message_queue'-style
    queues): here a named FIFO carries the same line commands as the TCP
    interface, so scripts can `echo coldstart > /tmp/gnss_sdr_cmd`.

    The FIFO is created if absent; a daemon thread re-opens it after each
    writer disconnects (named-pipe EOF semantics)."""

    def __init__(self, receiver, path: str) -> None:
        import os

        self.receiver = receiver
        self.path = path
        self.pending: queue.Queue[str] = queue.Queue()
        if not os.path.exists(path):
            os.mkfifo(path)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()
        log.info("command FIFO at %s", path)

    def _reader(self) -> None:
        while not self._stop.is_set():
            try:
                # blocks until a writer opens the FIFO
                with open(self.path, "r") as f:
                    for line in f:
                        cmd = line.strip().lower()
                        if cmd in COMMANDS:
                            self.pending.put(cmd)
                        elif cmd:
                            log.warning("FIFO: unknown command %r", cmd)
            except OSError:
                return

    def apply_pending(self) -> list[str]:
        applied = []
        while True:
            try:
                cmd = self.pending.get_nowait()
            except queue.Empty:
                return applied
            dispatch_command(self.receiver, cmd)
            applied.append(cmd)

    def close(self) -> None:
        import os

        self._stop.set()
        # unblock the reader's open() by connecting as a writer once
        try:
            fd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
            os.close(fd)
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass
