# Copied from gnss_sdr_tpu/receiver/agnss.py; only the package imports are rewritten.
"""A-GNSS assistance over the network (SUPL re-expression).

Reference analog: src/core/libs/supl/ + gnss_sdr_supl_client.{h,cc} — the
reference fetches ephemeris/almanac/iono/UTC/reference position+time from
a SUPL server (TLS + ASN.1 RRLP) to cut cold-start TTFF. The protocol
machinery there is ~73 kLoC of generated ASN.1; the *capability* is
"assistance payload over a socket". This module re-expresses it with the
framework's own assistance XML (receiver/assistance.py) over a trivial
length-prefixed TCP exchange — same payload semantics, same receiver
intake path, none of the legacy codec.

Server: serves the current assistance snapshot to any client.
Client: fetches and returns the decoded assistance dict, ready for
Receiver.ephemerides / warm start (tools/ttff.py warm path).
"""

from __future__ import annotations

import socket
import struct
import threading
from pathlib import Path

from gnss_sdr_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

_MAGIC = b"AGN1"


class AgnssServer:
    """Threaded assistance server; payload is the assistance XML bytes."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._payload = b""
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def set_assistance_xml(self, xml_bytes: bytes) -> None:
        with self._lock:
            self._payload = xml_bytes

    def set_assistance_file(self, path: str | Path) -> None:
        self.set_assistance_xml(Path(path).read_bytes())

    def _serve(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                with self._lock:
                    body = self._payload
                conn.sendall(_MAGIC + struct.pack(">I", len(body)) + body)
                log.info("A-GNSS: served %d bytes to %s", len(body), addr)
            except OSError:
                pass
            finally:
                conn.close()

    def close(self) -> None:
        self._stop.set()
        self._srv.close()
        self._thread.join(timeout=1.0)


def fetch_assistance(host: str, port: int, timeout_s: float = 5.0) -> dict:
    """Fetch + decode assistance; returns receiver/assistance.py's dict
    ({'ephemerides': {(sys, prn): eph}, 'iono_utc': ..., ...})."""
    import tempfile

    from gnss_sdr_tpu_torch.receiver.assistance import load_assistance

    with socket.create_connection((host, port), timeout=timeout_s) as s:
        head = _recv_exact(s, 8)
        if head[:4] != _MAGIC:
            raise ValueError("not an A-GNSS assistance server")
        (length,) = struct.unpack(">I", head[4:])
        body = _recv_exact(s, length)
    with tempfile.NamedTemporaryFile(suffix=".xml", delete=False) as f:
        f.write(body)
        path = f.name
    try:
        return load_assistance(path)
    finally:
        Path(path).unlink(missing_ok=True)


def _recv_exact(s: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("assistance stream truncated")
        buf += chunk
    return buf
