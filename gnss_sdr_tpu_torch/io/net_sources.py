# Copied from gnss_sdr_tpu/io/net_sources.py; only the package imports are rewritten.
"""Network signal sources: rtl_tcp client and ZeroMQ subscriber.

Reference analogs:
- RtlTcp_Signal_Source (src/algorithms/signal_source/adapters/
  rtl_tcp_signal_source.cc + gnuradio_blocks/rtl_tcp_signal_source_c.cc):
  connects to an `rtl_tcp` server, reads the 12-byte "RTL0" banner, sends
  u8-command + u32-BE-argument control messages (frequency, sample rate,
  gain mode), then streams unsigned 8-bit interleaved I/Q centred at
  ~127.5.
- ZMQ_Signal_Source (adapters/zmq_signal_source.cc): a ZeroMQ SUB socket
  delivering raw sample buffers in any File_Signal_Source item format.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

from gnss_sdr_tpu_torch.io.formats import decode_samples
from gnss_sdr_tpu_torch.io.sources import SignalSource
from gnss_sdr_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

# rtl_tcp command ids (rtl_tcp protocol, as used by rtl_tcp_signal_source_c)
RTL_TCP_SET_FREQUENCY = 0x01
RTL_TCP_SET_SAMPLE_RATE = 0x02
RTL_TCP_SET_GAIN_MODE = 0x03
RTL_TCP_SET_GAIN = 0x04
RTL_TCP_SET_FREQ_CORRECTION = 0x05
RTL_TCP_SET_IF_GAIN = 0x06
RTL_TCP_SET_AGC_MODE = 0x08


class RtlTcpSignalSource(SignalSource):
    """rtl_tcp streaming client (RtlTcp_Signal_Source analog)."""

    def __init__(self, address: str = "127.0.0.1", port: int = 1234,
                 fs: float = 2_000_000.0, freq_hz: float = 1_575_420_000.0,
                 gain_db: float | None = None, agc: bool = True,
                 if_gain_db: float | None = None,
                 timeout_s: float = 5.0) -> None:
        self.fs = fs
        self._sock = socket.create_connection((address, port),
                                              timeout=timeout_s)
        banner = self._recv_exact(12)
        if banner[:4] != b"RTL0":
            raise IOError(
                f"not an rtl_tcp server at {address}:{port} "
                f"(banner {banner[:4]!r})")
        self.tuner_type = struct.unpack(">I", banner[4:8])[0]
        self.tuner_gain_count = struct.unpack(">I", banner[8:12])[0]
        self._cmd(RTL_TCP_SET_SAMPLE_RATE, int(fs))
        self._cmd(RTL_TCP_SET_FREQUENCY, int(freq_hz))
        if gain_db is not None:
            self._cmd(RTL_TCP_SET_GAIN_MODE, 1)     # manual
            self._cmd(RTL_TCP_SET_GAIN, int(round(gain_db * 10)))
        else:
            self._cmd(RTL_TCP_SET_GAIN_MODE, 0)     # hardware AGC
        self._cmd(RTL_TCP_SET_AGC_MODE, 1 if agc else 0)
        if if_gain_db is not None:
            self._cmd(RTL_TCP_SET_IF_GAIN, int(round(if_gain_db * 10)))
        self._closed = False
        log.info("rtl_tcp connected: tuner type %d, %d gain steps",
                 self.tuner_type, self.tuner_gain_count)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise IOError("rtl_tcp connection closed")
            buf += chunk
        return buf

    def _cmd(self, cmd: int, value: int) -> None:
        self._sock.sendall(struct.pack(">BI", cmd, value & 0xFFFFFFFF))

    def read(self, num_samples: int) -> np.ndarray:
        if self._closed:
            return np.zeros(0, dtype=np.complex64)
        try:
            raw = self._recv_exact(2 * num_samples)
        except IOError:
            self._closed = True
            return np.zeros(0, dtype=np.complex64)
        u = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        x = ((u[0::2] - 127.4) + 1j * (u[1::2] - 127.4)) / 128.0
        self.samples_read += len(x)
        return x.astype(np.complex64)

    def exhausted(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class ZmqSignalSource(SignalSource):
    """ZeroMQ SUB-socket sample source (ZMQ_Signal_Source analog).

    The publisher side sends raw sample buffers (any item format); partial
    samples at message boundaries are carried over.
    """

    def __init__(self, endpoint: str, fmt: str = "gr_complex",
                 fs: float = 4_000_000.0, timeout_ms: int = 2000) -> None:
        try:
            import zmq
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "ZMQ_Signal_Source requires pyzmq (not installed)") from e
        self.fs = fs
        self.fmt = fmt
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.SUB)
        self._sock.setsockopt(zmq.SUBSCRIBE, b"")
        self._sock.setsockopt(zmq.RCVTIMEO, timeout_ms)
        self._sock.connect(endpoint)
        self._pending = np.zeros(0, dtype=np.complex64)
        self._carry = b""
        self._closed = False

    def read(self, num_samples: int) -> np.ndarray:
        import zmq

        out = [self._pending]
        have = len(self._pending)
        while have < num_samples and not self._closed:
            try:
                msg = self._sock.recv()
            except zmq.Again:
                self._closed = True
                break
            buf = self._carry + msg
            from gnss_sdr_tpu_torch.io.formats import bytes_per_sample

            bps = bytes_per_sample(self.fmt)
            usable = int(len(buf) // bps * bps)
            self._carry = buf[usable:]
            x = decode_samples(buf[:usable], self.fmt)
            out.append(x)
            have += len(x)
        allx = np.concatenate(out) if len(out) > 1 else out[0]
        x, self._pending = allx[:num_samples], allx[num_samples:]
        self.samples_read += len(x)
        return x

    def exhausted(self) -> bool:
        return self._closed and len(self._pending) == 0

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close(0)
        except Exception:
            pass
