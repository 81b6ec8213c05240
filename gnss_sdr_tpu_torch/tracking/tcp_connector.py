"""TCP-connector tracking: loop closure by an external peer.

Reference analog: src/algorithms/tracking/gnuradio_blocks/
gps_l1_ca_tcp_connector_tracking_cc.cc + libs/tcp_communication.cc
(GPS_L1_CA_TCP_CONNECTOR_Tracking): each integration's correlator outputs
stream to a TCP peer (classically a MATLAB loop-design sandbox), which
returns the carrier/code NCO commands — the discriminators and loop
filters run OUTSIDE the receiver.

Counterpart of ``gnss_sdr_tpu/tracking/tcp_connector.py``: the client,
the wire format and the reference peer are the same NumPy and socket code.
The exchange happens at tracking-block cadence on the batched engine:
after each block, the taps of the last boundary of each connected channel
are sent as one record per channel, the peer answers with
(carrier_doppler_hz, code_freq_cps) commands, and the wrapper writes them
into the tracker's state tensors in place, on their device, before the
next block. Wire format (little-endian f32, one record per channel):

  -> [channel, sample_stamp, t_int_s, E.re, E.im, P.re, P.im, L.re, L.im,
      carrier_doppler_hz, code_freq_cps]   (11 floats)
  <- [channel, carrier_doppler_hz, code_freq_cps]  (3 floats)
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from gnss_sdr_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

_REC_OUT = struct.Struct("<11f")
_REC_IN = struct.Struct("<3f")


class TcpLoopClient:
    """Connects to the external loop peer and exchanges one record per
    channel per block."""

    def __init__(self, address: str = "127.0.0.1", port: int = 3333,
                 timeout_s: float = 2.0) -> None:
        self._sock = socket.create_connection((address, port),
                                              timeout=timeout_s)

    def exchange(self, records: list[tuple]) -> dict[int, tuple]:
        """records: list of 11-float tuples -> {channel: (doppler, code_freq)}"""
        payload = struct.pack("<I", len(records)) + b"".join(
            _REC_OUT.pack(*r) for r in records)
        self._sock.sendall(payload)
        out = {}
        buf = b""
        need = 4
        while len(buf) < need:
            buf += self._sock.recv(4096)
        (n,) = struct.unpack_from("<I", buf, 0)
        need = 4 + n * _REC_IN.size
        while len(buf) < need:
            buf += self._sock.recv(4096)
        for i in range(n):
            ch, dop, cf = _REC_IN.unpack_from(buf, 4 + i * _REC_IN.size)
            out[int(ch)] = (float(dop), float(cf))
        return out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class TcpConnectorTracking:
    """Wraps a Tracker: streams correlator taps to the peer and applies
    the returned NCO commands to the connected channels."""

    def __init__(self, tracker, client: TcpLoopClient,
                 channels: list[int]) -> None:
        self.tracker = tracker
        self.client = client
        self.channels = list(channels)

    def process(self, window, abs_base: int):
        result = self.tracker.process(window, abs_base)
        self.after_block(self.tracker, result)
        return result

    def after_block(self, tracker, result) -> None:
        """Exchange one record per connected channel and apply the peer's
        NCO commands (used directly by the live receiver after each
        process_device block)."""
        out = result.outputs
        conf = tracker.conf
        records = []
        for ch in self.channels:
            b = out["boundary"][:, ch]
            if not b.any():
                continue
            s_i = int(np.flatnonzero(b)[-1])
            taps = out["taps"][s_i, ch]          # [T] complex
            p_idx = conf.num_taps // 2
            # the peer's loop runs at block cadence: the effective update
            # interval is the block duration, not one integration
            t_int = conf.steps_per_block * conf.code_period_s
            records.append((
                float(ch), float(result.abs_sample_end[s_i, ch]), t_int,
                float(taps[p_idx - 1].real), float(taps[p_idx - 1].imag),
                float(taps[p_idx].real), float(taps[p_idx].imag),
                float(taps[p_idx + 1].real), float(taps[p_idx + 1].imag),
                float(out["carrier_doppler"][s_i, ch]),
                float(out["code_freq"][s_i, ch]),
            ))
        if records:
            cmds = self.client.exchange(records)
            s = tracker.state
            for ch, (dop, cf) in cmds.items():
                # absolute-frequency commands land in the PLL integrator
                # too: pll_state[:,0] carries the absolute Doppler and
                # rewrites carrier_doppler at every boundary
                s.carrier_doppler[ch] = dop
                s.pll_state[ch, 0] = dop
                s.code_freq[ch] = cf


class SimpleLoopServer:
    """A reference external loop peer: a 2nd-order PLL + carrier-aided DLL
    in NumPy, serving the TCP-connector protocol (what the reference's
    MATLAB examples implement on the other end)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 pll_bw_hz: float = 15.0, dll_bw_hz: float = 1.5,
                 code_rate_cps: float = 1.023e6,
                 carrier_freq_hz: float = 1575.42e6) -> None:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self.pll_bw = pll_bw_hz
        self.dll_bw = dll_bw_hz
        self.code_rate = code_rate_cps
        self.fc = carrier_freq_hz
        self._integ: dict[int, float] = {}
        self._dll_i: dict[int, float] = {}
        self.records_seen = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _loop_update(self, ch, t_int, e, p, l, dop, cf):
        # Costas atan PLL, 2nd order
        err_c = float(np.arctan(p.imag / p.real) if p.real != 0 else 0.0) / (
            2 * np.pi)
        w0 = self.pll_bw / 0.53
        self._integ[ch] = self._integ.get(ch, dop) + w0 * w0 * err_c * t_int
        dop_new = self._integ[ch] + 1.414 * w0 * err_c
        # normalized E-L power DLL with carrier aiding
        ep, lp = abs(e), abs(l)
        err_d = 0.5 * (ep - lp) / (ep + lp) if (ep + lp) > 0 else 0.0
        w0d = self.dll_bw / 0.25
        self._dll_i[ch] = self._dll_i.get(ch, 0.0) + w0d * w0d * err_d * t_int
        aid = dop_new * self.code_rate / self.fc
        cf_new = self.code_rate + aid - (self._dll_i[ch] + 1.414 * w0d * err_d)
        return dop_new, cf_new

    def _serve(self) -> None:
        self._srv.settimeout(0.5)
        conn = None
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
                break
            except socket.timeout:
                continue
            except OSError:
                return
        if conn is None:
            return
        conn.settimeout(2.0)
        buf = b""
        while not self._stop.is_set():
            try:
                data = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            buf += data
            while len(buf) >= 4:
                (n,) = struct.unpack_from("<I", buf, 0)
                total = 4 + n * _REC_OUT.size
                if len(buf) < total:
                    break
                replies = []
                for i in range(n):
                    rec = _REC_OUT.unpack_from(buf, 4 + i * _REC_OUT.size)
                    ch, stamp, t_int = rec[0], rec[1], rec[2]
                    e = complex(rec[3], rec[4])
                    p = complex(rec[5], rec[6])
                    l = complex(rec[7], rec[8])
                    dop, cf = rec[9], rec[10]
                    self.records_seen += 1
                    replies.append((ch,) + self._loop_update(
                        int(ch), t_int, e, p, l, dop, cf))
                conn.sendall(struct.pack("<I", len(replies)) + b"".join(
                    _REC_IN.pack(*r) for r in replies))
                buf = buf[total:]
        conn.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
