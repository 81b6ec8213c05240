# Copied from gnss_sdr_tpu/io/sources.py; only the package imports are rewritten.
"""Signal sources: streaming sample producers for the receiver front end.

Host-side analogs of the reference's signal_source role
(src/algorithms/signal_source/adapters/, SURVEY.md §2.2):

- FileSignalSource      <- File_Signal_Source / file_source_base.{h,cc}
                           (item-format mapping, byte offset, sample budget,
                           optional repeat) and the packed-capture variants
                           (Two_Bit_Cpx_/Two_Bit_Packed_/Four_Bit_Cpx_
                           File_Signal_Source) via the ``format`` field
- MultichannelFileSignalSource <- Multichannel_File_Signal_Source
- FifoSignalSource      <- Fifo_Signal_Source (blocking pipe reader)
- UdpSignalSource       <- Custom_UDP_Signal_Source (datagram payloads)
- ArraySignalSource     in-memory source for tests/simulation
- Valve                 <- gnss_sdr_valve (libs/gnss_sdr_valve.h): bounds the
                           total sample count and flags completion

Sources yield complex64 numpy chunks; the receiver owns device placement.
Every source tracks ``samples_read`` as the absolute sample counter used for
timestamps downstream (the reference's samplestamp).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.io.formats import bytes_per_sample, decode_samples


class SignalSource:
    """Base streaming source interface (SignalSourceInterface analog)."""

    fs: float = 0.0
    samples_read: int = 0

    def read(self, num_samples: int) -> np.ndarray:
        """Return up to ``num_samples`` complex64 samples ([] at end of stream)."""
        raise NotImplementedError

    def exhausted(self) -> bool:
        raise NotImplementedError

    def get_rf_channels(self) -> int:
        return 1


@dataclass
class FileMeta:
    path: str
    format: str = "ibyte"
    fs: float = 4e6
    offset_bytes: int = 0
    total_samples: int | None = None   # valve budget; None = whole file
    repeat: bool = False


class FileSignalSource(SignalSource):
    """Streaming file capture reader with format decode.

    Config-compatible semantics with the reference File_Signal_Source:
    ``samples`` bounds the output (0/None = play the file), ``seconds_to_skip``
    maps to offset_bytes, unknown/short reads end the stream.
    """

    def __init__(self, meta: FileMeta) -> None:
        self.meta = meta
        self.fs = meta.fs
        self._bps = bytes_per_sample(meta.format)
        self._f = open(meta.path, "rb")
        self._f.seek(meta.offset_bytes)
        self._eof = False
        size = os.path.getsize(meta.path) - meta.offset_bytes
        file_samples = int(size / self._bps)
        self.total_samples = (
            min(meta.total_samples, file_samples)
            if (meta.total_samples and not meta.repeat)
            else (meta.total_samples or file_samples)
        )

    def read(self, num_samples: int) -> np.ndarray:
        if self.exhausted():
            return np.zeros(0, dtype=np.complex64)
        num_samples = min(num_samples, self.total_samples - self.samples_read)
        # round a packed-format request up to whole bytes
        nbytes = int(np.ceil(num_samples * self._bps))
        raw = self._f.read(nbytes)
        if len(raw) < nbytes:
            if self.meta.repeat:
                while len(raw) < nbytes:
                    self._f.seek(self.meta.offset_bytes)
                    more = self._f.read(nbytes - len(raw))
                    if not more:
                        break
                    raw += more
            if len(raw) < nbytes:
                self._eof = True
        x = decode_samples(raw, self.meta.format)[:num_samples]
        self.samples_read += len(x)
        return x

    def exhausted(self) -> bool:
        return self._eof or self.samples_read >= self.total_samples

    def close(self) -> None:
        self._f.close()


class MultichannelFileSignalSource(SignalSource):
    """N coherent RF channels from N files (Multichannel_File_Signal_Source).

    ``read`` returns a [n_channels, N] array; channels advance in lockstep.
    """

    def __init__(self, metas: list[FileMeta]) -> None:
        self.sources = [FileSignalSource(m) for m in metas]
        self.fs = self.sources[0].fs

    def get_rf_channels(self) -> int:
        return len(self.sources)

    def read(self, num_samples: int) -> np.ndarray:
        chunks = [s.read(num_samples) for s in self.sources]
        n = min(len(c) for c in chunks)
        self.samples_read += n
        return np.stack([c[:n] for c in chunks])

    def exhausted(self) -> bool:
        return any(s.exhausted() for s in self.sources)


class ArraySignalSource(SignalSource):
    """In-memory source over a precomputed array (tests/simulator)."""

    def __init__(self, samples: np.ndarray, fs: float) -> None:
        self._x = np.asarray(samples, dtype=np.complex64)
        self.fs = fs

    def read(self, num_samples: int) -> np.ndarray:
        x = self._x[self.samples_read : self.samples_read + num_samples]
        self.samples_read += len(x)
        return x

    def exhausted(self) -> bool:
        return self.samples_read >= len(self._x)


class GeneratorSignalSource(SignalSource):
    """Synthesized multi-satellite source (reference SignalGenerator block,
    signal_generator/gnuradio_blocks/signal_generator_c.cc): streams the
    framework's own simulator output as a SignalSource, for closed-loop
    tests without a capture file."""

    def __init__(self, sats, fs: float, total_samples: int,
                 noise: bool = True, seed: int = 0,
                 chunk: int = 1 << 20) -> None:
        from gnss_sdr_tpu_torch.simulate import generate_baseband

        self._gen = generate_baseband
        self.sats = sats
        self.fs = fs
        self.total_samples = total_samples
        self.noise = noise
        self.seed = seed

    def read(self, num_samples: int) -> np.ndarray:
        n = min(num_samples, self.total_samples - self.samples_read)
        if n <= 0:
            return np.zeros(0, dtype=np.complex64)
        t0 = self.samples_read / self.fs
        # per-chunk seed keeps the stream deterministic under any chunking
        x = self._gen(self.sats, self.fs, n, noise=self.noise,
                      seed=self.seed + self.samples_read, t0=t0)
        self.samples_read += n
        return x

    def exhausted(self) -> bool:
        return self.samples_read >= self.total_samples


class FifoSignalSource(SignalSource):
    """Blocking FIFO/pipe reader (Fifo_Signal_Source analog)."""

    def __init__(self, path: str, fmt: str = "ishort", fs: float = 4e6) -> None:
        self.fs = fs
        self._fmt = fmt
        self._bps = bytes_per_sample(fmt)
        self._f = open(path, "rb")
        self._eof = False

    def read(self, num_samples: int) -> np.ndarray:
        nbytes = int(np.ceil(num_samples * self._bps))
        raw = self._f.read(nbytes)
        if not raw:
            self._eof = True
            return np.zeros(0, dtype=np.complex64)
        x = decode_samples(raw, self._fmt)
        self.samples_read += len(x)
        return x

    def exhausted(self) -> bool:
        return self._eof


class UdpSignalSource(SignalSource):
    """Datagram sample source (Custom_UDP_Signal_Source analog).

    Each datagram payload is decoded with the configured format and appended
    to an internal buffer; ``read`` drains it (non-blocking, returns what has
    arrived).
    """

    def __init__(self, address: str = "127.0.0.1", port: int = 1234,
                 fmt: str = "ishort", fs: float = 4e6,
                 payload_bytes: int = 1472) -> None:
        self.fs = fs
        self._fmt = fmt
        self._payload = payload_bytes
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((address, port))
        self._sock.setblocking(False)
        self._buf = np.zeros(0, dtype=np.complex64)

    def _drain_socket(self) -> None:
        parts = []
        while True:
            try:
                data, _ = self._sock.recvfrom(self._payload)
            except BlockingIOError:
                break
            if data:
                parts.append(decode_samples(data, self._fmt))
        if parts:
            self._buf = np.concatenate([self._buf] + parts)

    def read(self, num_samples: int) -> np.ndarray:
        self._drain_socket()
        x = self._buf[:num_samples]
        self._buf = self._buf[len(x):]
        self.samples_read += len(x)
        return x

    def exhausted(self) -> bool:
        return False

    def close(self) -> None:
        self._sock.close()


class Valve:
    """Sample-count limiter that flags flowgraph completion
    (gnss_sdr_valve analog: open until ``total_samples`` have passed)."""

    def __init__(self, total_samples: int) -> None:
        self.total_samples = total_samples
        self.passed = 0
        self.done = False

    def apply(self, chunk: np.ndarray) -> np.ndarray:
        room = self.total_samples - self.passed
        out = chunk[: max(room, 0)]
        self.passed += len(out)
        if self.passed >= self.total_samples:
            self.done = True
        return out


@dataclass
class TimeTag:
    """Absolute GPS time tag attached at a stream sample index
    (Gnss_Sdr_Timestamp record: libs/gnss_sdr_timestamp.cc:52-64)."""

    sample_index: int
    week: int
    tow_ms: int
    tow_ms_fraction: float = 0.0


class TimestampedFileSignalSource(FileSignalSource):
    """File source paired with a binary timetag metadata file
    (File_Timestamp_Signal_Source analog,
    adapters/file_timestamp_signal_source.cc:37-38 +
    libs/gnss_sdr_timestamp.cc).

    The timetag file is a sequence of packed little-endian records
    ``(uint64 samplecount, int32 week, int32 tow_ms)``; samplecount is in
    *complex samples* for every item type — the reference tags file item
    ``samplecount * items_to_samples`` (2 items/sample for interleaved real
    formats, gnss_sdr_timestamp.cc:114), which is stream sample
    ``samplecount`` again after deinterleaving. ``clock_offset_ms`` shifts
    UTC-stamped tags onto GPS time; the integer part lands in ``tow_ms`` and
    the remainder in ``tow_ms_fraction`` (gnss_sdr_timestamp.cc:37,119-121).

    ``timetag_for(sample_index)`` returns the most recent tag at or before the
    absolute sample index, re-anchored to that index, so observables can pin
    the receiver clock to absolute GPS time.
    """

    def __init__(self, meta: FileMeta, timestamp_path: str,
                 clock_offset_ms: float = 0.0) -> None:
        super().__init__(meta)
        self._tags: list[TimeTag] = []
        int_ms = int(clock_offset_ms // 1)
        frac_ms = clock_offset_ms - int_ms
        rec = np.dtype([("count", "<u8"), ("week", "<i4"), ("tow_ms", "<i4")])
        raw = np.fromfile(timestamp_path, dtype=rec)
        for r in raw:
            self._tags.append(TimeTag(
                sample_index=int(r["count"]),
                week=int(r["week"]),
                tow_ms=int(r["tow_ms"]) + int_ms,
                tow_ms_fraction=frac_ms,
            ))

    def timetag_for(self, sample_index: int) -> TimeTag | None:
        """Latest tag at/before ``sample_index``, advanced to it at fs."""
        best = None
        for t in self._tags:
            if t.sample_index <= sample_index:
                best = t
            else:
                break
        if best is None:
            return None
        dt_ms = (sample_index - best.sample_index) / self.fs * 1e3
        whole = int(dt_ms)
        frac = best.tow_ms_fraction + (dt_ms - whole)
        if frac >= 1.0:
            whole += 1
            frac -= 1.0
        tow = best.tow_ms + whole
        week = best.week
        if tow >= 604_800_000:
            tow -= 604_800_000
            week += 1
        return TimeTag(sample_index, week, tow, frac)
