# Copied from gnss_sdr_tpu/io/labsat.py; only the package imports are rewritten.
"""LabSat 2 / LabSat 3 capture file source.

Reference analog: src/algorithms/signal_source/gnuradio_blocks/
labsat23_source.cc (Labsat_Signal_Source adapter). Single-channel LS2/LS3
files: an all-zero 8-byte preamble, an 'LS2'/'LS3' version tag, a
little-endian total header length at offset 12, then TLV-ish sections;
section 2 carries {reference clock, bits/sample, channel selector,
quantization, constellations}. Sample data follows the header as int16
words; with 1-bit quantization each word holds 8 complex samples (I at the
even bit from the MSB down, Q below it, 0/1 -> -1/+1), with 2-bit
quantization 4 complex samples (sign bit then magnitude bit, levels
+-1/+-2). LS3 Wideband (.LS3W) multi-RF captures are out of scope here.
"""

from __future__ import annotations

import os

import numpy as np

from gnss_sdr_tpu_torch.io.sources import SignalSource
from gnss_sdr_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

#: LabSat 3 nominal sampling rate (16.368 MHz) — the header does not carry
#: the rate for single-channel files; callers may override.
LS3_DEFAULT_FS = 16.368e6


class LabsatHeaderError(ValueError):
    pass


def parse_labsat_header(blob: bytes) -> dict:
    """Parse the LS2/LS3 file header (first KB of the file)."""
    if len(blob) < 64:
        raise LabsatHeaderError("file too short for a LabSat header")
    if any(blob[i] != 0 for i in range(8)):
        raise LabsatHeaderError("LabSat preamble (8x 0x00) not found")
    tag = blob[8:11]
    if tag == b"LS2":
        version = 2
    elif tag == b"LS3":
        version = 3
    else:
        raise LabsatHeaderError(f"unknown LabSat version tag {tag!r}")
    sub_version = blob[11]
    header_bytes = int.from_bytes(blob[12:16], "little")
    p = 16
    # first section: id (u16 LE) + length (u32 LE)
    section_id = int.from_bytes(blob[p:p + 2], "little")
    p += 6
    if section_id != 2:
        raise LabsatHeaderError(f"expected header section 2, got {section_id}")
    ref_clock = blob[p]
    bits_per_sample = blob[p + 1]     # bits per complex sample (I+Q)
    channel_selector = blob[p + 2]
    quantization = blob[p + 3]
    ch_a_constellation = blob[p + 4]
    ch_b_constellation = blob[p + 5]
    if bits_per_sample not in (2, 4):
        raise LabsatHeaderError(
            f"unsupported LabSat bits/sample {bits_per_sample}")
    if channel_selector == 0:
        raise LabsatHeaderError(
            "dual-channel LabSat files are not supported (select A or B "
            "at record time)")
    if channel_selector not in (1, 2, 3, 4):
        raise LabsatHeaderError(
            f"unknown LabSat channel selector {channel_selector}")
    return {
        "version": version,
        "sub_version": sub_version,
        "header_bytes": header_bytes,
        "ref_clock": ref_clock,
        "bits_per_sample": bits_per_sample,
        "channel_selector": channel_selector,
        "quantization": quantization,
        "channel_a": ch_a_constellation,
        "channel_b": ch_b_constellation,
    }


def decode_labsat_words(words: np.ndarray, bits_per_sample: int) -> np.ndarray:
    """int16 words -> complex64 samples (labsat23_source.cc
    decode_samples_one_channel)."""
    w = words.astype(np.uint16)
    if bits_per_sample == 2:
        # 8 samples per word: I = bit 15-2k, Q = bit 14-2k, 0/1 -> -1/+1
        out = np.empty((w.size, 8), dtype=np.complex64)
        for k in range(8):
            i = ((w >> (15 - 2 * k)) & 1).astype(np.float32) * 2.0 - 1.0
            q = ((w >> (14 - 2 * k)) & 1).astype(np.float32) * 2.0 - 1.0
            out[:, k] = i + 1j * q
        return out.reshape(-1)
    # 4 samples per word: per component sign bit then magnitude bit;
    # 00 -> +1, 01 -> +2, 10 -> -2, 11 -> -1
    lut = np.array([1.0, 2.0, -2.0, -1.0], dtype=np.float32)
    out = np.empty((w.size, 4), dtype=np.complex64)
    for k in range(4):
        iv = lut[((w >> (15 - 4 * k)) & 1) * 2 + ((w >> (13 - 4 * k)) & 1)]
        qv = lut[((w >> (14 - 4 * k)) & 1) * 2 + ((w >> (12 - 4 * k)) & 1)]
        out[:, k] = iv + 1j * qv
    return out.reshape(-1)


def encode_labsat_file(x: np.ndarray, bits_per_sample: int = 2,
                       channel: str = "A") -> bytes:
    """Build a minimal valid LS3 file around ``x`` (for tests/tools)."""
    spw = 8 if bits_per_sample == 2 else 4
    pad = (-x.size) % spw
    xv = np.concatenate([np.asarray(x).reshape(-1),
                         np.zeros(pad, np.complex64)])
    w = np.zeros(xv.size // spw, dtype=np.uint16)
    if bits_per_sample == 2:
        for k in range(spw):
            w |= (xv[k::spw].real > 0).astype(np.uint16) << (15 - 2 * k)
            w |= (xv[k::spw].imag > 0).astype(np.uint16) << (14 - 2 * k)
        selector = 1 if channel == "A" else 2
    else:
        inv = np.array([0b00, 0b01, 0b11, 0b10], dtype=np.uint16)  # 1,2,-1,-2

        def enc(v):
            lv = np.clip(np.round(np.abs(v)), 1, 2).astype(np.int64)
            neg = (v < 0).astype(np.int64)
            return inv[(lv - 1) + 2 * neg]

        for k in range(spw):
            iv = enc(xv[k::spw].real)
            qv = enc(xv[k::spw].imag)
            w |= ((iv >> 1) & 1).astype(np.uint16) << (15 - 4 * k)
            w |= (iv & 1).astype(np.uint16) << (13 - 4 * k)
            w |= ((qv >> 1) & 1).astype(np.uint16) << (14 - 4 * k)
            w |= (qv & 1).astype(np.uint16) << (12 - 4 * k)
        selector = 3 if channel == "A" else 4
    header_bytes = 64
    hdr = bytearray(header_bytes)
    hdr[8:11] = b"LS3"
    hdr[11] = 1
    hdr[12:16] = header_bytes.to_bytes(4, "little")
    hdr[16:18] = (2).to_bytes(2, "little")       # section id
    hdr[18:22] = (16).to_bytes(4, "little")      # section length
    hdr[22] = 0                                   # ref clock: OCXO
    hdr[23] = bits_per_sample
    hdr[24] = selector
    hdr[25] = bits_per_sample // 2
    hdr[26] = 0                                   # channel A: GPS
    hdr[27] = 255                                 # no channel B
    return bytes(hdr) + w.tobytes()


class LabsatSignalSource(SignalSource):
    """Streaming LS2/LS3 single-channel file reader (Labsat_Signal_Source)."""

    def __init__(self, path: str, fs: float = LS3_DEFAULT_FS) -> None:
        self.fs = fs
        self._f = open(path, "rb")
        head = self._f.read(1024)
        self.header = parse_labsat_header(head)
        # selector 1/2 -> 1-bit I&Q pairs (bits_per_sample field 2);
        # 3/4 -> 2-bit I&Q pairs (field 4)
        self.bits = 2 if self.header["channel_selector"] in (1, 2) else 4
        self._spw = 8 if self.bits == 2 else 4
        self._f.seek(self.header["header_bytes"])
        size = os.path.getsize(path) - self.header["header_bytes"]
        self.total_samples = (size // 2) * self._spw
        self._eof = False
        log.info("LabSat v%d capture: %d bits/sample, %d samples",
                 self.header["version"], self.header["bits_per_sample"],
                 self.total_samples)

    def read(self, num_samples: int) -> np.ndarray:
        pend = getattr(self, "_pending", np.zeros(0, np.complex64))
        if self._eof and len(pend) == 0:
            return np.zeros(0, dtype=np.complex64)
        need = num_samples - len(pend)
        if need > 0 and not self._eof:
            n_words = int(np.ceil(need / self._spw))
            raw = self._f.read(2 * n_words)
            if len(raw) < 2 * n_words:
                self._eof = True
                raw = raw[: 2 * (len(raw) // 2)]
            words = np.frombuffer(raw, dtype=np.uint16)
            pend = np.concatenate(
                [pend, decode_labsat_words(words, self.bits)])
        x, self._pending = pend[:num_samples], pend[num_samples:]
        self.samples_read += len(x)
        return x

    def exhausted(self) -> bool:
        return self._eof or self.samples_read >= self.total_samples

    def close(self) -> None:
        self._f.close()
