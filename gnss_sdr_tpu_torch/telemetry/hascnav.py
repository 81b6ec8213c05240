# Copied from gnss_sdr_tpu/telemetry/hascnav.py; only the package imports are rewritten.
"""Galileo E6-B CNAV / HAS page codec and message assembler.

Reference analogs: galileo_cnav_message.cc (page CRC + HAS header parse),
galileo_telemetry_decoder_gs.cc E6 branch (sync + deinterleave + Viterbi)
and core/libs/galileo_e6_has_msg_receiver.cc (message assembly).

Page (1 s, 1000 symbols; HAS SIS ICD 1.0 §4):
  16-symbol sync pattern + 984 coded symbols
  -> block-deinterleave (123 cols x 8 rows)
  -> rate-1/2 K=7 Viterbi (G2 inverted, as all Galileo FEC)
  -> 492 bits = 448 HAS data + 14 reserved + 24 CRC-24Q + 6 tail.

HAS data = 24-bit page header (status 2, reserved 2, message type 2,
message id 5, message size 5, page id 8) + 424 message bits (53 octets).
A message of size MS pages is protected by the RS(255, 32) outer code
vertically (each page carries one 53-octet column); the assembler here
recovers the message from the systematic pages (page ids 1..MS), which is
complete for a clean link; erasure decoding of parity pages can ride the
telemetry/reed_solomon.py codec later."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.constants.galileo_e6 import (
    BITS_FOR_CRC,
    INTERLEAVER_COLS,
    INTERLEAVER_ROWS,
    PAGE_DATA_BITS,
    SYMBOLS_PER_PAGE,
    SYNC_PATTERN,
)
from gnss_sdr_tpu_torch.telemetry.fec import (
    block_deinterleave,
    block_interleave,
    conv_encode,
    crc24q,
    viterbi_decode,
)

SYNC = np.array([1.0 if c == "1" else -1.0 for c in SYNC_PATTERN])
_CODED = SYMBOLS_PER_PAGE - len(SYNC_PATTERN)        # 984


def encode_page(has_bits448: np.ndarray) -> np.ndarray:
    """448 HAS data bits -> 1000 transmitted symbol levels (+-1)."""
    bits = np.zeros(492, dtype=np.uint8)
    bits[:PAGE_DATA_BITS] = np.asarray(has_bits448, np.uint8)
    crc = crc24q(bits[:BITS_FOR_CRC])
    bits[462:486] = [(crc >> (23 - i)) & 1 for i in range(24)]
    # 486..492: tail zeros
    coded = conv_encode(bits, invert_g2=True)        # 984
    inter = block_interleave(coded, cols=INTERLEAVER_COLS,
                             rows=INTERLEAVER_ROWS)
    return np.concatenate([SYNC, 1.0 - 2.0 * inter.astype(np.float64)])


def decode_page(symbols: np.ndarray) -> np.ndarray | None:
    """1000 soft symbol levels -> 448 HAS bits, or None (CRC/sync fail)."""
    s = np.asarray(symbols, dtype=np.float64)
    if len(s) != SYMBOLS_PER_PAGE:
        return None
    if float(s[:16] @ SYNC) < 12.0:
        return None
    deinter = block_deinterleave(s[16:], cols=INTERLEAVER_COLS,
                                 rows=INTERLEAVER_ROWS)
    bits = viterbi_decode(deinter, invert_g2=True, soft=True)
    crc = 0
    for b in bits[462:486]:
        crc = (crc << 1) | int(b)
    if crc24q(bits[:BITS_FOR_CRC]) != crc:
        return None
    return bits[:PAGE_DATA_BITS]


# ----------------------------------------------------------------- header
def build_has_header(status: int, mt: int, mid: int, ms: int,
                     pid: int) -> np.ndarray:
    h = np.zeros(24, dtype=np.uint8)
    def put(pos, n, v):
        for i in range(n):
            h[pos + i] = (v >> (n - 1 - i)) & 1
    put(0, 2, status)
    put(2, 2, 0)
    put(4, 2, mt)
    put(6, 5, mid)
    put(11, 5, ms)
    put(16, 8, pid)
    return h


def parse_has_header(bits24: np.ndarray) -> dict:
    b = np.asarray(bits24, np.uint8)
    def take(pos, n):
        v = 0
        for i in range(n):
            v = (v << 1) | int(b[pos + i])
        return v
    return {"status": take(0, 2), "mt": take(4, 2), "mid": take(6, 5),
            "ms": take(11, 5), "pid": take(16, 8)}


# -------------------------------------------------------------- assembler
@dataclass
class HasMessage:
    mid: int
    data: np.ndarray          # [ms * 424] message bits


class HasAssembler:
    """Collect pages per message id; emit once the systematic set
    (pids 1..ms) is complete (galileo_e6_has_msg_receiver analog)."""

    def __init__(self) -> None:
        self._pages: dict[int, dict[int, np.ndarray]] = {}
        self._ms: dict[int, int] = {}
        self.messages: list[HasMessage] = []

    def push_page(self, has_bits448: np.ndarray) -> HasMessage | None:
        hdr = parse_has_header(has_bits448[:24])
        if hdr["mt"] != 1 or hdr["ms"] == 0:
            return None
        mid = hdr["mid"]
        self._ms[mid] = hdr["ms"]
        book = self._pages.setdefault(mid, {})
        book[hdr["pid"]] = np.asarray(has_bits448[24:], np.uint8)
        ms = self._ms[mid]
        if all(p in book for p in range(1, ms + 1)):
            data = np.concatenate([book[p] for p in range(1, ms + 1)])
            msg = HasMessage(mid=mid, data=data)
            self.messages.append(msg)
            del self._pages[mid]
            return msg
        return None


class CnavStreamDecoder:
    """Symbol-stream wrapper for the tracker interface: E6-B symbols at
    1000 sps, page sync by the 16-symbol pattern, one event per CRC-clean
    page. Interface-compatible with the other telemetry decoders (no
    ephemeris: E6 is a data channel; PVT runs off E1/E5)."""

    def __init__(self, prn: int) -> None:
        self.prn = prn
        self._hist: list[float] = []
        self._stamps: list[int] = []
        self._synced = False
        self._flip = 1.0
        self.pages_ok = 0
        self.pages_bad = 0
        self.assembler = HasAssembler()
        self.eph = None

    def push_symbols(self, signs: np.ndarray, stamps: np.ndarray) -> list[dict]:
        self._hist.extend(float(x) for x in signs)
        self._stamps.extend(int(x) for x in stamps)
        events: list[dict] = []
        while True:
            if not self._synced:
                if len(self._hist) < SYMBOLS_PER_PAGE + 16:
                    return events
                h = np.asarray(self._hist)
                corr = np.correlate(h[: SYMBOLS_PER_PAGE + 16], SYNC)
                hits = np.flatnonzero(np.abs(corr) >= 15.0)
                if len(hits) == 0:
                    self._hist = self._hist[-32:]
                    self._stamps = self._stamps[-32:]
                    return events
                i = int(hits[0])
                self._flip = float(np.sign(corr[i]))
                self._hist = self._hist[i:]
                self._stamps = self._stamps[i:]
                self._synced = True
            if len(self._hist) < SYMBOLS_PER_PAGE:
                return events
            page = np.asarray(self._hist[:SYMBOLS_PER_PAGE]) * self._flip
            stamp = self._stamps[SYMBOLS_PER_PAGE - 1]
            del self._hist[:SYMBOLS_PER_PAGE]
            del self._stamps[:SYMBOLS_PER_PAGE]
            bits = decode_page(page)
            if bits is None:
                self.pages_bad += 1
                self._synced = False
                continue
            self.pages_ok += 1
            msg = self.assembler.push_page(bits)
            events.append({
                "has_page": parse_has_header(bits[:24]),
                "has_message_complete": msg is not None,
                "sample_stamp": int(stamp),
                "tow_s": None,
                "ephemeris_complete": False,
            })
        return events
