# Copied from gnss_sdr_tpu/telemetry/inav.py; only the package imports are rewritten.
"""Galileo E1-B I/NAV navigation message: page sync, FEC, word parsing.

Structure (Galileo OS SIS ICD §4.3): the E1-B stream at 250 sym/s carries
nominal pages of 2 s, split into an even (1 s) and odd (1 s) part. Each part
is 10 sync symbols (0101100000) + 240 coded symbols; the 240 symbols are a
30x8 block interleaving of the rate-1/2 K=7 convolutionally-encoded 120-bit
part (114 data + 6 tail). Even part: even/odd(1)=0, page type(1), data(112).
Odd part: even/odd(1)=1, page type(1), data(16), OSNMA(40), SAR(22),
spare(2), CRC24Q(24), SSP(8). The CRC covers the 196 bits from the even
part's first bit through the odd part's spare field.

A 128-bit word (112 even + 16 odd data bits) carries word types 1-5 with
clock/ephemeris/iono/GST (parsed in `parse_word`, scalings per ICD Tables
57-75).

Reference analog: galileo_telemetry_decoder_gs.cc (deinterleave + Viterbi +
CRC24) and core/system_parameters/galileo_inav_message.cc (word parsing).
`InavEncoder` is the simulator-side inverse (the reference uses the external
gnss-sim generator instead).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.telemetry.fec import (
    block_deinterleave,
    block_interleave,
    conv_encode,
    crc24q,
    viterbi_decode,
)

PREAMBLE = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], dtype=np.int8)
PART_SYMBOLS = 250          # 10 preamble + 240 coded
PAGE_SECONDS = 2.0
SYMBOL_SECONDS = 0.004


@dataclass
class GalileoEphemeris:
    """Galileo clock + ephemeris (I/NAV words 1-4 + BGD from word 5).

    Field names match GpsEphemeris so pvt.ephemeris.eph_to_pos_vel_clock
    propagates either (with the GTRF mu selected by ``system``).
    Reference analog: core/system_parameters/galileo_ephemeris.h.
    """

    prn: int = 0
    system: str = "E"
    week: int = 0               # Galileo System Time week
    iod_nav: int = -1
    toe: float = 0.0
    toc: float = 0.0
    m0: float = 0.0
    ecc: float = 0.0
    sqrt_a: float = 0.0
    omega0: float = 0.0
    i0: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0
    delta_n: float = 0.0
    idot: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    bgd_e1e5a: float = 0.0
    bgd_e1e5b: float = 0.0
    sisa: int = 107
    e1b_hs: int = 0
    e1b_dvs: int = 0

    # decode progress (word types 1-4 received with matching IODnav)
    has_w1: bool = False
    has_w2: bool = False
    has_w3: bool = False
    has_w4: bool = False

    @property
    def tgd(self) -> float:
        """Group delay applicable to single-frequency E1 (BGD E1/E5b is the
        E1B broadcast convention used by the solver's tgd hook)."""
        return self.bgd_e1e5b

    @property
    def complete(self) -> bool:
        return self.has_w1 and self.has_w2 and self.has_w3 and self.has_w4


@dataclass
class GalileoIono:
    """NeQuick-G broadcast coefficients (word 5)."""

    ai0: float = 0.0
    ai1: float = 0.0
    ai2: float = 0.0


# ------------------------------------------------------------- bit utilities
def _u(bits: np.ndarray, pos: int, n: int) -> int:
    v = 0
    for b in bits[pos : pos + n]:
        v = (v << 1) | int(b)
    return v


def _s(bits: np.ndarray, pos: int, n: int) -> int:
    v = _u(bits, pos, n)
    if v >= 1 << (n - 1):
        v -= 1 << n
    return v


def _put(bits: np.ndarray, pos: int, n: int, value: int) -> None:
    v = int(value) & ((1 << n) - 1)
    for k in range(n):
        bits[pos + n - 1 - k] = (v >> k) & 1


SEMI = np.pi  # semicircles -> radians


# ------------------------------------------------------------- word parsing
def parse_word(word: np.ndarray, eph: GalileoEphemeris,
               iono: GalileoIono) -> dict:
    """Parse one 128-bit I/NAV word into eph/iono; returns event info
    (word type, and TOW/WN when present)."""
    wt = _u(word, 0, 6)
    ev: dict = {"word_type": wt}
    if wt == 1:
        iod = _u(word, 6, 10)
        if eph.iod_nav not in (-1, iod):
            _reset_eph(eph)
        eph.iod_nav = iod
        eph.toe = _u(word, 16, 14) * 60.0
        eph.m0 = _s(word, 30, 32) * 2.0 ** -31 * SEMI
        eph.ecc = _u(word, 62, 32) * 2.0 ** -33
        eph.sqrt_a = _u(word, 94, 32) * 2.0 ** -19
        eph.has_w1 = True
    elif wt == 2:
        iod = _u(word, 6, 10)
        if eph.iod_nav not in (-1, iod):
            _reset_eph(eph)
        eph.iod_nav = iod
        eph.omega0 = _s(word, 16, 32) * 2.0 ** -31 * SEMI
        eph.i0 = _s(word, 48, 32) * 2.0 ** -31 * SEMI
        eph.omega = _s(word, 80, 32) * 2.0 ** -31 * SEMI
        eph.idot = _s(word, 112, 14) * 2.0 ** -43 * SEMI
        eph.has_w2 = True
    elif wt == 3:
        iod = _u(word, 6, 10)
        if eph.iod_nav not in (-1, iod):
            _reset_eph(eph)
        eph.iod_nav = iod
        eph.omega_dot = _s(word, 16, 24) * 2.0 ** -43 * SEMI
        eph.delta_n = _s(word, 40, 16) * 2.0 ** -43 * SEMI
        eph.cuc = _s(word, 56, 16) * 2.0 ** -29
        eph.cus = _s(word, 72, 16) * 2.0 ** -29
        eph.crc = _s(word, 88, 16) * 2.0 ** -5
        eph.crs = _s(word, 104, 16) * 2.0 ** -5
        eph.sisa = _u(word, 120, 8)
        eph.has_w3 = True
    elif wt == 4:
        iod = _u(word, 6, 10)
        if eph.iod_nav not in (-1, iod):
            _reset_eph(eph)
        eph.iod_nav = iod
        eph.prn = _u(word, 16, 6)
        eph.cic = _s(word, 22, 16) * 2.0 ** -29
        eph.cis = _s(word, 38, 16) * 2.0 ** -29
        eph.toc = _u(word, 54, 14) * 60.0
        eph.af0 = _s(word, 68, 31) * 2.0 ** -34
        eph.af1 = _s(word, 99, 21) * 2.0 ** -46
        eph.af2 = _s(word, 120, 6) * 2.0 ** -59
        eph.has_w4 = True
    elif wt == 5:
        iono.ai0 = _u(word, 6, 11) * 2.0 ** -2
        iono.ai1 = _s(word, 17, 11) * 2.0 ** -8
        iono.ai2 = _s(word, 28, 14) * 2.0 ** -15
        eph.bgd_e1e5a = _s(word, 47, 10) * 2.0 ** -32
        eph.bgd_e1e5b = _s(word, 57, 10) * 2.0 ** -32
        eph.e1b_hs = _u(word, 69, 2)
        eph.e1b_dvs = _u(word, 72, 1)
        eph.week = _u(word, 73, 12)
        ev["wn"] = eph.week
        ev["tow_s"] = float(_u(word, 85, 20))
    elif wt == 16:
        # Reduced Clock and Ephemeris Data (Galileo ICD 2.0 Table 38;
        # reference galileo_inav_message.cc:1232-1259 case 16)
        ev["reduced_ced"] = {
            "delta_a_red": _s(word, 6, 5) * 2.0 ** 8,
            "ex_red": _s(word, 11, 13) * 2.0 ** -22,
            "ey_red": _s(word, 24, 13) * 2.0 ** -22,
            "delta_i0_red": _s(word, 37, 17) * 2.0 ** -22,
            "omega0_red": _s(word, 54, 23) * 2.0 ** -22,
            "lambda0_red": _s(word, 77, 23) * 2.0 ** -22,
            "af0_red": _s(word, 100, 22) * 2.0 ** -26,
            "af1_red": _s(word, 122, 6) * 2.0 ** -35,
        }
    return ev


# ----------------------------------------------------------- reduced CED
@dataclass
class GalileoReducedCed:
    """Word type 16 reduced CED -> full ephemeris expansion (reference
    galileo_reduced_ced.cc:22 compute_eph, ICD 2.0 Table 1 nominals)."""

    prn: int = 0
    iod_nav: int = 0
    tot_red_ced: float = 0.0          # GST seconds (WN*604800 + TOW)
    delta_a_red: float = 0.0
    ex_red: float = 0.0
    ey_red: float = 0.0
    delta_i0_red: float = 0.0
    omega0_red: float = 0.0
    lambda0_red: float = 0.0
    af0_red: float = 0.0
    af1_red: float = 0.0

    def compute_eph(self) -> GalileoEphemeris:
        import math

        eph = GalileoEphemeris(prn=self.prn)
        a_nominal = 29600000.0                    # m
        i_nominal = 56.0                          # deg
        eph.sqrt_a = math.sqrt(self.delta_a_red + a_nominal)
        eph.i0 = (self.delta_i0_red + i_nominal / 180.0) * math.pi
        eph.ecc = math.hypot(self.ex_red, self.ey_red)
        eph.omega = math.atan2(self.ey_red, self.ex_red)
        eph.m0 = self.lambda0_red * math.pi - eph.omega
        eph.omega0 = self.omega0_red * math.pi
        eph.iod_nav = self.iod_nav
        t0r = (30 * (int(self.tot_red_ced) // 30) + 1) % 604800
        eph.toe = float(t0r)
        eph.toc = float(t0r)
        eph.af0 = self.af0_red
        eph.af1 = self.af1_red
        eph.week = int(self.tot_red_ced) // 604800
        eph.has_w1 = eph.has_w2 = eph.has_w3 = eph.has_w4 = True
        return eph


def _reset_eph(eph: GalileoEphemeris) -> None:
    eph.has_w1 = eph.has_w2 = eph.has_w3 = eph.has_w4 = False
    eph.iod_nav = -1


# ------------------------------------------------------------ page encoding
def _encode_part(part_bits: np.ndarray) -> np.ndarray:
    """120 part bits (incl 6 tail zeros) -> 250 transmitted symbols."""
    coded = conv_encode(part_bits, invert_g2=True)         # 240
    inter = block_interleave(coded)
    return np.concatenate([PREAMBLE, inter]).astype(np.int8)


def build_page(word: np.ndarray,
               osnma40: np.ndarray | None = None) -> np.ndarray:
    """One 128-bit word -> 500 symbols (even + odd part, CRC appended).

    ``osnma40``: the odd part's 40-bit OSNMA field (8 HKROOT + 32 MACK
    bits per page, OSNMA ICD §3.1); zero-filled when absent. SAR/SSP stay
    zero-filled.
    """
    even = np.zeros(120, dtype=np.uint8)
    odd = np.zeros(120, dtype=np.uint8)
    even[0] = 0                       # even/odd
    even[1] = 0                       # page type: nominal
    even[2:114] = word[:112]
    odd[0] = 1
    odd[1] = 0
    odd[2:18] = word[112:128]
    if osnma40 is not None:
        odd[18:58] = np.asarray(osnma40, dtype=np.uint8)
    # CRC over even[0:114] + odd[0:82] (through the spare field)
    crc_bits = np.concatenate([even[:114], odd[:82]])
    crc = crc24q(crc_bits)
    _put(odd, 82, 24, crc)
    return np.concatenate([_encode_part(even), _encode_part(odd)])


class InavDecoder:
    """Streaming E1-B I/NAV decoder: feed per-symbol signs, get events.

    Symbol alignment follows the reference telemetry decoder: correlate the
    sign history with the preamble (both polarities), then lock to the 250-
    symbol part cadence.
    """

    def __init__(self, prn: int) -> None:
        self.prn = prn
        self.eph = GalileoEphemeris(prn=prn)
        self.iono = GalileoIono()
        self._hist: list[float] = []
        self._stamps: list[int] = []
        self._synced = False
        self._flip = 1.0
        self._even_bits: np.ndarray | None = None
        self.pages_ok = 0
        self.pages_bad = 0
        # per-page OSNMA fields (odd part bits 18..58) for the OSNMA
        # engine: (page_end_stamp, 40 bits) per CRC-clean page
        self.osnma_fields: list[tuple[int, np.ndarray]] = []
        # FEC2 Reed-Solomon CED (ICD 2.0; reference
        # galileo_inav_message.cc:240-347): 58 info + 60 parity octets
        # from words 1-4 / 17-20; any 4 of the 8 pages recover the CED
        self.rs_enabled = False
        self._rs_buffer = np.zeros(118, dtype=np.int64)
        self._rs_pages = [0] * 8
        self._rs_iodnav = 0
        self.ced_from_rs = False
        # word type 16 reduced CED
        self.reduced_ced: GalileoReducedCed | None = None
        self._last_wn_tow: tuple[int, float] | None = None

    def enable_reed_solomon(self) -> None:
        """Enable FEC2 erasure assembly of the CED (reference
        galileo_inav_message.h:270 enable_reed_solomon, config
        TelemetryDecoder_1B.enable_reed_solomon)."""
        self.rs_enabled = True

    _RS = None

    @classmethod
    def _rs_codec(cls):
        if cls._RS is None:
            from gnss_sdr_tpu_torch.telemetry.reed_solomon import ReedSolomon

            # RS(255,195) fcr=195 (reference galileo_inav_message.cc:42)
            cls._RS = ReedSolomon(nroots=60, min_poly=29, prim=1, fcr=195)
        return cls._RS

    def _rs_reset(self, iod: int) -> None:
        self._rs_iodnav = iod
        self._rs_buffer[:] = 0
        self._rs_pages = [0] * 8

    def _rs_collect(self, wt: int, word: np.ndarray) -> None:
        """Fill the RS buffer from a CED info or parity word (reference
        galileo_inav_message.cc:850-1010 / :1261-1350 octet maps)."""
        buf = self._rs_buffer
        if 1 <= wt <= 4:
            iod = _u(word, 6, 10)
            if self._rs_iodnav == 0:
                self._rs_iodnav = iod
            if self._rs_iodnav != iod:
                self._rs_reset(iod)
            buf[0] = 4 + self._rs_iodnav % 4       # always known (c_{0,0})
            if wt == 1:
                buf[1] = _u(word, 6, 8)            # IODnav 8 MSBs
                for k in range(14):
                    buf[2 + k] = _u(word, 16 + 8 * k, 8)
            else:
                base = {2: 16, 3: 30, 4: 44}[wt]
                for k in range(14):
                    buf[base + k] = _u(word, 16 + 8 * k, 8)
            self._rs_pages[wt - 1] = 1
        else:                                      # wt in 17..20
            iod_lsb = _u(word, 14, 2)
            if iod_lsb != self._rs_iodnav % 4:
                # IODnav changed: the stored info pages are stale
                self._rs_pages[0:4] = [0, 0, 0, 0]
            base = 58 + (wt - 17) * 15
            buf[base] = _u(word, 6, 8)
            for k in range(14):
                buf[base + 1 + k] = _u(word, 16 + 8 * k, 8)
            self._rs_pages[4 + (wt - 17)] = 1

    def _rs_try_assemble(self) -> bool:
        """4 pages in: erasure-decode and parse the regenerated words."""
        if sum(self._rs_pages) != 4 or self.eph.complete:
            return False
        buf = self._rs_buffer
        u = np.zeros(255, dtype=np.int64)
        u[0:58] = buf[0:58]
        u[195:255] = buf[58:118]
        erasures: list[int] = []
        spans = [(1, 16), (16, 30), (30, 44), (44, 58)]
        for i, (a, b) in enumerate(spans):
            if not self._rs_pages[i]:
                erasures.extend(range(a, b))       # buf[0] always known
        for j in range(4):
            if not self._rs_pages[4 + j]:
                erasures.extend(range(195 + 15 * j, 195 + 15 * (j + 1)))
        dec, n = self._rs_codec().decode(u, erasure_pos=erasures)
        if dec is None:
            return False
        # the corrected buffer carries the authoritative IODnav
        # (8 MSBs in octet 1, 2 LSBs in octet 0)
        iod = (int(dec[1]) << 2) | (int(dec[0]) & 3)
        for wt in range(1, 5):
            if self._rs_pages[wt - 1]:
                continue
            w = np.zeros(128, dtype=np.uint8)
            _put(w, 0, 6, wt)
            _put(w, 6, 10, iod)
            base = {1: 2, 2: 16, 3: 30, 4: 44}[wt]
            for k in range(14):
                _put(w, 16 + 8 * k, 8, int(dec[base + k]))
            parse_word(w, self.eph, self.iono)
        self._rs_pages = [0] * 8
        self.ced_from_rs = True
        return True

    def push_symbols(self, signs: np.ndarray, stamps: np.ndarray) -> list[dict]:
        """signs: prompt-correlation signs (+-1) at 250 sym/s; stamps:
        absolute sample stamp of each symbol end. Returns TOW events:
        {'tow_s', 'wn', 'sample_stamp', 'ephemeris_complete'}.
        """
        events: list[dict] = []
        self._hist.extend(float(s) for s in signs)
        self._stamps.extend(int(s) for s in stamps)
        pre = 1.0 - 2.0 * PREAMBLE.astype(np.float64)

        while True:
            if not self._synced:
                if len(self._hist) < 2 * PART_SYMBOLS + 10:
                    return events
                h = np.asarray(self._hist)
                # find a preamble that repeats one part later (vectorized:
                # one correlation flags candidates, pairs checked in bulk)
                corr = np.correlate(h, pre)        # [len-9]
                limit = len(h) - PART_SYMBOLS - 10
                c0 = corr[:limit]
                c1 = corr[PART_SYMBOLS : PART_SYMBOLS + limit]
                hits = np.flatnonzero(
                    (np.abs(c0) >= 9.0) & (np.abs(c1) >= 9.0)
                    & (np.sign(c0) == np.sign(c1))
                )
                found = int(hits[0]) if len(hits) else -1
                if found >= 0:
                    self._flip = float(np.sign(c0[found]))
                if found < 0:
                    keep = PART_SYMBOLS + 10
                    self._hist = self._hist[-keep:]
                    self._stamps = self._stamps[-keep:]
                    return events
                self._hist = self._hist[found:]
                self._stamps = self._stamps[found:]
                self._synced = True

            if len(self._hist) < PART_SYMBOLS:
                return events
            part = np.asarray(self._hist[:PART_SYMBOLS]) * self._flip
            part_end_stamp = self._stamps[PART_SYMBOLS - 1]
            del self._hist[:PART_SYMBOLS]
            del self._stamps[:PART_SYMBOLS]
            # re-verify the preamble; drop sync when it disappears
            if float(part[:10] @ pre) < 8.0:
                self._synced = False
                self.pages_bad += 1
                self._even_bits = None
                continue
            deinter = block_deinterleave(part[10:])    # soft symbols, +1<=>bit 0
            bits = viterbi_decode(deinter, invert_g2=True, soft=True)
            if bits[0] == 0:                           # even part
                self._even_bits = bits
                continue
            if self._even_bits is None:
                continue
            even, odd = self._even_bits, bits
            self._even_bits = None
            crc_bits = np.concatenate([even[:114], odd[:82]])
            if crc24q(crc_bits) != _u(odd, 82, 24):
                self.pages_bad += 1
                continue
            self.pages_ok += 1
            self.osnma_fields.append(
                (part_end_stamp, odd[18:58].astype(np.uint8)))
            if len(self.osnma_fields) > 1024:      # ~34 min of pages
                del self.osnma_fields[:-512]
            word = np.concatenate([even[2:114], odd[2:18]])
            ev = parse_word(word, self.eph, self.iono)
            wt = ev["word_type"]
            if self.rs_enabled and (1 <= wt <= 4 or 17 <= wt <= 20):
                self._rs_collect(wt, word)
                self._rs_try_assemble()
            if "reduced_ced" in ev:
                wn, tow = self._last_wn_tow or (self.eph.week, 0.0)
                self.reduced_ced = GalileoReducedCed(
                    prn=self.prn, iod_nav=max(self.eph.iod_nav, 0),
                    tot_red_ced=wn * 604800.0 + tow + 4.0,
                    **ev["reduced_ced"])
            if "tow_s" in ev:
                self._last_wn_tow = (ev["wn"], ev["tow_s"])
            if "tow_s" in ev:
                # WT5 TOW marks the start of the page's even part; the odd
                # part ends 2 s after that
                events.append({
                    "tow_s": ev["tow_s"] + PAGE_SECONDS,
                    "wn": ev["wn"],
                    "sample_stamp": part_end_stamp,
                    "ephemeris_complete": self.eph.complete,
                })
        return events


class InavEncoder:
    """Simulator-side I/NAV symbol stream generator for one satellite.

    Emits the repeating word schedule 1,2,3,4,5 (one page = 2 s each, so the
    full ephemeris + GST repeats every 10 s), starting at an even-part
    boundary with WT5's TOW field set per page position.
    """

    SCHEDULE = (2, 4, 5, 1, 3)   # WT5 early so TOW/WN resolve fast

    def __init__(self, eph: GalileoEphemeris, iono: GalileoIono | None = None,
                 tow0_s: float = 0.0, osnma_page_bits=None,
                 schedule: tuple | None = None) -> None:
        """``osnma_page_bits``: optional callable page_index -> 40-bit
        OSNMA field (8 HKROOT + 32 MACK bits) riding each odd part.
        ``schedule``: override the word-type cycle (word types 16-20 emit
        the reduced CED and the FEC2 RS parity words)."""
        self.eph = eph
        self.iono = iono or GalileoIono()
        self.tow0 = tow0_s
        self.osnma_page_bits = osnma_page_bits
        if schedule is not None:
            self.SCHEDULE = tuple(schedule)
        self._rs_parity: np.ndarray | None = None

    def _ced_parity(self) -> np.ndarray:
        """FEC2 RS parity octets from words 1-4 (computed once)."""
        if self._rs_parity is None:
            buf = np.zeros(58, dtype=np.int64)
            iod = self.eph.iod_nav
            for wt in range(1, 5):
                w = self._word_bits(wt, 0.0)
                if wt == 1:
                    buf[0] = 4 + iod % 4
                    buf[1] = _u(w, 6, 8)
                    for k in range(14):
                        buf[2 + k] = _u(w, 16 + 8 * k, 8)
                else:
                    base = {2: 16, 3: 30, 4: 44}[wt]
                    for k in range(14):
                        buf[base + k] = _u(w, 16 + 8 * k, 8)
            info = np.zeros(195, dtype=np.int64)
            info[0:58] = buf
            cw = InavDecoder._rs_codec().encode(info)
            self._rs_parity = cw[195:255]
        return self._rs_parity

    def _word_bits(self, wt: int, tow_s: float) -> np.ndarray:
        w = np.zeros(128, dtype=np.uint8)
        _put(w, 0, 6, wt)
        e = self.eph
        if wt == 1:
            _put(w, 6, 10, e.iod_nav)
            _put(w, 16, 14, int(round(e.toe / 60.0)))
            _put(w, 30, 32, int(round(e.m0 / SEMI / 2.0 ** -31)))
            _put(w, 62, 32, int(round(e.ecc / 2.0 ** -33)))
            _put(w, 94, 32, int(round(e.sqrt_a / 2.0 ** -19)))
        elif wt == 2:
            _put(w, 6, 10, e.iod_nav)
            _put(w, 16, 32, int(round(e.omega0 / SEMI / 2.0 ** -31)))
            _put(w, 48, 32, int(round(e.i0 / SEMI / 2.0 ** -31)))
            _put(w, 80, 32, int(round(e.omega / SEMI / 2.0 ** -31)))
            _put(w, 112, 14, int(round(e.idot / SEMI / 2.0 ** -43)))
        elif wt == 3:
            _put(w, 6, 10, e.iod_nav)
            _put(w, 16, 24, int(round(e.omega_dot / SEMI / 2.0 ** -43)))
            _put(w, 40, 16, int(round(e.delta_n / SEMI / 2.0 ** -43)))
            _put(w, 56, 16, int(round(e.cuc / 2.0 ** -29)))
            _put(w, 72, 16, int(round(e.cus / 2.0 ** -29)))
            _put(w, 88, 16, int(round(e.crc / 2.0 ** -5)))
            _put(w, 104, 16, int(round(e.crs / 2.0 ** -5)))
            _put(w, 120, 8, e.sisa)
        elif wt == 4:
            _put(w, 6, 10, e.iod_nav)
            _put(w, 16, 6, e.prn)
            _put(w, 22, 16, int(round(e.cic / 2.0 ** -29)))
            _put(w, 38, 16, int(round(e.cis / 2.0 ** -29)))
            _put(w, 54, 14, int(round(e.toc / 60.0)))
            _put(w, 68, 31, int(round(e.af0 / 2.0 ** -34)))
            _put(w, 99, 21, int(round(e.af1 / 2.0 ** -46)))
            _put(w, 120, 6, int(round(e.af2 / 2.0 ** -59)))
        elif wt == 5:
            _put(w, 6, 11, int(round(self.iono.ai0 / 2.0 ** -2)))
            _put(w, 17, 11, int(round(self.iono.ai1 / 2.0 ** -8)))
            _put(w, 28, 14, int(round(self.iono.ai2 / 2.0 ** -15)))
            _put(w, 47, 10, int(round(e.bgd_e1e5a / 2.0 ** -32)))
            _put(w, 57, 10, int(round(e.bgd_e1e5b / 2.0 ** -32)))
            _put(w, 69, 2, e.e1b_hs)
            _put(w, 72, 1, e.e1b_dvs)
            _put(w, 73, 12, e.week)
            _put(w, 85, 20, int(round(tow_s)))
        elif wt == 16:
            # reduced CED derived from the full ephemeris (ICD Table 38)
            import math

            a_nominal = 29600000.0
            i_nominal = 56.0
            _put(w, 6, 5, int(round(
                (e.sqrt_a ** 2 - a_nominal) / 2.0 ** 8)))
            _put(w, 11, 13, int(round(
                e.ecc * math.cos(e.omega) / 2.0 ** -22)))
            _put(w, 24, 13, int(round(
                e.ecc * math.sin(e.omega) / 2.0 ** -22)))
            _put(w, 37, 17, int(round(
                (e.i0 / math.pi - i_nominal / 180.0) / 2.0 ** -22)))
            _put(w, 54, 23, int(round(e.omega0 / math.pi / 2.0 ** -22)))
            _put(w, 77, 23, int(round(
                (e.m0 + e.omega) / math.pi / 2.0 ** -22)))
            _put(w, 100, 22, int(round(e.af0 / 2.0 ** -26)))
            _put(w, 122, 6, int(round(e.af1 / 2.0 ** -35)))
        elif 17 <= wt <= 20:
            parity = self._ced_parity()
            base = (wt - 17) * 15
            _put(w, 6, 8, int(parity[base]))
            _put(w, 14, 2, e.iod_nav % 4)
            for k in range(14):
                _put(w, 16 + 8 * k, 8, int(parity[base + 1 + k]))
        return w

    def symbols(self, num_pages: int, start_page: int = 0) -> np.ndarray:
        """Symbol stream (0/1) for pages [start_page, start_page+num_pages).

        Page k starts at GST TOW = tow0 + 2k.
        """
        out = []
        for k in range(start_page, start_page + num_pages):
            wt = self.SCHEDULE[k % len(self.SCHEDULE)]
            tow = self.tow0 + PAGE_SECONDS * k
            osnma = (self.osnma_page_bits(k)
                     if self.osnma_page_bits is not None else None)
            out.append(build_page(self._word_bits(wt, tow), osnma))
        return np.concatenate(out)
