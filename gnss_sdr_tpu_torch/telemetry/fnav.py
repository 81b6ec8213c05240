# Copied from gnss_sdr_tpu/telemetry/fnav.py; only the package imports are rewritten.
"""Galileo E5a FNAV message codec (encoder + streaming decoder).

FNAV page (Galileo OS SIS ICD §4.2): 214 information bits (6-bit page type
first) + CRC-24Q + 6 tail bits = 244 bits, rate-1/2 K=7 convolutionally
encoded (G2 inverted) to 488 symbols, block-interleaved 61x8, preceded by
the 12-symbol unencoded preamble 101101110000 — 500 symbols per 10 s page
at 50 sym/s. The page-type schedule repeats 1,2,3,4,5,6 every 50 s; pages
1-4 carry clock+iono / ephemeris 1-3; the TOW field in each page is the GST
at the page's own preamble start (the reference maps it the same way:
galileo_telemetry_decoder_gs.cc FNAV branch, TOW_at_current_symbol =
TOW_at_preamble + n_symbols*20 ms).

Field bit layout per the ICD (the reference carries the same published
positions in core/system_parameters/Galileo_FNAV.h); parser analog:
core/system_parameters/galileo_fnav_message.cc.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.telemetry.fec import (
    block_deinterleave,
    block_interleave,
    conv_encode,
    crc24q,
    viterbi_decode,
)
from gnss_sdr_tpu_torch.telemetry.inav import GalileoEphemeris, GalileoIono, _put, _s, _u

PAGE_SYMBOLS = 500
PAGE_SECONDS = 10.0
PREAMBLE = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0], dtype=np.int8)
DATA_BITS = 214
FRAME_BITS = 244          # data + CRC24 + 6 tail
INTER_COLS = 61
INTER_ROWS = 8

SEMI = np.pi


# ----------------------------------------------------------------- encoding
def _page_frame(data214: np.ndarray) -> np.ndarray:
    """data+CRC+tail -> 500 on-air symbols (0/1) including preamble."""
    crc = crc24q(data214)
    frame = np.zeros(FRAME_BITS, dtype=np.int8)
    frame[:DATA_BITS] = data214
    _put(frame, DATA_BITS, 24, crc)
    sym = conv_encode(frame, invert_g2=True)               # 488
    inter = block_interleave(sym, cols=INTER_COLS, rows=INTER_ROWS)
    return np.concatenate([PREAMBLE, inter.astype(np.int8)])


def encode_page(eph: GalileoEphemeris, iono: GalileoIono | None,
                page_type: int, tow_s: float) -> np.ndarray:
    """214 data bits for page types 1-5 (5 = almanac placeholder)."""
    b = np.zeros(DATA_BITS, dtype=np.int8)
    _put(b, 0, 6, page_type)
    wn = eph.week
    if page_type == 1:
        _put(b, 6, 6, eph.prn)
        _put(b, 12, 10, eph.iod_nav)
        _put(b, 22, 14, int(round(eph.toc / 60.0)))
        _put(b, 36, 31, int(round(eph.af0 / 2.0**-34)))
        _put(b, 67, 21, int(round(eph.af1 / 2.0**-46)))
        _put(b, 88, 6, int(round(eph.af2 / 2.0**-59)))
        _put(b, 94, 8, eph.sisa)
        if iono is not None:
            _put(b, 102, 11, int(round(iono.ai0 / 2.0**-2)))
            _put(b, 113, 11, int(round(iono.ai1 / 2.0**-8)))
            _put(b, 124, 14, int(round(iono.ai2 / 2.0**-15)))
        _put(b, 143, 10, int(round(eph.bgd_e1e5a / 2.0**-32)))
        _put(b, 153, 2, eph.e1b_hs)       # E5a_HS
        _put(b, 155, 12, wn)
        _put(b, 167, 20, int(round(tow_s)))
        _put(b, 187, 1, eph.e1b_dvs)      # E5a_DVS
    elif page_type == 2:
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 32, int(round(eph.m0 / (SEMI * 2.0**-31))))
        _put(b, 48, 24, int(round(eph.omega_dot / (SEMI * 2.0**-43))))
        _put(b, 72, 32, int(round(eph.ecc / 2.0**-33)))
        _put(b, 104, 32, int(round(eph.sqrt_a / 2.0**-19)))
        _put(b, 136, 32, int(round(eph.omega0 / (SEMI * 2.0**-31))))
        _put(b, 168, 14, int(round(eph.idot / (SEMI * 2.0**-43))))
        _put(b, 182, 12, wn)
        _put(b, 194, 20, int(round(tow_s)))
    elif page_type == 3:
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 32, int(round(eph.i0 / (SEMI * 2.0**-31))))
        _put(b, 48, 32, int(round(eph.omega / (SEMI * 2.0**-31))))
        _put(b, 80, 16, int(round(eph.delta_n / (SEMI * 2.0**-43))))
        _put(b, 96, 16, int(round(eph.cuc / 2.0**-29)))
        _put(b, 112, 16, int(round(eph.cus / 2.0**-29)))
        _put(b, 128, 16, int(round(eph.crc / 2.0**-5)))
        _put(b, 144, 16, int(round(eph.crs / 2.0**-5)))
        _put(b, 160, 14, int(round(eph.toe / 60.0)))
        _put(b, 174, 12, wn)
        _put(b, 186, 20, int(round(tow_s)))
    elif page_type == 4:
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 16, int(round(eph.cic / 2.0**-29)))
        _put(b, 32, 16, int(round(eph.cis / 2.0**-29)))
        # GST-UTC / GST-GPS terms left zero in simulation
        _put(b, 189, 20, int(round(tow_s)))
    elif page_type == 5:
        _put(b, 189, 20, int(round(tow_s)))   # almanac placeholder
    return b


class FnavEncoder:
    """Simulator-side FNAV symbol stream for one satellite.

    Page schedule 1,2,3,4,5 (50 s cycle), starting at GST ``tow0_s`` which
    must be a multiple of 10 s.
    """

    def __init__(self, eph: GalileoEphemeris, iono: GalileoIono | None = None,
                 tow0_s: float = 0.0) -> None:
        self.eph = eph
        self.iono = iono or GalileoIono()
        self.tow0 = tow0_s

    def symbols(self, num_pages: int) -> np.ndarray:
        """[num_pages*500] symbol bits (0/1) from GST tow0 onward."""
        out = []
        for k in range(num_pages):
            tow = self.tow0 + k * PAGE_SECONDS
            ptype = [1, 2, 3, 4, 5][int(tow / PAGE_SECONDS) % 5]
            out.append(_page_frame(encode_page(self.eph, self.iono, ptype, tow)))
        return np.concatenate(out)


# ----------------------------------------------------------------- decoding
def parse_page(data: np.ndarray, eph: GalileoEphemeris,
               iono: GalileoIono) -> dict:
    """Parse one CRC-valid 214-bit page into eph/iono; returns
    {'page_type', 'tow_s'?, 'wn'?}."""
    ptype = _u(data, 0, 6)
    ev: dict = {"page_type": ptype}
    if ptype == 1:
        iod = _u(data, 12, 10)
        if iod != eph.iod_nav:
            _reset_flags(eph, iod)
        eph.prn = _u(data, 6, 6) or eph.prn
        eph.toc = _u(data, 22, 14) * 60.0
        eph.af0 = _s(data, 36, 31) * 2.0**-34
        eph.af1 = _s(data, 67, 21) * 2.0**-46
        eph.af2 = _s(data, 88, 6) * 2.0**-59
        eph.sisa = _u(data, 94, 8)
        iono.ai0 = _u(data, 102, 11) * 2.0**-2
        iono.ai1 = _s(data, 113, 11) * 2.0**-8
        iono.ai2 = _s(data, 124, 14) * 2.0**-15
        eph.bgd_e1e5a = _s(data, 143, 10) * 2.0**-32
        eph.e1b_hs = _u(data, 153, 2)
        eph.week = _u(data, 155, 12)
        eph.e1b_dvs = _u(data, 187, 1)
        eph.has_w4 = True     # clock page (I/NAV word-4 analog)
        ev["tow_s"] = float(_u(data, 167, 20))
        ev["wn"] = eph.week
    elif ptype == 2:
        iod = _u(data, 6, 10)
        if iod != eph.iod_nav:
            _reset_flags(eph, iod)
        eph.m0 = _s(data, 16, 32) * SEMI * 2.0**-31
        eph.omega_dot = _s(data, 48, 24) * SEMI * 2.0**-43
        eph.ecc = _u(data, 72, 32) * 2.0**-33
        eph.sqrt_a = _u(data, 104, 32) * 2.0**-19
        eph.omega0 = _s(data, 136, 32) * SEMI * 2.0**-31
        eph.idot = _s(data, 168, 14) * SEMI * 2.0**-43
        eph.week = _u(data, 182, 12)
        eph.has_w1 = True
        ev["tow_s"] = float(_u(data, 194, 20))
        ev["wn"] = eph.week
    elif ptype == 3:
        iod = _u(data, 6, 10)
        if iod != eph.iod_nav:
            _reset_flags(eph, iod)
        eph.i0 = _s(data, 16, 32) * SEMI * 2.0**-31
        eph.omega = _s(data, 48, 32) * SEMI * 2.0**-31
        eph.delta_n = _s(data, 80, 16) * SEMI * 2.0**-43
        eph.cuc = _s(data, 96, 16) * 2.0**-29
        eph.cus = _s(data, 112, 16) * 2.0**-29
        eph.crc = _s(data, 128, 16) * 2.0**-5
        eph.crs = _s(data, 144, 16) * 2.0**-5
        eph.toe = _u(data, 160, 14) * 60.0
        eph.week = _u(data, 174, 12)
        eph.has_w2 = True
        ev["tow_s"] = float(_u(data, 186, 20))
        ev["wn"] = eph.week
    elif ptype == 4:
        iod = _u(data, 6, 10)
        if iod != eph.iod_nav:
            _reset_flags(eph, iod)
        eph.cic = _s(data, 16, 16) * 2.0**-29
        eph.cis = _s(data, 32, 16) * 2.0**-29
        eph.has_w3 = True
        ev["tow_s"] = float(_u(data, 189, 20))
    elif ptype == 5:
        ev["tow_s"] = float(_u(data, 189, 20))
    return ev


def _reset_flags(eph: GalileoEphemeris, iod: int) -> None:
    eph.iod_nav = iod
    eph.has_w1 = eph.has_w2 = eph.has_w3 = eph.has_w4 = False


class FnavDecoder:
    """Streaming E5a-I FNAV decoder: feed per-symbol signs (50 sym/s), get
    TOW/ephemeris events (reference analog: galileo_telemetry_decoder_gs
    FNAV branch + galileo_fnav_message.cc)."""

    def __init__(self, prn: int) -> None:
        self.prn = prn
        self.eph = GalileoEphemeris(prn=prn)
        self.iono = GalileoIono()
        self._hist: list[float] = []
        self._stamps: list[int] = []
        self._synced = False
        self._flip = 1.0
        self.pages_ok = 0
        self.pages_bad = 0

    def push_symbols(self, signs: np.ndarray, stamps: np.ndarray) -> list[dict]:
        events: list[dict] = []
        self._hist.extend(float(s) for s in signs)
        self._stamps.extend(int(s) for s in stamps)
        pre = 1.0 - 2.0 * PREAMBLE.astype(np.float64)
        np_pre = len(pre)

        while True:
            if not self._synced:
                if len(self._hist) < PAGE_SYMBOLS + 2 * np_pre:
                    return events
                h = np.asarray(self._hist)
                # vectorized: one correlation flags candidate offsets whose
                # preamble repeats one page later with the same polarity
                corr = np.correlate(h, pre)        # [len-np_pre+1]
                limit = len(h) - PAGE_SYMBOLS - np_pre
                c0 = corr[:limit]
                c1 = corr[PAGE_SYMBOLS : PAGE_SYMBOLS + limit]
                hits = np.flatnonzero(
                    (np.abs(c0) >= np_pre - 1) & (np.abs(c1) >= np_pre - 1)
                    & (np.sign(c0) == np.sign(c1))
                )
                found = int(hits[0]) if len(hits) else -1
                if found >= 0:
                    self._flip = float(np.sign(c0[found]))
                if found < 0:
                    keep = PAGE_SYMBOLS + np_pre
                    self._hist = self._hist[-keep:]
                    self._stamps = self._stamps[-keep:]
                    return events
                self._hist = self._hist[found:]
                self._stamps = self._stamps[found:]
                self._synced = True

            if len(self._hist) < PAGE_SYMBOLS:
                return events
            page = np.asarray(self._hist[:PAGE_SYMBOLS]) * self._flip
            end_stamp = self._stamps[PAGE_SYMBOLS - 1]
            del self._hist[:PAGE_SYMBOLS]
            del self._stamps[:PAGE_SYMBOLS]
            if float(page[:np_pre] @ pre) < np_pre - 2:
                self._synced = False
                self.pages_bad += 1
                continue
            deinter = block_deinterleave(
                page[np_pre:], cols=INTER_COLS, rows=INTER_ROWS
            )
            bits = viterbi_decode(deinter, invert_g2=True, soft=True)
            data = bits[:DATA_BITS]
            if crc24q(data) != _u(bits, DATA_BITS, 24):
                self.pages_bad += 1
                continue
            self.pages_ok += 1
            ev = parse_page(data.astype(np.int8), self.eph, self.iono)
            if "tow_s" in ev:
                # the TOW field is the GST at this page's preamble start;
                # the page's last symbol lands PAGE_SECONDS later
                events.append({
                    "tow_s": ev["tow_s"] + PAGE_SECONDS,
                    "wn": ev.get("wn", self.eph.week),
                    "sample_stamp": end_stamp,
                    "ephemeris_complete": self.eph.complete,
                })
        return events
