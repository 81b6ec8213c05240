# Copied from gnss_sdr_tpu/telemetry/gnav.py; only the package imports are rewritten.
"""GLONASS GNAV navigation message codec (L1/L2 C/A, 50 bps).

Structure (GLONASS ICD 5.1; reference analogs
glonass_l1_ca_telemetry_decoder_gs.cc and
glonass_gnav_navigation_message.cc):

- a *string* spans 2 s: 1.7 s of data (85 bits, bi-binary encoded at 100
  sps — each differentially-encoded bit becomes a (+,-) or (-,+) pair of
  10 ms halves) followed by a 0.3 s time mark (fixed 30-bit m-sequence,
  plain 100 sps);
- 15 strings form a 30 s frame; strings 1-4 carry the ephemeris state
  vector, string 5 the timescale parameters; 6-15 almanac;
- each string carries an 8-bit modified Hamming (KX) checksum able to
  correct single-bit errors (ICD 4.7; reference CRC_test).

The receiver-side symbol stream is at 10 ms (the tracker integrates 10
code periods per symbol after bit sync, conf.codes_per_bit = 10); the
decoder hunts the +-time mark, undoes the bi-binary + differential
encoding, checks/corrects KX, and parses fields. GLONASS day time
(UTC(SU)+3h) converts to GPS TOW once here — downstream (observables,
PVT) never sees the GLONASS timescale.
"""

from __future__ import annotations

import datetime as _dt
from functools import lru_cache

import numpy as np

from gnss_sdr_tpu_torch.pvt.glonass import GlonassEphemeris

STRING_BITS = 85
DATA_SYMBOLS = 170            # bi-binary halves per string
MARK_SYMBOLS = 30
STRING_SYMBOLS = DATA_SYMBOLS + MARK_SYMBOLS          # at 10 ms each
TIME_MARK_BITS = "111110001101110101000010010110"     # ICD time mark
TIME_MARK = np.array([1.0 if c == "1" else -1.0 for c in TIME_MARK_BITS])

# field positions: (first_bit_1based, length) from transmission start
# (GLONASS_L1_L2_CA.h:254-330)
_F = {
    "string_id": (2, 4), "kx": (78, 8),
    # string 1
    "p1": (8, 2), "tk_hr": (10, 5), "tk_min": (15, 6), "tk_sec": (21, 1),
    "xdot": (22, 24), "xdotdot": (46, 5), "x": (51, 27),
    # string 2
    "bn": (6, 3), "p2": (9, 1), "tb": (10, 7),
    "ydot": (22, 24), "ydotdot": (46, 5), "y": (51, 27),
    # string 3
    "p3": (6, 1), "gamma_n": (7, 11), "p": (19, 2), "l_n": (21, 1),
    "zdot": (22, 24), "zdotdot": (46, 5), "z": (51, 27),
    # string 4
    "tau_n": (6, 22), "dtau_n": (28, 5), "e_n": (33, 5), "p4": (52, 1),
    "ft": (53, 4), "nt": (60, 11), "n": (71, 5), "m": (76, 2),
    # string 5
    "na": (6, 11), "tau_c": (17, 32), "n4": (50, 5), "tau_gps": (55, 22),
    "alm_l_n": (77, 1),
}

# UTC -> GPS leap seconds by effectivity date (subset of the reference's
# GLONASS_LEAP_SECONDS table; entries after 1996 cover the simulator range)
_LEAPS = [
    (_dt.date(2017, 1, 1), 18), (_dt.date(2015, 7, 1), 17),
    (_dt.date(2012, 7, 1), 16), (_dt.date(2009, 1, 1), 15),
    (_dt.date(2006, 1, 1), 14), (_dt.date(1999, 1, 1), 13),
    (_dt.date(1997, 7, 1), 12), (_dt.date(1996, 1, 1), 11),
    (_dt.date(1980, 1, 6), 0),
]
_GPS_EPOCH = _dt.date(1980, 1, 6)
GLONASS_TO_UTC_S = 3 * 3600.0


# ------------------------------------------------------------------ Hamming
@lru_cache(maxsize=1)
def _kx_masks() -> tuple[np.ndarray, np.ndarray]:
    """Parity masks for the GNAV modified Hamming code, derived from the
    standard construction rather than the ICD's printed index tables: data
    positions 9..85 (ICD numbering, counted from the string END) map to the
    Hamming codeword positions 3,5,6,7,9,... (non-powers-of-two, in order);
    check bit C_i sits at codeword position 2^(i-1). Verified against the
    reference's GLONASS_GNAV_CRC_*_INDEX tables by the unit tests.

    Returns (masks[7, 85], all_mask[85]) over ICD bit positions 1..85
    (index p-1), where masks[i] covers the data bits of check C_{i+1}.
    """
    ham_pos = []
    h = 3
    while len(ham_pos) < STRING_BITS - 8:
        if h & (h - 1):                       # not a power of two
            ham_pos.append(h)
        h += 1
    masks = np.zeros((7, STRING_BITS), dtype=bool)
    for d in range(STRING_BITS - 8):
        p = 9 + d                             # ICD position of this data bit
        for i in range(7):
            if ham_pos[d] & (1 << i):
                masks[i, p - 1] = True
    all_mask = np.zeros(STRING_BITS, dtype=bool)
    all_mask[8:] = True                       # C_Sigma covers all data bits
    return masks, all_mask


def _icd_order(bits_tx: np.ndarray) -> np.ndarray:
    """Transmission order (b[0] first) -> ICD numbering (position 1 = last
    transmitted bit): icd[p-1] = b[85-p]."""
    return bits_tx[::-1]


def kx_encode(bits_tx: np.ndarray) -> np.ndarray:
    """Fill the 8 KX check bits (transmission positions 78..85) so the
    string passes CRC_test; returns a copy."""
    out = np.array(bits_tx, dtype=np.uint8)
    out[77:85] = 0
    icd = _icd_order(out)                     # icd[0..7] are the check bits
    masks, all_mask = _kx_masks()
    for i in range(7):
        icd[i] = icd[masks[i]].sum() % 2
    # C_Sigma parity: icd[7] makes (sum of check bits + data bits) even
    icd[7] = (icd[:7].sum() + icd[all_mask].sum()) % 2
    return icd[::-1].copy()


def kx_check(bits_tx: np.ndarray) -> tuple[bool, np.ndarray]:
    """(ok, possibly-corrected bits). Accepts error-free strings and
    corrects single-bit data errors (reference CRC_test cases 1-3)."""
    b = np.array(bits_tx, dtype=np.uint8)
    icd = _icd_order(b)
    masks, all_mask = _kx_masks()
    c = np.array([
        icd[i] ^ (icd[masks[i]].sum() % 2) for i in range(7)
    ])
    c_sigma = (icd[:8].sum() + icd[all_mask].sum()) % 2
    psum = int(c.sum())
    if psum == 0 and c_sigma == 0:
        return True, b
    if c_sigma == 1 and psum >= 1:
        # single-bit error at the Hamming position given by the syndrome
        syndrome = int(sum(c[i] << i for i in range(7)))
        ham_pos = []
        h = 3
        while len(ham_pos) < STRING_BITS - 8:
            if h & (h - 1):
                ham_pos.append(h)
            h += 1
        if psum == 1:
            # error in a check bit itself: data is fine
            return True, b
        if syndrome in ham_pos:
            icd_pos = 9 + ham_pos.index(syndrome)      # 1-based ICD position
            b[STRING_BITS - icd_pos] ^= 1
            return True, b
    return False, b


# ------------------------------------------------------------- bit helpers
def _get(bits: np.ndarray, key: str) -> int:
    p, ln = _F[key]
    v = 0
    for j in range(ln):
        v = (v << 1) | int(bits[p - 1 + j])
    return v


def _get_signed(bits: np.ndarray, key: str) -> int:
    """GLONASS sign-magnitude: first bit is the sign."""
    p, ln = _F[key]
    mag = 0
    for j in range(1, ln):
        mag = (mag << 1) | int(bits[p - 1 + j])
    return -mag if bits[p - 1] else mag


def _put(bits: np.ndarray, key: str, value: int) -> None:
    p, ln = _F[key]
    for j in range(ln):
        bits[p - 1 + j] = (value >> (ln - 1 - j)) & 1


def _put_signed(bits: np.ndarray, key: str, value: int) -> None:
    p, ln = _F[key]
    bits[p - 1] = 1 if value < 0 else 0
    mag = abs(int(value))
    for j in range(1, ln):
        bits[p - 1 + j] = (mag >> (ln - 1 - j)) & 1


# ---------------------------------------------------------------- timescale
def _leap_seconds(d: _dt.date) -> int:
    for eff, ls in _LEAPS:
        if d >= eff:
            return ls
    return 0


def glonass_date(n4: int, nt: int) -> _dt.date:
    """Calendar date from the four-year interval N4 and day number NT
    (ICD A3.11)."""
    if nt <= 366:
        j, day = 1, nt
    elif nt <= 731:
        j, day = 2, nt - 366
    elif nt <= 1096:
        j, day = 3, nt - 731
    else:
        j, day = 4, nt - 1096
    year = 1996 + 4 * (n4 - 1) + (j - 1)
    return _dt.date(year, 1, 1) + _dt.timedelta(days=int(day) - 1)


def glot_to_gpst(tod_s: float, nt: int, n4: int) -> tuple[int, float]:
    """GLONASS day time (UTC(SU)+3h) -> (GPS week, GPS TOW).

    Mirrors Glonass_Gnav_Ephemeris::glot_to_gpst (tau_c/tau_gps fine
    corrections applied by the caller if desired)."""
    date = glonass_date(n4, nt)
    utc = (_dt.datetime.combine(date, _dt.time())
           + _dt.timedelta(seconds=tod_s - GLONASS_TO_UTC_S))
    gps = utc + _dt.timedelta(seconds=_leap_seconds(utc.date()))
    delta = gps - _dt.datetime.combine(_GPS_EPOCH, _dt.time())
    total = delta.days * 86400.0 + delta.seconds + delta.microseconds * 1e-6
    wn = int(total // 604800)
    return wn, total - wn * 604800.0


def gpst_to_glot(week: int, tow_s: float) -> tuple[float, int, int]:
    """(GLONASS day time, NT, N4) for a GPS epoch — the encoder-side
    inverse of glot_to_gpst."""
    gps = (_dt.datetime.combine(_GPS_EPOCH, _dt.time())
           + _dt.timedelta(days=7 * week, seconds=tow_s))
    # leap seconds keyed by (approximate) UTC date
    utc = gps - _dt.timedelta(seconds=_leap_seconds(gps.date()))
    glo = utc + _dt.timedelta(seconds=GLONASS_TO_UTC_S)
    year = glo.year
    n4 = (year - 1996) // 4 + 1
    base = _dt.date(1996 + 4 * (n4 - 1), 1, 1)
    nt = (glo.date() - base).days + 1
    tod = (glo - _dt.datetime.combine(glo.date(), _dt.time())).total_seconds()
    return tod, nt, n4


def align_tb_gps(week: int, approx_tow: float) -> float:
    """Nearest valid ephemeris reference epoch (GLONASS tb is quantized to
    15-minute marks of the GLONASS day) as a GPS TOW — simulator helper."""
    tod, nt, n4 = gpst_to_glot(week, approx_tow)
    tb_tod = round(tod / 900.0) * 900.0
    _, tow = glot_to_gpst(tb_tod, nt, n4)
    return tow


# ------------------------------------------------------------------ encoder
class GnavEncoder:
    """Builds the per-string bit arrays and the 10 ms symbol stream for one
    satellite (simulator side; analog of the gnss-sim GLONASS path)."""

    def __init__(self, eph: GlonassEphemeris, week: int = 2290,
                 tau_c: float = 0.0, tau_gps: float = 0.0) -> None:
        """``week``: GPS week of the scenario (GNAV carries a calendar
        date, so the within-week TOW alone cannot place NT/N4)."""
        self.eph = eph
        self.week = week
        self.tau_c = tau_c
        self.tau_gps = tau_gps
        tod_b, nt, n4 = gpst_to_glot(week, eph.tb_gps_tow)
        self._nt = nt if eph.nt == 0 else eph.nt
        self._n4 = n4 if eph.n4 == 0 else eph.n4
        self._tb_tod = tod_b

    def string_bits(self, string_id: int, frame_tod: float) -> np.ndarray:
        """85 transmission-ordered bits for the given string of the frame
        starting at GLONASS day time ``frame_tod``."""
        e = self.eph
        b = np.zeros(STRING_BITS, dtype=np.uint8)
        _put(b, "string_id", string_id)
        if string_id == 1:
            hours = int(frame_tod // 3600)
            mins = int((frame_tod - hours * 3600) // 60)
            secs30 = int(frame_tod - hours * 3600 - mins * 60) // 30
            _put(b, "tk_hr", hours)
            _put(b, "tk_min", mins)
            _put(b, "tk_sec", secs30)
            _put_signed(b, "xdot", round(e.vel[0] / 1e3 / 2.0 ** -20))
            _put_signed(b, "xdotdot", round(e.acc[0] / 1e3 / 2.0 ** -30))
            _put_signed(b, "x", round(e.pos[0] / 1e3 / 2.0 ** -11))
        elif string_id == 2:
            _put(b, "bn", e.health)
            _put(b, "tb", int(round(self._tb_tod / 900.0)))
            _put_signed(b, "ydot", round(e.vel[1] / 1e3 / 2.0 ** -20))
            _put_signed(b, "ydotdot", round(e.acc[1] / 1e3 / 2.0 ** -30))
            _put_signed(b, "y", round(e.pos[1] / 1e3 / 2.0 ** -11))
        elif string_id == 3:
            _put_signed(b, "gamma_n", round(e.gamma_n / 2.0 ** -40))
            _put_signed(b, "zdot", round(e.vel[2] / 1e3 / 2.0 ** -20))
            _put_signed(b, "zdotdot", round(e.acc[2] / 1e3 / 2.0 ** -30))
            _put_signed(b, "z", round(e.pos[2] / 1e3 / 2.0 ** -11))
        elif string_id == 4:
            _put_signed(b, "tau_n", round(e.tau_n / 2.0 ** -30))
            _put_signed(b, "dtau_n", round(e.dtau_n / 2.0 ** -30))
            _put(b, "ft", e.ft)
            _put(b, "nt", self._nt)
            _put(b, "n", e.slot)
            _put(b, "m", 1)                       # GLONASS-M
        elif string_id == 5:
            _put(b, "na", self._nt)
            _put_signed(b, "tau_c", round(self.tau_c / 2.0 ** -31))
            _put(b, "n4", self._n4)
            _put_signed(b, "tau_gps", round(self.tau_gps / 2.0 ** -30))
        # strings 6-15: almanac left zeroed (valid KX)
        return kx_encode(b)

    def symbols_at(self, sym_indices: np.ndarray) -> np.ndarray:
        """Symbol levels (+-1) at absolute 10 ms symbol indices counted
        from GLONASS day time 0 (frames aligned to 30 s epochs)."""
        out = np.empty(len(sym_indices), dtype=np.float64)
        # cache per-string symbol blocks
        cache: dict[int, np.ndarray] = {}
        string_idx = np.floor_divide(sym_indices, STRING_SYMBOLS)
        within = sym_indices - string_idx * STRING_SYMBOLS
        for s_i in np.unique(string_idx):
            sel = string_idx == s_i
            if s_i not in cache:
                sid = int(s_i % 15) + 1
                frame_tod = float((s_i // 15) * 30 % 86400)
                bits = self.string_bits(sid, frame_tod)
                # differential (relative) code then bi-binary
                rel = np.bitwise_xor.accumulate(bits)
                syms = np.empty(STRING_SYMBOLS)
                lv = 2.0 * rel - 1.0
                syms[0:DATA_SYMBOLS:2] = lv
                syms[1:DATA_SYMBOLS:2] = -lv
                syms[DATA_SYMBOLS:] = TIME_MARK
                cache[s_i] = syms
            out[sel] = cache[s_i][within[sel]]
        return out


# ------------------------------------------------------------------ decoder
class GnavDecoder:
    """Streaming GNAV decoder for one satellite channel.

    push_symbols(signs, stamps): 10 ms symbol signs (+-1) with their sample
    stamps; returns TOW-anchor events as the other decoders do
    (receiver/receiver.py telemetry intake)."""

    def __init__(self, slot: int) -> None:
        self.slot = slot
        self.eph = GlonassEphemeris(slot=slot)
        self.syms: list[float] = []
        self.stamps: list[int] = []
        self._have = set()
        self._nt: int | None = None
        self._n4: int | None = None
        self._frame_tod: float | None = None
        self._frame_pos: int | None = None   # stream idx of frame string 1 data start
        self._pos0 = 0                       # stream index of syms[0]
        self.strings = 0
        self.crc_errors = 0

    # -- decoding
    def push_symbols(self, signs: np.ndarray, stamps: np.ndarray) -> list[dict]:
        self.syms.extend(float(s) for s in signs)
        self.stamps.extend(int(s) for s in stamps)
        events = []
        while True:
            ev = self._try_decode()
            if ev is None:
                break
            if ev:
                events.append(ev)
        if len(self.syms) > 3 * STRING_SYMBOLS:
            drop = len(self.syms) - 2 * STRING_SYMBOLS
            self.syms = self.syms[drop:]
            self.stamps = self.stamps[drop:]
            self._pos0 += drop
        return events

    def _try_decode(self) -> dict | None:
        """Find a time mark and decode the 170 data symbols that follow."""
        s = np.asarray(self.syms)
        if len(s) < MARK_SYMBOLS + DATA_SYMBOLS:
            return None
        n_starts = len(s) - (MARK_SYMBOLS + DATA_SYMBOLS) + 1
        for i in range(n_starts):
            corr = float(np.dot(s[i : i + MARK_SYMBOLS], TIME_MARK))
            if abs(corr) == MARK_SYMBOLS:
                pol = 1.0 if corr > 0 else -1.0
                data = pol * s[i + MARK_SYMBOLS : i + MARK_SYMBOLS + DATA_SYMBOLS]
                ev = self._decode_string(
                    data,
                    end_stamp=self.stamps[i + MARK_SYMBOLS + DATA_SYMBOLS - 1],
                    data_start_stream_idx=self._pos0 + i + MARK_SYMBOLS,
                )
                # consume through the data field (keep the tail: the next
                # string's mark follows immediately)
                drop = i + MARK_SYMBOLS + DATA_SYMBOLS
                self.syms = self.syms[drop:]
                self.stamps = self.stamps[drop:]
                self._pos0 += drop
                return ev if ev is not None else {}
        return None

    def _decode_string(self, data: np.ndarray, end_stamp: int,
                       data_start_stream_idx: int) -> dict | None:
        # bi-binary -> relative code -> differential decode
        first = data[0:DATA_SYMBOLS:2]
        second = data[1:DATA_SYMBOLS:2]
        rel = ((first - second) > 0).astype(np.uint8)
        bits = np.zeros(STRING_BITS, dtype=np.uint8)
        bits[1:] = rel[:-1] ^ rel[1:]
        ok, bits = kx_check(bits)
        if not ok:
            self.crc_errors += 1
            return None
        self.strings += 1
        sid = _get(bits, "string_id")
        e = self.eph
        if sid == 1:
            tk = (_get(bits, "tk_hr") * 3600 + _get(bits, "tk_min") * 60
                  + _get(bits, "tk_sec") * 30)
            self._frame_tod = float(tk)
            self._frame_pos = data_start_stream_idx
            e.vel[0] = _get_signed(bits, "xdot") * 2.0 ** -20 * 1e3
            e.acc[0] = _get_signed(bits, "xdotdot") * 2.0 ** -30 * 1e3
            e.pos[0] = _get_signed(bits, "x") * 2.0 ** -11 * 1e3
            self._have.add(1)
        elif sid == 2:
            e.health = _get(bits, "bn")
            self._tb_tod = _get(bits, "tb") * 900.0
            e.vel[1] = _get_signed(bits, "ydot") * 2.0 ** -20 * 1e3
            e.acc[1] = _get_signed(bits, "ydotdot") * 2.0 ** -30 * 1e3
            e.pos[1] = _get_signed(bits, "y") * 2.0 ** -11 * 1e3
            self._have.add(2)
        elif sid == 3:
            e.gamma_n = _get_signed(bits, "gamma_n") * 2.0 ** -40
            e.vel[2] = _get_signed(bits, "zdot") * 2.0 ** -20 * 1e3
            e.acc[2] = _get_signed(bits, "zdotdot") * 2.0 ** -30 * 1e3
            e.pos[2] = _get_signed(bits, "z") * 2.0 ** -11 * 1e3
            self._have.add(3)
        elif sid == 4:
            e.tau_n = _get_signed(bits, "tau_n") * 2.0 ** -30
            e.dtau_n = _get_signed(bits, "dtau_n") * 2.0 ** -30
            e.ft = _get(bits, "ft")
            e.nt = self._nt = _get(bits, "nt")
            slot = _get(bits, "n")
            if slot:
                e.slot = slot
            self._have.add(4)
        elif sid == 5:
            e.n4 = self._n4 = _get(bits, "n4")
            self._have.add(5)

        complete = {1, 2, 3, 4, 5} <= self._have
        if complete and getattr(self, "_tb_tod", None) is not None:
            _, e.tb_gps_tow = glot_to_gpst(self._tb_tod, e.nt, e.n4)

        # TOW anchor: this string's data position relative to the last
        # string-1 data start (known GLONASS time) gives its transmit time;
        # the data field ENDS 1.7 s into the string.
        if (self._frame_tod is None or self._nt is None or self._n4 is None
                or self._frame_pos is None):
            return {}
        delta = data_start_stream_idx - self._frame_pos
        if delta % STRING_SYMBOLS:
            return {}                          # stream gap mid-string
        tod_data_end = self._frame_tod + (delta // STRING_SYMBOLS) * 2.0 + 1.7
        _, tow = glot_to_gpst(tod_data_end, self._nt, self._n4)
        return {
            "tow_s": tow,
            "sample_stamp": int(end_stamp),
            "ephemeris_complete": complete,
            "string_id": sid,
        }
