# Copied from gnss_sdr_tpu/outputs/rtcm2.py; only the package imports are rewritten.
"""RTCM 2.3 codec: legacy DGPS corrections over the 30-bit word format.

Reference analog: rtklib_rtcm2.cc (message decoders) + rtklib_rtcm.cc
input_rtcm2 (:170 — 6-of-8 byte transport, frame sync, GPS-parity words)
+ rtklib_rtkcmn.cc decode_word (:947). Messages implemented (the set the
reference supports for DGPS positioning): type 1/9 differential
corrections, type 3 reference-station ECEF, type 14 GPS time of week,
type 16 special message. The encoder is the exact inverse, used by tests
and by anyone who needs to serve legacy corrections.

RTCM 2 transport: every byte carries 6 data bits (LSB-first, upper two
bits 01); 30-bit words carry 24 data bits + 6 parity bits computed with
the GPS LNAV Hamming masks, with whole-word inversion signalled by the
previous word's D30.
"""

from __future__ import annotations

from dataclasses import dataclass, field

RTCM2_PREAMBLE = 0x66

_HAMMING = (0xBB1F3480, 0x5D8F9A40, 0xAEC7CD00,
            0x5763E680, 0x6BB1F340, 0x8B7A89C0)


def _parity6(word: int) -> int:
    """6 parity bits over the 24 data bits + D29*/D30* (the two LSBs of
    the previous word, already shifted into bits 31-30 of ``word``)."""
    p = 0
    for mask in _HAMMING:
        p <<= 1
        w = (word & mask) >> 6
        while w:
            p ^= w & 1
            w >>= 1
    return p


def decode_word(word: int) -> bytes | None:
    """30-bit word (+2 bits of previous D29/D30 above) -> 3 data bytes,
    or None on parity failure (rtklib_rtkcmn.cc:947)."""
    if word & 0x40000000:
        word ^= 0x3FFFFFC0
    if _parity6(word) != (word & 0x3F):
        return None
    return bytes(((word >> 22) & 0xFF, (word >> 14) & 0xFF,
                  (word >> 6) & 0xFF))


def _getbitu(buf: bytes, pos: int, n: int) -> int:
    v = 0
    for i in range(pos, pos + n):
        v = (v << 1) | ((buf[i // 8] >> (7 - i % 8)) & 1)
    return v


def _getbits(buf: bytes, pos: int, n: int) -> int:
    v = _getbitu(buf, pos, n)
    if v >= 1 << (n - 1):
        v -= 1 << n
    return v


@dataclass
class DgpsCorrection:
    """Type 1/9 per-satellite pseudorange correction
    (rtklib_rtcm2.cc:100-148)."""

    prc: float = 0.0          # pseudorange correction, m
    rrc: float = 0.0          # range-rate correction, m/s
    iod: int = 0
    udre: int = 0
    t0: float = 0.0           # correction epoch (GPS TOW, s)


@dataclass
class Rtcm2State:
    station_pos: tuple | None = None        # ECEF m (type 3)
    week: int = 0
    leaps: int = 0
    zcnt_s: float = 0.0
    hour: int = 0
    staid: int = 0
    seqno: int = -1
    message: str = ""                       # type 16 text
    dgps: dict[int, DgpsCorrection] = field(default_factory=dict)


class Rtcm2Decoder:
    """Streaming RTCM 2 decoder (rtklib_rtcm.cc input_rtcm2 analog).

    ``push(data) -> list[int]`` feeds raw bytes and returns the decoded
    message types; results accumulate in ``state``.
    """

    def __init__(self, approx_tow_s: float = 0.0) -> None:
        self.state = Rtcm2State()
        self._word = 0
        self._buff = bytearray()
        self._nbit = 0
        self._tow_ref = float(approx_tow_s)
        self._len = 0

    # ------------------------------------------------------------- transport
    def push(self, data: bytes) -> list[int]:
        decoded = []
        for byte in data:
            if (byte & 0xC0) != 0x40:
                continue                      # upper 2 bits must be 01
            b = byte
            for _ in range(6):                # 6-of-8, LSB first
                self._word = ((self._word << 1) | (b & 1)) & 0xFFFFFFFF
                b >>= 1
                if not self._buff:
                    pre = (self._word >> 22) & 0xFF
                    if self._word & 0x40000000:
                        pre ^= 0xFF
                    if pre != RTCM2_PREAMBLE:
                        continue
                    data3 = decode_word(self._word)
                    if data3 is None:
                        continue
                    self._buff += data3
                    self._nbit = 0
                    continue
                self._nbit += 1
                if self._nbit < 30:
                    continue
                self._nbit = 0
                data3 = decode_word(self._word)
                if data3 is None:
                    self._buff.clear()
                    self._word &= 0x3
                    continue
                self._buff += data3
                if len(self._buff) == 6:
                    self._len = ((self._buff[5] >> 3) & 0x1F) * 3 + 6
                if len(self._buff) < self._len:
                    continue
                msg = bytes(self._buff)
                self._buff.clear()
                self._word &= 0x3
                t = self._decode_message(msg)
                if t is not None:
                    decoded.append(t)
        return decoded

    # --------------------------------------------------------------- message
    def _decode_message(self, buf: bytes) -> int | None:
        st = self.state
        mtype = _getbitu(buf, 8, 6)
        zcnt = _getbitu(buf, 24, 13) * 0.6
        if zcnt >= 3600.0:
            return None
        # hourly rollover vs the reference epoch (adjhour analog)
        hour = int(self._tow_ref // 3600.0)
        sec = self._tow_ref - hour * 3600.0
        if zcnt < sec - 1800.0:
            zcnt += 3600.0
        elif zcnt > sec + 1800.0:
            zcnt -= 3600.0
        st.zcnt_s = zcnt
        st.staid = _getbitu(buf, 14, 10)
        st.seqno = _getbitu(buf, 37, 3)
        nbits = len(buf) * 8
        t_corr = hour * 3600.0 + zcnt

        if mtype in (1, 9):
            i = 48
            while i + 40 <= nbits:
                fact = _getbitu(buf, i, 1)
                udre = _getbitu(buf, i + 1, 2)
                prn = _getbitu(buf, i + 3, 5)
                prc = _getbits(buf, i + 8, 16)
                rrc = _getbits(buf, i + 24, 8)
                iod = _getbits(buf, i + 32, 8)
                i += 40
                if prn == 0:
                    prn = 32
                if prc == -0x8000 or rrc == -0x80:
                    continue              # satellite problem flag
                st.dgps[prn] = DgpsCorrection(
                    prc=prc * (0.32 if fact else 0.02),
                    rrc=rrc * (0.032 if fact else 0.002),
                    iod=iod, udre=udre, t0=t_corr)
            return 7
        if mtype == 3:
            if 48 + 96 <= nbits:
                st.station_pos = (
                    _getbits(buf, 48, 32) * 0.01,
                    _getbits(buf, 80, 32) * 0.01,
                    _getbits(buf, 112, 32) * 0.01)
                return 5
            return None
        if mtype == 14:
            if 48 + 24 <= nbits:
                st.week = _getbitu(buf, 48, 10)
                st.hour = _getbitu(buf, 58, 8)
                st.leaps = _getbitu(buf, 66, 6)
                return 6
            return None
        if mtype == 16:
            chars = []
            i = 48
            while i + 8 <= nbits:
                c = _getbitu(buf, i, 8)
                i += 8
                if c:
                    chars.append(chr(c))
            st.message = "".join(chars)
            return 9
        return 0                               # known frame, unhandled type


class Rtcm2Encoder:
    """RTCM 2 message builder (inverse of the decoder; the reference
    only decodes ver.2, its encoder is ver.3 — this closes the loop for
    tests and legacy correction servers)."""

    def __init__(self, staid: int = 0) -> None:
        self.staid = staid
        self.seqno = 0
        # parity chain state: RTCM 2 words chain D29*/D30* continuously
        # across message boundaries on a real link
        self._d29 = 0
        self._d30 = 0

    def _frame(self, mtype: int, body_bits: list[int],
               zcnt_s: float, health: int = 0) -> bytes:
        nwords = (len(body_bits) + 23) // 24
        body_bits = body_bits + [0] * (nwords * 24 - len(body_bits))
        zcnt = int(round(zcnt_s / 0.6)) % 6000
        hdr1 = (RTCM2_PREAMBLE << 16) | (mtype << 10) | self.staid
        hdr2 = (zcnt << 11) | (self.seqno << 8) | (nwords << 3) | health
        self.seqno = (self.seqno + 1) % 8
        words24 = [hdr1, hdr2]
        for w in range(nwords):
            v = 0
            for b in body_bits[w * 24:(w + 1) * 24]:
                v = (v << 1) | (b & 1)
            words24.append(v)
        # chain parity, then emit 6-of-8 bytes
        out = bytearray()
        d29, d30 = self._d29, self._d30
        for d24 in words24:
            # parity over the UNINVERTED data + D29*/D30* (GPS LNAV
            # convention); D30* inverts only the transmitted data bits
            base = (d29 << 31) | (d30 << 30) | ((d24 & 0xFFFFFF) << 6)
            p = _parity6(base)
            data = d24 & 0xFFFFFF
            if d30:
                data ^= 0xFFFFFF
            w = (d29 << 31) | (d30 << 30) | (data << 6) | p
            d29 = (w >> 1) & 1
            d30 = w & 1
            bits30 = [(w >> (29 - i)) & 1 for i in range(30)]
            for k in range(0, 30, 6):
                six = bits30[k:k + 6]
                byte = 0x40
                for j, bit in enumerate(six):
                    byte |= bit << j         # LSB-first transport
                out.append(byte)
        self._d29, self._d30 = d29, d30
        return bytes(out)

    @staticmethod
    def _bits(value: int, n: int) -> list[int]:
        v = int(value) & ((1 << n) - 1)
        return [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def type1(self, corrections: dict[int, DgpsCorrection],
              zcnt_s: float) -> bytes:
        body: list[int] = []
        for prn, c in sorted(corrections.items()):
            fact = 1 if (abs(c.prc) > 0.02 * 32767 * 0.999
                         or abs(c.rrc) > 0.002 * 127 * 0.999) else 0
            scale_p = 0.32 if fact else 0.02
            scale_r = 0.032 if fact else 0.002
            body += self._bits(fact, 1)
            body += self._bits(c.udre, 2)
            body += self._bits(prn % 32, 5)
            body += self._bits(int(round(c.prc / scale_p)), 16)
            body += self._bits(int(round(c.rrc / scale_r)), 8)
            body += self._bits(c.iod, 8)
        return self._frame(1, body, zcnt_s)

    def type3(self, pos_ecef, zcnt_s: float) -> bytes:
        body: list[int] = []
        for v in pos_ecef:
            body += self._bits(int(round(v / 0.01)), 32)
        return self._frame(3, body, zcnt_s)

    def type14(self, week: int, hour: int, leaps: int,
               zcnt_s: float) -> bytes:
        body = (self._bits(week % 1024, 10) + self._bits(hour, 8)
                + self._bits(leaps, 6))
        return self._frame(14, body, zcnt_s)

    def type16(self, text: str, zcnt_s: float) -> bytes:
        body: list[int] = []
        for ch in text[:90]:
            body += self._bits(ord(ch), 8)
        return self._frame(16, body, zcnt_s)


def apply_dgps_corrections(pseudoranges: dict[int, float],
                           state: Rtcm2State, t: float,
                           max_age_s: float = 60.0) -> dict[int, float]:
    """PRC + RRC*(t-t0) applied per PRN (the reference feeds these into
    rtkpos' DGPS mode; here the corrected pseudoranges go straight back
    to the solver)."""
    out = {}
    for prn, pr in pseudoranges.items():
        c = state.dgps.get(prn)
        if c is not None and abs(t - c.t0) <= max_age_s:
            out[prn] = pr + c.prc + c.rrc * (t - c.t0)
        else:
            out[prn] = pr
    return out
