# Copied from gnss_sdr_tpu/telemetry/cnav.py; only the package imports are rewritten.
"""GPS CNAV message codec for L5 (encoder + streaming decoder).

CNAV (IS-GPS-705 §20.3.3 / IS-GPS-200 Appendix III): 300-bit messages —
preamble 10001011, PRN(6), message type(6), TOW count(17, units of 6 s),
alert(1), payload, CRC-24Q over the first 276 bits. The bit stream is
rate-1/2 K=7 convolutionally encoded *continuously across messages* (no
per-message termination), 100 sym/s on L5I; each message occupies one 6 s
epoch and its TOW field is the time of the start of the NEXT message.

Implemented message types: 10 (ephemeris 1), 11 (ephemeris 2), 30 (clock,
iono, group delays). Field positions per IS-GPS-200 Appendix III (the
reference carries the same published tables in
core/system_parameters/GPS_CNAV.h; parser analog
gps_cnav_navigation_message.cc; the streaming decode replaces libswiftcnav's
running hard-decision Viterbi with a free-boundary block Viterbi over the
buffered soft symbols + preamble/CRC scan).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.telemetry.fec import conv_encode, crc24q, viterbi_decode
from gnss_sdr_tpu_torch.telemetry.inav import _put, _s, _u
from gnss_sdr_tpu_torch.telemetry.lnav import GpsEphemeris

MSG_BITS = 300
MSG_SECONDS = 6.0
PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int8)

SEMI = np.pi
AREF_M = 26_559_710.0                 # IS-GPS-705 Table 20-I reference SMA
OMEGA_DOT_REF = -2.6e-9 * SEMI        # rad/s reference rate


@dataclass
class CnavClock:
    toc: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    tgd: float = 0.0
    isc_l5i: float = 0.0
    isc_l5q: float = 0.0


def encode_message(eph: GpsEphemeris, msg_type: int, tow_next_s: float,
                   prn: int) -> np.ndarray:
    """300-bit CNAV message (types 10/11/30) from a Keplerian ephemeris
    (precision terms A_dot / delta_n_dot emitted as zero)."""
    b = np.zeros(MSG_BITS, dtype=np.int8)
    b[:8] = PREAMBLE
    _put(b, 8, 6, prn)
    _put(b, 14, 6, msg_type)
    _put(b, 20, 17, int(round(tow_next_s / 6.0)))
    _put(b, 37, 1, 0)                             # alert
    if msg_type == 10:
        _put(b, 38, 13, eph.week)
        _put(b, 51, 3, eph.sv_health)
        _put(b, 54, 11, int(eph.toe // 300))      # top ~ toe
        _put(b, 65, 5, eph.ura_index)
        _put(b, 70, 11, int(eph.toe // 300))
        delta_a = eph.sqrt_a**2 - AREF_M
        _put(b, 81, 26, int(round(delta_a / 2.0**-9)))
        _put(b, 107, 25, 0)                       # A_dot
        _put(b, 132, 17, int(round(eph.delta_n / (SEMI * 2.0**-44))))
        _put(b, 149, 23, 0)                       # delta_n0_dot
        _put(b, 172, 33, int(round(eph.m0 / (SEMI * 2.0**-32))))
        _put(b, 205, 33, int(round(eph.ecc / 2.0**-34)))
        _put(b, 238, 33, int(round(eph.omega / (SEMI * 2.0**-32))))
    elif msg_type == 11:
        _put(b, 38, 11, int(eph.toe // 300))
        _put(b, 49, 33, int(round(eph.omega0 / (SEMI * 2.0**-32))))
        _put(b, 82, 33, int(round(eph.i0 / (SEMI * 2.0**-32))))
        _put(b, 115, 17,
             int(round((eph.omega_dot - OMEGA_DOT_REF) / (SEMI * 2.0**-44))))
        _put(b, 132, 15, int(round(eph.idot / (SEMI * 2.0**-44))))
        _put(b, 147, 16, int(round(eph.cis / 2.0**-30)))
        _put(b, 163, 16, int(round(eph.cic / 2.0**-30)))
        _put(b, 179, 24, int(round(eph.crs / 2.0**-8)))
        _put(b, 203, 24, int(round(eph.crc / 2.0**-8)))
        _put(b, 227, 21, int(round(eph.cus / 2.0**-30)))
        _put(b, 248, 21, int(round(eph.cuc / 2.0**-30)))
    elif msg_type == 30:
        _put(b, 38, 11, int(eph.toe // 300))      # top
        _put(b, 60, 11, int(eph.toc // 300))
        _put(b, 71, 26, int(round(eph.af0 / 2.0**-35)))
        _put(b, 97, 20, int(round(eph.af1 / 2.0**-48)))
        _put(b, 117, 10, int(round(eph.af2 / 2.0**-60)))
        _put(b, 127, 13, int(round(eph.tgd / 2.0**-35)))
        # ISC L1CA/L2C/L5I/L5Q left zero in simulation
    _put(b, 276, 24, crc24q(b[:276]))
    return b


def parse_message(bits: np.ndarray) -> dict:
    """Parse one CRC-valid 300-bit message into a field dict."""
    out = {
        "prn": _u(bits, 8, 6),
        "msg_type": _u(bits, 14, 6),
        "tow_s": _u(bits, 20, 17) * 6.0,
        "alert": _u(bits, 37, 1),
    }
    t = out["msg_type"]
    if t == 10:
        out.update(
            week=_u(bits, 38, 13),
            sv_health=_u(bits, 51, 3),
            ura_index=_u(bits, 65, 5),
            toe=_u(bits, 70, 11) * 300.0,
            sqrt_a=np.sqrt(AREF_M + _s(bits, 81, 26) * 2.0**-9),
            a_dot=_s(bits, 107, 25) * 2.0**-21,
            delta_n=_s(bits, 132, 17) * SEMI * 2.0**-44,
            delta_n_dot=_s(bits, 149, 23) * SEMI * 2.0**-57,
            m0=_s(bits, 172, 33) * SEMI * 2.0**-32,
            ecc=_u(bits, 205, 33) * 2.0**-34,
            omega=_s(bits, 238, 33) * SEMI * 2.0**-32,
        )
    elif t == 11:
        out.update(
            toe=_u(bits, 38, 11) * 300.0,
            omega0=_s(bits, 49, 33) * SEMI * 2.0**-32,
            i0=_s(bits, 82, 33) * SEMI * 2.0**-32,
            omega_dot=OMEGA_DOT_REF + _s(bits, 115, 17) * SEMI * 2.0**-44,
            idot=_s(bits, 132, 15) * SEMI * 2.0**-44,
            cis=_s(bits, 147, 16) * 2.0**-30,
            cic=_s(bits, 163, 16) * 2.0**-30,
            crs=_s(bits, 179, 24) * 2.0**-8,
            crc=_s(bits, 203, 24) * 2.0**-8,
            cus=_s(bits, 227, 21) * 2.0**-30,
            cuc=_s(bits, 248, 21) * 2.0**-30,
        )
    elif t == 30:
        out.update(
            toc=_u(bits, 60, 11) * 300.0,
            af0=_s(bits, 71, 26) * 2.0**-35,
            af1=_s(bits, 97, 20) * 2.0**-48,
            af2=_s(bits, 117, 10) * 2.0**-60,
            tgd=_s(bits, 127, 13) * 2.0**-35,
            isc_l5i=_s(bits, 166, 13) * 2.0**-35,
            isc_l5q=_s(bits, 179, 13) * 2.0**-35,
        )
    return out


class CnavEncoder:
    """Simulator-side CNAV symbol stream: message schedule 10,11,30
    repeating from GPS time ``tow0_s`` (multiple of the message duration),
    continuously convolutionally encoded (state carried across messages).

    ``msg_seconds`` is the on-air duration of one 300-bit message: 6 s on
    L5 (100 sym/s) and 12 s on L2 CM (50 sym/s, IS-GPS-200 §30.3.3); the
    encoded TOW field always names the next message's start epoch."""

    def __init__(self, eph: GpsEphemeris, tow0_s: float,
                 msg_seconds: float = MSG_SECONDS) -> None:
        self.eph = eph
        self.tow0 = tow0_s
        self.msg_seconds = msg_seconds

    def symbols(self, num_msgs: int) -> np.ndarray:
        """[num_msgs*600] symbols (0/1) from tow0 onward."""
        bits = []
        for k in range(num_msgs):
            tow = self.tow0 + k * self.msg_seconds
            mtype = [10, 11, 30][int(tow / self.msg_seconds) % 3]
            bits.append(encode_message(self.eph, mtype,
                                       tow + self.msg_seconds,
                                       self.eph.prn))
        return conv_encode(np.concatenate(bits), invert_g2=False)


class CnavDecoder:
    """Streaming L5I CNAV decoder: feed per-symbol signs (100 sym/s), get
    TOW + ephemeris events.

    Continuous encoding means message boundaries are unknown: the decoder
    runs a free-boundary Viterbi over the buffered soft symbols (both
    polarities) and scans the decoded bits for preamble + CRC-24Q.
    """

    #: margin of symbols kept on each side against traceback edge effects
    EDGE = 64

    def __init__(self, prn: int) -> None:
        self.prn = prn
        self.eph = GpsEphemeris(prn=prn)
        self._toe10: float | None = None
        self._toe11: float | None = None
        self._toc30: float | None = None
        self._hist: list[float] = []
        self._stamps: list[int] = []
        self._bit_base = 0          # absolute bit index of _hist[0]/2
        self.msgs_ok = 0
        self.clock: CnavClock = CnavClock()
        self.last_tow: float | None = None
        self.last_tow_stamp: int | None = None

    def push_symbols(self, signs: np.ndarray, stamps: np.ndarray) -> list[dict]:
        self._hist.extend(float(s) for s in signs)
        self._stamps.extend(int(s) for s in stamps)
        self._pending = getattr(self, "_pending", 0) + len(signs)
        events: list[dict] = []
        # need at least one full message plus sync/edge margin buffered, and
        # enough new symbols to plausibly complete a message (every half
        # message: decode latency matters more than the extra Viterbi pass)
        if (len(self._hist) < 3 * MSG_BITS // 2 + 4 * self.EDGE
                or self._pending < MSG_BITS // 2):
            return events
        self._pending = 0
        consumed_bits = 0
        align_used = 0
        # unknown symbol-pair alignment (stream may start on a G2 symbol)
        # and BPSK polarity; a flipped-polarity stream decodes to
        # complemented bits (both generator polynomials have odd weight),
        # so exactly one (alignment, polarity) combination yields
        # preamble+CRC hits. Once locked, only that combination is scanned.
        locked = getattr(self, "_locked", None)
        combos = [locked] if locked else [(0, 1.0), (0, -1.0),
                                          (1, 1.0), (1, -1.0)]
        for align, pol in combos:
            sym = np.asarray(self._hist[align:])
            sym = sym[: 2 * (len(sym) // 2)]
            bits = viterbi_decode(
                sym * pol, invert_g2=False, soft=True,
                start_state=None, end_state=None,
            )
            events, consumed_bits = self._scan(bits, align)
            if events:
                self._locked = (align, pol)
                align_used = align
                break
        n_sym = len(self._hist)
        if consumed_bits:
            # retain 2*EDGE symbols before the boundary so the next
            # message's preamble sits past the scan's edge margin (too few
            # retained bits to ever re-complete an old message)
            drop = max(0, align_used + 2 * consumed_bits - 2 * self.EDGE)
            del self._hist[:drop]
            del self._stamps[:drop]
            self._locked = (0, self._locked[1])  # buffer stays bit-aligned
        elif n_sym > 6 * MSG_BITS:
            # nothing decodable for several message lengths: drop sync and
            # old symbols (reference: alarm after frames without valid CRC)
            self._locked = None
            drop = n_sym - 4 * MSG_BITS
            del self._hist[:drop]
            del self._stamps[:drop]
        return events

    # ------------------------------------------------------------------ scan
    def _scan(self, bits: np.ndarray, align: int) -> tuple[list[dict], int]:
        events = []
        consumed = 0
        i = self.EDGE // 2
        limit = len(bits) - MSG_BITS - self.EDGE // 2
        while i < limit:
            if not np.array_equal(bits[i : i + 8], PREAMBLE):
                i += 1
                continue
            msg = bits[i : i + MSG_BITS]
            if crc24q(msg[:276]) != _u(msg, 276, 24):
                i += 1
                continue
            fields = parse_message(msg.astype(np.int8))
            self.msgs_ok += 1
            self._ingest(fields)
            # TOW field = start of NEXT message = transmit time at this
            # message's last symbol
            end_stamp = self._stamps[align + 2 * (i + MSG_BITS) - 1]
            self.last_tow = fields["tow_s"]
            self.last_tow_stamp = end_stamp
            events.append({
                "tow_s": fields["tow_s"],
                "msg_type": fields["msg_type"],
                "sample_stamp": end_stamp,
                "ephemeris_complete": self._complete(),
            })
            consumed = i + MSG_BITS
            i += MSG_BITS
        return events, consumed

    def _ingest(self, f: dict) -> None:
        eph = self.eph
        t = f["msg_type"]
        if t == 10:
            self._toe10 = f["toe"]
            eph.week = f["week"]
            eph.sv_health = f["sv_health"]
            eph.ura_index = f["ura_index"]
            eph.toe = f["toe"]
            eph.sqrt_a = f["sqrt_a"]
            eph.delta_n = f["delta_n"]
            eph.m0 = f["m0"]
            eph.ecc = f["ecc"]
            eph.omega = f["omega"]
            eph.has_sf1 = True
        elif t == 11:
            self._toe11 = f["toe"]
            eph.omega0 = f["omega0"]
            eph.i0 = f["i0"]
            eph.omega_dot = f["omega_dot"]
            eph.idot = f["idot"]
            eph.cis = f["cis"]
            eph.cic = f["cic"]
            eph.crs = f["crs"]
            eph.crc = f["crc"]
            eph.cus = f["cus"]
            eph.cuc = f["cuc"]
            eph.has_sf2 = True
        elif t == 30:
            self._toc30 = f["toc"]
            eph.toc = f["toc"]
            eph.af0 = f["af0"]
            eph.af1 = f["af1"]
            eph.af2 = f["af2"]
            eph.tgd = f["tgd"]
            self.clock = CnavClock(
                toc=f["toc"], af0=f["af0"], af1=f["af1"], af2=f["af2"],
                tgd=f["tgd"], isc_l5i=f["isc_l5i"], isc_l5q=f["isc_l5q"],
            )
            eph.has_sf3 = True

    def _complete(self) -> bool:
        """Types 10+11+30 received for the same data set (reference checks
        toe_1 == toe_2, gps_cnav_navigation_message.cc)."""
        return (
            self._toe10 is not None
            and self._toe10 == self._toe11
            and self._toc30 is not None
        )

    @property
    def ephemeris_complete(self) -> bool:
        return self._complete()
