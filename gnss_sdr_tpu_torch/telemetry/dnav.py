# Copied from gnss_sdr_tpu/telemetry/dnav.py; only the package imports are rewritten.
"""BeiDou D1 NAV message (B1I MEO/IGSO, 50 bps): BCH coding, frame
sync, ephemeris/iono parsing, and a simulator-side encoder.

Format (BDS-SIS-ICD-2.1 §5.2): 300-bit subframes of ten 30-bit words.
Word 1 is transmitted plain (its second half carries BCH(15,11) parity);
words 2-10 are two BCH(15,11,1) codewords, symbol-interleaved pairwise.
Field positions below are 1-based indices into the de-interleaved,
BCH-decoded 300-bit subframe.

Reference analog: beidou_b1i_telemetry_decoder_gs.cc (BCH + deinterleave)
+ beidou_dnav_navigation_message.cc (field map, Beidou_DNAV.h). All
internal timelines are GPS time: decoded BDT SOW gets +14 s
(BDT_TO_GPST_S) on the way out, and the encoder subtracts it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu_torch.constants.beidou_b1i import BDT_TO_GPST_S

PREAMBLE = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], dtype=np.int8)
SUBFRAME_BITS = 300
SUBFRAME_SECONDS = 6.0
PI_ICD = 3.1415926535898


@dataclass
class BeidouEphemeris:
    """BeiDou clock + ephemeris (D1 subframes 1-3). Field names follow
    GpsEphemeris so pvt.ephemeris.eph_to_pos_vel_clock propagates it
    (CGCS2000 mu selected by system='C'). Reference analog:
    core/system_parameters/beidou_dnav_ephemeris.h."""

    prn: int = 0
    system: str = "C"
    week: int = 0
    sv_health: int = 0
    ura_index: int = 0
    aodc: int = 0
    aode: int = 0
    tgd: float = 0.0                  # TGD1 (B1I), seconds
    tgd2: float = 0.0
    toc: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    crs: float = 0.0
    delta_n: float = 0.0
    m0: float = 0.0
    cuc: float = 0.0
    ecc: float = 0.0
    cus: float = 0.0
    sqrt_a: float = 0.0
    toe: float = 0.0
    cic: float = 0.0
    omega0: float = 0.0
    cis: float = 0.0
    i0: float = 0.0
    crc: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0
    idot: float = 0.0
    _toe_msb2: int = -1
    _toe_lsb15: int = -1

    has_sf1: bool = False
    has_sf2: bool = False
    has_sf3: bool = False

    @property
    def complete(self) -> bool:
        return (self.has_sf1 and self.has_sf2 and self.has_sf3
                and self._toe_msb2 >= 0 and self._toe_lsb15 >= 0)


# ---------------------------------------------------------- field layout
# (1-based start, length) pairs into the decoded 300-bit subframe
# (Beidou_DNAV.h D1_* tables; BDS-SIS-ICD-2.1 Figures 5-4..5-6)
_F = {
    "fraid": (((16, 3),), 1.0, False),
    "sow": (((19, 8), (31, 12)), 1.0, False),
    # subframe 1
    "sat_h1": (((43, 1),), 1.0, False),
    "aodc": (((44, 5),), 1.0, False),
    "urai": (((49, 4),), 1.0, False),
    "wn": (((61, 13),), 1.0, False),
    "toc": (((74, 9), (91, 8)), 2.0**3, False),
    "tgd1": (((99, 10),), 0.1e-9, True),
    "tgd2": (((109, 4), (121, 6)), 0.1e-9, True),
    "alpha0": (((127, 8),), 2.0**-30, True),
    "alpha1": (((135, 8),), 2.0**-27, True),
    "alpha2": (((151, 8),), 2.0**-24, True),
    "alpha3": (((159, 8),), 2.0**-24, True),
    "beta0": (((167, 6), (181, 2)), 2.0**11, True),
    "beta1": (((183, 8),), 2.0**14, True),
    "beta2": (((191, 8),), 2.0**16, True),
    "beta3": (((199, 4), (211, 4)), 2.0**16, True),
    "af2": (((215, 11),), 2.0**-66, True),
    "af0": (((226, 7), (241, 17)), 2.0**-33, True),
    "af1": (((258, 5), (271, 17)), 2.0**-50, True),
    "aode": (((288, 5),), 1.0, False),
    # subframe 2
    "delta_n": (((43, 10), (61, 6)), PI_ICD * 2.0**-43, True),
    "cuc": (((67, 16), (91, 2)), 2.0**-31, True),
    "m0": (((93, 20), (121, 12)), PI_ICD * 2.0**-31, True),
    "ecc": (((133, 10), (151, 22)), 2.0**-33, False),
    "cus": (((181, 18),), 2.0**-31, True),
    "crc": (((199, 4), (211, 14)), 2.0**-6, True),
    "crs": (((225, 8), (241, 10)), 2.0**-6, True),
    "sqrt_a": (((251, 12), (271, 20)), 2.0**-19, False),
    "toe_msb2": (((291, 2),), 1.0, False),
    # subframe 3
    "toe_lsb15": (((43, 10), (61, 5)), 1.0, False),
    "i0": (((66, 17), (91, 15)), PI_ICD * 2.0**-31, True),
    "cic": (((106, 7), (121, 11)), 2.0**-31, True),
    "omega_dot": (((132, 11), (151, 13)), PI_ICD * 2.0**-43, True),
    "cis": (((164, 9), (181, 9)), 2.0**-31, True),
    "idot": (((190, 13), (211, 1)), PI_ICD * 2.0**-43, True),
    "omega0": (((212, 21), (241, 11)), PI_ICD * 2.0**-31, True),
    "omega": (((252, 11), (271, 21)), PI_ICD * 2.0**-31, True),
}

TOE_LSB = 2.0**3


def _read(bits: np.ndarray, key: str) -> int:
    spans, _, signed = _F[key]
    v = 0
    n = 0
    for start, length in spans:
        for k in range(length):
            v = (v << 1) | int(bits[start - 1 + k])
        n += length
    if signed and v & (1 << (n - 1)):
        v -= 1 << n
    return v


def _read_scaled(bits: np.ndarray, key: str) -> float:
    return _read(bits, key) * _F[key][1]


def _write(bits: np.ndarray, key: str, value: int) -> None:
    spans, _, _ = _F[key]
    n = sum(length for _, length in spans)
    v = int(value) & ((1 << n) - 1)
    pos = n
    for start, length in spans:
        for k in range(length):
            pos -= 1
            bits[start - 1 + k] = (v >> pos) & 1


def _write_scaled(bits: np.ndarray, key: str, value: float) -> None:
    _write(bits, key, int(round(value / _F[key][1])))


# -------------------------------------------------------------- BCH(15,11)
def bch1511_encode(data11: np.ndarray) -> np.ndarray:
    """4 parity bits for 11 data bits, g(x) = x^4 + x + 1."""
    reg = [0, 0, 0, 0]
    for b in data11:
        fb = int(b) ^ reg[3]
        reg = [fb, reg[0] ^ fb, reg[1], reg[2]]
    return np.array(reg[::-1], dtype=np.int8)


def _syndrome(bits15) -> int:
    reg = [0, 0, 0, 0]
    for b in bits15:
        fb = int(b) ^ reg[3]
        reg = [fb, reg[0] ^ fb, reg[1], reg[2]]
    return reg[0] | (reg[1] << 1) | (reg[2] << 2) | (reg[3] << 3)


def _error_table() -> dict[int, int]:
    """syndrome -> single-error position, derived from the register (so
    encoder and corrector can never disagree)."""
    table = {}
    for k in range(15):
        e = np.zeros(15, dtype=np.int8)
        e[k] = 1
        table[_syndrome(e)] = k
    return table


_ERRPOS = _error_table()


def bch1511_decode(bits15: np.ndarray) -> np.ndarray:
    """Single-error-correcting decode; returns the corrected 15 bits."""
    out = bits15.copy()
    syn = _syndrome(bits15)
    if syn:
        out[_ERRPOS[syn]] ^= 1
    return out


def encode_word(dec30: np.ndarray, word_idx: int) -> np.ndarray:
    """Decoded word (data in place, parity slots ignored) -> transmitted
    30 bits. Word 1 is plain with BCH parity over its second half."""
    if word_idx == 1:
        tx = dec30.copy()
        tx[26:30] = bch1511_encode(dec30[15:26])
        return tx
    b1 = np.concatenate([dec30[0:11], bch1511_encode(dec30[0:11])])
    b2 = np.concatenate([dec30[11:22], bch1511_encode(dec30[11:22])])
    tx = np.empty(30, dtype=np.int8)
    tx[0::2] = b1
    tx[1::2] = b2
    return tx


def decode_word(tx30: np.ndarray, word_idx: int) -> np.ndarray:
    """Transmitted word -> decoded 30 bits ([22 data][8 parity] layout for
    words 2-10; word 1 raw, matching the reference's field positions)."""
    if word_idx == 1:
        return tx30.copy()
    b1 = bch1511_decode(tx30[0::2])
    b2 = bch1511_decode(tx30[1::2])
    dec = np.empty(30, dtype=np.int8)
    dec[0:11] = b1[:11]
    dec[11:22] = b2[:11]
    dec[22:26] = b1[11:]
    dec[26:30] = b2[11:]
    return dec


def encode_subframe(eph: BeidouEphemeris, sf_id: int,
                    sow_bdt: float) -> np.ndarray:
    """300 transmitted bits for one D1 subframe (SOW in BDT seconds at the
    subframe's leading edge)."""
    dec = np.zeros(SUBFRAME_BITS, dtype=np.int8)
    dec[0:11] = PREAMBLE
    _write(dec, "fraid", sf_id)
    _write(dec, "sow", int(round(sow_bdt)))
    if sf_id == 1:
        _write(dec, "sat_h1", eph.sv_health & 1)
        _write(dec, "aodc", eph.aodc)
        _write(dec, "urai", eph.ura_index)
        _write(dec, "wn", eph.week)
        _write_scaled(dec, "toc", eph.toc)
        _write_scaled(dec, "tgd1", eph.tgd)
        _write_scaled(dec, "tgd2", eph.tgd2)
        _write_scaled(dec, "af2", eph.af2)
        _write_scaled(dec, "af0", eph.af0)
        _write_scaled(dec, "af1", eph.af1)
        _write(dec, "aode", eph.aode)
    elif sf_id == 2:
        _write_scaled(dec, "delta_n", eph.delta_n)
        _write_scaled(dec, "cuc", eph.cuc)
        _write_scaled(dec, "m0", eph.m0)
        _write_scaled(dec, "ecc", eph.ecc)
        _write_scaled(dec, "cus", eph.cus)
        _write_scaled(dec, "crc", eph.crc)
        _write_scaled(dec, "crs", eph.crs)
        _write_scaled(dec, "sqrt_a", eph.sqrt_a)
        toe_units = int(round(eph.toe / TOE_LSB))
        _write(dec, "toe_msb2", toe_units >> 15)
    elif sf_id == 3:
        toe_units = int(round(eph.toe / TOE_LSB))
        _write(dec, "toe_lsb15", toe_units & 0x7FFF)
        _write_scaled(dec, "i0", eph.i0)
        _write_scaled(dec, "cic", eph.cic)
        _write_scaled(dec, "omega_dot", eph.omega_dot)
        _write_scaled(dec, "cis", eph.cis)
        _write_scaled(dec, "idot", eph.idot)
        _write_scaled(dec, "omega0", eph.omega0)
        _write_scaled(dec, "omega", eph.omega)
    out = np.empty(SUBFRAME_BITS, dtype=np.int8)
    for w in range(10):
        out[w * 30:(w + 1) * 30] = encode_word(dec[w * 30:(w + 1) * 30],
                                               w + 1)
    return out


def parse_subframe(dec: np.ndarray, eph: BeidouEphemeris,
                   iono: dict | None = None) -> tuple[int, float]:
    """Parse a decoded subframe; returns (sf_id, sow_bdt)."""
    sf_id = _read(dec, "fraid")
    sow = float(_read(dec, "sow"))
    if sf_id == 1:
        eph.sv_health = _read(dec, "sat_h1")
        eph.aodc = _read(dec, "aodc")
        eph.ura_index = _read(dec, "urai")
        eph.week = _read(dec, "wn")
        eph.toc = _read_scaled(dec, "toc")
        eph.tgd = _read_scaled(dec, "tgd1")
        eph.tgd2 = _read_scaled(dec, "tgd2")
        eph.af2 = _read_scaled(dec, "af2")
        eph.af0 = _read_scaled(dec, "af0")
        eph.af1 = _read_scaled(dec, "af1")
        eph.aode = _read(dec, "aode")
        eph.has_sf1 = True
        if iono is not None:
            for k in ("alpha0", "alpha1", "alpha2", "alpha3",
                      "beta0", "beta1", "beta2", "beta3"):
                iono[k] = _read_scaled(dec, k)
    elif sf_id == 2:
        eph.delta_n = _read_scaled(dec, "delta_n")
        eph.cuc = _read_scaled(dec, "cuc")
        eph.m0 = _read_scaled(dec, "m0")
        eph.ecc = _read_scaled(dec, "ecc")
        eph.cus = _read_scaled(dec, "cus")
        eph.crc = _read_scaled(dec, "crc")
        eph.crs = _read_scaled(dec, "crs")
        eph.sqrt_a = _read_scaled(dec, "sqrt_a")
        eph._toe_msb2 = _read(dec, "toe_msb2")
        eph.has_sf2 = True
    elif sf_id == 3:
        eph._toe_lsb15 = _read(dec, "toe_lsb15")
        eph.i0 = _read_scaled(dec, "i0")
        eph.cic = _read_scaled(dec, "cic")
        eph.omega_dot = _read_scaled(dec, "omega_dot")
        eph.cis = _read_scaled(dec, "cis")
        eph.idot = _read_scaled(dec, "idot")
        eph.omega0 = _read_scaled(dec, "omega0")
        eph.omega = _read_scaled(dec, "omega")
        eph.has_sf3 = True
    if eph._toe_msb2 >= 0 and eph._toe_lsb15 >= 0:
        eph.toe = ((eph._toe_msb2 << 15) | eph._toe_lsb15) * TOE_LSB
    return sf_id, sow


class D1Encoder:
    """Simulator-side D1 bit stream: bit n of the BDT week <-> SOW n/50
    (subframe k spans SOW [6k, 6k+6); 1,2,3,4,5 cycling)."""

    def __init__(self, eph: BeidouEphemeris) -> None:
        self.eph = eph
        self._cache: dict[int, np.ndarray] = {}

    def subframe(self, epoch: int) -> np.ndarray:
        sf = self._cache.get(epoch)
        if sf is None:
            sf_id = (epoch % 5) + 1
            sf = encode_subframe(self.eph, sf_id, 6.0 * epoch)
            self._cache[epoch] = sf
        return sf

    def bits_at(self, bit_indices: np.ndarray) -> np.ndarray:
        """Signs (+1 for bit 0) for absolute BDT bit indices."""
        out = np.empty(bit_indices.shape, dtype=np.float64)
        flat = bit_indices.ravel()
        res = out.ravel()
        for j, b in enumerate(flat):
            epoch = int(b) // SUBFRAME_BITS
            within = int(b) % SUBFRAME_BITS
            res[j] = 1.0 - 2.0 * self.subframe(epoch)[within]
        return out


class D1Decoder:
    """Streaming D1 decoder: feed 20 ms bit signs (NH-wiped data symbols),
    get TOW + ephemeris events (GPS timescale)."""

    def __init__(self, prn: int) -> None:
        self.prn = prn
        self.eph = BeidouEphemeris(prn=prn)
        self.iono: dict = {}
        self.bits: list[int] = []
        self.stamps: list[int] = []
        self.synced = False
        self.inverted = False
        self.frame_start: int | None = None
        self.subframes_ok = 0
        self.subframes_bad = 0

    def push_symbols(self, signs: np.ndarray, stamps: np.ndarray) -> list[dict]:
        events: list[dict] = []
        for s, st in zip(signs, stamps):
            self.bits.append(0 if s > 0 else 1)
            self.stamps.append(int(st))
        while True:
            ev = self._try_decode()
            if ev is None:
                break
            events.append(ev)
        if len(self.bits) > 4 * SUBFRAME_BITS and self.frame_start is None:
            drop = len(self.bits) - 2 * SUBFRAME_BITS
            self.bits = self.bits[drop:]
            self.stamps = self.stamps[drop:]
        return events

    def _find_preamble(self) -> None:
        b = np.asarray(self.bits, dtype=np.int8)
        if len(b) < SUBFRAME_BITS + 11:
            return
        x = 1.0 - 2.0 * b
        pre = (1.0 - 2.0 * PREAMBLE).astype(np.float64)
        corr = np.correlate(x, pre)
        # require the preamble to repeat one subframe later with the same
        # polarity (the 11-bit pattern alone false-alarms in data)
        limit = len(b) - SUBFRAME_BITS - 11
        if limit <= 0:
            return
        c0 = corr[:limit]
        c1 = corr[SUBFRAME_BITS:SUBFRAME_BITS + limit]
        hits = np.flatnonzero(
            (np.abs(c0) == 11) & (np.abs(c1) == 11)
            & (np.sign(c0) == np.sign(c1))
        )
        if len(hits):
            i = int(hits[0])
            self.synced = True
            self.inverted = bool(c0[i] < 0)
            self.frame_start = i

    def _try_decode(self) -> dict | None:
        if not self.synced:
            self._find_preamble()
            if not self.synced:
                return None
        i = self.frame_start
        if i is None or len(self.bits) < i + SUBFRAME_BITS:
            return None
        tx = np.asarray(self.bits[i:i + SUBFRAME_BITS], dtype=np.int8)
        if self.inverted:
            tx = tx ^ 1
        dec = np.empty(SUBFRAME_BITS, dtype=np.int8)
        for w in range(10):
            dec[w * 30:(w + 1) * 30] = decode_word(
                tx[w * 30:(w + 1) * 30], w + 1)
        if not np.array_equal(dec[0:11], PREAMBLE):
            self.subframes_bad += 1
            self.synced = False
            self.frame_start = None
            drop = i + 1
            self.bits = self.bits[drop:]
            self.stamps = self.stamps[drop:]
            return None
        sf_id, sow = parse_subframe(dec, self.eph, self.iono)
        self.subframes_ok += 1
        # SOW is at this subframe's leading edge (BDT); the last bit ends
        # SUBFRAME_SECONDS later; +14 s converts to the GPS timescale
        end_stamp = self.stamps[i + SUBFRAME_BITS - 1]
        tow_gps = sow + SUBFRAME_SECONDS + BDT_TO_GPST_S
        self.frame_start = i + SUBFRAME_BITS
        keep_from = self.frame_start
        self.bits = self.bits[keep_from:]
        self.stamps = self.stamps[keep_from:]
        self.frame_start = 0
        return {
            "prn": self.prn,
            "subframe": sf_id,
            "tow_s": tow_gps,
            "sample_stamp": end_stamp,
            "ephemeris_complete": self.eph.complete,
        }
