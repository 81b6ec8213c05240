# Copied from gnss_sdr_tpu/telemetry/dnav_d2.py; only the package imports are rewritten.
"""BeiDou D2 NAV message (B1I GEO satellites, 500 bps).

Format (BDS-SIS-ICD-2.1 §5.3): 300-bit subframes at 0.6 s each, five
subframes per frame; subframe 1 carries the basic navigation data split
over 10 pages (one page per frame, 30 s cycle), subframes 2-5 carry the
integrity/differential and almanac payloads (ignored here, as in the
reference). Word coding (word 1 plain, words 2-10 BCH(15,11)
pair-interleaved) is shared with D1.

Reference analog: beidou_dnav_navigation_message.cc d2_subframe_decoder
(:377-560) with the D2_* field tables from Beidou_DNAV.h:214-284; GEO
PRNs (1-5, 59-63) stream D2, MEO/IGSO stream D1
(beidou_b1i_telemetry_decoder_gs.cc satellite-type switch).
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.constants.beidou_b1i import BDT_TO_GPST_S
from gnss_sdr_tpu_torch.telemetry.dnav import (
    PREAMBLE,
    SUBFRAME_BITS,
    BeidouEphemeris,
    PI_ICD,
    decode_word,
    encode_word,
)

SUBFRAME_SECONDS = 0.6       # 300 bits at 500 bps
PAGES = 10

#: GEO PRNs broadcasting D2 (C01-C05 + C59-C63)
GEO_PRNS = frozenset(range(1, 6)) | frozenset(range(59, 64))


def is_geo_prn(prn: int) -> bool:
    return prn in GEO_PRNS


# (1-based start, length) spans into the decoded 300-bit subframe
# (Beidou_DNAV.h D2_* tables)
_SPANS = {
    "fraid": ((16, 3),),
    "sow": ((19, 8), (31, 12)),
    "pnum": ((43, 4),),
    # page 1
    "sat_h1": ((47, 1),),
    "aodc": ((48, 5),),
    "urai": ((61, 4),),
    "wn": ((65, 13),),
    "toc": ((78, 5), (91, 12)),
    "tgd1": ((103, 10),),
    # page 2 (iono)
    "alpha0": ((47, 6), (61, 2)),
    "alpha1": ((63, 8),),
    "alpha2": ((71, 8),),
    "alpha3": ((79, 4), (91, 4)),
    "beta0": ((95, 8),),
    "beta1": ((103, 8),),
    "beta2": ((111, 2), (121, 6)),
    "beta3": ((127, 8),),
    # page 3/4 (clock)
    "af0": ((101, 12), (121, 12)),
    "af1_msb": ((133, 4),),
    "af1_lsb": ((47, 6), (61, 12)),
    # af2 on page 4: the reference decodes it with the D1_A2 span (215,11)
    # (d2_subframe_decoder case 4) — keep encoder/decoder on that layout
    "af2": ((215, 11),),
    "aode": ((92, 5),),
    "delta_n": ((97, 16),),
    "cuc_msb": ((121, 14),),
    # page 5
    "cuc_lsb": ((47, 4),),
    "m0": ((51, 2), (61, 22), (91, 8)),
    "cus": ((99, 14), (121, 4)),
    "e_msb": ((125, 10),),
    # page 6
    "e_lsb": ((47, 6), (61, 16)),
    "sqrt_a": ((77, 6), (91, 22), (121, 4)),
    "cic_msb": ((125, 10),),
    # page 7
    "cic_lsb": ((47, 6), (61, 2)),
    "cis": ((63, 18),),
    "toe": ((81, 2), (91, 15)),
    "i0_msb": ((106, 7), (121, 14)),
    # page 8
    "i0_lsb": ((47, 6), (61, 5)),
    "crc": ((66, 17), (91, 1)),
    "crs": ((92, 18),),
    "omega_dot_msb": ((110, 3), (121, 16)),
    # page 9
    "omega_dot_lsb": ((47, 5),),
    "omega0": ((52, 1), (61, 22), (91, 9)),
    "omega_msb": ((100, 13), (121, 14)),
    # page 10
    "omega_lsb": ((47, 5),),
    "idot": ((52, 1), (61, 13)),
}

# assembled-field scales (same LSBs as D1, Beidou_DNAV.h D1_*_LSB)
_SCALE = {
    "toc": 2.0**3, "tgd1": 0.1e-9,
    "alpha0": 2.0**-30, "alpha1": 2.0**-27, "alpha2": 2.0**-24,
    "alpha3": 2.0**-24, "beta0": 2.0**11, "beta1": 2.0**14,
    "beta2": 2.0**16, "beta3": 2.0**16,
    "af0": 2.0**-33, "af1": 2.0**-50, "af2": 2.0**-66,
    "delta_n": PI_ICD * 2.0**-43, "cuc": 2.0**-31, "m0": PI_ICD * 2.0**-31,
    "cus": 2.0**-31, "ecc": 2.0**-33, "sqrt_a": 2.0**-19,
    "cic": 2.0**-31, "cis": 2.0**-31, "toe": 2.0**3,
    "i0": PI_ICD * 2.0**-31, "crc": 2.0**-6, "crs": 2.0**-6,
    "omega_dot": PI_ICD * 2.0**-43, "omega0": PI_ICD * 2.0**-31,
    "omega": PI_ICD * 2.0**-31, "idot": PI_ICD * 2.0**-43,
}

_SIGNED = {"tgd1", "alpha0", "alpha1", "alpha2", "alpha3", "beta0", "beta1",
           "beta2", "beta3", "af0", "af2", "delta_n", "cus", "cis", "crc",
           "crs", "idot"}
# split fields: (msb key, lsb key, total bits, signed)
_SPLIT = {
    "af1": ("af1_msb", "af1_lsb", 22, True),
    "cuc": ("cuc_msb", "cuc_lsb", 18, True),
    "ecc": ("e_msb", "e_lsb", 32, False),
    "cic": ("cic_msb", "cic_lsb", 18, True),
    "i0": ("i0_msb", "i0_lsb", 32, True),
    "omega_dot": ("omega_dot_msb", "omega_dot_lsb", 24, True),
    "omega": ("omega_msb", "omega_lsb", 32, True),
}


def _width(key: str) -> int:
    return sum(n for _, n in _SPANS[key])


def _read(bits: np.ndarray, key: str) -> int:
    v = 0
    for start, length in _SPANS[key]:
        for k in range(length):
            v = (v << 1) | int(bits[start - 1 + k])
    return v


def _read_signed(bits: np.ndarray, key: str) -> int:
    v = _read(bits, key)
    n = _width(key)
    return v - (1 << n) if v & (1 << (n - 1)) else v


def _write(bits: np.ndarray, key: str, value: int) -> None:
    n = _width(key)
    v = int(value) & ((1 << n) - 1)
    pos = n
    for start, length in _SPANS[key]:
        for k in range(length):
            pos -= 1
            bits[start - 1 + k] = (v >> pos) & 1


class D2EphemerisAssembler:
    """Collects D2 subframe-1 pages into a BeidouEphemeris + iono dict."""

    def __init__(self, prn: int) -> None:
        self.eph = BeidouEphemeris(prn=prn)
        self.iono: dict = {}
        self.pages_seen: set[int] = set()
        self._msb: dict[str, int] = {}

    @property
    def complete(self) -> bool:
        return self.pages_seen >= set(range(1, PAGES + 1))

    def _assemble(self, name: str, lsb_val: int) -> None:
        msb_key, _, total, signed = _SPLIT[name]
        if msb_key not in self._msb:
            return
        lsb_bits = _width(_SPLIT[name][1])
        v = (self._msb[msb_key] << lsb_bits) | lsb_val
        if signed and v & (1 << (total - 1)):
            v -= 1 << total
        val = v * _SCALE[name]
        if name == "ecc":
            self.eph.ecc = val
        else:
            setattr(self.eph, name, val)

    def push_page(self, dec: np.ndarray) -> tuple[int, float]:
        """Parse one decoded subframe-1 page; returns (page, sow_bdt)."""
        page = _read(dec, "pnum")
        sow = float(_read(dec, "sow"))
        e = self.eph

        def rs(key):
            return _read_signed(dec, key) * _SCALE[key]

        if page == 1:
            e.sv_health = _read(dec, "sat_h1")
            e.aodc = _read(dec, "aodc")
            e.ura_index = _read(dec, "urai")
            e.week = _read(dec, "wn")
            e.toc = _read(dec, "toc") * _SCALE["toc"]
            e.tgd = rs("tgd1")
        elif page == 2:
            for k in ("alpha0", "alpha1", "alpha2", "alpha3",
                      "beta0", "beta1", "beta2", "beta3"):
                self.iono[k] = rs(k)
        elif page == 3:
            e.af0 = rs("af0")
            self._msb["af1_msb"] = _read(dec, "af1_msb")
        elif page == 4:
            self._assemble("af1", _read(dec, "af1_lsb"))
            e.af2 = rs("af2")
            e.aode = _read(dec, "aode")
            e.delta_n = rs("delta_n")
            self._msb["cuc_msb"] = _read(dec, "cuc_msb")
        elif page == 5:
            self._assemble("cuc", _read(dec, "cuc_lsb"))
            e.m0 = _read_signed(dec, "m0") * _SCALE["m0"]
            e.cus = rs("cus")
            self._msb["e_msb"] = _read(dec, "e_msb")
        elif page == 6:
            self._assemble("ecc", _read(dec, "e_lsb"))
            e.sqrt_a = _read(dec, "sqrt_a") * _SCALE["sqrt_a"]
            self._msb["cic_msb"] = _read(dec, "cic_msb")
        elif page == 7:
            self._assemble("cic", _read(dec, "cic_lsb"))
            e.cis = rs("cis")
            e.toe = _read(dec, "toe") * _SCALE["toe"]
            self._msb["i0_msb"] = _read(dec, "i0_msb")
        elif page == 8:
            self._assemble("i0", _read(dec, "i0_lsb"))
            e.crc = rs("crc")
            e.crs = rs("crs")
            self._msb["omega_dot_msb"] = _read(dec, "omega_dot_msb")
        elif page == 9:
            self._assemble("omega_dot", _read(dec, "omega_dot_lsb"))
            e.omega0 = _read_signed(dec, "omega0") * _SCALE["omega0"]
            self._msb["omega_msb"] = _read(dec, "omega_msb")
        elif page == 10:
            self._assemble("omega", _read(dec, "omega_lsb"))
            e.idot = rs("idot")
        if 1 <= page <= PAGES:
            self.pages_seen.add(page)
            if self.complete:
                e.has_sf1 = e.has_sf2 = e.has_sf3 = True
                e._toe_msb2 = 0
                e._toe_lsb15 = 0
        return page, sow


def encode_d2_page(eph: BeidouEphemeris, iono: dict, page: int,
                   sow_bdt: float) -> np.ndarray:
    """300 transmitted bits for one D2 subframe-1 page."""
    dec = np.zeros(SUBFRAME_BITS, dtype=np.int8)
    dec[0:11] = PREAMBLE
    _write(dec, "fraid", 1)
    _write(dec, "sow", int(round(sow_bdt)))
    _write(dec, "pnum", page)

    def ws(key, value):
        _write(dec, key, int(round(value / _SCALE[key])))

    def split_units(name, value):
        _, lsb_key, total, _ = _SPLIT[name]
        units = int(round(value / _SCALE[name])) & ((1 << total) - 1)
        lsb_bits = _width(lsb_key)
        return units >> lsb_bits, units & ((1 << lsb_bits) - 1)

    if page == 1:
        _write(dec, "sat_h1", eph.sv_health & 1)
        _write(dec, "aodc", eph.aodc)
        _write(dec, "urai", eph.ura_index)
        _write(dec, "wn", eph.week)
        ws("toc", eph.toc)
        ws("tgd1", eph.tgd)
    elif page == 2:
        for k in ("alpha0", "alpha1", "alpha2", "alpha3",
                  "beta0", "beta1", "beta2", "beta3"):
            ws(k, iono.get(k, 0.0))
    elif page == 3:
        ws("af0", eph.af0)
        _write(dec, "af1_msb", split_units("af1", eph.af1)[0])
    elif page == 4:
        _write(dec, "af1_lsb", split_units("af1", eph.af1)[1])
        ws("af2", eph.af2)
        _write(dec, "aode", eph.aode)
        ws("delta_n", eph.delta_n)
        _write(dec, "cuc_msb", split_units("cuc", eph.cuc)[0])
    elif page == 5:
        _write(dec, "cuc_lsb", split_units("cuc", eph.cuc)[1])
        ws("m0", eph.m0)
        ws("cus", eph.cus)
        _write(dec, "e_msb", split_units("ecc", eph.ecc)[0])
    elif page == 6:
        _write(dec, "e_lsb", split_units("ecc", eph.ecc)[1])
        ws("sqrt_a", eph.sqrt_a)
        _write(dec, "cic_msb", split_units("cic", eph.cic)[0])
    elif page == 7:
        _write(dec, "cic_lsb", split_units("cic", eph.cic)[1])
        ws("cis", eph.cis)
        ws("toe", eph.toe)
        _write(dec, "i0_msb", split_units("i0", eph.i0)[0])
    elif page == 8:
        _write(dec, "i0_lsb", split_units("i0", eph.i0)[1])
        ws("crc", eph.crc)
        ws("crs", eph.crs)
        _write(dec, "omega_dot_msb", split_units("omega_dot", eph.omega_dot)[0])
    elif page == 9:
        _write(dec, "omega_dot_lsb", split_units("omega_dot", eph.omega_dot)[1])
        ws("omega0", eph.omega0)
        _write(dec, "omega_msb", split_units("omega", eph.omega)[0])
    elif page == 10:
        _write(dec, "omega_lsb", split_units("omega", eph.omega)[1])
        ws("idot", eph.idot)
    out = np.empty(SUBFRAME_BITS, dtype=np.int8)
    for w in range(10):
        out[w * 30:(w + 1) * 30] = encode_word(dec[w * 30:(w + 1) * 30],
                                               w + 1)
    return out


class D2Encoder:
    """Simulator-side D2 bit stream: bit n of the BDT week at 500 bps.
    Subframe k spans SOW [0.6k, 0.6(k+1)); subframe 1 fires when k%5 == 0
    with page (k//5) % 10 + 1; other subframes carry a neutral filler
    page (valid preamble + FRAID, empty payload)."""

    def __init__(self, eph: BeidouEphemeris, iono: dict | None = None) -> None:
        self.eph = eph
        self.iono = iono or {}
        self._cache: dict[int, np.ndarray] = {}

    def subframe(self, k: int) -> np.ndarray:
        sf = self._cache.get(k)
        if sf is None:
            # SOW is integer-valued: every subframe carries the SOW of its
            # FRAME's leading edge (frames are 3 s = 5 subframes; the
            # subframe id recovers the 0.6 s offset)
            sow = 3 * (k // 5)
            if k % 5 == 0:
                page = (k // 5) % PAGES + 1
                sf = encode_d2_page(self.eph, self.iono, page, sow)
            else:
                dec = np.zeros(SUBFRAME_BITS, dtype=np.int8)
                dec[0:11] = PREAMBLE
                _write(dec, "fraid", k % 5 + 1)
                _write(dec, "sow", int(sow))
                sf = np.empty(SUBFRAME_BITS, dtype=np.int8)
                for w in range(10):
                    sf[w * 30:(w + 1) * 30] = encode_word(
                        dec[w * 30:(w + 1) * 30], w + 1)
            self._cache[k] = sf
        return sf

    def bits_at(self, bit_indices: np.ndarray) -> np.ndarray:
        out = np.empty(bit_indices.shape, dtype=np.float64)
        flat = bit_indices.ravel()
        res = out.ravel()
        for j, b in enumerate(flat):
            k = int(b) // SUBFRAME_BITS
            within = int(b) % SUBFRAME_BITS
            res[j] = 1.0 - 2.0 * self.subframe(k)[within]
        return out


class D2Decoder:
    """Streaming D2 decoder: feed 2 ms symbol signs, get TOW + ephemeris
    events (GPS timescale). Interface-compatible with D1Decoder."""

    def __init__(self, prn: int) -> None:
        self.prn = prn
        self.asm = D2EphemerisAssembler(prn)
        self.bits: list[int] = []
        self.stamps: list[int] = []
        self.synced = False
        self.inverted = False
        self.frame_start: int | None = None
        self.subframes_ok = 0
        self.subframes_bad = 0

    @property
    def eph(self) -> BeidouEphemeris:
        return self.asm.eph

    @property
    def iono(self) -> dict:
        return self.asm.iono

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
        from gnss_sdr_tpu_torch.telemetry.dnav import _read as _read_d1

        sf_id = _read_d1(dec, "fraid")
        sow = float(_read(dec, "sow"))
        page = 0
        if sf_id == 1:
            page, sow = self.asm.push_page(dec)
        self.subframes_ok += 1
        end_stamp = self.stamps[i + SUBFRAME_BITS - 1]
        # SOW marks the frame's leading edge; this subframe ends
        # (sf_id-1)*0.6 + 0.6 s later
        tow_gps = (sow + (sf_id - 1) * SUBFRAME_SECONDS + SUBFRAME_SECONDS
                   + BDT_TO_GPST_S)
        self.frame_start = i + SUBFRAME_BITS
        keep_from = self.frame_start
        self.bits = self.bits[keep_from:]
        self.stamps = self.stamps[keep_from:]
        self.frame_start = 0
        return {
            "prn": self.prn,
            "subframe": sf_id,
            "page": page,
            "tow_s": tow_gps,
            "sample_stamp": end_stamp,
            "ephemeris_complete": self.eph.complete,
        }
