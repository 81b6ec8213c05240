# Copied from gnss_sdr_tpu/pvt/sbas_corr.py; only the package imports are rewritten.
"""SBAS correction engine: DO-229 message payloads -> range/iono
corrections for the single-point solver.

Reference analog: src/algorithms/libs/rtklib/rtklib_sbas.cc —
decode_sbstype1/2/5/18/25/26 (:200-560), sbsfastcorr/sbslongcorr
(:700-800), searchigp + sbsioncorr (:560-660). The telemetry side
(telemetry/sbas.py) frames/CRC-checks the 250-bit messages; this module
decodes the 212-bit payloads and applies:

- MT1     PRN mask (51 slots) + IODP
- MT2-5   fast pseudorange corrections (13 slots/message, 0.125 m LSB)
- MT25    long-term satellite position/clock error (velocity code 0/1)
- MT18    ionospheric grid point (IGP) masks per band (DO-229 band
          tables, bands 0-10)
- MT26    ionospheric vertical delays at the masked IGPs (0.125 m LSB)

Application is pseudorange-domain: fast PRC adds directly; long-term
corrections project onto the receiver-satellite line of sight; the iono
grid interpolates the vertical delay at the pierce point bilinearly and
scales by the DO-229 obliquity factor (replacing Klobuchar when
available).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

C_M_S = 299_792_458.0
R_EARTH_M = 6378136.3
H_IONO_M = 350_000.0

# ------------------------------------------------------- DO-229 IGP bands
# Latitude column patterns (degrees) — DO-229 Appendix A IGP band tables
_X1 = [-75, -65] + list(range(-55, 56, 5)) + [65, 75, 85]
_X2 = list(range(-55, 56, 5))
_X3 = [-75, -65] + list(range(-55, 56, 5)) + [65, 75]
_X4 = [-85, -75, -65] + list(range(-55, 56, 5)) + [65, 75]
_X5 = list(range(-180, 176, 5))
_X6 = list(range(-180, 171, 10))
_X7 = list(range(-180, 151, 30))
_X8 = list(range(-170, 161, 30))

# bands 0-8: (longitude, lat-pattern, first mask bit, last mask bit)
_BAND1 = [
    [(-180, _X1, 1, 28), (-175, _X2, 29, 51), (-170, _X3, 52, 78),
     (-165, _X2, 79, 101), (-160, _X3, 102, 128), (-155, _X2, 129, 151),
     (-150, _X3, 152, 178), (-145, _X2, 179, 201)],
    [(-140, _X4, 1, 28), (-135, _X2, 29, 51), (-130, _X3, 52, 78),
     (-125, _X2, 79, 101), (-120, _X3, 102, 128), (-115, _X2, 129, 151),
     (-110, _X3, 152, 178), (-105, _X2, 179, 201)],
    [(-100, _X3, 1, 27), (-95, _X2, 28, 50), (-90, _X1, 51, 78),
     (-85, _X2, 79, 101), (-80, _X3, 102, 128), (-75, _X2, 129, 151),
     (-70, _X3, 152, 178), (-65, _X2, 179, 201)],
    [(-60, _X3, 1, 27), (-55, _X2, 28, 50), (-50, _X4, 51, 78),
     (-45, _X2, 79, 101), (-40, _X3, 102, 128), (-35, _X2, 129, 151),
     (-30, _X3, 152, 178), (-25, _X2, 179, 201)],
    [(-20, _X3, 1, 27), (-15, _X2, 28, 50), (-10, _X3, 51, 77),
     (-5, _X2, 78, 100), (0, _X1, 101, 128), (5, _X2, 129, 151),
     (10, _X3, 152, 178), (15, _X2, 179, 201)],
    [(20, _X3, 1, 27), (25, _X2, 28, 50), (30, _X3, 51, 77),
     (35, _X2, 78, 100), (40, _X4, 101, 128), (45, _X2, 129, 151),
     (50, _X3, 152, 178), (55, _X2, 179, 201)],
    [(60, _X3, 1, 27), (65, _X2, 28, 50), (70, _X3, 51, 77),
     (75, _X2, 78, 100), (80, _X3, 101, 127), (85, _X2, 128, 150),
     (90, _X1, 151, 178), (95, _X2, 179, 201)],
    [(100, _X3, 1, 27), (105, _X2, 28, 50), (110, _X3, 51, 77),
     (115, _X2, 78, 100), (120, _X3, 101, 127), (125, _X2, 128, 150),
     (130, _X4, 151, 178), (135, _X2, 179, 201)],
    [(140, _X3, 1, 27), (145, _X2, 28, 50), (150, _X3, 51, 77),
     (155, _X2, 78, 100), (160, _X3, 101, 127), (165, _X2, 128, 150),
     (170, _X3, 151, 177), (175, _X2, 178, 200)],
]
# bands 9-10: (latitude, lon-pattern, first, last)
_BAND2 = [
    [(60, _X5, 1, 72), (65, _X6, 73, 108), (70, _X6, 109, 144),
     (75, _X6, 145, 180), (85, _X7, 181, 192)],
    [(-60, _X5, 1, 72), (-65, _X6, 73, 108), (-70, _X6, 109, 144),
     (-75, _X6, 145, 180), (-85, _X8, 181, 192)],
]


def igp_latlon(band: int, mask_bit: int) -> tuple[float, float] | None:
    """(lat, lon) of IGP ``mask_bit`` (1-based) in ``band``, or None."""
    if 0 <= band <= 8:
        for lon, ys, b0, b1 in _BAND1[band]:
            if b0 <= mask_bit <= b1:
                return float(ys[mask_bit - b0]), float(lon)
    elif band in (9, 10):
        for lat, xs, b0, b1 in _BAND2[band - 9]:
            if b0 <= mask_bit <= b1:
                return float(lat), float(xs[mask_bit - b0])
    return None


# --------------------------------------------------------- payload codecs
def _bits_to_uint(bits, start, n):
    v = 0
    for k in range(n):
        v = (v << 1) | int(bits[start + k])
    return v


def _bits_to_int(bits, start, n):
    v = _bits_to_uint(bits, start, n)
    return v - (1 << n) if v & (1 << (n - 1)) else v


def _uint_to_bits(bits, start, n, value):
    v = int(value) & ((1 << n) - 1)
    for k in range(n):
        bits[start + k] = (v >> (n - 1 - k)) & 1


def decode_mt1(data: np.ndarray) -> dict:
    """PRN mask: 210 mask bits (PRN 1..210) + 2-bit IODP."""
    prns = [i + 1 for i in range(210) if data[i]]
    return {"type": 1, "prns": prns, "iodp": _bits_to_uint(data, 210, 2)}


def encode_mt1(prns: list[int], iodp: int = 0) -> np.ndarray:
    data = np.zeros(212, dtype=np.int8)
    for p in prns:
        data[p - 1] = 1
    _uint_to_bits(data, 210, 2, iodp)
    return data


def decode_mt2_5(data: np.ndarray, msg_type: int) -> dict:
    """Fast corrections: IODF(2), IODP(2), 13x PRC(12, 0.125 m),
    13x UDREI(4). Message t covers mask slots 13(t-2)+1 .. 13(t-2)+13."""
    iodf = _bits_to_uint(data, 0, 2)
    iodp = _bits_to_uint(data, 2, 2)
    prc = [_bits_to_int(data, 4 + 12 * i, 12) * 0.125 for i in range(13)]
    udrei = [_bits_to_uint(data, 160 + 4 * i, 4) for i in range(13)]
    return {"type": msg_type, "iodf": iodf, "iodp": iodp,
            "slot0": 13 * (msg_type - 2), "prc_m": prc, "udrei": udrei}


def encode_mt2_5(prc_m: list[float], iodf: int = 0,
                 iodp: int = 0) -> np.ndarray:
    data = np.zeros(212, dtype=np.int8)
    _uint_to_bits(data, 0, 2, iodf)
    _uint_to_bits(data, 2, 2, iodp)
    for i, v in enumerate(prc_m[:13]):
        _uint_to_bits(data, 4 + 12 * i, 12, int(round(v / 0.125)))
    for i in range(13):
        _uint_to_bits(data, 160 + 4 * i, 4, 14)  # UDREI placeholder
    return data


def decode_mt25(data: np.ndarray) -> dict:
    """Long-term satellite error corrections: two independent 106-bit
    halves; velocity code 0 packs 2 satellites (dx,dy,dz 9 bits x 0.125 m
    + daf0 10 bits x 2^-31), velocity code 1 packs 1 satellite with
    velocity terms (11-bit positions, 8-bit rates)."""
    out = []
    for h in range(2):
        base = 106 * h
        vel = int(data[base])
        if vel == 0:
            p = base + 1
            for _ in range(2):
                slot = _bits_to_uint(data, p, 6)
                iode = _bits_to_uint(data, p + 6, 8)
                d = [_bits_to_int(data, p + 14 + 9 * k, 9) * 0.125
                     for k in range(3)]
                daf0 = _bits_to_int(data, p + 41, 10) * 2.0**-31
                if slot:
                    out.append({"slot": slot, "iode": iode,
                                "dpos_m": np.array(d), "daf0_s": daf0,
                                "dvel_ms": np.zeros(3), "daf1_ss": 0.0,
                                "t0_s": None})
                p += 51
        else:
            p = base + 1
            slot = _bits_to_uint(data, p, 6)
            iode = _bits_to_uint(data, p + 6, 8)
            d = [_bits_to_int(data, p + 14 + 11 * k, 11) * 0.125
                 for k in range(3)]
            daf0 = _bits_to_int(data, p + 47, 11) * 2.0**-31
            dv = [_bits_to_int(data, p + 58 + 8 * k, 8) * 2.0**-11
                  for k in range(3)]
            daf1 = _bits_to_int(data, p + 82, 8) * 2.0**-39
            t0 = _bits_to_uint(data, p + 90, 13) * 16.0
            if slot:
                out.append({"slot": slot, "iode": iode,
                            "dpos_m": np.array(d), "daf0_s": daf0,
                            "dvel_ms": np.array(dv), "daf1_ss": daf1,
                            "t0_s": t0})
    return {"type": 25, "corrections": out}


def encode_mt25_vel0(sats: list[dict]) -> np.ndarray:
    """Velocity-code-0 MT25 for up to 4 satellites
    ({slot, iode, dpos_m, daf0_s})."""
    data = np.zeros(212, dtype=np.int8)
    for h in range(2):
        base = 106 * h
        data[base] = 0
        p = base + 1
        for s in sats[2 * h: 2 * h + 2]:
            _uint_to_bits(data, p, 6, s["slot"])
            _uint_to_bits(data, p + 6, 8, s.get("iode", 0))
            for k in range(3):
                _uint_to_bits(data, p + 14 + 9 * k, 9,
                              int(round(s["dpos_m"][k] / 0.125)))
            _uint_to_bits(data, p + 41, 10,
                          int(round(s["daf0_s"] / 2.0**-31)))
            p += 51
    return data


def decode_mt18(data: np.ndarray) -> dict:
    """IGP mask: n_bands(4), band(4), IODI(2), 201 mask bits."""
    band = _bits_to_uint(data, 4, 4)
    iodi = _bits_to_uint(data, 8, 2)
    igps = []
    for i in range(1, 202):
        if data[9 + i]:
            ll = igp_latlon(band, i)
            if ll is not None:
                igps.append(ll)
    return {"type": 18, "band": band, "iodi": iodi, "igps": igps}


def encode_mt18(band: int, mask_bits: list[int], iodi: int = 0,
                n_bands: int = 1) -> np.ndarray:
    data = np.zeros(212, dtype=np.int8)
    _uint_to_bits(data, 0, 4, n_bands)
    _uint_to_bits(data, 4, 4, band)
    _uint_to_bits(data, 8, 2, iodi)
    for b in mask_bits:
        data[9 + b] = 1
    return data


def decode_mt26(data: np.ndarray) -> dict:
    """Iono delays: band(4), block(4), 15 x (delay 9 bits x 0.125 m,
    GIVEI 4 bits), IODI(2)."""
    band = _bits_to_uint(data, 0, 4)
    block = _bits_to_uint(data, 4, 4)
    entries = []
    for i in range(15):
        d = _bits_to_uint(data, 8 + 13 * i, 9)
        give = _bits_to_uint(data, 8 + 13 * i + 9, 4)
        entries.append({"delay_m": None if d == 0x1FF else d * 0.125,
                        "givei": give})
    iodi = _bits_to_uint(data, 8 + 13 * 15, 2)
    return {"type": 26, "band": band, "block": block, "entries": entries,
            "iodi": iodi}


def encode_mt26(band: int, block: int, delays_m: list[float | None],
                iodi: int = 0) -> np.ndarray:
    data = np.zeros(212, dtype=np.int8)
    _uint_to_bits(data, 0, 4, band)
    _uint_to_bits(data, 4, 4, block)
    for i in range(15):
        d = delays_m[i] if i < len(delays_m) else None
        units = 0x1FF if d is None else int(round(d / 0.125))
        _uint_to_bits(data, 8 + 13 * i, 9, units)
        _uint_to_bits(data, 8 + 13 * i + 9, 4, 7)
    _uint_to_bits(data, 8 + 13 * 15, 2, iodi)
    return data


# ------------------------------------------------------------- the engine
@dataclass
class SbasCorrections:
    """Correction store fed by decoded SBAS messages; query per satellite
    and per pierce point (rtklib sbssatcorr/sbsioncorr analog)."""

    prn_mask: list[int] = field(default_factory=list)   # slot i -> PRN
    fast_prc_m: dict[int, float] = field(default_factory=dict)   # prn -> m
    long_term: dict[int, dict] = field(default_factory=dict)     # prn -> c
    # band -> list of (lat, lon) from MT18, in mask order
    igp_masks: dict[int, list] = field(default_factory=dict)
    # (lat, lon) -> vertical delay m
    igp_delay_m: dict[tuple, float] = field(default_factory=dict)

    def ingest(self, msg_type: int, data: np.ndarray) -> None:
        """Feed one CRC-checked message payload (212 bits)."""
        if msg_type == 1:
            self.prn_mask = decode_mt1(data)["prns"]
        elif msg_type in (2, 3, 4, 5):
            m = decode_mt2_5(data, msg_type)
            for i, prc in enumerate(m["prc_m"]):
                slot = m["slot0"] + i
                if slot < len(self.prn_mask):
                    self.fast_prc_m[self.prn_mask[slot]] = prc
        elif msg_type == 24:
            # mixed message: first half = 6 fast slots (not stored — MT24
            # is rare on modern SBAS), second half = one MT25 half
            m = decode_mt25(np.concatenate(
                [data[106:212], np.zeros(106, np.int8)]))
            for c in m["corrections"]:
                if c["slot"] - 1 < len(self.prn_mask):
                    self.long_term[self.prn_mask[c["slot"] - 1]] = c
        elif msg_type == 25:
            for c in decode_mt25(data)["corrections"]:
                if c["slot"] - 1 < len(self.prn_mask):
                    self.long_term[self.prn_mask[c["slot"] - 1]] = c
        elif msg_type == 18:
            m = decode_mt18(data)
            self.igp_masks[m["band"]] = m["igps"]
        elif msg_type == 26:
            m = decode_mt26(data)
            igps = self.igp_masks.get(m["band"])
            if igps is None:
                return
            for i, e in enumerate(m["entries"]):
                j = m["block"] * 15 + i
                if j < len(igps) and e["delay_m"] is not None:
                    self.igp_delay_m[igps[j]] = e["delay_m"]

    # ------------------------------------------------------------ queries
    def fast_correction(self, prn: int) -> float:
        """Pseudorange correction (m), added to the measured range."""
        return self.fast_prc_m.get(prn, 0.0)

    def long_term_range_correction(self, prn: int,
                                   los_unit: np.ndarray) -> float:
        """Pseudorange-domain long-term correction: satellite position
        error projected on the (sat->rx) line of sight plus the clock
        term (rtklib sbslongcorr applies dpos to rs and daf0 to dts; in
        range domain: dPR = -los . dpos - c*daf0 with los pointing
        rx->sat)."""
        c = self.long_term.get(prn)
        if c is None:
            return 0.0
        return float(-np.dot(los_unit, c["dpos_m"]) - C_M_S * c["daf0_s"])

    def iono_delay_m(self, lat_pp_rad: float, lon_pp_rad: float,
                     elevation_rad: float) -> float | None:
        """Slant L1 iono delay at the pierce point, or None when the grid
        does not cover it (caller falls back to Klobuchar)."""
        lat = np.rad2deg(lat_pp_rad)
        lon = np.rad2deg(lon_pp_rad)
        if not self.igp_delay_m:
            return None
        # surrounding 5-degree cell (mid-latitudes; the high-latitude
        # 10-degree cells fall out of the same lookup on their grid)
        for step in (5.0, 10.0):
            la0 = np.floor(lat / step) * step
            lo0 = np.floor(lon / step) * step
            corners = [(la0, lo0), (la0 + step, lo0),
                       (la0, lo0 + step), (la0 + step, lo0 + step)]
            vals = [self.igp_delay_m.get(c) for c in corners]
            if all(v is not None for v in vals):
                xp = (lon - lo0) / step
                yp = (lat - la0) / step
                v = (vals[0] * (1 - xp) * (1 - yp) + vals[1] * (1 - xp) * yp
                     + vals[2] * xp * (1 - yp) + vals[3] * xp * yp)
                # DO-229 obliquity factor
                f = (1.0 - (R_EARTH_M * np.cos(elevation_rad)
                            / (R_EARTH_M + H_IONO_M)) ** 2) ** -0.5
                return float(v * f)
        return None


def pierce_point(lat_rad: float, lon_rad: float, az_rad: float,
                 el_rad: float) -> tuple[float, float]:
    """Ionospheric pierce point at 350 km (DO-229 A.4.4.10.1)."""
    psi = np.pi / 2 - el_rad - np.arcsin(
        R_EARTH_M / (R_EARTH_M + H_IONO_M) * np.cos(el_rad))
    lat_pp = np.arcsin(np.sin(lat_rad) * np.cos(psi)
                       + np.cos(lat_rad) * np.sin(psi) * np.cos(az_rad))
    lon_pp = lon_rad + np.arcsin(np.sin(psi) * np.sin(az_rad)
                                 / np.cos(lat_pp))
    return float(lat_pp), float(lon_pp)
