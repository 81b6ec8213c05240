# Frozen copy of gnss_sdr_tpu_torch/telemetry/lnav_encode.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/telemetry/lnav_encode.py; only the package imports are rewritten.
"""GPS LNAV message encoder (simulator side).

Inverse of telemetry/lnav.py: packs a GpsEphemeris into subframes 1-3 with
correct (32,26) parity chaining, D30* data inversion on air, and HOW
non-information bits solved so each word-2/word-10 leaves D29=D30=0
(IS-GPS-200 §20.3.3.2). Subframes 4/5 are emitted as parity-valid filler
until almanac support lands.

This is part of the signal-generator capability (reference: the gnss-sim
external simulator used by system tests, SURVEY.md §4; and
signal_generator_c.cc which modulates externally supplied data bits).
"""

from __future__ import annotations

import numpy as np

from rxbench.frozen.telemetry.lnav import (
    BITS_PER_SUBFRAME,
    PI_GPS,
    PREAMBLE_BITS,
    SUBFRAME_SECONDS,
    GpsEphemeris,
    _PARITY_PREV,
    _PARITY_TAPS,
    compute_parity,
)


def _uint_bits(v: int, n: int) -> list[int]:
    if not 0 <= v < (1 << n):
        raise ValueError(f"value {v} does not fit in {n} unsigned bits")
    return [(v >> (n - 1 - i)) & 1 for i in range(n)]


def _int_bits(v: int, n: int) -> list[int]:
    if not -(1 << (n - 1)) <= v < (1 << (n - 1)):
        raise ValueError(f"value {v} does not fit in {n} signed bits")
    return _uint_bits(v & ((1 << n) - 1), n)


def _scaled_int(x: float, scale: float, n: int) -> list[int]:
    return _int_bits(int(round(x / scale)), n)


def _scaled_uint(x: float, scale: float, n: int) -> list[int]:
    return _uint_bits(int(round(x / scale)), n)


def _semi_int(x_rad: float, scale: float, n: int) -> list[int]:
    """Signed field in semicircles."""
    return _int_bits(int(round(x_rad / PI_GPS / scale)), n)


def _solve_word(d24: np.ndarray, d29s: int, d30s: int,
                force_zero_tail: bool) -> tuple[np.ndarray, int, int]:
    """Encode one word: returns (30 transmitted bits, D29, D30)."""
    d24 = d24.copy()
    if force_zero_tail:
        # choose d23,d24 so that computed D29 = D30 = 0
        prev = (d29s, d30s)
        a = prev[_PARITY_PREV[4]]
        for t in _PARITY_TAPS[4]:
            if t not in (23, 24):
                a ^= int(d24[t - 1])
        d24[23] = a                      # D29 taps include 24, not 23
        b = prev[_PARITY_PREV[5]]
        for t in _PARITY_TAPS[5]:
            if t not in (23, 24):
                b ^= int(d24[t - 1])
        d24[22] = b ^ int(d24[23])       # D30 taps include both 23 and 24
    par = compute_parity(d24, d29s, d30s)
    tx = np.empty(30, dtype=np.int8)
    tx[:24] = d24 ^ d30s                 # data bits inverted by D30* on air
    tx[24:] = par
    return tx, int(par[4]), int(par[5])


def encode_subframe(
    eph: GpsEphemeris, sf_id: int, tow_next_s: float,
    d29s: int = 0, d30s: int = 0,
    page: int | None = None,
    iono_utc=None,
    almanacs=None,
) -> np.ndarray:
    """300 transmitted bits for one subframe.

    tow_next_s: TOW at the start of the NEXT subframe (HOW definition).
    For subframes 4/5, `page` selects the page (SF4 page 18 = iono/UTC,
    SF5 pages 1-24 = almanac for SV=page).
    """
    words = [np.zeros(24, dtype=np.int8) for _ in range(10)]

    # TLM word: preamble + message (zeros) + integrity + reserved
    words[0][:8] = PREAMBLE_BITS
    # HOW: truncated TOW (17) + alert/AS (2) + subframe id (3) + t23/t24
    tow_trunc = int(round(tow_next_s / SUBFRAME_SECONDS))
    words[1][:17] = _uint_bits(tow_trunc, 17)
    words[1][19:22] = _uint_bits(sf_id, 3)

    def setb(w: int, a: int, b: int, bits: list[int]) -> None:
        words[w][a - 1 : b] = bits

    if sf_id == 1:
        setb(2, 1, 10, _uint_bits(eph.week % 1024, 10))
        setb(2, 11, 12, _uint_bits(1, 2))                 # C/A code on L2
        setb(2, 13, 16, _uint_bits(eph.ura_index, 4))
        setb(2, 17, 22, _uint_bits(eph.sv_health, 6))
        setb(2, 23, 24, _uint_bits(eph.iodc >> 8, 2))
        setb(6, 17, 24, _scaled_int(eph.tgd, 2.0**-31, 8))
        setb(7, 1, 8, _uint_bits(eph.iodc & 0xFF, 8))
        setb(7, 9, 24, _scaled_uint(eph.toc, 2.0**4, 16))
        setb(8, 1, 8, _scaled_int(eph.af2, 2.0**-55, 8))
        setb(8, 9, 24, _scaled_int(eph.af1, 2.0**-43, 16))
        setb(9, 1, 22, _scaled_int(eph.af0, 2.0**-31, 22))
    elif sf_id == 2:
        setb(2, 1, 8, _uint_bits(eph.iode_sf2, 8))
        setb(2, 9, 24, _scaled_int(eph.crs, 2.0**-5, 16))
        setb(3, 1, 16, _semi_int(eph.delta_n, 2.0**-43, 16))
        m0 = _semi_int(eph.m0, 2.0**-31, 32)
        setb(3, 17, 24, m0[:8])
        setb(4, 1, 24, m0[8:])
        setb(5, 1, 16, _scaled_int(eph.cuc, 2.0**-29, 16))
        ecc = _scaled_uint(eph.ecc, 2.0**-33, 32)
        setb(5, 17, 24, ecc[:8])
        setb(6, 1, 24, ecc[8:])
        setb(7, 1, 16, _scaled_int(eph.cus, 2.0**-29, 16))
        sqa = _scaled_uint(eph.sqrt_a, 2.0**-19, 32)
        setb(7, 17, 24, sqa[:8])
        setb(8, 1, 24, sqa[8:])
        setb(9, 1, 16, _scaled_uint(eph.toe, 2.0**4, 16))
        words[9][16] = eph.fit_interval
    elif sf_id == 3:
        setb(2, 1, 16, _scaled_int(eph.cic, 2.0**-29, 16))
        om0 = _semi_int(eph.omega0, 2.0**-31, 32)
        setb(2, 17, 24, om0[:8])
        setb(3, 1, 24, om0[8:])
        setb(4, 1, 16, _scaled_int(eph.cis, 2.0**-29, 16))
        i0 = _semi_int(eph.i0, 2.0**-31, 32)
        setb(4, 17, 24, i0[:8])
        setb(5, 1, 24, i0[8:])
        setb(6, 1, 16, _scaled_int(eph.crc, 2.0**-5, 16))
        om = _semi_int(eph.omega, 2.0**-31, 32)
        setb(6, 17, 24, om[:8])
        setb(7, 1, 24, om[8:])
        setb(8, 1, 24, _semi_int(eph.omega_dot, 2.0**-43, 24))
        setb(9, 1, 8, _uint_bits(eph.iode_sf3, 8))
        setb(9, 9, 22, _semi_int(eph.idot, 2.0**-43, 14))
    elif sf_id in (4, 5) and page is not None:
        _encode_page45(words, setb, sf_id, page, iono_utc, almanacs)
    # sf 4/5 without page data: parity-valid filler (data zeros)

    out = np.empty(BITS_PER_SUBFRAME, dtype=np.int8)
    for wi in range(10):
        force = wi in (1, 9)        # HOW and word 10 end with D29=D30=0
        tx, d29s, d30s = _solve_word(words[wi], d29s, d30s, force)
        out[wi * 30 : (wi + 1) * 30] = tx
    return out


def _encode_page45(words, setb, sf_id: int, page: int,
                   iono_utc, almanacs) -> None:
    """Fill subframe 4/5 page data (IS-GPS-200 20.3.3.5.1): page 18 of SF4
    carries iono+UTC; SF5 pages 1-24 carry the almanac for SV=page."""
    if sf_id == 4 and page == 18 and iono_utc is not None:
        setb(2, 1, 2, _uint_bits(1, 2))                   # data ID
        setb(2, 3, 8, _uint_bits(56, 6))                  # SV (page) ID
        setb(2, 9, 16, _scaled_int(iono_utc.alpha0, 2.0**-30, 8))
        setb(2, 17, 24, _scaled_int(iono_utc.alpha1, 2.0**-27, 8))
        setb(3, 1, 8, _scaled_int(iono_utc.alpha2, 2.0**-24, 8))
        setb(3, 9, 16, _scaled_int(iono_utc.alpha3, 2.0**-24, 8))
        setb(3, 17, 24, _scaled_int(iono_utc.beta0, 2.0**11, 8))
        setb(4, 1, 8, _scaled_int(iono_utc.beta1, 2.0**14, 8))
        setb(4, 9, 16, _scaled_int(iono_utc.beta2, 2.0**16, 8))
        setb(4, 17, 24, _scaled_int(iono_utc.beta3, 2.0**16, 8))
        setb(5, 1, 24, _scaled_int(iono_utc.a1, 2.0**-50, 24))
        a0 = _scaled_int(iono_utc.a0, 2.0**-30, 32)
        setb(6, 1, 24, a0[:24])
        setb(7, 1, 8, a0[24:])
        setb(7, 9, 16, _scaled_uint(iono_utc.tot, 2.0**12, 8))
        setb(7, 17, 24, _uint_bits(iono_utc.wn_t & 0xFF, 8))
        setb(8, 1, 8, _scaled_int(float(iono_utc.delta_t_ls), 1.0, 8))
        setb(8, 9, 16, _uint_bits(iono_utc.wn_lsf & 0xFF, 8))
        setb(8, 17, 24, _uint_bits(iono_utc.dn & 0xFF, 8))
        setb(9, 1, 8, _scaled_int(float(iono_utc.delta_t_lsf), 1.0, 8))
    elif sf_id == 5 and 1 <= page <= 24 and almanacs and page in almanacs:
        alm = almanacs[page]
        setb(2, 1, 2, _uint_bits(1, 2))
        setb(2, 3, 8, _uint_bits(page, 6))                # SV ID = page
        setb(2, 9, 24, _scaled_uint(alm.ecc, 2.0**-21, 16))
        setb(3, 1, 8, _scaled_uint(alm.toa, 2.0**12, 8))
        setb(3, 9, 24, _semi_int(alm.delta_i, 2.0**-19, 16))
        setb(4, 1, 16, _semi_int(alm.omega_dot, 2.0**-38, 16))
        setb(4, 17, 24, _uint_bits(alm.sv_health, 8))
        setb(5, 1, 24, _scaled_uint(alm.sqrt_a, 2.0**-11, 24))
        setb(6, 1, 24, _semi_int(alm.omega0, 2.0**-23, 24))
        setb(7, 1, 24, _semi_int(alm.omega, 2.0**-23, 24))
        setb(8, 1, 24, _semi_int(alm.m0, 2.0**-23, 24))
        af0 = _scaled_int(alm.af0, 2.0**-20, 11)
        setb(9, 1, 8, af0[:8])
        setb(9, 20, 22, af0[8:])
        setb(9, 9, 19, _scaled_int(alm.af1, 2.0**-38, 11))


class LnavEncoder:
    """Bit stream source for one satellite: bit n of the week <-> TOW n/50.

    With `iono_utc`/`almanacs`, subframes 4/5 carry real pages on the
    IS-GPS-200 25-frame cycle. `sf4_page18_every_frame` pins SF4 to the
    iono/UTC page each frame (simulator convenience: real receivers wait
    up to 12.5 min for page 18; tests need it inside a 30 s capture)."""

    def __init__(self, eph: GpsEphemeris, iono_utc=None, almanacs=None,
                 sf4_page18_every_frame: bool = False) -> None:
        self.eph = eph
        self.iono_utc = iono_utc
        self.almanacs = almanacs or {}
        self.page18_always = sf4_page18_every_frame
        self._cache: dict[int, np.ndarray] = {}

    def subframe(self, epoch: int) -> np.ndarray:
        """Transmitted bits of the subframe starting at TOW = 6*epoch."""
        sf = self._cache.get(epoch)
        if sf is None:
            sf_id = (epoch % 5) + 1
            page = None
            if sf_id in (4, 5):
                frame = epoch // 5
                page = (frame % 25) + 1
                if sf_id == 4 and self.page18_always:
                    page = 18
            # word-10 tail forcing guarantees D29*=D30*=0 at subframe start
            sf = encode_subframe(
                self.eph, sf_id, 6.0 * (epoch + 1), 0, 0,
                page=page, iono_utc=self.iono_utc, almanacs=self.almanacs,
            )
            self._cache[epoch] = sf
        return sf

    def bits_at(self, bit_indices: np.ndarray) -> np.ndarray:
        """Signs (+1.0 for bit 0 / -1.0 for bit 1) for absolute bit indices
        (bit k spans TOW [k, k+1) / 50)."""
        out = np.empty(bit_indices.shape, dtype=np.float64)
        flat = bit_indices.ravel()
        res = out.ravel()
        for j, b in enumerate(flat):
            epoch = int(b) // BITS_PER_SUBFRAME
            within = int(b) % BITS_PER_SUBFRAME
            res[j] = 1.0 - 2.0 * self.subframe(epoch)[within]
        return out
