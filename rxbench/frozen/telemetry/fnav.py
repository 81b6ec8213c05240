# Frozen copy of gnss_sdr_tpu_torch/telemetry/fnav.py at commit 74b7c5f, imports rewritten to
# this package: the benchmark's generator and reference never import the port.
# Copied from gnss_sdr_tpu/telemetry/fnav.py; only the package imports are
# rewritten, and what the benchmark never calls is left out (the docstring is the original's).
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

from rxbench.frozen.telemetry.fec import block_interleave, conv_encode, crc24q
from rxbench.frozen.telemetry.inav import GalileoEphemeris, GalileoIono, _put

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
