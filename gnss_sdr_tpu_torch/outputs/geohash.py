# Copied from gnss_sdr_tpu/outputs/geohash.py; only the package imports are rewritten.
"""Geohash encoder (reference: PVT/libs/geohash.cc)."""

from __future__ import annotations

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def geohash_encode(lat_deg: float, lon_deg: float, precision: int = 12) -> str:
    """Standard geohash of a WGS84 position."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    bits = []
    even = True
    while len(bits) < precision * 5:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon_deg >= mid:
                bits.append(1)
                lon_lo = mid
            else:
                bits.append(0)
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat_deg >= mid:
                bits.append(1)
                lat_lo = mid
            else:
                bits.append(0)
                lat_hi = mid
        even = not even
    out = []
    for i in range(precision):
        v = 0
        for b in bits[i * 5 : i * 5 + 5]:
            v = (v << 1) | b
        out.append(_BASE32[v])
    return "".join(out)
