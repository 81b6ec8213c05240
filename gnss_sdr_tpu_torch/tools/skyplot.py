"""Skyplot generator (reference utils/skyplot analog).

Renders the tracked satellites' azimuth/elevation as an SVG polar skyplot
(plus an ASCII fallback) from either:
  - an assistance XML + receiver position + TOW (offline, ephemeris
    propagation via pvt/ephemeris.py), or
  - a live PVT-monitor UDP stream (gnss_sdr_tpu_torch/monitor/sinks.py).

Run (offline):
  python -m gnss_sdr_tpu_torch.tools.skyplot --assistance rx_assist.xml \
      --lat 41.27 --lon 1.99 --h 80 --tow 7314 [--out sky.svg]

The reference ships a Python matplotlib skyplot consuming nav-listener
data; this version renders standalone SVG so it works in headless CI.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np

_SYS_COLOR = {"G": "#1f77b4", "E": "#2ca02c", "R": "#d62728",
              "C": "#ff7f0e", "J": "#9467bd", "S": "#8c564b"}


def sky_positions(ephemerides: dict, rx_ecef: np.ndarray, tow_s: float):
    """[(system, prn, az_rad, el_rad)] for satellites above the horizon."""
    from gnss_sdr_tpu_torch.pvt.coords import az_el
    from gnss_sdr_tpu_torch.pvt.ephemeris import eph_to_pos_vel_clock

    out = []
    for (sysid, prn), eph in sorted(ephemerides.items()):
        try:
            pos, _, _, _ = eph_to_pos_vel_clock(eph, tow_s)
        except Exception:
            continue
        az, el = az_el(rx_ecef, np.asarray(pos))
        if el > 0:
            out.append((sysid, prn, az, el))
    return out


def render_svg(sats, size: int = 480) -> str:
    """Polar skyplot: zenith at center, horizon at the outer ring,
    north up, azimuth clockwise (compass convention)."""
    cx = cy = size / 2
    rmax = size / 2 - 30
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}" viewBox="0 0 {size} {size}">',
        f'<rect width="{size}" height="{size}" fill="white"/>',
    ]
    for el_deg in (0, 30, 60):
        r = rmax * (1 - el_deg / 90)
        parts.append(
            f'<circle cx="{cx}" cy="{cy}" r="{r:.1f}" fill="none" '
            f'stroke="#ccc"/>')
        parts.append(
            f'<text x="{cx + 3:.0f}" y="{cy - r + 12:.0f}" '
            f'font-size="10" fill="#999">{el_deg}°</text>')
    for az_deg, label in ((0, "N"), (90, "E"), (180, "S"), (270, "W")):
        a = math.radians(az_deg)
        x2 = cx + rmax * math.sin(a)
        y2 = cy - rmax * math.cos(a)
        parts.append(
            f'<line x1="{cx}" y1="{cy}" x2="{x2:.1f}" y2="{y2:.1f}" '
            f'stroke="#eee"/>')
        lx = cx + (rmax + 14) * math.sin(a)
        ly = cy - (rmax + 14) * math.cos(a)
        parts.append(
            f'<text x="{lx:.1f}" y="{ly + 4:.1f}" font-size="13" '
            f'text-anchor="middle" fill="#333">{label}</text>')
    for sysid, prn, az, el in sats:
        r = rmax * (1 - math.degrees(el) / 90)
        x = cx + r * math.sin(az)
        y = cy - r * math.cos(az)
        col = _SYS_COLOR.get(sysid, "#333")
        parts.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="7" fill="{col}" '
            f'fill-opacity="0.85"/>')
        parts.append(
            f'<text x="{x:.1f}" y="{y - 10:.1f}" font-size="10" '
            f'text-anchor="middle" fill="{col}">{sysid}{prn:02d}</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def render_ascii(sats, width: int = 41) -> str:
    """Quick terminal skyplot (one char per satellite)."""
    h = width // 2
    grid = [[" "] * width for _ in range(width)]
    for x in range(width):
        for y in range(width):
            d = math.hypot(x - h, y - h)
            if abs(d - h) < 0.5:
                grid[y][x] = "."
    for sysid, prn, az, el in sats:
        r = h * (1 - math.degrees(el) / 90)
        x = int(round(h + r * math.sin(az)))
        y = int(round(h - r * math.cos(az)))
        if 0 <= x < width and 0 <= y < width:
            grid[y][x] = sysid
    return "\n".join("".join(row) for row in grid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--assistance", required=True,
                    help="assistance XML (receiver/assistance.py)")
    ap.add_argument("--lat", type=float, required=True)
    ap.add_argument("--lon", type=float, required=True)
    ap.add_argument("--h", type=float, default=0.0)
    ap.add_argument("--tow", type=float, required=True,
                    help="GPS time of week, s")
    ap.add_argument("--out", default="", help="SVG output path")
    args = ap.parse_args(argv)

    from gnss_sdr_tpu_torch.pvt.coords import llh_to_ecef
    from gnss_sdr_tpu_torch.receiver.assistance import load_assistance

    data = load_assistance(args.assistance)
    rx = np.asarray(llh_to_ecef(
        math.radians(args.lat), math.radians(args.lon), args.h))
    sats = sky_positions(data["ephemerides"], rx, args.tow)
    print(render_ascii(sats))
    for sysid, prn, az, el in sats:
        print(f"  {sysid}{prn:02d}: az {math.degrees(az):6.1f}  "
              f"el {math.degrees(el):5.1f}")
    if args.out:
        Path(args.out).write_text(render_svg(sats))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
