# Copied from gnss_sdr_tpu/pvt/preceph.py; only the package imports are rewritten.
"""Precise ephemeris: SP3-c orbit/clock file reader + polynomial
interpolation.

Reference analog: src/algorithms/libs/rtklib/rtklib_preceph.cc —
readsp3() (SP3-c parsing), pephpos() (NMAX=10 Neville polynomial
interpolation of positions, linear clock interpolation), and satpos with
EPHOPT_PREC. Used by the PPP engine in place of broadcast orbits.

SP3-c essentials parsed here: the `#c` header line (epoch count, time of
first epoch), `+` satellite id lines, `* yyyy mm dd hh mm ss` epoch
records, and `P<sys><prn> x y z clk` position records (km and
microseconds; 999999.999999 clock = unavailable).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

C_LIGHT = 299_792_458.0
_BAD_CLK = 999999.0


@dataclass
class Sp3Data:
    """Parsed SP3 product: per-satellite sampled positions/clocks."""

    times: np.ndarray = field(default_factory=lambda: np.zeros(0))  # TOW s
    week: int = 0
    # (system, prn) -> [N, 3] km->m positions / [N] s clocks (NaN = missing)
    pos_m: dict = field(default_factory=dict)
    clk_s: dict = field(default_factory=dict)


def _tow_from_ymdhms(y, mo, d, h, mi, s) -> tuple[int, float]:
    """(week, TOW) from a calendar epoch (GPS time)."""
    # days since GPS epoch 1980-01-06
    from datetime import datetime, timezone

    t = datetime(y, mo, d, h, mi, 0, tzinfo=timezone.utc)
    t0 = datetime(1980, 1, 6, tzinfo=timezone.utc)
    days = (t - t0).days
    secs = (t - t0).seconds + s
    week = days // 7
    tow = (days % 7) * 86400.0 + secs
    return int(week), float(tow)


def read_sp3(path: str | Path) -> Sp3Data:
    out = Sp3Data()
    times: list[float] = []
    cur: dict[tuple, tuple] = {}
    records: list[dict] = []
    with open(path) as f:
        for line in f:
            if line.startswith("*"):
                parts = line.split()
                y, mo, d, h, mi = (int(parts[1]), int(parts[2]),
                                   int(parts[3]), int(parts[4]),
                                   int(parts[5]))
                s = float(parts[6])
                week, tow = _tow_from_ymdhms(y, mo, d, h, mi, s)
                if not times:
                    out.week = week
                # continuous TOW across week boundaries
                tow += (week - out.week) * 7 * 86400.0
                times.append(tow)
                if cur:
                    records.append(cur)
                    cur = {}
            elif line.startswith("P") and times:
                sys_c = line[1]
                prn = int(line[2:4])
                vals = line[4:].split()
                x, y_, z = (float(vals[0]) * 1e3, float(vals[1]) * 1e3,
                            float(vals[2]) * 1e3)
                clk = float(vals[3])
                clk_s = np.nan if abs(clk) >= _BAD_CLK else clk * 1e-6
                cur[(sys_c, prn)] = (np.array([x, y_, z]), clk_s)
    if cur:
        records.append(cur)
    out.times = np.asarray(times)
    sats = {k for rec in records for k in rec}
    n = len(records)
    for k in sats:
        p = np.full((n, 3), np.nan)
        c = np.full(n, np.nan)
        for i, rec in enumerate(records):
            if k in rec:
                p[i], c[i] = rec[k]
        out.pos_m[k] = p
        out.clk_s[k] = c
    return out


def write_sp3(path: str | Path, data: Sp3Data) -> None:
    """Minimal SP3-c writer (tests/tools)."""
    from datetime import datetime, timedelta, timezone

    t0 = datetime(1980, 1, 6, tzinfo=timezone.utc)
    lines = []
    n = len(data.times)
    sats = sorted(data.pos_m)
    ep0 = t0 + timedelta(days=data.week * 7, seconds=float(data.times[0]))
    lines.append(
        f"#cP{ep0.year:5d} {ep0.month:2d} {ep0.day:2d} {ep0.hour:2d} "
        f"{ep0.minute:2d} {ep0.second:11.8f} {n:7d} ORBIT IGS14 HLM  IGS")
    lines.append(f"+   {len(sats)}   " + "".join(
        f"{s}{p:02d}" for s, p in sats[:17]))
    for i, tow in enumerate(data.times):
        ep = t0 + timedelta(days=data.week * 7, seconds=float(tow))
        lines.append(f"*  {ep.year:4d} {ep.month:2d} {ep.day:2d} "
                     f"{ep.hour:2d} {ep.minute:2d} {ep.second:11.8f}")
        for k in sats:
            p = data.pos_m[k][i]
            c = data.clk_s[k][i]
            if np.isnan(p).any():
                continue
            ck = 999999.999999 if np.isnan(c) else c * 1e6
            lines.append(
                f"P{k[0]}{k[1]:02d}{p[0] / 1e3:14.6f}{p[1] / 1e3:14.6f}"
                f"{p[2] / 1e3:14.6f}{ck:14.6f}")
    lines.append("EOF")
    Path(path).write_text("\n".join(lines) + "\n")


@dataclass
class ClkData:
    """Parsed RINEX clock product: per-satellite sampled clock biases."""

    week: int = 0
    # (system, prn) -> ([N] TOW s, [N] bias s), sorted by time
    clk: dict = field(default_factory=dict)


def read_clk(path: str | Path) -> ClkData:
    """RINEX clock (CLK 3.x) reader — AS (satellite) records only.

    Reference analog: rtklib_rinex.cc readrnxc. Precise CLK products
    sample the satellite clocks far denser (30 s / 5 min) than SP3's
    15 min epochs; PPP uses them in place of the SP3 clock column
    (EPHOPT_PREC clock source precedence).
    """
    out = ClkData()
    raw: dict[tuple, list] = {}
    in_header = True
    with open(path) as f:
        for line in f:
            if in_header:
                if "END OF HEADER" in line:
                    in_header = False
                continue
            if not line.startswith("AS "):
                continue
            name = line[3:7].strip()
            try:
                sys_c, prn = name[0], int(name[1:3])
                p = line[8:].split()
                y, mo, d, h, mi = (int(p[0]), int(p[1]), int(p[2]),
                                   int(p[3]), int(p[4]))
                s = float(p[5])
                bias = float(p[7])
            except (ValueError, IndexError):
                continue
            week, tow = _tow_from_ymdhms(y, mo, d, h, mi, s)
            if not raw and out.week == 0:
                out.week = week
            tow += (week - out.week) * 7 * 86400.0
            raw.setdefault((sys_c, prn), []).append((tow, bias))
    for k, rows in raw.items():
        rows.sort()
        a = np.asarray(rows)
        out.clk[k] = (a[:, 0], a[:, 1])
    return out


class PreciseEphemeris:
    """Orbit/clock interpolation over an SP3 product
    (rtklib_preceph.cc pephpos analog: NMAX-point Neville polynomial for
    position, linear for clock). An optional RINEX clock product
    overrides the SP3 clock column (rtklib peph2pos clock precedence)."""

    def __init__(self, data: Sp3Data, order: int = 10,
                 clk: ClkData | None = None) -> None:
        self.data = data
        self.order = order
        self.clk = clk

    @classmethod
    def load(cls, path: str | Path, order: int = 10,
             clk_path: str | Path | None = None) -> "PreciseEphemeris":
        return cls(read_sp3(path), order=order,
                   clk=read_clk(clk_path) if clk_path else None)

    def sat_pos_clock(self, system: str, prn: int,
                      t_tow: float) -> tuple[np.ndarray, float] | None:
        key = (system, prn)
        if key not in self.data.pos_m:
            return None
        times = self.data.times
        pos = self.data.pos_m[key]
        clk = self.data.clk_s[key]
        n = len(times)
        m = min(self.order, n)
        if n < 2 or t_tow < times[0] - 300 or t_tow > times[-1] + 300:
            return None
        # centered window of m samples
        i1 = int(np.searchsorted(times, t_tow))
        lo = max(0, min(i1 - m // 2, n - m))
        tt = times[lo:lo + m]
        pp = pos[lo:lo + m]
        if np.isnan(pp).any():
            return None
        p_out = np.array([_neville(tt, pp[:, k], t_tow) for k in range(3)])
        # clock: the dense RINEX CLK product wins over the SP3 column.
        # The CLK TOW axis is in the CLK file's own first-record week;
        # shift it into the SP3 week frame before comparing.
        if self.clk is not None and key in self.clk.clk:
            ct, cb = self.clk.clk[key]
            ct = ct + (self.clk.week - self.data.week) * 604800.0
            if ct[0] - 300 <= t_tow <= ct[-1] + 300:
                return p_out, float(np.interp(t_tow, ct, cb))
        # SP3 clock: linear between bracketing finite samples
        ok = np.isfinite(clk)
        if not ok.any():
            c_out = 0.0
        else:
            c_out = float(np.interp(t_tow, times[ok], clk[ok]))
        return p_out, c_out


def _neville(xs: np.ndarray, ys: np.ndarray, x: float) -> float:
    """Neville polynomial interpolation (rtklib interppol)."""
    p = ys.astype(np.float64).copy()
    n = len(xs)
    for j in range(1, n):
        for i in range(n - j):
            p[i] = ((x - xs[i + j]) * p[i] + (xs[i] - x) * p[i + 1]) / (
                xs[i] - xs[i + j])
    return float(p[0])
