# Copied from gnss_sdr_tpu/pvt/antex.py; only the package imports are rewritten.
"""ANTEX antenna phase-center models: PCO + elevation-grid PCV.

Reference analogs: rtklib_rtkcmn.cc readpcv/readantex (:2945), antmodel
(:4779 — receiver antenna range correction -PCO.e + PCV(zenith)),
antmodel_s (:4814 — satellite PCV by nadir angle) and
rtklib_preceph.cc satantoff (:877 — satellite phase-center offset in the
sun-pointing body frame, iono-free combined). Used by the PPP engine:
precise products are referenced to the satellite's center of mass and
the station marker, so centimetre-level PPP needs both ends' phase
centers modelled.

Units follow ANTEX: PCO/PCV values are millimetres in the file,
converted to metres here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class AntennaPcv:
    """One antenna (or one satellite) phase-center model."""

    antenna_type: str = ""
    serial: str = ""                 # 'G01'… for satellite entries
    # per frequency code ('G01', 'G02', 'E01', …):
    # PCO [3] m — receiver: NEU; satellite: body-frame XYZ
    pco: dict = field(default_factory=dict)
    # PCV NOAZI grid [n] m over zen1..zen2 (deg)
    pcv: dict = field(default_factory=dict)
    zen1: float = 0.0
    zen2: float = 90.0
    dzen: float = 5.0

    def pcv_at(self, freq: str, zen_deg: float) -> float:
        """Linear interpolation on the NOAZI grid (interpvar analog)."""
        grid = self.pcv.get(freq)
        if grid is None or len(grid) == 0 or self.dzen <= 0.0:
            return 0.0
        a = (zen_deg - self.zen1) / self.dzen
        i = int(math.floor(a))
        if i < 0:
            return float(grid[0])
        if i >= len(grid) - 1:
            return float(grid[-1])
        return float(grid[i] * (1.0 - (a - i)) + grid[i + 1] * (a - i))


def parse_antex(text: str) -> dict[str, AntennaPcv]:
    """ANTEX 1.4 text -> {key: AntennaPcv}. Satellite entries key on the
    PRN designator ('G01'); receiver antennas key on the antenna type."""
    out: dict[str, AntennaPcv] = {}
    ant: AntennaPcv | None = None
    freq: str | None = None
    for line in text.splitlines():
        label = line[60:].strip()
        if label == "START OF ANTENNA":
            ant = AntennaPcv()
            freq = None
        elif ant is None:
            continue
        elif label == "TYPE / SERIAL NO":
            ant.antenna_type = line[0:20].strip()
            ant.serial = line[20:40].strip()
        elif label == "ZEN1 / ZEN2 / DZEN":
            ant.zen1 = float(line[2:8])
            ant.zen2 = float(line[8:14])
            ant.dzen = float(line[14:20])
        elif label == "START OF FREQUENCY":
            freq = line[3:6].strip()
        elif label == "END OF FREQUENCY":
            freq = None
        elif label == "NORTH / EAST / UP" and freq:
            vals = [float(v) for v in line[:60].split()[:3]]
            ant.pco[freq] = np.asarray(vals) * 1e-3
        elif freq and line[3:8] == "NOAZI":
            vals = [float(v) for v in line[8:].split()]
            ant.pcv[freq] = np.asarray(vals) * 1e-3
        elif label == "END OF ANTENNA":
            key = ant.serial if ant.serial[:1] in "GRECJS" and \
                len(ant.serial) == 3 else ant.antenna_type
            out[key] = ant
            ant = None
    return out


def load_antex(path: str) -> dict[str, AntennaPcv]:
    with open(path, "r", errors="replace") as f:
        return parse_antex(f.read())


def antmodel(pcv: AntennaPcv, freq: str, az_rad: float, el_rad: float,
             delta_neu=None) -> float:
    """Receiver-antenna range correction in metres (add to the modelled
    range): -PCO.e + PCV(zen) with e the NEU line-of-sight unit vector
    (rtklib antmodel, rtklib_rtkcmn.cc:4779). ``delta_neu``: marker->ARP
    eccentricity."""
    cosel = math.cos(el_rad)
    # NEU line-of-sight to pair with the NEU-stored ANTEX offsets
    # (rtklib stores ENU and swaps at read time, rtkcmn.cc:2909-2911 —
    # same arithmetic)
    e = np.array([math.cos(az_rad) * cosel,
                  math.sin(az_rad) * cosel,
                  math.sin(el_rad)])
    off = pcv.pco.get(freq, np.zeros(3))
    if delta_neu is not None:
        off = off + np.asarray(delta_neu, dtype=float)
    return float(-off @ e + pcv.pcv_at(freq, 90.0 - math.degrees(el_rad)))


def sun_position_ecef(t_gps_s: float, week: int = 0) -> np.ndarray:
    """Low-precision solar ephemeris in ECEF metres (rtklib sunmoonpos;
    accuracy ~0.01 deg — ample for the satellite yaw frame).
    ``t_gps_s``: GPS seconds of week; ``week``: GPS week. One sun model
    for the whole pvt package: delegates to pvt.tides.sun_moon_ecef so
    the PCO yaw frame, phase windup and eclipse tests all agree."""
    from gnss_sdr_tpu_torch.pvt.tides import sun_moon_ecef

    rsun, _, _ = sun_moon_ecef(week * 604800.0 + t_gps_s)
    return rsun


def satantoff(pcv: AntennaPcv, sat_pos: np.ndarray, t_gps_s: float,
              week: int = 0, freqs: tuple[str, str] = ("G01", "G02"),
              lams: tuple[float, float] = (0.19029367, 0.24421021),
              ) -> np.ndarray:
    """Satellite phase-center offset vector in ECEF metres (add to the
    center-of-mass position from precise products to get the antenna
    phase center) — iono-free combination of the two frequencies' body
    frame PCOs in the nominal sun-pointing attitude
    (rtklib_preceph.cc:877 satantoff)."""
    rs = np.asarray(sat_pos, dtype=float)
    ez = -rs / np.linalg.norm(rs)
    rsun = sun_position_ecef(t_gps_s, week)
    es = rsun - rs
    es = es / np.linalg.norm(es)
    ey = np.cross(ez, es)
    ny = np.linalg.norm(ey)
    if ny < 1e-12:
        return np.zeros(3)
    ey /= ny
    ex = np.cross(ey, ez)
    gamma = lams[1] ** 2 / lams[0] ** 2
    c1 = gamma / (gamma - 1.0)
    c2 = -1.0 / (gamma - 1.0)
    off1 = pcv.pco.get(freqs[0], np.zeros(3))
    off2 = pcv.pco.get(freqs[1], np.zeros(3))
    out = np.zeros(3)
    for k in range(3):
        d1 = off1[0] * ex[k] + off1[1] * ey[k] + off1[2] * ez[k]
        d2 = off2[0] * ex[k] + off2[1] * ey[k] + off2[2] * ez[k]
        out[k] = c1 * d1 + c2 * d2
    return out


def antmodel_s(pcv: AntennaPcv, nadir_rad: float, freq: str) -> float:
    """Satellite PCV by nadir angle (rtklib antmodel_s; ANTEX satellite
    entries grid ZEN1/ZEN2/DZEN in nadir degrees — unlike rtklib's
    interpvar this honours the file's own grid spacing)."""
    return pcv.pcv_at(freq, math.degrees(nadir_rad))
