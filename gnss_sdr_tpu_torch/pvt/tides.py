# Copied from gnss_sdr_tpu/pvt/tides.py; only the package imports are rewritten.
"""Earth-tide site displacement and carrier phase windup (host, f64).

Reference analogs (specifications, not translations):
- src/algorithms/libs/rtklib/rtklib_tides.cc — tidedisp(): solid earth
  tide (IERS degree-2/3 in-phase + out-of-phase + K1 radial), ocean tide
  loading from 11 BLQ constituents, pole tide from the IERS mean-pole
  model.
- src/algorithms/libs/rtklib/rtklib_rtkcmn.cc:5253 — windupcorr():
  satellite/receiver antenna phase windup in cycles.
- src/algorithms/libs/rtklib/rtklib_rtkcmn.cc:4829 — sunmoonpos_eci():
  low-precision analytic sun/moon ephemerides.

Design note: the reference rotates ECI->ECEF through the full IAU-76/80
precession+nutation chain (eci2ecef). Tidal displacements are cm-level
and the sun/moon series above are themselves only ~0.1% accurate, so
this implementation rotates by GMST alone (sidereal rotation about Z);
the induced displacement error is far below the phase noise floor and
keeps the module dependency-free. Time enters as GPS seconds since the
GPS epoch (1980-01-06T00:00:00Z), converted internally to UT1~UTC with
a caller-supplied leap-second count.
"""

from __future__ import annotations

import numpy as np

_PI = np.pi
_D2R = _PI / 180.0
_AS2R = _D2R / 3600.0
_AU = 149597870691.0
_RE = 6378137.0
# gravitational constants (rtklib_tides.h:51-53)
_GME = 3.986004415e14
_GMS = 1.327124e20
_GMM = 4.902801e12

# GPS epoch 1980-01-06 00:00:00 UTC as days from J2000.0 (2000-01-01 12:00)
_GPS0_MINUS_J2000_DAYS = -7300.5
# seconds from 1975-01-01 00:00 (ocean-arg reference epoch) to the GPS
# epoch 1980-01-06: 1831 days (1826 for the five years incl. leap 1976,
# plus 5 days into January)
_GPS0_MINUS_1975_S = 1831.0 * 86400.0


def gps_to_utc_s(t_gps_s: float, leap_s: float = 18.0) -> float:
    """GPS seconds since GPS epoch -> UTC seconds since GPS epoch."""
    return t_gps_s - leap_s


def _j2000_centuries(t_utc_s: float) -> float:
    """Julian centuries of (UT1~UTC) since J2000.0."""
    return (_GPS0_MINUS_J2000_DAYS + t_utc_s / 86400.0) / 36525.0


def gmst_rad(t_utc_s: float) -> float:
    """Greenwich mean sidereal time (rtklib utc2gmst, ut1_utc=0)."""
    days = _GPS0_MINUS_J2000_DAYS + t_utc_s / 86400.0
    ut = (days - np.floor(days) + 0.5) % 1.0 * 86400.0   # seconds of UT day
    t1 = (np.floor(days + 0.5) - 0.5) / 36525.0           # centuries at 0h UT
    gmst0 = (24110.54841 + 8640184.812866 * t1 + 0.093104 * t1**2
             - 6.2e-6 * t1**3)
    gmst = gmst0 + 1.002737909350795 * ut
    return float(gmst % 86400.0) * _PI / 43200.0


def _ast_args(t: float) -> np.ndarray:
    """IAU 1980 nutation fundamental arguments (rtkcmn ast_args)."""
    fc = np.array([
        [134.96340251, 1717915923.2178, 31.8792, 0.051635, -0.00024470],
        [357.52910918, 129596581.0481, -0.5532, 0.000136, -0.00001149],
        [93.27209062, 1739527262.8478, -12.7512, -0.001037, 0.00000417],
        [297.85019547, 1602961601.2090, -6.3706, 0.006593, -0.00003169],
        [125.04455501, -6962890.2665, 7.4722, 0.007702, -0.00005939],
    ])
    tt = np.array([t, t**2, t**3, t**4])
    f = fc[:, 0] * 3600.0 + fc[:, 1:] @ tt
    return np.mod(f * _AS2R, 2.0 * _PI)


def sun_moon_ecef(t_gps_s: float, leap_s: float = 18.0):
    """Sun and moon ECEF positions (m) + GMST (rad).

    rtklib sunmoonpos/sunmoonpos_eci analog; ECI->ECEF by GMST rotation
    (see module docstring).
    """
    tu = gps_to_utc_s(t_gps_s, leap_s)
    t = _j2000_centuries(tu)
    f = _ast_args(t)
    eps = (23.439291 - 0.0130042 * t) * _D2R
    se, ce = np.sin(eps), np.cos(eps)

    # sun (ecliptic -> equatorial ECI)
    ms = (357.5277233 + 35999.05034 * t) * _D2R
    ls = (280.460 + 36000.770 * t) * _D2R + (
        1.914666471 * np.sin(ms) + 0.019994643 * np.sin(2 * ms)) * _D2R
    rs = _AU * (1.000140612 - 0.016708617 * np.cos(ms)
                - 0.000139589 * np.cos(2 * ms))
    sun_eci = np.array([rs * np.cos(ls),
                        rs * ce * np.sin(ls),
                        rs * se * np.sin(ls)])

    # moon
    lm = (218.32 + 481267.883 * t) * _D2R + (
        6.29 * np.sin(f[0]) - 1.27 * np.sin(f[0] - 2 * f[3])
        + 0.66 * np.sin(2 * f[3]) + 0.21 * np.sin(2 * f[0])
        - 0.19 * np.sin(f[1]) - 0.11 * np.sin(2 * f[2])) * _D2R
    pm = (5.13 * np.sin(f[2]) + 0.28 * np.sin(f[0] + f[2])
          - 0.28 * np.sin(f[2] - f[0])
          - 0.17 * np.sin(f[2] - 2 * f[3])) * _D2R
    par = (0.9508 + 0.0518 * np.cos(f[0]) + 0.0095 * np.cos(f[0] - 2 * f[3])
           + 0.0078 * np.cos(2 * f[3]) + 0.0028 * np.cos(2 * f[0])) * _D2R
    rm = _RE / np.sin(par)
    moon_eci = np.array([
        rm * np.cos(pm) * np.cos(lm),
        rm * (ce * np.cos(pm) * np.sin(lm) - se * np.sin(pm)),
        rm * (se * np.cos(pm) * np.sin(lm) + ce * np.sin(pm)),
    ])

    g = gmst_rad(tu)
    cg, sg = np.cos(g), np.sin(g)
    rot = np.array([[cg, sg, 0.0], [-sg, cg, 0.0], [0.0, 0.0, 1.0]])
    return rot @ sun_eci, rot @ moon_eci, g


def _enu_matrix(lat: float, lon: float) -> np.ndarray:
    """Rows = east, north, up unit vectors in ECEF (rtkcmn xyz2enu)."""
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])


def _tide_pl(eu: np.ndarray, rp: np.ndarray, gmp: float,
             lat: float, lon: float) -> np.ndarray:
    """Degree-2/3 displacement by one perturbing body (tides.cc tide_pl)."""
    h3, l3 = 0.292, 0.015
    r = float(np.linalg.norm(rp))
    if r <= 0.0:
        return np.zeros(3)
    ep = rp / r
    # K2 = (GMp/GMe) * Re^4 / r^3 (IERS eq.; original RTKLIB SQR*SQR).
    # The reference copy writes pow(RE,2.04)*pow(RE,2.0) — a typo that
    # inflates the tide by RE^0.04 ~ 1.87x; physics (peak lunar tide
    # ~0.36 m) confirms Re^4.
    k2 = gmp / _GME * _RE ** 4 / r**3
    k3 = k2 * _RE / r
    latp = np.arcsin(ep[2])
    lonp = np.arctan2(ep[1], ep[0])
    sinl, cosl = np.sin(lat), np.cos(lat)
    p = (3.0 * sinl * sinl - 1.0) / 2.0
    h2 = 0.6078 - 0.0006 * p
    l2 = 0.0847 + 0.0002 * p
    a = float(ep @ eu)
    dp = k2 * 3.0 * l2 * a
    du = k2 * (h2 * (1.5 * a * a - 0.5) - 3.0 * l2 * a * a)
    dp += k3 * l3 * (7.5 * a * a - 1.5)
    du += k3 * (h3 * (2.5 * a**3 - 1.5 * a) - l3 * (7.5 * a * a - 1.5) * a)
    # out-of-phase, radial only
    du += 0.75 * 0.0025 * k2 * np.sin(2 * latp) * np.sin(2 * lat) \
        * np.sin(lon - lonp)
    du += 0.75 * 0.0022 * k2 * np.cos(latp)**2 * cosl**2 \
        * np.sin(2.0 * (lon - lonp))
    return dp * ep + du * eu


def tide_solid(rsun: np.ndarray, rmoon: np.ndarray,
               lat: float, lon: float, eu: np.ndarray,
               gmst: float) -> np.ndarray:
    """Solid earth tide ECEF displacement (tides.cc tide_solid)."""
    dr = (_tide_pl(eu, rsun, _GMS, lat, lon)
          + _tide_pl(eu, rmoon, _GMM, lat, lon))
    # frequency-domain K1 radial term
    du = -0.012 * np.sin(2.0 * lat) * np.sin(gmst + lon)
    return dr + du * eu


# BLQ constituent order and angular arguments (tides.cc tide_oload)
_OLOAD_ARGS = np.array([
    [1.40519e-4, 2.0, -2.0, 0.0, 0.00],   # M2
    [1.45444e-4, 0.0, 0.0, 0.0, 0.00],    # S2
    [1.37880e-4, 2.0, -3.0, 1.0, 0.00],   # N2
    [1.45842e-4, 2.0, 0.0, 0.0, 0.00],    # K2
    [0.72921e-4, 1.0, 0.0, 0.0, 0.25],    # K1
    [0.67598e-4, 1.0, -2.0, 0.0, -0.25],  # O1
    [0.72523e-4, -1.0, 0.0, 0.0, -0.25],  # P1
    [0.64959e-4, 1.0, -3.0, 1.0, -0.25],  # Q1
    [0.53234e-5, 0.0, 2.0, 0.0, 0.00],    # Mf
    [0.26392e-5, 0.0, 1.0, -1.0, 0.00],   # Mm
    [0.03982e-5, 2.0, 0.0, 0.0, 0.00],    # Ssa
])


def tide_oload(t_utc_s: float, odisp: np.ndarray) -> np.ndarray:
    """Ocean loading ENU displacement from BLQ table (tide_oload).

    ``odisp``: (11, 6) rows per constituent M2..Ssa, columns
    [amp_radial, amp_west, amp_south, ph_radial, ph_west, ph_south]
    (m / deg) — the BLQ convention.
    """
    fday = t_utc_s % 86400.0
    days = (t_utc_s - fday + _GPS0_MINUS_1975_S) / 86400.0 + 1.0
    t = (27392.500528 + 1.000000035 * days) / 36525.0
    a = np.array([
        fday,
        (279.69668 + 36000.768930485 * t + 3.03e-4 * t**2) * _D2R,
        (270.434358 + 481267.88314137 * t - 0.001133 * t**2
         + 1.9e-6 * t**3) * _D2R,
        (334.329653 + 4069.0340329577 * t - 0.010325 * t**2
         - 1.2e-5 * t**3) * _D2R,
        2.0 * _PI,
    ])
    ang = _OLOAD_ARGS @ a                                  # (11,)
    dp = np.sum(odisp[:, :3] * np.cos(
        ang[:, None] - odisp[:, 3:] * _D2R), axis=0)       # [r, w, s]
    return np.array([-dp[1], -dp[2], dp[0]])               # ENU


def iers_mean_pole(t_utc_s: float) -> tuple[float, float]:
    """IERS mean pole in mas (tides.cc iers_mean_pole)."""
    y = (_GPS0_MINUS_J2000_DAYS + t_utc_s / 86400.0) / 365.25
    if y < 3653.0 / 365.25:
        xb = 55.974 + 1.8243 * y + 0.18413 * y**2 + 0.007024 * y**3
        yb = 346.346 + 1.7896 * y - 0.10729 * y**2 - 0.000908 * y**3
    else:
        xb = 23.513 + 7.6141 * y
        yb = 358.891 - 0.6287 * y
    return xb, yb


def tide_pole(t_utc_s: float, lat: float, lon: float,
              xp_rad: float = 0.0, yp_rad: float = 0.0) -> np.ndarray:
    """Pole tide ENU displacement (tides.cc tide_pole); xp/yp are the
    observed pole coordinates (rad) from ERP data, 0 if unavailable."""
    xb, yb = iers_mean_pole(t_utc_s)
    m1 = xp_rad / _AS2R - xb * 1e-3      # arcsec
    m2 = -yp_rad / _AS2R + yb * 1e-3
    cl, sl = np.cos(lon), np.sin(lon)
    return np.array([
        9e-3 * np.sin(lat) * (m1 * sl - m2 * cl),
        -9e-3 * np.cos(2.0 * lat) * (m1 * cl + m2 * sl),
        -33e-3 * np.sin(2.0 * lat) * (m1 * cl + m2 * sl),
    ])


def tidedisp(t_gps_s: float, rr: np.ndarray, *,
             solid: bool = True, oload: np.ndarray | None = None,
             pole: bool = False, xp_rad: float = 0.0, yp_rad: float = 0.0,
             erp: np.ndarray | None = None,
             leap_s: float = 18.0) -> np.ndarray:
    """Total tidal site displacement in ECEF meters (tides.cc tidedisp).

    ``t_gps_s``: GPS seconds since the GPS epoch (week*604800 + tow).
    ``oload``: optional (11, 6) BLQ table enables ocean loading.
    ``erp``: optional read_erp() table — supplies the observed pole
    coordinates for the pole tide and UT1-UTC for the tide arguments.
    """
    if erp is not None:
        ev = get_erp(erp, t_gps_s, leap_s)
        xp_rad, yp_rad = float(ev[0]), float(ev[1])
        leap_s = leap_s - float(ev[2])          # UTC -> UT1 for the args
    rr = np.asarray(rr, dtype=np.float64)
    rn = float(np.linalg.norm(rr))
    if rn <= 0.0:
        return np.zeros(3)
    lat = np.arcsin(rr[2] / rn)           # geocentric, as the reference
    lon = np.arctan2(rr[1], rr[0])
    E = _enu_matrix(lat, lon)
    eu = E[2]
    tu = gps_to_utc_s(t_gps_s, leap_s)
    dr = np.zeros(3)
    if solid:
        rsun, rmoon, gmst = sun_moon_ecef(t_gps_s, leap_s)
        dr += tide_solid(rsun, rmoon, lat, lon, eu, gmst)
    if oload is not None:
        dr += E.T @ tide_oload(tu, np.asarray(oload, dtype=np.float64))
    if pole:
        dr += E.T @ tide_pole(tu, lat, lon, xp_rad, yp_rad)
    return dr


def read_blq(path, station: str) -> np.ndarray | None:
    """Read one station's (11, 6) ocean-loading table from a BLQ file.

    Accepts the standard Onsala/BLQ layout: comment lines start with
    '$$'; a station block is the station-name line followed by six data
    lines of 11 values each (3 amplitude rows in m: radial/west/south,
    then 3 phase rows in deg). Returns None if the station is absent.
    """
    want = station.strip().upper()
    lines = [ln.rstrip("\n") for ln in open(path, encoding="utf-8")]
    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("$$") or not ln.strip():
            i += 1
            continue
        name = ln.strip().split()[0].upper()
        rows = []
        j = i + 1
        while j < len(lines) and len(rows) < 6:
            if lines[j].startswith("$$"):
                j += 1
                continue
            vals = lines[j].split()
            if len(vals) == 11:
                rows.append([float(v) for v in vals])
                j += 1
            else:
                break
        if len(rows) == 6:
            if name == want:
                m = np.asarray(rows)                  # (6, 11)
                return np.column_stack([m[0], m[1], m[2], m[3], m[4], m[5]])
            i = j
        else:
            i += 1
    return None


def in_eclipse(rs: np.ndarray, rsun: np.ndarray) -> bool:
    """True when the satellite is inside the earth's shadow cylinder
    (rtklib_ppp.cc testeclipse:856-865): sun-earth-satellite angle past
    90 deg and perpendicular distance to the earth-sun axis under one
    earth radius. PPP excludes such satellites — their yaw attitude
    (hence windup/PCO) is unpredictable during eclipse maneuvers."""
    rs = np.asarray(rs, dtype=np.float64)
    r = float(np.linalg.norm(rs))
    sn = float(np.linalg.norm(rsun))
    if r <= 0.0 or sn <= 0.0:
        return False
    cosa = float(np.clip(rs @ rsun / (r * sn), -1.0, 1.0))
    ang = np.arccos(cosa)
    return ang >= np.pi / 2.0 and r * np.sin(ang) <= _RE


_GPS0_MJD = 44244.0          # MJD of the GPS epoch 1980-01-06


def read_erp(path) -> np.ndarray:
    """Read an IGS ERP (ver.2) file (rtkcmn readerp).

    Returns rows [mjd, xp_rad, yp_rad, ut1_utc_s, lod_s, xpr_rad_d,
    ypr_rad_d], sorted by MJD; units converted exactly as the reference
    (xp/yp 1e-6 as -> rad, ut1/lod 1e-7 s -> s, rates 1e-6 as/d).
    """
    rows = []
    for ln in open(path, encoding="utf-8", errors="replace"):
        v = ln.split()
        try:
            f = [float(x) for x in v[:14]]
        except ValueError:
            continue
        if len(f) < 5:
            continue
        f += [0.0] * (14 - len(f))
        rows.append([f[0], f[1] * 1e-6 * _AS2R, f[2] * 1e-6 * _AS2R,
                     f[3] * 1e-7, f[4] * 1e-7,
                     f[12] * 1e-6 * _AS2R, f[13] * 1e-6 * _AS2R])
    out = np.asarray(rows)
    return out[np.argsort(out[:, 0])] if len(rows) else out.reshape(0, 7)


def get_erp(erp: np.ndarray, t_gps_s: float,
            leap_s: float = 18.0) -> np.ndarray:
    """Interpolate [xp_rad, yp_rad, ut1_utc_s, lod_s] at a GPS time
    (rtkcmn geterp: linear between daily values, rate extrapolation
    outside the table)."""
    if erp is None or len(erp) == 0:
        return np.zeros(4)
    mjd = _GPS0_MJD + gps_to_utc_s(t_gps_s, leap_s) / 86400.0
    if mjd <= erp[0, 0] or mjd >= erp[-1, 0]:
        r = erp[0] if mjd <= erp[0, 0] else erp[-1]
        day = mjd - r[0]
        return np.array([r[1] + r[5] * day, r[2] + r[6] * day,
                         r[3] - r[4] * day, r[4]])
    j = int(np.searchsorted(erp[:, 0], mjd) - 1)
    d = erp[j + 1, 0] - erp[j, 0]
    a = 0.5 if d == 0 else (mjd - erp[j, 0]) / d
    v = (1 - a) * erp[j] + a * erp[j + 1]
    return np.array([v[1], v[2], v[3], v[4]])


def phase_windup(rs: np.ndarray, rr: np.ndarray, rsun: np.ndarray,
                 phw_prev: float) -> float:
    """Carrier phase windup in cycles (rtkcmn windupcorr).

    ``rs``/``rr``: satellite / receiver ECEF positions; ``rsun``: sun
    ECEF position; ``phw_prev``: previous value for cycle continuity.
    """
    rs = np.asarray(rs, dtype=np.float64)
    rr = np.asarray(rr, dtype=np.float64)

    def _unit(v):
        n = np.linalg.norm(v)
        return v / n if n > 0 else None

    ek = _unit(rr - rs)
    ezs = _unit(-rs)
    ess = _unit(rsun - rs)
    if ek is None or ezs is None or ess is None:
        return phw_prev
    eys = _unit(np.cross(ezs, ess))
    if eys is None:
        return phw_prev
    exs = np.cross(eys, ezs)

    rn = float(np.linalg.norm(rr))
    lat = np.arcsin(rr[2] / rn)
    lon = np.arctan2(rr[1], rr[0])
    E = _enu_matrix(lat, lon)
    exr = E[1]            # north
    eyr = -E[0]           # west

    ds = exs - ek * float(ek @ exs) - np.cross(ek, eys)
    dr = exr - ek * float(ek @ exr) + np.cross(ek, eyr)
    denom = np.linalg.norm(ds) * np.linalg.norm(dr)
    if denom <= 0:
        return phw_prev
    cosp = float(np.clip(ds @ dr / denom, -1.0, 1.0))
    ph = np.arccos(cosp) / (2.0 * _PI)
    if float(ek @ np.cross(ds, dr)) < 0.0:
        ph = -ph
    return float(ph + np.floor(phw_prev - ph + 0.5))
