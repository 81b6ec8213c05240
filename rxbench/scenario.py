"""The benchmark's capture generator: GPS L1 C/A and Galileo E5a basebands
of a geometry-consistent scenario, per-sample arithmetic in float64
PyTorch on the device.

A copy of the port's ``simulate/scenario.py`` (GPS L1 C/A), of the
geometry part of ``simulate/galileo.py`` and of ``simulate/multiband.py::
GalileoE5aBand``, built on frozen copies of the code tables, the LNAV and
F/NAV encoders and the orbit model (``rxbench/frozen/``) and on the
vectorised truth of ``rxbench/truth.py``. What differs from the copies:
the timelines come from ``truth.measure`` over the whole 20 ms grid at
once; the samples are made on the device; the noise comes from a
``torch.Generator`` seeded by the run, not from NumPy per chunk. With
``noise=False`` a slice equals the port's NumPy generator on the same
samples to float rounding (``rxbench/tests/test_scenario.py``).

A scenario is one long recording; the benchmark cuts it into files.
"""

from __future__ import annotations

import numpy as np
import torch

from rxbench import truth
from rxbench.frozen.codes.galileo_e5a import (
    e5ai_secondary_levels,
    e5aq_secondary_levels,
    galileo_e5ai_code,
    galileo_e5aq_code,
)
from rxbench.frozen.codes.gps_l1_ca import gps_l1_ca_code
from rxbench.frozen.constants import galileo_e5a as E5A
from rxbench.frozen.constants import gps_l1_ca as L1
from rxbench.frozen.pvt.coords import ecef_to_llh, llh_to_ecef
from rxbench.frozen.pvt.ephemeris import C_LIGHT
from rxbench.frozen.simulate.constellation import (
    make_constellation,
    visible_sats,
)
from rxbench.frozen.telemetry.fnav import PAGE_SECONDS, FnavEncoder
from rxbench.frozen.telemetry.inav import GalileoEphemeris, GalileoIono
from rxbench.frozen.telemetry.lnav import GpsAlmanac
from rxbench.frozen.telemetry.lnav_encode import LnavEncoder

GRID_STEP_S = 0.02
PI_ICD = 3.1415926535898
GAL_SQRT_A = 5440.588
GAL_INCLINATION = 0.9774


def make_galileo_constellation(seed: int, num_sats: int = 24,
                               week: int = 1250,
                               toe: float = 7200.0) -> dict:
    """Copy of ``simulate/galileo.py::make_galileo_constellation``."""
    rng = np.random.default_rng(seed + 101)
    ephs = {}
    for i in range(num_sats):
        prn, plane, slot = i + 1, i % 3, i // 3
        ephs[prn] = GalileoEphemeris(
            prn=prn, week=week, iod_nav=prn, toc=toe, toe=toe,
            af0=float(rng.uniform(-2e-4, 2e-4)),
            af1=float(rng.uniform(-3e-12, 3e-12)), af2=0.0,
            bgd_e1e5a=float(rng.uniform(-6e-9, 6e-9)),
            bgd_e1e5b=float(rng.uniform(-6e-9, 6e-9)),
            sqrt_a=GAL_SQRT_A + float(rng.uniform(-0.2, 0.2)),
            ecc=float(rng.uniform(0.0002, 0.003)),
            m0=float((2.0 * np.pi * slot / 8.0 + plane * 0.3
                      + rng.uniform(-0.1, 0.1)) % (2 * np.pi) - np.pi),
            omega0=float((2.0 * np.pi * plane / 3.0
                          + rng.uniform(-0.05, 0.05)) % (2 * np.pi) - np.pi),
            i0=GAL_INCLINATION + float(rng.uniform(-0.02, 0.02)),
            omega=float(rng.uniform(-np.pi, np.pi)), omega_dot=-5.6e-9,
            idot=float(rng.uniform(-3e-10, 3e-10)),
            delta_n=float(rng.uniform(2e-9, 4e-9)),
            cus=float(rng.uniform(-6e-6, 6e-6)),
            cuc=float(rng.uniform(-6e-6, 6e-6)),
            crs=float(rng.uniform(-80, 80)),
            crc=float(rng.uniform(80, 250)),
            cis=float(rng.uniform(-2e-7, 2e-7)),
            cic=float(rng.uniform(-2e-7, 2e-7)))
    return ephs


def _almanac(eph) -> GpsAlmanac:
    """Copy of ``simulate/scenario.py::almanac_from_ephemeris``."""
    return GpsAlmanac(prn=eph.prn, ecc=eph.ecc, toa=eph.toe,
                      delta_i=eph.i0 - 0.30 * PI_ICD,
                      omega_dot=eph.omega_dot, sv_health=eph.sv_health,
                      sqrt_a=eph.sqrt_a, omega0=eph.omega0, omega=eph.omega,
                      m0=eph.m0, af0=eph.af0, af1=eph.af1)


class Geometry:
    """A constellation seen from a static receiver: which satellites are
    up at the start, and each one's satellite-clock transmit-time
    timeline on a 20 ms grid of receiver time (``ttx_sv``, with the
    troposphere's delay in metres beside it)."""

    def __init__(self, system: str, constellation_seed: int,
                 tow_start_s: float, duration_s: float, rx_lat_deg: float,
                 rx_lon_deg: float, rx_height_m: float,
                 rx_clock_bias_s: float, max_sats: int,
                 min_elevation_deg: float) -> None:
        self.ephs = (make_constellation(seed=constellation_seed)
                     if system == "G"
                     else make_galileo_constellation(constellation_seed))
        self.tow_start_s = tow_start_s
        self.duration_s = duration_s
        self.rx_clock_bias_s = rx_clock_bias_s
        self.rx_ecef = llh_to_ecef(np.deg2rad(rx_lat_deg),
                                   np.deg2rad(rx_lon_deg), rx_height_m)
        _, _, hgt = ecef_to_llh(self.rx_ecef)
        self.prns = visible_sats(self.ephs, self.rx_ecef, tow_start_s,
                                 np.deg2rad(min_elevation_deg))[:max_sats]
        n_grid = int(np.ceil(duration_s / GRID_STEP_S)) + 3
        self.t_grid = np.arange(n_grid) * GRID_STEP_S
        self.ttx_sv, self.tropo_m = {}, {}
        for prn in self.prns:
            m = truth.measure(self.ephs[prn], self.rx_ecef,
                              tow_start_s + self.t_grid,
                              np.full(n_grid, rx_clock_bias_s), L1.FREQ_HZ)
            self.ttx_sv[prn] = m["t_tx_sv"]
            self.tropo_m[prn] = truth.tropo_delay(
                truth.elevation(self.rx_ecef, m["sat_pos"]), hgt)


def _interp(t: torch.Tensor, grid: torch.Tensor, step: float) -> torch.Tensor:
    """``np.interp(t, arange(len(grid)) * step, grid)`` on a uniform grid,
    in numpy's order of operations."""
    j = torch.clamp(torch.floor(t / step).long(), 0, grid.shape[0] - 2)
    x0 = j.to(torch.float64) * step
    slope = (grid[j + 1] - grid[j]) / ((j + 1).to(torch.float64) * step - x0)
    return slope * (t - x0) + grid[j]


class Band:
    """One band's baseband (``signal`` "L1CA" for GPS L1 C/A, "E5a" for
    Galileo E5a) of a geometry, made on ``device``: ``generate(start, n,
    gen)`` gives complex128 samples [start, start + n) of the recording,
    the noise drawn from ``gen`` (None: no noise)."""

    def __init__(self, geo: Geometry, signal: str, fs: float,
                 cn0_dbhz: float, device: torch.device) -> None:
        self.geo, self.signal, self.fs = geo, signal, fs
        self.device = device
        self.amp = float(np.sqrt(10.0 ** (cn0_dbhz / 10.0) / fs))
        dev = dict(device=device, dtype=torch.float64)
        self.code_grid, self.phase_grid, self.codes = {}, {}, {}
        self.signs, self.sym0 = {}, {}
        if signal == "L1CA":
            self.carrier_hz, self.code_rate = L1.FREQ_HZ, L1.CODE_RATE_CPS
            self.code_len, self.sym_rate = L1.CODE_LENGTH_CHIPS, 50.0
            almanacs = {p: _almanac(e) for p, e in geo.ephs.items()}
            for prn in geo.prns:
                eph = geo.ephs[prn]
                # the code leaves the satellite TGD late, then the
                # troposphere delays code and carrier alike (no iono)
                base = geo.ttx_sv[prn] - eph.tgd - geo.tropo_m[prn] / C_LIGHT
                self.code_grid[prn] = self.phase_grid[prn] = torch.tensor(
                    base, **dev)
                self.codes[prn] = (torch.tensor(
                    gps_l1_ca_code(prn).astype(np.float64), **dev),)
                lo = int(np.floor(base.min() * 50.0)) - 1
                hi = int(np.floor(base.max() * 50.0)) + 2
                enc = LnavEncoder(eph, iono_utc=None, almanacs=almanacs,
                                  sf4_page18_every_frame=False)
                self.signs[prn] = torch.tensor(
                    enc.bits_at(np.arange(lo, hi)), **dev)
                self.sym0[prn] = lo
        elif signal == "E5a":
            self.carrier_hz, self.code_rate = E5A.FREQ_HZ, E5A.CODE_RATE_CPS
            self.code_len, self.sym_rate = E5A.CODE_LENGTH_CHIPS, float(
                E5A.SYMBOL_RATE_SPS)
            gamma = (L1.FREQ_HZ / E5A.FREQ_HZ) ** 2
            # F/NAV pages start on 10 s boundaries before the first
            # transmit time
            tow0 = PAGE_SECONDS * np.floor(
                (geo.tow_start_s - 0.1) / PAGE_SECONDS) - PAGE_SECONDS
            n_pages = int(np.ceil(geo.duration_s / PAGE_SECONDS)) + 3
            for prn in geo.prns:
                eph = geo.ephs[prn]
                base = (geo.ttx_sv[prn] - gamma * eph.bgd_e1e5a
                        - geo.tropo_m[prn] / C_LIGHT)
                self.code_grid[prn] = self.phase_grid[prn] = torch.tensor(
                    base, **dev)
                self.codes[prn] = (
                    torch.tensor(galileo_e5ai_code(prn).astype(np.float64),
                                 **dev),
                    torch.tensor(galileo_e5aq_code(prn).astype(np.float64),
                                 **dev),
                    torch.tensor(e5ai_secondary_levels().astype(np.float64),
                                 **dev),
                    torch.tensor(e5aq_secondary_levels(prn).astype(
                        np.float64), **dev))
                syms = FnavEncoder(eph, GalileoIono(), tow0_s=tow0).symbols(
                    n_pages)
                self.signs[prn] = torch.tensor(
                    1.0 - 2.0 * syms.astype(np.float64), **dev)
                self.sym0[prn] = int(round(tow0 * self.sym_rate))
        else:
            raise ValueError(f"unknown signal {signal!r}")

    def generate(self, start: int, n: int,
                 gen: torch.Generator | None) -> torch.Tensor:
        f64 = torch.float64
        t = (start + torch.arange(n, device=self.device, dtype=f64)) / self.fs
        re = torch.zeros(n, device=self.device, dtype=f64)
        im = torch.zeros(n, device=self.device, dtype=f64)
        for prn in self.geo.prns:
            ttx = _interp(t, self.code_grid[prn], GRID_STEP_S)
            chip = torch.floor(ttx * self.code_rate).long()
            idx = chip % self.code_len
            sym = torch.floor(ttx * self.sym_rate).long() - self.sym0[prn]
            signs = self.signs[prn]
            sign = signs[torch.clamp(sym, 0, signs.shape[0] - 1)]
            ttx_ph = (ttx if self.phase_grid[prn] is self.code_grid[prn]
                      else _interp(t, self.phase_grid[prn], GRID_STEP_S))
            cycles = -self.carrier_hz * (t - ttx_ph)
            phase = 2.0 * np.pi * torch.remainder(cycles, 1.0)
            cs, sn = torch.cos(phase), torch.sin(phase)
            if self.signal == "L1CA":
                d = self.amp * self.codes[prn][0][idx] * sign
                re += d * cs
                im += d * sn
            else:
                code_i, code_q, sec_i, sec_q = self.codes[prn]
                period = torch.div(chip, self.code_len, rounding_mode="floor")
                a = self.amp / np.sqrt(2.0)
                d = a * code_i[idx] * sec_i[period % sec_i.shape[0]] * sign
                p = a * code_q[idx] * sec_q[period % sec_q.shape[0]]
                re += d * cs - p * sn
                im += d * sn + p * cs
        if gen is not None:
            sd = float(np.sqrt(0.5))
            re += torch.randn(n, generator=gen, device=self.device,
                              dtype=f64) * sd
            im += torch.randn(n, generator=gen, device=self.device,
                              dtype=f64) * sd
        return torch.complex(re, im)
