"""The plain reference that decides ``correct``: the scenario's own truth,
in NumPy, computed again from the true ephemerides and the receiver's
position and clock (``truth.py``), never from anything the port made.

It judges, file by file, what the timed path produced:

- ``acq_code_err_samples``: the worst gap between each satellite's first
  acquisition (its code delay) and the true code phase at the file's
  first sample, in samples of its band (the search's own resolution); a
  satellite not in view that it starts is a false alarm at the
  configured Pfa, judged only if it locks;
- ``trk_code_err_m``: the worst gap between a locked channel's code phase
  at the end of a sampled period (``rem_code_phase`` at
  ``abs_sample_end``) and the true code phase at that sample, in metres
  (a chip is 293 m on L1 C/A and 29.3 m on E5a);
- ``sats_unlocked``: satellites in view that an acquisition started in a
  file fed to its end at their Doppler (within half the search's step of
  the truth, DOPPLER_SLACK_HZ more: the bin the grid puts nearest) and
  that never reached a locked period there. A start one bin off, which
  the search's noise gives a few times in a hundred at these C/N0, can
  fail to pull in; that is the acquisition's miss at its configured grid,
  not a channel the tracker left unlocked;
- ``eph_err_m``: the worst gap, as position or clock times c, between a
  decoded ephemeris and the broadcast one, at the file's middle;
- ``fix_err_3d_m``: the worst 3D error of the fixes, past each file's
  first three (the smoothing's start, as ``tests/test_position.py`` skips
  them);
- ``fix_gap_max_s``: the longest time between two consecutive fixes of
  a file, by their receiver time: the configuration's PVT runs every
  100 ms on its 20 ms observation grid;
- ``files_without_fix``: files fed to their end without a fix.

``control`` is the same reference computed in float32 and put in the
port's place: its acquisitions, periods, ephemerides and fixes (a least-
squares fix from its own pseudoranges) are judged by the float64 truth.
"""

from __future__ import annotations

import math

import numpy as np

from rxbench import truth
from rxbench.frozen.constants import galileo_e5a as E5A
from rxbench.frozen.constants import gps_l1_ca as L1
from rxbench.frozen.pvt.coords import ecef_to_llh
from rxbench.frozen.pvt.ephemeris import C_LIGHT

SIGNALS = {
    "L1CA": dict(carrier_hz=L1.FREQ_HZ, code_rate=L1.CODE_RATE_CPS,
                 code_len=L1.CODE_LENGTH_CHIPS),
    "E5a": dict(carrier_hz=E5A.FREQ_HZ, code_rate=E5A.CODE_RATE_CPS,
                code_len=E5A.CODE_LENGTH_CHIPS),
}
GAMMA_E5A = (L1.FREQ_HZ / E5A.FREQ_HZ) ** 2
NUMBERS = ("acq_code_err_samples", "trk_code_err_m", "sats_unlocked",
           "eph_err_m", "fix_err_3d_m", "fix_gap_max_s", "files_without_fix")
COUNTS = ("sats_unlocked", "files_without_fix")
# the truth's Doppler drifts under 1 Hz a second over the window a search
# reads; a bin centre half a step from it is still the nearest bin
DOPPLER_SLACK_HZ = 5.0


class BandTruth:
    """One band's true code timeline at receiver samples, in ``dtype``."""

    def __init__(self, geo, signal: str, fs: float, file_samples: int,
                 dop_step_hz: float, dtype=np.float64) -> None:
        self.geo, self.signal, self.fs = geo, signal, fs
        self.file_samples = file_samples
        self.dop_step_hz = dop_step_hz
        self.dtype = dtype
        self.sig = SIGNALS[signal]
        self.height_m = ecef_to_llh(geo.rx_ecef)[2]

    def _group_delay(self, prn: int) -> float:
        eph = self.geo.ephs[prn]
        return (eph.tgd if self.signal == "L1CA"
                else GAMMA_E5A * eph.bgd_e1e5a)

    def code_time(self, prn: int, file_index: int, samples) -> np.ndarray:
        """Satellite time of the code received at ``samples`` of file
        ``file_index``."""
        dt = self.dtype
        s = np.asarray(samples, np.int64) + file_index * self.file_samples
        tow = dt(self.geo.tow_start_s) + s.astype(dt) / dt(self.fs)
        m = truth.measure(self.geo.ephs[prn], self.geo.rx_ecef, tow,
                          np.full(tow.shape, self.geo.rx_clock_bias_s, dt),
                          self.sig["carrier_hz"], dtype=dt)
        tropo = truth.tropo_delay(truth.elevation(
            self.geo.rx_ecef, m["sat_pos"].astype(np.float64)),
            self.height_m)
        return (m["t_tx_sv"] - dt(self._group_delay(prn))
                - tropo.astype(dt) / dt(C_LIGHT))

    def doppler_hz(self, prn: int, file_index: int, sample: int) -> float:
        """Carrier Doppler at ``sample`` of file ``file_index``: the carrier
        times the rate of the satellite time received, less one (over ten
        milliseconds)."""
        n = int(round(self.fs * 1e-2))
        t = self.code_time(prn, file_index, [sample, sample + n])
        return float(self.sig["carrier_hz"]
                     * ((t[1] - t[0]) * self.fs / n - 1.0))

    def code_phase(self, prn: int, file_index: int, samples) -> np.ndarray:
        """Chips past the code epoch at ``samples`` (float64 out)."""
        dt = self.dtype
        chips = self.code_time(prn, file_index, samples) * dt(
            self.sig["code_rate"])
        return np.mod(chips, dt(self.sig["code_len"])).astype(np.float64)


def _by_sat(periods: list) -> dict:
    """{(system, PRN): (sample stamps [N] int64, code phases [N])}."""
    rows: dict = {}
    for sys_, prn, s_end, rem in periods:
        rows.setdefault((sys_, prn), []).append((s_end, rem))
    return {k: (np.array([r[0] for r in v], np.int64),
                np.array([r[1] for r in v], np.float64))
            for k, v in rows.items()}


def _wrap(x, length: float) -> np.ndarray:
    return (np.asarray(x) + length / 2.0) % length - length / 2.0


def judge(cfg: dict, geos: dict, answers: list, file_s: float) -> dict:
    """The reference's numbers for the answers of every file (float64)."""
    tr = _truths(cfg, geos, file_s)
    acq = trk = eph_gap = fix = fix_gap = 0.0
    no_fix = unlocked = 0
    for ans in answers:
        for (sys_, prn), (_dop, delay) in ans.first_acq.items():
            t = tr[sys_]
            if prn not in t.geo.prns:
                continue
            length = t.sig["code_len"]
            truth_chips = t.code_phase(prn, ans.index, [0])[0]
            got = (length - float(delay) * t.sig["code_rate"] / t.fs) % length
            gap = abs(float(_wrap(got - truth_chips, length)))
            acq = max(acq, gap * t.fs / t.sig["code_rate"])
        locked = _by_sat(ans.periods)
        if ans.complete:
            unlocked += len({(sys_, prn) for sys_, prn in sound_starts(tr, ans)
                             if (sys_, prn) not in locked})
        for (sys_, prn), (s_end, rem) in locked.items():
            t = tr[sys_]
            if prn not in t.geo.prns:
                trk = math.inf
                continue
            phase = t.code_phase(prn, ans.index, s_end)
            gap = float(np.abs(_wrap(phase - rem, t.sig["code_len"])).max())
            trk = max(trk, gap * C_LIGHT / t.sig["code_rate"])
        for (sys_, prn), eph in ans.ephemerides.items():
            t = tr.get(sys_)
            if t is None or prn not in t.geo.prns:
                eph_gap = math.inf
                continue
            mid_tow = t.geo.tow_start_s + (ans.index + 0.5) * file_s
            eph_gap = max(eph_gap, eph_error(eph, t.geo.ephs[prn], mid_tow))
        rx_ecef = next(iter(tr.values())).geo.rx_ecef
        for f in ans.fixes[3:]:
            fix = max(fix, float(np.linalg.norm(np.asarray(f.pos_ecef)
                                                - rx_ecef)))
        if len(ans.fixes) > 1:
            fix_gap = max(fix_gap, float(np.diff([f.tow_s
                                                  for f in ans.fixes]).max()))
        if ans.complete and not ans.fixes:
            no_fix += 1
    return {"acq_code_err_samples": acq, "trk_code_err_m": trk,
            "sats_unlocked": float(unlocked), "eph_err_m": eph_gap,
            "fix_err_3d_m": fix, "fix_gap_max_s": fix_gap,
            "files_without_fix": float(no_fix)}


def start_doppler_errors(tr: dict, ans) -> list:
    """(system, PRN, Hz) of each start of a satellite in view: the start's
    Doppler less the truth at the start of the feed it searched."""
    out = []
    for feed, sys_, prn, dop in ans.starts:
        t = tr[sys_]
        if prn in t.geo.prns:
            out.append((sys_, prn, dop - t.doppler_hz(
                prn, ans.index, int(round(feed * t.fs)))))
    return out


def sound_starts(tr: dict, ans) -> list:
    """(system, PRN) of the starts at the nearest Doppler bin."""
    return [(s, p) for s, p, err in start_doppler_errors(tr, ans)
            if abs(err) <= tr[s].dop_step_hz / 2 + DOPPLER_SLACK_HZ]


def _truths(cfg: dict, geos: dict, file_s: float, dtype=np.float64) -> dict:
    return {b["system"]: BandTruth(geos[b["geometry"]], b["signal"],
                                   b["fs"], int(round(b["fs"] * file_s)),
                                   b["plan_options"]["doppler_step_hz"], dtype)
            for b in cfg["bands"]}


def eph_error(got, want, tow: float, want_dtype=np.float64) -> float:
    """Worst of the position gap and c times the clock gap between
    ephemeris ``got`` (float64) and ``want`` (in ``want_dtype``)."""
    p1, _, c1, _ = truth.orbit(got, [tow])
    p2, _, c2, _ = truth.orbit(want, [tow], want_dtype)
    return float(max(np.linalg.norm(p1[0] - p2[0].astype(np.float64)),
                     C_LIGHT * abs(c1[0] - float(c2[0]))))


def ls_fix(sat_pos, pr, dtype) -> np.ndarray:
    """Position and clock by Gauss-Newton least squares on pseudoranges
    ``pr`` [N] from satellites at ``sat_pos`` [N, 3], every step in
    ``dtype``, from the centre of the earth."""
    sat_pos = np.asarray(sat_pos, dtype)
    pr = np.asarray(pr, dtype)
    x = np.zeros(4, dtype)
    for _ in range(10):
        d = sat_pos - x[:3]
        rng = np.linalg.norm(d, axis=1)
        h = np.concatenate([-d / rng[:, None], np.ones((len(pr), 1), dtype)],
                           axis=1)
        dx = np.linalg.lstsq(h, pr - (rng + x[3]), rcond=None)[0]
        x = (x + dx).astype(dtype)
    return x


def control(cfg: dict, geos: dict, answers: list, file_s: float,
            dtype=np.float32) -> dict:
    """The reference in ``dtype`` put in the port's place: for each
    file, its own acquisitions at the first sample, its own code phases
    at the periods the port was sampled at, the broadcast ephemerides
    evaluated in ``dtype`` and a least-squares fix at each of the port's
    fix times from its own pseudoranges; judged as ``judge`` judges the
    port, by the float64 truth."""
    lo = _truths(cfg, geos, file_s, dtype)
    hi = _truths(cfg, geos, file_s)
    acq = trk = eph_gap = fix = fix_gap = 0.0
    for ans in answers:
        # its fixes come at the port's fix times
        if len(ans.fixes) > 1:
            fix_gap = max(fix_gap, float(np.diff([f.tow_s
                                                  for f in ans.fixes]).max()))
        for (sys_, prn) in ans.first_acq:
            t = hi[sys_]
            if prn not in t.geo.prns:
                continue
            gap = abs(float(_wrap(lo[sys_].code_phase(prn, ans.index, [0])[0]
                                  - t.code_phase(prn, ans.index, [0])[0],
                                  t.sig["code_len"])))
            acq = max(acq, gap * t.fs / t.sig["code_rate"])
        for (sys_, prn), (s_end, _rem) in _by_sat(ans.periods).items():
            t = hi[sys_]
            if prn not in t.geo.prns:
                continue
            gap = np.abs(_wrap(lo[sys_].code_phase(prn, ans.index, s_end)
                               - t.code_phase(prn, ans.index, s_end),
                               t.sig["code_len"])).max()
            trk = max(trk, float(gap) * C_LIGHT / t.sig["code_rate"])
        for (sys_, prn) in ans.ephemerides:
            t = hi[sys_]
            mid_tow = t.geo.tow_start_s + (ans.index + 0.5) * file_s
            eph_gap = max(eph_gap, eph_error(
                t.geo.ephs[prn], t.geo.ephs[prn], mid_tow, dtype))
        gps = lo.get("G")
        for f in ans.fixes[3:]:
            if gps is None:
                break
            # the receiver time of the fix, as the port's solution states it
            tow = dtype(f.tow_s)
            geo = gps.geo
            pos, pr = [], []
            for prn in geo.prns:
                m = truth.measure(geo.ephs[prn], geo.rx_ecef, [tow],
                                  [geo.rx_clock_bias_s], L1.FREQ_HZ,
                                  dtype=dtype)
                pos.append(m["sat_pos"][0])
                pr.append(dtype(C_LIGHT) * (tow - m["t_tx_sv"][0]))
            x = ls_fix(pos, pr, dtype)
            fix = max(fix, float(np.linalg.norm(
                x[:3].astype(np.float64) - geo.rx_ecef)))
    return {"acq_code_err_samples": acq, "trk_code_err_m": trk,
            "sats_unlocked": 0.0, "eph_err_m": eph_gap, "fix_err_3d_m": fix,
            "fix_gap_max_s": fix_gap, "files_without_fix": 0.0}


def detail(cfg: dict, geos: dict, ans, file_s: float) -> dict:
    """Per system of one file: satellites in view, those the first
    acquisition started, each start's Doppler error (Hz, by feed), the
    decoded ephemerides and each locked satellite's worst tracked
    code-phase gap (m) over its sampled periods."""
    out = {}
    truths = _truths(cfg, geos, file_s)
    dop_err = start_doppler_errors(truths, ans)
    for sys_, t in truths.items():
        trk = {}
        for (s_, prn), (s_end, rem) in _by_sat(ans.periods).items():
            if s_ != sys_ or prn not in t.geo.prns:
                continue
            gap = np.abs(_wrap(t.code_phase(prn, ans.index, s_end) - rem,
                               t.sig["code_len"])).max()
            trk[prn] = float(gap) * C_LIGHT / t.sig["code_rate"]
        out[sys_] = {"in_view": list(t.geo.prns),
                     "acquired": sorted(p for s_, p in ans.first_acq
                                        if s_ == sys_),
                     "start_dop_err_hz": [[p, round(e, 1)] for s_, p, e
                                          in dop_err if s_ == sys_],
                     "trk_worst_m": trk,
                     "ephemerides": sorted(p for s_, p in ans.ephemerides
                                           if s_ == sys_)}
    out["fixes"] = len(ans.fixes)
    if ans.fixes:
        tows = np.array([f.tow_s for f in ans.fixes])
        t0 = next(iter(geos.values())).tow_start_s + ans.index * file_s
        out["first_fix_s"] = float(tows[0] - t0)
        out["last_fix_s"] = float(tows[-1] - t0)
        out["fix_gap_max_s"] = float(np.diff(tows).max()) if len(tows) > 1 \
            else None
    out["seconds_fed"] = ans.seconds_fed
    return out
