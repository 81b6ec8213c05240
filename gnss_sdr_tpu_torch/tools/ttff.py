"""TTFF (time-to-first-fix) measurement harness.

Counterpart of ``tools/ttff.py`` (reference analog:
tests/system-tests/ttff.cc): repeated starts of the port's ``Receiver``
against a GPS L1 C/A scenario, reporting cold and warm TTFF statistics.
Cold start decodes ephemerides live (~18-30 s of LNAV); warm start
preloads them (assistance XML / prior session), so TTFF collapses to
acquisition + track settle + first anchored subframe.

    python -m gnss_sdr_tpu_torch.tools.ttff [--trials N] [--duration S]

Runs on the card by default and raises without one; ``--device cpu`` (or
``run_trial(..., device="cpu")``) runs the receiver on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from gnss_sdr_tpu_torch import resolve_device
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig


def run_trial(seed: int, duration_s: float, warm: bool,
              device="cuda") -> float | None:
    """One receiver start on the scenario of ``seed``, fed 1 s at a time
    until the first fix or ``duration_s``; returns its TTFF in signal s, or
    None without a fix."""
    resolve_device(device)
    fs = 2.6e6
    scen = GpsScenario(ScenarioConfig(
        fs=fs, tow_start_s=7314.0, duration_s=duration_s, cn0_dbhz=45.0,
        max_sats=6, seed=seed,
    ))
    rx = Receiver(ReceiverConfig(fs=fs, num_channels=6, device=device))
    if warm:
        for prn in scen.prns:
            rx.ephemerides[("G", prn)] = scen.ephs[prn]
    sec = int(fs)
    total = int(duration_s)
    rx.feed(scen.generate(0, 2 * sec))
    rx.acquire()
    rx.run()
    for i in range(2, total):
        rx.feed(scen.generate(i * sec, sec))
        rx.run()
        if rx.status.ttff_s is not None:
            break
    return rx.status.ttff_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--duration", type=float, default=32.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the receiver (default cuda)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cold, warm = [], []
    for k in range(args.trials):
        t0 = time.time()
        c = run_trial(seed=1 + k, duration_s=args.duration, warm=False,
                      device=args.device)
        print(f"cold trial {k}: TTFF {c} s  (wall {time.time()-t0:.0f} s)",
              flush=True)
        if c is not None:
            cold.append(c)
        t0 = time.time()
        w = run_trial(seed=1 + k, duration_s=min(args.duration, 12.0),
                      warm=True, device=args.device)
        print(f"warm trial {k}: TTFF {w} s  (wall {time.time()-t0:.0f} s)",
              flush=True)
        if w is not None:
            warm.append(w)
    if cold:
        print(f"COLD: mean {np.mean(cold):.1f} s  min {min(cold):.1f}  "
              f"max {max(cold):.1f}  ({len(cold)}/{args.trials} fixed)")
    if warm:
        print(f"WARM: mean {np.mean(warm):.1f} s  min {min(warm):.1f}  "
              f"max {max(warm):.1f}  ({len(warm)}/{args.trials} fixed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
