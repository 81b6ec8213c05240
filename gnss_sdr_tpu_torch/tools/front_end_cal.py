"""Front-end oscillator calibration (reference utils/front-end-cal analog).

Counterpart of ``tools/front_end_cal.py``: acquires all GPS PRNs from a
capture over a wide Doppler range with the port's PCPS engine on the card,
predicts each detected satellite's true Doppler from assistance
ephemerides and an approximate receiver position, and least-squares fits
the common offset:

    measured_doppler = predicted_doppler + f_offset

f_offset is the front-end LO error (reported in Hz and ppm of L1), the
quantity the reference's front-end-cal writes back into the config as
IF/ppm corrections (utils/front-end-cal/main.cc:310).

    python -m gnss_sdr_tpu_torch.tools.front_end_cal --capture x.bin \\
        --format ibyte --fs 2.6e6 --assist assist.xml --lat 41.27 \\
        --lon 1.99 --h 80 --tow 7314

Runs on the card by default and raises without one; ``--device cpu`` (or
``calibrate(..., device="cpu")``) runs PCPS on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from gnss_sdr_tpu_torch.acquisition import AcqConfig, PcpsAcquisition
from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu_torch.simulate.constellation import truth_measurement


def calibrate(x, fs: float, ephemerides: dict, rx_ecef, tow_s: float,
              doppler_max_hz: float = 15000.0, device="cuda") -> dict:
    """Core routine (importable for tests): returns the fit + per-PRN rows."""
    conf = AcqConfig(
        fs=fs, code_length_chips=1023, code_rate_cps=1.023e6,
        doppler_max_hz=doppler_max_hz, doppler_step_hz=250.0,
        max_dwells=2, pfa=1e-3, make_two_steps=True,
        doppler_step2_hz=25.0, num_doppler_bins_step2=6,
    )
    eng = PcpsAcquisition(conf, gps_l1_ca_code_table(), list(range(1, 33)),
                          device=device)
    xb = np.broadcast_to(x[: conf.input_samples],
                         (32, conf.input_samples))
    res = eng.acquire(xb, np.arange(32))
    rows = []
    for i in range(32):
        prn = i + 1
        if not res.detected[i] or prn not in ephemerides:
            continue
        tr = truth_measurement(ephemerides[prn], rx_ecef, tow_s)
        rows.append((prn, float(res.doppler_hz[i]), tr["doppler_hz"]))
    if len(rows) < 2:
        return {"ok": False, "rows": rows}
    meas = np.array([r[1] for r in rows])
    pred = np.array([r[2] for r in rows])
    offset = float(np.mean(meas - pred))
    resid = meas - pred - offset
    return {
        "ok": True,
        "f_offset_hz": offset,
        "ppm": offset / 1575.42e6 * 1e6,
        "resid_rms_hz": float(np.sqrt(np.mean(resid ** 2))),
        "rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capture", required=True)
    ap.add_argument("--format", default="ibyte")
    ap.add_argument("--fs", type=float, required=True)
    ap.add_argument("--assist", required=True, help="assistance XML")
    ap.add_argument("--lat", type=float, required=True)
    ap.add_argument("--lon", type=float, required=True)
    ap.add_argument("--h", type=float, default=0.0)
    ap.add_argument("--tow", type=float, required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the acquisition (default cuda)")
    args = ap.parse_args(argv)

    from gnss_sdr_tpu_torch.io.formats import decode_samples
    from gnss_sdr_tpu_torch.pvt.coords import llh_to_ecef
    from gnss_sdr_tpu_torch.receiver.assistance import load_assistance

    raw = Path(args.capture).read_bytes()
    x = decode_samples(raw, args.format)
    data = load_assistance(args.assist)
    ephs = {prn: e for (sys_, prn), e in data["ephemerides"].items()
            if sys_ == "G"}
    rx = llh_to_ecef(np.deg2rad(args.lat), np.deg2rad(args.lon), args.h)
    out = calibrate(x, args.fs, ephs, rx, args.tow, device=args.device)
    if not out["ok"]:
        print("not enough detected satellites with assistance ephemerides")
        return 1
    for prn, m, p in out["rows"]:
        print(f"PRN {prn:2d}: measured {m:+8.1f} Hz  predicted {p:+8.1f} Hz")
    print(f"\nLO offset: {out['f_offset_hz']:+.1f} Hz "
          f"({out['ppm']:+.3f} ppm of L1), residual RMS "
          f"{out['resid_rms_hz']:.1f} Hz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
