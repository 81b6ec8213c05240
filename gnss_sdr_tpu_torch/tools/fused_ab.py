"""K1 and K2 at the GPS receiver's shape (C = 8, K = 20), timed as
``chip_smoke.py`` times them, for the ``gnss_sdr_tpu_torch`` on
``PYTHONPATH``.

    cd <checkout> && PYTHONPATH=<checkout> python \
        <this repo>/gnss_sdr_tpu_torch/tools/fused_ab.py LABEL

Builds that checkout's kernels, starts eight GPS channels (chip_smoke.py's
phase 4: Dopplers, delays and seed) on a synthetic signal, and times one
launch of K1 and of K2 five times over 50 launches queued behind a sleep
of the stream; prints one JSON line with ``LABEL``, each kernel's median
and runs, and whether the host paced a timing. Run it from two checkouts
in turns (A, B, B, A) inside one chip call to compare their kernels on one
card. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu_torch.ops import track_kernel as k2
from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
from gnss_sdr_tpu_torch.ops.slots import LANES
from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
from gnss_sdr_tpu_torch.tracking.fused import _pack_scalars, build_fused_engine
from gnss_sdr_tpu_torch.tracking.tracker import Tracker

FS = 2.6e6
DOPS = [1200.0, -2500.0, 3400.0, -400.0, 150.0, -3900.0, 2600.0, -1700.0]


def synthetic_signal(tbl: np.ndarray, n: int, dops, delays, seed: int):
    """chip_smoke.py's GPS L1 C/A channels at the given Dopplers and code
    delays (samples), with noise; no data bits."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / FS
    sig = np.zeros(n, np.complex64)
    for c, (dop, dly) in enumerate(zip(dops, delays)):
        cph = (1.023e6 * (1 + dop / 1575.42e6)) * (tt - dly / FS)
        chips = tbl[c][np.floor(cph).astype(np.int64) % 1023]
        sig += (0.5 * chips * np.exp(2j * np.pi * dop * tt + 0.3j * c)
                ).astype(np.complex64)
    noise = rng.normal(size=(n, 2)).astype(np.float32) * 0.05
    return (sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


def queued_ms(fn, reps: int) -> tuple[float, bool]:
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up,
    queued behind a sleep of the stream (chip_smoke.py's cuda_ms), and
    whether the sleep ran out before the host had queued them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(4_000_000, 500_000 * reps))
    start.record()
    for _ in range(reps):
        fn()
    paced = start.query()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, paced


def main(label: str) -> None:
    dev = torch.device("cuda")
    tbl = gps_l1_ca_code_table().astype(np.float32)
    c, k = 8, 20
    delays = [37.0 + 311.0 * ch for ch in range(c)]
    sig = synthetic_signal(tbl, int(FS * 1.12), DOPS, delays, seed=1)
    window = torch.as_tensor(sig, device=dev)
    conf = gps_l1ca_plan(FS, num_channels=c, steps_per_block=k).trk_conf
    trk = Tracker(conf, tbl, device=dev)
    for ch in range(c):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=delays[ch],
                          acq_doppler_hz=DOPS[ch] + 30.0, acq_samplestamp=0,
                          current_abs_sample=0)
    st = trk.state.replace(pos=torch.as_tensor(
        trk.pos_abs.astype(np.int32), device=dev))
    args = (window, torch.as_tensor(trk.codes, device=dev),
            _pack_scalars(conf, st), st.pos, build_fused_engine(conf))
    out = torch.empty((c, k, LANES), dtype=torch.float32, device=dev)
    res = {"tree": label, "host_paced": False}
    for name, launch in (("k1", k1.launch), ("k2", k2.launch)):
        runs = []
        for _ in range(5):
            ms, paced = queued_ms(lambda: launch(*args, out), 50)
            runs.append(ms)
            res["host_paced"] |= paced
        res[name] = float(np.median(runs))
        res[name + "_runs"] = runs
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
