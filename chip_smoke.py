"""Run the PyTorch port of the receiver on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gnss_sdr_tpu_torch/csrc/``, holds
each against its plain PyTorch version on the card, drives the three
tracking engines (eager through the correlator K3, fused through K1 and
through K2) over the same blocks, runs the GPS L1 C/A receiver through K1
and the .conf/CLI entry point (``gnss_sdr_tpu_torch.main``) from an
``ibyte`` capture through K1 and, under ``GNSS_SDR_TPU_FUSED=perchannel``,
through K2, and checks every run's fixes against the position gates of
``tests/test_position.py``. Then the kernel-bench path: K4 against its
plain version, the port's ``tools/kbench.py`` (K2 and K4 at C = 32,
K = 200, with K1 timed at the same shape) and ``tools/mosaic_probe.py``
(every P1 variant against its plain version, then ns per period over
K = 2000, at the trackers' cluster size and at one CTA a channel). Then
Galileo E1: K1 and K2 against their plain version at the E1 shape (T = 5,
with and without the pilot), the E1-B receiver of ``tests/test_galileo.py``
from Python and through the CLI with ``conf/galileo_e1_file.conf``'s keys
(K1 and K2), the E1-B+C pilot receiver of ``tests/test_galileo_pilot.py``
with the three engines held to each other on its capture, and ``bench.py``'s
gal8 settings. Then long codes and two bands: K1, K2 and K3 against their
plain version at the GPS L5 and Galileo E5a shapes (10230-chip tables at
10.4 Msps, K = 20 and 500), the L1 + L5 receiver and the E5a receiver
(assisted start, then the three engines) of ``tests/test_dual_band.py``,
its Doppler-projection check, ``bench.py``'s dual16, and the CLI with
``conf/dual_band_gps_gal.conf``'s keys (two RF chains) through K1 and K2,
held to the dual16 run. Then GLONASS L1 C/A (FDMA): K1 and K2 with FDMA
against their plain version at the GLONASS shape (3.6 Msps, frequency
channels -7..+6, K = 20 and 200), the 28 s receiver of
``tests/test_glonass.py`` from Python, the three engines on
``tests/test_fused_receiver.py``'s FDMA case, and the CLI with
``Channels_1G`` keys through K1 and K2. Then the last plans: K1, K2 and
K3 against their plain version at the BeiDou B1I and B3I (the D1 mode:
NH20 on the one data component, the Costas discriminator kept), GPS L2C
(20 ms periods), Galileo E6B and SBAS shapes, the GPS L1 + BeiDou B1I
receiver of ``tests/test_beidou.py`` from Python (with the three engines
on its B1I capture) and through the CLI with two RF chains (K1 and K2),
the B1I GEO (D2) case of ``tests/test_beidou_geo.py`` through the
``Tracker``, PCPS for E6B, SBAS, L2C and B3I, and ``bench.py``'s mc64
(GPS, Galileo, GLONASS and BeiDou, 16 channels each, three bands). Then
the alternates: the fine-Doppler, Tong, QuickSync, CCCWSR and
noncoherent I/Q acquisition engines against PCPS on the first window of
the gps8, E1-B and E5a captures, and ``tests/test_roc.py``'s ROC sweep;
``tests/test_kf_tracking.py``'s cases and the gps8 receiver with
GPS_L1_CA_KF_Tracking (the eager engine, K3 once a period, K3 held to its
plain version on a period of the run); ``conf/gps_l1_gaussian.conf``'s
CKF loop closer through the CLI (K1); ``tests/test_tcp_connector.py``'s
external loop over a localhost socket; the gps8 capture moved to a
250 kHz IF through the CLI with a Freq_Xlating_Fir_Filter; and each
conditioner stage on the card against the CPU. Then the receiver's host
options and the CLI's control plane (phases 38-42): the moving receiver
of ``tests/test_dynamic.py`` with the PVT Kalman filter and the tracking
and acquisition dumps (gps8-dyn-pvtkf); phase 17's L1 + L5 run in
PPP_Static with the solid, pole and ocean tides (l1l5-ppp); phase 12's
E1-B run with OSNMA in strict mode (e1b-osnma); conf/gps_l1_file.conf
through the CLI cold, with the assistance XML, the telecommand server
queried by a client thread, SUPL against a closed port and the dumps,
then warm from that XML with a ``reset`` through the command FIFO
(gps8-ctl); and the port's front_end_cal, ttff and bench_micro tools.
Then multi-device (phases 43-46) on the one card: the gps8 Tracker on two
channel shards of cuda:0 against the unsharded Tracker, bit for bit,
through K1 and under ``perchannel`` through K2; phase 6's 32 s run with
``num_devices=1`` (the sharded code path) on phase 6's gates, and
``num_devices`` past the card count refused; ``dryrun_multichip(1)``, whose
two ``tools/dist_worker.py`` ranks (gloo, both on the card, K3 a period)
gather the rows this process computes unsharded, bit for bit; and the
scaling tool at 1, 2 and 4 shards. Each
run is held to its test's gates, and each kernel it ran to its plain
version on a block of the run's own inputs. The Galileo, dual-band,
GLONASS, BeiDou and mc64 captures are made in 1 s chunks by worker
processes. Every phase prints one JSON line; any failure exits nonzero. The last two lines are
the kernel table and ``{"ok": true, "device": {...}}``. Needs a CUDA
device and the repository's ``gnss_sdr_tpu_torch`` package; imports no
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FS = 2.6e6
CARD_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
CARD_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
ROOT = Path(__file__).resolve().parent
# operations per sample, counted from the kernels' inner loops (csrc/):
# phase fma 2, sincosf ~20, wipeoff 6, code phase fma 2, and per tap the
# replica (K1 and K2 ~12, K3's ramp form ~20) plus 4 for the two products
# and sums
FUSED_OPS_PER_SAMPLE = 2 + 20 + 6 + 2 + 3 * (12 + 4)
K3_OPS_PER_SAMPLE = 2 + 20 + 6 + 2 + 3 * (20 + 4)
# P1: operations per element of v and period, counted from the plain
# versions (tools/mosaic_probe.py): the add of acc and the consuming sum,
# plus each body's own (sincosf ~20 each way as above, vec20 20 mul+add,
# lanereduce8 8 mul+add); gathers and copies are loads, not operations
P1_OPS_PER_ELEMENT = {"baseline": 2, "gather1": 2, "gather3": 6,
                      "qloop8": 2, "sincos": 2 + 2 * 20 + 1, "vec20": 42,
                      "matreduce": 2, "lanereduce8": 1 + 16, "staging": 1,
                      "narrow": 300, "out store": 1}
# P1's loop-carried chain: period i + 1 starts from acc, so every period
# costs at least its dependent float32 operations, 4 cycles each: the
# body's own for one element (from acc to v), ceil(log2(elements consumed
# a period)) adds of the period's sum, and the acc update (acc + sum *
# 1e-20 + 1: 3 operations). Counted from the plain versions
# (tools/mosaic_probe.py) and the kernel's forms (csrc/probe.cu):
#   variant       body  consumed  sum  update  chain
#   baseline         1      2816   12       3     16   v = src + acc
#   gather1          1      2816   12       3     16   the index needs no acc
#   gather3          3      2816   12       3     18   ((a+acc)+(b+acc))+(c+acc)
#   qloop8           1      2816   12       3     16
#   sincos           8      2816   12       3     23   add, mul, rint, 2 fma,
#                                                       mul, MUFU, cos + sin
#   vec20           41      2816   12       3     56   add, 20 x (mul, add)
#   matreduce        6       128    7       3     16   add, a 22-row column: 5
#   lanereduce8      9       176    8       3     20   add, scale, 128 lanes: 7
#   staging          3      2816   12       3     18   r0: mul, add, convert
#                                                       (the copy is a load)
#   narrow         300         1    0       0    300   v itself, no acc
#   out store        0         1    0       1      1   acc + 1; the row's
#                                                       store is off the chain
P1_CHAIN_OPS = {"baseline": 16, "gather1": 16, "gather3": 18, "qloop8": 16,
                "sincos": 23, "vec20": 56, "matreduce": 16,
                "lanereduce8": 20, "staging": 18, "narrow": 300,
                "out store": 1}
CYCLES_PER_OP = 4               # dependent float32 latency on the H100
# lanes compared between fused trackers at T = 3
# (tests/test_track_kernel_blocked.py); period length and position exact
CHECK_LANES = [0, 1, 2, 3, 10, 11, 12, 13, 14, 17, 20, 21, 22, 23,
               32, 33, 34, 35, 36, 37]
EXACT_LANES = [10, 17]


def check_lanes(num_taps: int) -> list[int]:
    """Lanes compared between fused trackers with ``num_taps`` taps (the
    Galileo E1 cases): every tap, lanes 10-14, 17, 20 and 21, every tap
    accumulator, and the data and secondary lanes 32-37."""
    return (list(range(2 * num_taps)) + [10, 11, 12, 13, 14, 17, 20, 21]
            + list(range(22, 22 + 2 * num_taps)) + list(range(32, 38)))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# cycles the stream sleeps before the timed calls start, per call and at
# least: at ~1.7-2 GHz about 250 us a call (the host takes 60-100 us to
# queue one K1 launch) and 2 ms
QUEUE_CYCLES_PER_CALL = 500_000
QUEUE_CYCLES_MIN = 4_000_000
# timings in which the host had not queued every call when the stream woke
HOST_PACED: list[str] = []


def cuda_ms(fn, reps: int, warm: bool = True, queue_ahead: bool = True,
            name: str = "") -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call unless ``warm`` is False. With
    ``queue_ahead`` the stream first sleeps while the host queues the calls,
    so that a kernel shorter than the host's launch interval is timed and
    not the interval; a timing where the sleep ran out first is recorded in
    HOST_PACED."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(max(QUEUE_CYCLES_MIN, QUEUE_CYCLES_PER_CALL * reps))
    start.record()
    for _ in range(reps):
        fn()
    if queue_ahead and start.query():
        HOST_PACED.append(name or getattr(fn, "__name__", "?"))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float,
          chain_ms: float = 0.0) -> tuple[float, str]:
    """The least time in ms and what sets it: the bytes over the memory
    rate, the operations over the float32 rate, or a loop-carried chain."""
    times = {"bytes": bytes_moved / CARD_BYTES_PER_S * 1e3,
             "operations": ops / CARD_F32_FLOPS * 1e3, "chain": chain_ms}
    by = max(times, key=times.get)
    return times[by], by


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi``'s clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def stream_bytes(rows: np.ndarray, window_len: int) -> int:
    """Bytes of the sample stream that a fused tracker's rows [C, K, 128]
    read: the union of every period's samples [position, position +
    length) (lanes 17 and 10) inside the window, so that a sample several
    channels read counts once."""
    start = np.clip(rows[:, :, 17].astype(np.int64).ravel(), 0, window_len)
    stop = np.clip(rows[:, :, 17].astype(np.int64).ravel()
                   + rows[:, :, 10].astype(np.int64).ravel(), 0, window_len)
    order = np.argsort(start, kind="stable")
    start, stop = start[order], stop[order]
    # what each range adds past the furthest end of the ranges before it
    reach = np.maximum.accumulate(stop)
    before = np.concatenate([start[:1], reach[:-1]])
    return int(np.clip(stop - np.maximum(start, before), 0, None).sum()) * 8


def synthetic_signal(tbl: np.ndarray, n: int, dops, delays, seed: int):
    """Sum of GPS L1 C/A channels at the given Dopplers and code delays
    (samples), with noise; no data bits."""
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


def fused_ops_per_sample(num_taps: int) -> int:
    return FUSED_OPS_PER_SAMPLE + (num_taps - 3) * (12 + 4)


def k3_ops_per_sample(num_taps: int, pilot: bool) -> int:
    return K3_OPS_PER_SAMPLE + (num_taps - 3 + int(pilot)) * (20 + 4)


def simple_lanes(num_taps: int) -> list[int]:
    """K4's output lanes: the taps, then lanes 10-19."""
    return list(range(2 * num_taps)) + list(range(10, 20))


def rows_rel_err(name: str, ref: np.ndarray, got: np.ndarray, K: int,
                 lanes=CHECK_LANES, first_tol: float = 5e-5) -> dict:
    """Worst relative difference over the checked lanes, within
    ``first_tol`` over the first 2 periods (5e-5; 2e-4 for long codes, as
    tests/test_track_kernel_blocked.py holds them) and 2e-3 over all K;
    period lengths and positions equal."""
    rels = {}
    for upto, tol in ((2, first_tol), (K, 2e-3)):
        worst = 0.0
        for ln in lanes:
            a, b = ref[:, :upto, ln], got[:, :upto, ln]
            worst = max(worst, float(np.abs(a - b).max())
                        / max(1e-6, float(np.abs(a).max())))
        if not worst < tol:
            raise AssertionError(
                f"{name} (K={K}) disagrees over {upto} periods: {worst}")
        rels[f"rel_err_first_{upto}"] = worst
    for ln in EXACT_LANES:
        if not np.array_equal(ref[:, :, ln], got[:, :, ln]):
            raise AssertionError(f"{name} (K={K}) lane {ln} not exact")
    return rels


def position_gates(status, scen, ttff=(10.0, 32.0)) -> dict:
    """The receiver's fixes against tests/test_position.py's gates; raises
    if one fails. ``ttff`` is the window of the first fix, in signal s (a
    cold start's by default)."""
    from gnss_sdr_tpu_torch.pvt.coords import ecef_to_enu

    fixes = status.fixes
    lat, lon = np.deg2rad(scen.cfg.rx_lat_deg), np.deg2rad(scen.cfg.rx_lon_deg)
    enu = np.array([ecef_to_enu(f.pos_ecef - scen.rx_ecef, lat, lon)
                    for f in fixes[3:]]) if len(fixes) > 3 else np.zeros((0, 3))
    err_2d = np.hypot(enu[:, 0], enu[:, 1])
    err_3d = np.linalg.norm(enu, axis=1)
    speed = np.array([np.linalg.norm(f.vel_ecef) for f in fixes[3:]])
    e = dict(
        acquired=len(status.acquired), subframes=status.subframes,
        fixes=len(fixes),
        mean_2d_m=float(err_2d.mean()) if len(err_2d) else math.inf,
        mean_3d_m=float(err_3d.mean()) if len(err_3d) else math.inf,
        rms_2d_m=float(np.sqrt(np.mean(err_2d ** 2))) if len(err_2d)
        else math.inf,
        mean_speed_mps=float(speed.mean()) if len(speed) else math.inf,
        ttff_s=status.ttff_s)
    gates = (e["acquired"] >= 4 and e["subframes"] >= 8
             and e["fixes"] >= 10 and e["mean_2d_m"] < 2.0
             and e["mean_3d_m"] < 5.0 and e["rms_2d_m"] < 3.0
             and e["mean_speed_mps"] < 0.5 and e["ttff_s"] is not None
             and ttff[0] < e["ttff_s"] < ttff[1])
    if not gates:
        raise AssertionError(f"position gates failed: {e}")
    return e


@contextlib.contextmanager
def fused_engine(value: str | None):
    """GNSS_SDR_TPU_FUSED set to ``value`` (unset for None) inside."""
    old = os.environ.pop("GNSS_SDR_TPU_FUSED", None)
    if value is not None:
        os.environ["GNSS_SDR_TPU_FUSED"] = value
    try:
        yield
    finally:
        os.environ.pop("GNSS_SDR_TPU_FUSED", None)
        if old is not None:
            os.environ["GNSS_SDR_TPU_FUSED"] = old


def assert_match(a, b, prompt_tol=5e-3, dop_tol=0.1, phase_tol=1e-3,
                 channels=slice(None)) -> dict:
    """tests/test_fused_receiver.py's _assert_match on two BlockResults,
    over ``channels`` (all by default; an idle channel's rows track
    nothing), the carrier phase within ``phase_tol`` rad; returns the
    measured differences."""
    oa = {k: v[:, channels] for k, v in a.outputs.items()}
    ob = {k: v[:, channels] for k, v in b.outputs.items()}
    for k in ("n_samples", "pos_end", "boundary"):
        if not np.array_equal(oa[k], ob[k]):
            raise AssertionError(f"engines disagree on {k}")
    pa, pb = oa["prompt"], ob["prompt"]
    diffs = {
        "doppler_hz": float(np.abs(oa["carrier_doppler"]
                                   - ob["carrier_doppler"]).max()),
        "prompt_rel_median": float(np.median(np.abs(pa - pb)
                                             / (np.abs(pa) + 1e-9))),
        "carrier_phase_rad": float(np.abs(oa["carrier_phase"]
                                          - ob["carrier_phase"]).max()),
        "rem_code_phase_chips": float(np.abs(
            oa["rem_code_phase"] - ob["rem_code_phase"]).max()),
    }
    limits = {"doppler_hz": dop_tol, "prompt_rel_median": prompt_tol,
              "carrier_phase_rad": phase_tol, "rem_code_phase_chips": 1e-3}
    for k, lim in limits.items():
        if not diffs[k] < lim:
            raise AssertionError(f"engines disagree on {k}: {diffs[k]}")
    return diffs


def k3_phase(dev, tbl, kernels) -> None:
    """Phase 3: K3 against its plain version on random samples (N = 2688,
    2602 valid) at the eager engine's C = 8 (R = 8) and at C = 132 (R = 1),
    T = 3, and at C = 8 with T = 5 and the data prompt; then at the
    Galileo E1-B+C eager engine's shape (C = 8, the 8184-unit sinBOC pilot
    and data tables, N = 16128, 16000 valid at 4 Msps, T = 5 with the data
    prompt). Each timed over five runs of 200 launches queued ahead of the
    device (the median is the kernel's time) and, at C = 8, T = 3, five
    runs paced by the host. The C = 8, T = 3 numbers go into ``kernels``
    (K3 on the Galileo path is held on the E1-B+C run's own periods in
    phase 14)."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import (
        galileo_e1b_sinboc_table,
        galileo_e1c_sinboc_table,
    )
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.ops.correlator import pack_code_table
    from gnss_sdr_tpu_torch.ops.slots import LANES

    sms = k1.sm_count(dev)
    t3, t5 = [-0.25, 0.0, 0.25], [-0.5, -0.25, 0.0, 0.25, 0.5]
    e1c, e1b = galileo_e1c_sinboc_table(), galileo_e1b_sinboc_table()
    gps = (1023, tbl, -tbl[::-1], 2688, 2602, 1.023e6 / FS)
    e1 = (E1_LEN, e1c, e1b, 16128, 16000, E1_RATE / E1_FS)
    for C, taps, pilot, shape in (
            (8, t3, False, gps), (132, t3, False, gps), (8, t5, True, gps),
            (8, [-0.6, -0.25, 0.0, 0.25, 0.6], True, e1)):
        L, ptbl, dtbl, npad, n_valid, step = shape
        rng = np.random.default_rng(0)
        x = torch.as_tensor((rng.normal(size=(C, npad))
                             + 1j * rng.normal(size=(C, npad))
                             ).astype(np.complex64), device=dev)
        rows = np.arange(C) % len(ptbl)
        cq = torch.as_tensor(pack_code_table(ptbl[rows]), device=dev)
        dq = torch.as_tensor(pack_code_table(dtbl[rows]), device=dev)
        sc = np.zeros((C, 8), np.float32)
        sc[:, 0] = rng.uniform(0, L, C)
        sc[:, 1] = step
        sc[:, 2] = rng.uniform(0, 6.28, C)
        sc[:, 3] = rng.uniform(-0.012, 0.012, C)
        sc[:, 4] = n_valid
        sc = torch.as_tensor(sc, device=dev)
        kw = dict(code_len=L, track_pilot=pilot)
        nt = len(taps) + (1 if pilot else 0)
        got = k3.correlator(x, cq, dq, sc, taps, **kw)
        cluster = dict(cluster_ctas=k3.correlator.cluster,
                       cluster_rule=k1.cluster_shape(C, npad, sms)[0])
        ref = k3.correlator_plain(x, cq, dq, sc, taps, **kw)
        g, r = got.cpu().numpy()[:, 0], ref.cpu().numpy()[:, 0]
        gc = g[:, 0:2 * nt:2] + 1j * g[:, 1:2 * nt:2]
        rc = r[:, 0:2 * nt:2] + 1j * r[:, 1:2 * nt:2]
        rel = float((np.abs(gc - rc) / np.maximum(np.abs(rc), 1.0)).max())
        if not rel < 2e-3 or np.any(g[:, 2 * nt:] != 0):
            raise AssertionError(f"K3 C={C} T={len(taps)} disagrees with its "
                                 f"plain version: {rel}")
        out = torch.empty_like(got)

        def k3_launch():
            k3.launch(x, cq, dq, sc, taps, out, **kw)

        main = C == 8 and not pilot
        runs = [cuda_ms(k3_launch, 200,
                        name=f"K3 C={C} T={len(taps)} L={L}")
                for _ in range(5)]
        paced = ([cuda_ms(k3_launch, 200, queue_ahead=False)
                  for _ in range(5)] if main else None)
        ms = float(np.median(runs))
        plain_ms = cuda_ms(
            lambda: k3.correlator_plain(x, cq, dq, sc, taps, **kw), 20,
            queue_ahead=False)
        # samples each channel reads (n_valid of N), tables, scalars, output
        k3_bytes = (C * n_valid * 8 + C * L * 4 * (2 if pilot else 1)
                    + sc.numel() * 4 + C * LANES * 4)
        b_ms, b_by = bound(k3_bytes, C * n_valid * k3_ops_per_sample(
            len(taps), pilot))
        res = dict(max_abs_err=float(np.abs(g - r).max()), ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        if main:
            kernels["correlator"] = dict(res)
        emit("k3_vs_plain", C=C, N=npad, n_valid=n_valid, L=L, T=len(taps),
             data_prompt=pilot, rel_err=rel, tol=2e-3, ms_runs=runs,
             ms_host_paced_runs=paced, **cluster, **res)


def fused_phase(dev, tbl, sig, dops, delays, C, kernels) -> None:
    """Phase 4: K1 and K2 against their plain version at K = 20 and 1000,
    C channels on the 8-satellite signal (channel c tracks satellite c % 8,
    started 30 Hz + 5 Hz x (c // 8) off its Doppler); the K = 20 numbers go
    into ``kernels`` unless it is None."""
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.ops.slots import LANES
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
    from gnss_sdr_tpu_torch.tracking.fused import (
        _pack_scalars,
        build_fused_engine,
    )
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    window = torch.as_tensor(sig, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for K in (20, 1000):
        plan = gps_l1ca_plan(FS, num_channels=C, steps_per_block=K)
        conf = plan.trk_conf
        trk = Tracker(conf, tbl, device=dev)
        for ch in range(C):
            s = ch % len(dops)
            trk.start_channel(ch, prn=s + 1, code_row=s,
                              acq_delay_samples=delays[s],
                              acq_doppler_hz=dops[s] + 30.0 + 5.0 * (ch // 8),
                              acq_samplestamp=0, current_abs_sample=0)
        st = trk.state.replace(pos=torch.as_tensor(
            trk.pos_abs.astype(np.int32), device=dev))
        codes = torch.as_tensor(trk.codes, device=dev)
        scal = _pack_scalars(conf, st)
        spec = build_fused_engine(conf)
        args = (window, codes, scal, st.pos, spec)
        o_1 = k1.track_blocked(*args).cpu().numpy()
        # R as launched, and as the first rule gives it before the occupancy
        # query may halve it
        cluster = dict(cluster_ctas=k1.track_blocked.cluster,
                       cluster_rule=k1.cluster_shape(C, spec.n_max, sms)[0])
        o_2 = k2.track_full(*args).cpu().numpy()
        o_p = k1.track_blocked_plain(*args).cpu().numpy()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: k1.track_blocked_plain(*args), 1,
                           queue_ahead=False)
        n_total = float(o_p[:, :, 10].sum())
        fused_bytes = (stream_bytes(o_p, window.shape[0]) + codes.numel() * 4
                       + scal.numel() * 4 + C * 4 + C * K * LANES * 4)
        b_ms, b_by = bound(fused_bytes, n_total * FUSED_OPS_PER_SAMPLE)
        out = torch.empty((C, K, LANES), dtype=torch.float32, device=dev)
        reps = 50 if K == 20 else 5
        for kname, o_k, launch in (("track_blocked", o_1, k1.launch),
                                   ("track_full", o_2, k2.launch)):
            rels = rows_rel_err(f"{kname} C={C}", o_p, o_k, K)
            ms = cuda_ms(lambda: launch(*args, out), reps,
                         name=f"{kname} C={C} K={K}")
            res = dict(max_abs_err=float(np.abs(o_p[:, :, CHECK_LANES]
                                                - o_k[:, :, CHECK_LANES]).max()),
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       msamples_per_s=n_total / (ms * 1e-3) / 1e6,
                       us_per_period=ms * 1e3 / K)
            if K == 20 and kernels is not None:
                kernels[kname] = dict(res)
            if kname == "track_full":
                extra = {f"vs_k1_{k}": v for k, v in rows_rel_err(
                    f"K2 against K1 C={C}", o_1, o_2, K).items()}
            else:
                extra = cluster
            emit("k1_vs_plain" if kname == "track_blocked" else "k2_vs_plain",
                 C=C, K=K, n_max=spec.n_max, L=1023, T=3,
                 exact_lanes=EXACT_LANES, **rels, **extra, **res)


def cli_phase(capture: np.ndarray, scen, tmp: Path) -> dict:
    """Phase 7: the .conf/CLI entry point on an ibyte copy of the capture,
    through K1 and through K2, and the CLI itself as a subprocess. The K1
    run's first acquisition goes into the result as ``first_acquired``
    ((system, PRN) -> (Doppler, delay)), for phases 35 and 37."""
    from gnss_sdr_tpu_torch import main as cli
    from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
    from gnss_sdr_tpu_torch.io import encode_samples
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    # tests/test_main_cli.py's encoding: int8 I/Q at 16 counts per unit
    t0 = time.perf_counter()
    cap = tmp / "capture_l1.dat"
    cap.write_bytes(encode_samples(np.round(capture * 16), "ibyte"))
    # conf/gps_l1_file.conf's keys, this capture, outputs into tmp
    text = (ROOT / "conf" / "gps_l1_file.conf").read_text().replace(
        "SignalSource.filename=./capture_l1.dat",
        f"SignalSource.filename={cap}")
    if str(cap) not in text:
        raise AssertionError("conf/gps_l1_file.conf has no filename key")
    text += "".join(f"PVT.{k}={tmp / v}\n" for k, v in (
        ("kml_dump_filename", "pvt.kml"), ("rinex_obs_filename", "obs.rnx"),
        ("rinex_nav_filename", "nav.rnx")))
    conf = tmp / "gps_l1_file.conf"
    conf.write_text(text)
    emit("cli_capture", seconds=time.perf_counter() - t0,
         bytes=cap.stat().st_size, conf=str(conf.name))

    blocks = [0]
    process = Tracker.process_device

    def counted(self, *a):
        r = process(self, *a)
        blocks[0] += 1
        return r

    runs, acquisitions, acquire = {}, [], Receiver.acquire

    def acquired(self, *a, **kw):
        started = acquire(self, *a, **kw)
        acquisitions.append(started)
        return started

    Tracker.process_device = counted
    Receiver.acquire = acquired
    try:
        for engine, env in (("track_blocked", None),
                            ("track_full", "perchannel")):
            blocks[0] = 0
            acquisitions.clear()
            k1.track_blocked.launches = 0
            k2.track_full.launches = 0
            out = io.StringIO()
            with fused_engine(env), contextlib.redirect_stdout(out):
                torch.cuda.synchronize()
                t = time.perf_counter()
                status = cli.run_from_config(FileConfiguration(conf))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            n1, n2 = k1.track_blocked.launches, k2.track_full.launches
            want = {"track_blocked": (blocks[0], 0),
                    "track_full": (0, blocks[0])}[engine]
            if not (blocks[0] > 0 and (n1, n2) == want):
                raise AssertionError(
                    f"CLI run ({engine}): {n1} K1 and {n2} K2 launches for "
                    f"{blocks[0]} blocks")
            e = position_gates(status, scen)
            runs[engine] = dict(
                e, GNSS_SDR_TPU_FUSED=env, blocks=blocks[0],
                k1_launches=n1, k2_launches=n2,
                status_tables=out.getvalue().count("channel status"),
                wall_s=wall, realtime_factor=scen.cfg.duration_s / wall)
            emit("cli_run", engine=engine, **runs[engine])
            if engine == "track_blocked":
                runs["first_acquired"] = dict(acquisitions[0])
    finally:
        Tracker.process_device = process
        Receiver.acquire = acquire

    # the CLI as a user runs it
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gnss_sdr_tpu_torch.main", "-c", str(conf),
         "--max_seconds", "4"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    tail = proc.stdout.strip().splitlines()[-2:]
    emit("cli_subprocess", rc=proc.returncode,
         seconds=time.perf_counter() - t, stdout_tail=tail)
    if proc.returncode != 0:
        raise AssertionError(f"CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return runs


def k4_phase(dev, tbl, sig, dops, delays, kernels) -> None:
    """Phase 8: K4 against its plain version at C = 8, K = 20 and 1000 on
    phase 4's signal: T = 3 order 2, T = 5 order 3, and T = 3 with one
    channel disabled (K4 advances it all the same); K1 timed beside it on
    the same channels, and both kernels' cluster sizes."""
    from gnss_sdr_tpu_torch.ops import track_kernel as tk
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.ops.slots import LANES
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
    from gnss_sdr_tpu_torch.tracking.fused import (
        _pack_scalars,
        build_fused_engine,
    )
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    C, L = len(dops), 1023
    window = torch.as_tensor(sig, device=dev)
    cases = (("t3_order2", [-0.25, 0.0, 0.25], 2, None),
             ("t5_order3", [-0.5, -0.25, 0.0, 0.25, 0.5], 3, None),
             ("t3_disabled", [-0.25, 0.0, 0.25], 2, 3))
    for K in (20, 1000):
        plan = gps_l1ca_plan(FS, num_channels=C, steps_per_block=K)
        conf = plan.trk_conf
        trk = Tracker(conf, tbl, device=dev)
        for ch in range(C):
            trk.start_channel(ch, prn=ch + 1, code_row=ch,
                              acq_delay_samples=delays[ch],
                              acq_doppler_hz=dops[ch] + 30.0,
                              acq_samplestamp=0, current_abs_sample=0)
        st = trk.state.replace(pos=torch.as_tensor(
            trk.pos_abs.astype(np.int32), device=dev))
        codes = torch.as_tensor(trk.codes, device=dev)
        reps = 50 if K == 20 else 5
        k1_args = (window, codes, _pack_scalars(conf, st), st.pos,
                   build_fused_engine(conf))
        k1_out = torch.empty((C, K, LANES), dtype=torch.float32, device=dev)
        k1_ms = cuda_ms(lambda: k1.launch(*k1_args, k1_out), reps,
                        name=f"K1 beside K4 K={K}")
        k1_cluster = k1.track_blocked.cluster
        for name, taps, order, disabled in cases:
            scal = tk.fused_scalars_from_state(st, conf).contiguous()
            if disabled is not None:
                scal[disabled, 7] = 0.0
            spec = tk.make_simple_spec(
                K, conf.max_step_samples, L, taps, fs=FS,
                code_rate_cps=1.023e6, carrier_freq_hz=1575.42e6,
                pll_bw_hz=conf.pll_bw_hz, dll_bw_hz=conf.dll_bw_hz,
                pll_order=order, dll_order=order)
            args = (window, codes, scal, spec)
            o_k = tk.track_simple(*args).cpu().numpy()
            o_p = tk.track_simple_plain(*args).cpu().numpy()
            lanes = simple_lanes(len(taps))
            rels = rows_rel_err(f"K4 {name}", o_p, o_k, K, lanes)
            if np.any(o_k[:, :, 20:] != 0.0):
                raise AssertionError(f"K4 {name}: lanes 20-127 not zero")
            if disabled is not None and not np.all(
                    np.diff(o_k[disabled, :, 17]) > 0):
                raise AssertionError("K4 did not advance the disabled channel")
            out = torch.empty((C, K, LANES), dtype=torch.float32, device=dev)
            ms = cuda_ms(lambda: tk.launch_simple(*args, out), reps,
                         name=f"K4 {name} K={K}")
            plain_ms = cuda_ms(lambda: tk.track_simple_plain(*args), 1,
                               queue_ahead=False)
            n_total = float(o_p[:, :, 10].sum())
            b_ms, b_by = bound(
                stream_bytes(o_p, window.shape[0]) + codes.numel() * 4
                + scal.numel() * 4 + C * K * LANES * 4,
                n_total * fused_ops_per_sample(len(taps)))
            emit("k4_vs_plain", case=name, C=C, K=K, n_max=spec.n_max, L=L,
                 T=len(taps), order=order, exact_lanes=EXACT_LANES, **rels,
                 max_abs_err=float(np.abs(o_p[:, :, lanes]
                                          - o_k[:, :, lanes]).max()),
                 ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 msamples_per_s=n_total / (ms * 1e-3) / 1e6,
                 us_per_period=ms * 1e3 / K,
                 cluster_ctas=tk.track_simple.cluster,
                 cluster_rule=k1.cluster_shape(C, spec.n_max,
                                               k1.sm_count(dev))[0],
                 k1_ms=k1_ms, k1_cluster_ctas=k1_cluster)


def kbench_phase(dev, kernels) -> dict:
    """Phase 9: the port's tools/kbench.py for ``full`` (K2) and ``simple``
    (K4), each with its launches counted (1 warm-up + 10 timed); then K1,
    K2 and K4 held against their plain versions and timed alone at the
    tool's shape (C = 32, K = 200, one launch from the seed scalars)."""
    from gnss_sdr_tpu_torch.ops import track_kernel as tk
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.ops.slots import LANES
    from gnss_sdr_tpu_torch.tools import kbench

    runs = {}
    for kind, counter in (("full", tk.track_full),
                          ("simple", tk.track_simple)):
        k1.track_blocked.launches = 0
        tk.track_full.launches = 0
        tk.track_simple.launches = 0
        r = kbench.run(kind, device=dev)
        torch.cuda.synchronize()
        counts = (k1.track_blocked.launches, tk.track_full.launches,
                  tk.track_simple.launches)
        want = 1 + kbench.ITERS
        if counter.launches != want or sum(counts) != want:
            raise AssertionError(f"kbench {kind}: launches (K1, K2, K4) = "
                                 f"{counts}, want {want} of one kernel")
        if not math.isfinite(r["checksum"]):
            raise AssertionError(f"kbench {kind}: checksum {r['checksum']}")
        runs[kind] = dict(r, launches=counter.launches)
        emit("kbench_run", **runs[kind])

    C, K = kbench.CHANNELS, kbench.STEPS
    shape = {}
    for name in ("track_blocked", "track_full", "track_simple"):
        kind = "simple" if name == "track_simple" else "full"
        conf, spec, window, codes, scal = kbench.build(kind, device=dev)
        pos = torch.zeros((C,), dtype=torch.int32, device=window.device)
        out = torch.empty((C, K, LANES), dtype=torch.float32,
                          device=window.device)
        if name == "track_simple":
            args = (window, codes, scal, spec)
            kern, plain, launch = (tk.track_simple, tk.track_simple_plain,
                                   tk.launch_simple)
            lanes = simple_lanes(spec.num_taps)
        else:
            if name == "track_blocked":
                spec = k1.make_blocked_spec(
                    K, spec.n_max, spec.code_len, spec.tap_offsets, fs=FS,
                    code_rate_cps=spec.code_rate_cps,
                    carrier_freq_hz=spec.carrier_freq_hz,
                    pll_order=spec.pll_order, dll_order=spec.dll_order,
                    interp_code=spec.interp_code)
            args = (window, codes, scal, pos, spec)
            kern, plain, launch = {
                "track_blocked": (k1.track_blocked, k1.track_blocked_plain,
                                  k1.launch),
                "track_full": (tk.track_full, tk.track_full_plain,
                               tk.launch)}[name]
            lanes = CHECK_LANES
        o_k = kern(*args).cpu().numpy()
        o_p = plain(*args).cpu().numpy()
        rels = rows_rel_err(f"{name} at the kbench shape", o_p, o_k, K, lanes)
        ms = cuda_ms(lambda: launch(*args, out), 5, name=f"{name} kbench")
        plain_ms = cuda_ms(lambda: plain(*args), 1, queue_ahead=False)
        n_total = float(o_p[:, :, 10].sum())
        b_ms, b_by = bound(
            stream_bytes(o_p, window.shape[0]) + codes.numel() * 4
            + scal.numel() * 4 + (C * 4 if name != "track_simple" else 0)
            + C * K * LANES * 4,
            n_total * fused_ops_per_sample(spec.num_taps))
        shape[name] = dict(
            max_abs_err=float(np.abs(o_p[:, :, lanes]
                                     - o_k[:, :, lanes]).max()),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            msamples_per_s=n_total / (ms * 1e-3) / 1e6,
            us_per_ch_period=ms * 1e3 / (C * K), us_per_period=ms * 1e3 / K)
        if name == "track_blocked":
            shape[name]["cluster_ctas"] = k1.track_blocked.cluster
        if name == "track_simple":
            shape[name]["cluster_ctas"] = tk.track_simple.cluster
        emit("kbench_shape", kernel=name, C=C, K=K, n_max=spec.n_max,
             exact_lanes=EXACT_LANES, **rels, **shape[name])
    kernels["track_simple"] = dict(shape["track_simple"],
                                   launches=runs["simple"]["launches"])
    return {"runs": runs, "shape": shape}


def probe_phase(dev, kernels) -> None:
    """Phase 10: every P1 variant against its plain version over K = 16
    periods at every cluster size the probe accepts (R = 1, 2, 4, 8; the
    trackers' rule gives 4 on an H100 SXM): per-channel sums at the first
    and the last period within SUMS_TOL, output and out-store buffer exact.
    Then the port's tools/mosaic_probe.py at the rule's R with its launches
    counted: ns per period over K = 2000, best of 2 x 30 launches, and each
    variant's margin over the baseline; the same at R = 1, and the baseline
    at the other R. Each variant's K = 2000 run is held against its plain
    version's too, and its bound counts the loop-carried chain."""
    from gnss_sdr_tpu_torch.ops.track_kernel_blocked import sm_count
    from gnss_sdr_tpu_torch.tools import mosaic_probe as p1

    x = p1.probe_input(dev)
    rule = p1.ranks_for(sm_count(dev))
    sm_hz = sm_clock_hz()
    checks = {}
    for ranks in sorted({rule, 1, 2, 4, 8}):
        for v in p1.VARIANTS:
            out, sums, big = p1.probe(v, x, 16, ranks=ranks)
            w_out, w_sums, w_big = p1.probe_plain(v, x, 16)
            err = p1.sums_err(sums, w_sums)
            name = f"{v} R={ranks}"
            if not (err < p1.SUMS_TOL and torch.equal(out, w_out)
                    and (big is None or torch.equal(big, w_big))):
                raise AssertionError(f"P1 {name} disagrees with its "
                                     f"plain version: sums {err}")
            checks[name] = dict(sums_err=err, max_abs_err=float(
                (sums - w_sums).abs().max()))
    emit("probe_vs_plain", K=16, tol=p1.SUMS_TOL, checks=checks)

    p1.probe.launches = 0
    ns = p1.run_all(device=dev)
    torch.cuda.synchronize()
    launches, cluster = p1.probe.launches, p1.probe.cluster
    want = len(p1.VARIANTS) * (1 + 2 * p1.ITERS)
    if launches != want or cluster != rule:
        raise AssertionError(f"P1: {launches} launches at R = {cluster}, "
                             f"want {want} at R = {rule}")
    ns1 = p1.run_all(device=dev, ranks=1)
    baseline_ns = {rule: ns["baseline"], 1: ns1["baseline"]}
    for r in (2, 4, 8):
        if r not in baseline_ns:
            baseline_ns[r] = p1.timed(f"{p1.LABELS['baseline']}, R={r}",
                                      "baseline", ranks=r, device=dev)

    rows = []
    for v in p1.VARIANTS:
        out, sums, _ = p1.probe(v, x, p1.K)
        ref = {}

        def plain():
            ref["w"] = p1.probe_plain(v, x, p1.K)

        plain_ms = cuda_ms(plain, 1, warm=False, queue_ahead=False)
        err = p1.sums_err(sums, ref["w"][1])
        if not (err < p1.SUMS_TOL and torch.equal(out, ref["w"][0])):
            raise AssertionError(f"P1 {v} over K = {p1.K} disagrees with "
                                 f"its plain version: sums {err}")
        if v == "narrow":
            elems, nbytes = p1.C, p1.C * 4
        elif v == "out store":
            elems = p1.C * p1.LANES
            nbytes = elems * 4 + p1.C * p1.OUT_ROWS * p1.LANES * 4
        elif v == "staging":
            elems, nbytes = p1.BR * p1.LANES, (p1.ROWS_P + 1) * p1.LANES * 4
        else:
            elems, nbytes = p1.BR * p1.LANES, p1.BR * p1.LANES * 4
        chain_ms = p1.K * P1_CHAIN_OPS[v] * CYCLES_PER_OP / sm_hz * 1e3
        b_ms, b_by = bound(nbytes + 8 * p1.LANES * 4 + p1.C * 2 * 4,
                           elems * P1_OPS_PER_ELEMENT[v] * p1.K, chain_ms)
        rows.append(dict(variant=v, ns_per_period=ns[v],
                         marginal_ns=ns[v] - ns["baseline"],
                         ns_per_period_r1=ns1[v],
                         marginal_ns_r1=ns1[v] - ns1["baseline"],
                         ms=ns[v] * p1.K * 1e-6, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         chain_ops=P1_CHAIN_OPS[v],
                         sums_err_k=err, max_abs_err_k=float(
                             (sums - ref["w"][1]).abs().max()),
                         **checks[f"{v} R={rule}"]))
    emit("probe", K=p1.K, iters=p1.ITERS, reps=2, ranks=rule,
         launches=launches, sm_clock_hz=sm_hz,
         baseline_ns_by_ranks={str(r): baseline_ns[r]
                               for r in sorted(baseline_ns)},
         variants=rows)
    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
    kernels["probe"] = dict(
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows),
        bound_by=max(by, key=by.get),
        variants=[{k: r[k] for k in ("variant", "ns_per_period",
                                     "marginal_ns", "ns_per_period_r1",
                                     "marginal_ns_r1", "ms", "plain_ms",
                                     "bound_ms", "bound_by")}
                  for r in rows])


# ---- Galileo E1 -----------------------------------------------------------

E1_FS = 4.0e6
E1_RATE = 2.046e6               # sinBOC table units per second
E1_LEN = 8184                   # sinBOC table units a code period
GAL_F = 1575.42e6
# the scenarios of tests/test_galileo.py (E1-B, data only), of
# tests/test_galileo_pilot.py (E1-B+C with the pilot) and of bench.py's gal8
GAL_SCENARIOS = {
    "e1b": dict(fs=2.6e6, tow_start_s=7310.0, duration_s=20.0, cn0_dbhz=46.0,
                rx_clock_bias_s=1.7e-4, max_sats=6, min_elevation_deg=15.0,
                seed=3),
    "e1bc": dict(fs=4.0e6, tow_start_s=7310.0, duration_s=20.0,
                 cn0_dbhz=48.0, rx_clock_bias_s=1.1e-4, max_sats=6,
                 min_elevation_deg=15.0, seed=3, emit_pilot=True),
    "gal8": dict(fs=4.0e6, tow_start_s=7310.0, duration_s=6.0, cn0_dbhz=46.0,
                 max_sats=8, seed=3),
}
# the second band of tests/test_dual_band.py (GPS L1 + L5, seed 4; Galileo
# E5a alone with injected ephemerides, seed 4) and of bench.py's dual16
# (GPS L1 with 8 satellites asked, Galileo E5a with 8), each beside the
# primary scenario whose geometry it shares
L5_FS = 10.4e6
DUAL_L1 = dict(fs=FS, tow_start_s=7314.0, duration_s=32.0, cn0_dbhz=46.0,
               rx_clock_bias_s=1.3e-4, max_sats=5, min_elevation_deg=15.0,
               seed=4)
E5A_GAL = dict(fs=FS, tow_start_s=7312.0, duration_s=20.0, cn0_dbhz=47.0,
               rx_clock_bias_s=0.9e-4, max_sats=5, min_elevation_deg=15.0,
               seed=4)
DUAL16_L1 = dict(fs=FS, tow_start_s=7314.0, duration_s=6.0, cn0_dbhz=46.0,
                 max_sats=8, seed=4)
DUAL16_GAL = dict(fs=FS, tow_start_s=7310.0, duration_s=6.0, cn0_dbhz=46.0,
                  max_sats=8, seed=4)
# tests/test_beidou.py's gps_bds_receiver: GPS L1 C/A and BeiDou B1I at
# 2.6 Msps, 35 s, seed 1, 4 satellites each (BDT = GPST - 14 s phases the
# D1 frame so the last ephemeris subframe completes at 32 s)
GPS_BDS = dict(fs=FS, tow_start_s=7314.0, duration_s=35.0, cn0_dbhz=46.0,
               rx_clock_bias_s=1.2e-4, min_elevation_deg=15.0, max_sats=4,
               seed=1)
# bench.py's mc64: GPS and Galileo on a shared L1 at 4 Msps, GLONASS G1 at
# 3.6 Msps, BeiDou B1 at 2.6 Msps, 16 satellites asked of each, 6 s, seed 5
MC64_FS = {"L1": 4.0e6, "G1": 3.6e6, "B1": 2.6e6}
MC64_GPS = dict(fs=4.0e6, tow_start_s=7314.0, duration_s=6.0, cn0_dbhz=46.0,
                max_sats=16, seed=5)
MC64_GLO = dict(fs=3.6e6, tow_start_s=7335.0, duration_s=6.0, cn0_dbhz=46.0,
                max_sats=16, seed=5)
MC64_BDS = dict(fs=2.6e6, duration_s=6.0, cn0_dbhz=46.0, max_sats=16, seed=5)
# gps8: tests/test_position.py's scenario with bench.py's 8 satellites
# asked (phases 6, 7, 32, 34, 35, 37, 41), made in 1 s chunks as the test
# feeds it
GPS8 = dict(fs=FS, tow_start_s=7314.0, duration_s=32.0, cn0_dbhz=46.0,
            rx_clock_bias_s=2.1e-4, max_sats=8, min_elevation_deg=15.0,
            seed=1)
# tests/test_dynamic.py's moving receiver: GPS L1 C/A at 2.6 Msps, 32 s,
# 12 m/s east and -8 m/s north, 6 satellites, seed 1
DYN = dict(fs=FS, tow_start_s=7314.0, duration_s=32.0, cn0_dbhz=46.0,
           rx_clock_bias_s=1.5e-4, rx_vel_enu_mps=(12.0, -8.0, 0.0),
           max_sats=6, min_elevation_deg=15.0, seed=1)
# capture -> (primary scenario's kind, second band, a second scenario on
# the primary's band, or None)
CAPTURES = {
    "dual_l5": ("dual_l1", "l5"), "e5a": ("e5a_gal", "e5a"),
    "dual16_e5a": ("dual16_gal", "e5a"), "dual_l1": ("dual_l1", None),
    "dual16_l1": ("dual16_l1", None), "e1b": ("e1b", None),
    "e1bc": ("e1bc", None), "gal8": ("gal8", None), "glo": ("glo", None),
    "bds_l1": ("bds_l1", None), "bds_b1": ("bds_b1", None),
    "geo": ("geo", None), "mc64_l1": ("mc64_gps", "mc64_gal"),
    "mc64_g1": ("mc64_glo", None), "mc64_b1": ("mc64_bds", None),
    "dyn": ("dyn", None), "gps8": ("gps8", None),
}
_SCEN_CACHE: dict = {}


def gal_scenario(kind: str):
    """The primary scenario ``kind`` (one per process): a Galileo
    scenario of GAL_SCENARIOS, a GPS or Galileo scenario of the dual-band
    runs, the GLONASS scenario ("glo"), the GPS and BeiDou scenarios of
    gps_bds ("bds_l1", "bds_b1"), the B1I GEO signal ("geo"), a scenario
    of mc64 ("mc64_gps", "mc64_gal", "mc64_glo", "mc64_bds") or the moving
    receiver of tests/test_dynamic.py ("dyn") or gps8's ("gps8")."""
    from gnss_sdr_tpu_torch.simulate.beidou import (
        BeidouScenario,
        BeidouScenarioConfig,
    )
    from gnss_sdr_tpu_torch.simulate.galileo import (
        GalileoScenario,
        GalileoScenarioConfig,
    )
    from gnss_sdr_tpu_torch.simulate.glonass import (
        GlonassScenario,
        GlonassScenarioConfig,
    )
    from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig

    if kind not in _SCEN_CACHE:
        gps = {"dual_l1": DUAL_L1, "dual16_l1": DUAL16_L1, "bds_l1": GPS_BDS,
               "mc64_gps": MC64_GPS, "dyn": DYN, "gps8": GPS8}
        gal = dict(GAL_SCENARIOS, e5a_gal=E5A_GAL, dual16_gal=DUAL16_GAL,
                   mc64_gal=MC64_GPS)
        glo = {"glo": GLO_SCEN, "mc64_glo": MC64_GLO}
        bds = {"bds_b1": GPS_BDS, "mc64_bds": MC64_BDS}
        if kind == "geo":
            scen = GeoSignal()
        elif kind in glo:
            scen = GlonassScenario(GlonassScenarioConfig(**glo[kind]))
        elif kind in bds:
            scen = BeidouScenario(BeidouScenarioConfig(**bds[kind]))
        elif kind in gps:
            scen = GpsScenario(ScenarioConfig(**gps[kind]))
        else:
            scen = GalileoScenario(GalileoScenarioConfig(**gal[kind]))
        _SCEN_CACHE[kind] = scen
    return _SCEN_CACHE[kind]


class SharedBand:
    """Two scenarios on one band, summed as bench.py's mc64 sums GPS and
    Galileo on L1 (each with its own noise)."""

    def __init__(self, primary, other) -> None:
        self.primary, self.other = primary, other
        self.fs = primary.cfg.fs

    def generate(self, start: int, n: int) -> np.ndarray:
        return self.primary.generate(start, n) + self.other.generate(start, n)


def capture_source(kind: str):
    """What generates capture ``kind``: its primary scenario, the second
    band (GpsL5Band, GalileoE5aBand at 10.4 Msps, 47 dB-Hz, as the tests and
    bench.py make it) that shares the scenario's geometry, or the primary
    and a second scenario summed on its band (SharedBand)."""
    from gnss_sdr_tpu_torch.simulate.multiband import GalileoE5aBand, GpsL5Band

    primary, band = CAPTURES[kind]
    if band is None:
        return gal_scenario(primary)
    key = ("band", kind)
    if key not in _SCEN_CACHE:
        if band in ("l5", "e5a"):
            make = GpsL5Band if band == "l5" else GalileoE5aBand
            _SCEN_CACHE[key] = make(gal_scenario(primary), fs=L5_FS,
                                    cn0_dbhz=47.0)
        else:
            _SCEN_CACHE[key] = SharedBand(gal_scenario(primary),
                                          gal_scenario(band))
    return _SCEN_CACHE[key]


def capture_chunks(kind: str) -> list[tuple[str, int, int]]:
    """Capture ``kind`` as the tests make it: 1 s chunks (start, length) of
    its source (the noise is seeded by the chunk's start)."""
    src = capture_source(kind)
    fs = int(getattr(src, "fs", None) or src.cfg.fs)
    scen = src.primary if hasattr(src, "primary") else src
    total = int(scen.cfg.duration_s * fs)
    return [(kind, s, min(fs, total - s)) for s in range(0, total, fs)]


def capture_chunk(task: tuple[str, int, int]) -> np.ndarray:
    """One chunk of a capture (a worker process's task)."""
    kind, start, n = task
    return capture_source(kind).generate(start, n)


def make_captures(kinds, check: tuple[str, int]) -> dict:
    """Every capture of ``kinds``, made in 1 s chunks by a pool of worker
    processes (one fewer than the host's cores; they import no CUDA). Chunk
    ``check`` = (kind, index) is also made here, one process, beside the
    pool, and must equal the worker's."""
    import multiprocessing

    tasks = [t for k in kinds for t in capture_chunks(k)]
    # the second band's chunks (10.4 Msps) first: they take the longest
    tasks.sort(key=lambda t: CAPTURES[t[0]][1] is None)
    workers = max(1, min(len(tasks), (os.cpu_count() or 2) - 1))
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pending = pool.map_async(capture_chunk, tasks, chunksize=1)
        kind, idx = check
        t1 = time.perf_counter()
        serial = capture_chunk(capture_chunks(kind)[idx])
        serial_s = time.perf_counter() - t1
        chunks = pending.get(timeout=900)
    got = dict(zip(tasks, chunks))
    same = bool(np.array_equal(got[capture_chunks(kind)[idx]], serial))
    caps = {k: np.concatenate([got[t] for t in capture_chunks(k)])
            for k in kinds}
    emit("captures", workers=workers, chunks=len(tasks),
         seconds=time.perf_counter() - t0, check_chunk=list(check),
         check_chunk_seconds=serial_s, worker_chunk_equals_serial=same,
         samples={k: len(v) for k, v in caps.items()})
    if not same:
        raise AssertionError(f"capture chunk {check}: the worker's differs "
                             "from the one made in this process")
    return caps


@contextlib.contextmanager
def record_blocks(every: int = 64):
    """Keep a copy of the inputs of the kernel calls the tracking engines
    make (tracking/fused.py's ``track_blocked`` and ``track_full``,
    tracking/dll_pll.py's ``correlator``): of calls 0, 1, 2, 4, 8, ... and
    of every ``every``-th, the latest per kernel, as ``{kernel: (args,
    kwargs, call index)}``, and the latest per kernel and code length (a
    dual-band run's bands), as ``{(kernel, length): ...}``, where the
    first call of each length is kept too. A kernel can
    then be held to its plain version on a block of the run itself."""
    from gnss_sdr_tpu_torch.tracking import dll_pll, fused

    kept, saved = {}, []

    def wrap(mod, attr):
        fn = getattr(mod, attr)
        calls = [0]

        def recorded(*args, **kw):
            i = calls[0]
            calls[0] += 1
            length = kw["code_len"] if "code_len" in kw else (
                args[4].code_len)
            keep = i & (i - 1) == 0 or i % every == 0
            if keep or (attr, length) not in kept:
                snap = (tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args), dict(kw), i)
                if keep:
                    kept[attr] = snap
                kept[(attr, length)] = snap
            return fn(*args, **kw)

        saved.append((mod, attr, fn))
        setattr(mod, attr, recorded)

    wrap(fused, "track_blocked")
    wrap(fused, "track_full")
    wrap(dll_pll, "correlator")
    try:
        yield kept
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def hold_fused_block(run: str, kname: str, rec, kernels=None,
                     entry: str | None = None, reps: int = 20,
                     first_tol: float = 2e-4) -> dict:
    """K1 (``kname`` "track_blocked") or K2 ("track_full") against its
    plain version (K1's) on a recorded block ``rec`` of the run ``run``:
    the long-code bounds (``first_tol``, 2e-4 relative, over the first two
    periods, 2e-3 over the block, tests/test_track_kernel_blocked.py) on
    check_lanes(T),
    lanes 10 and 17 exact; timed, with its bound from the block's own
    rows. Goes into ``kernels[entry]`` where given."""
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.ops.slots import LANES, S_EN

    args, _, call = rec
    window, codes, scal, pos, spec = args[:5]
    tabs = args[5:] if spec.track_pilot else ()
    C, K, T = scal.shape[0], spec.n_periods, spec.num_taps
    wrapper, launch = {"track_blocked": (k1.track_blocked, k1.launch),
                       "track_full": (k2.track_full, k2.launch)}[kname]
    o_k = wrapper(window, codes, scal, pos, spec, *tabs).cpu().numpy()
    cluster = k1.track_blocked.cluster if kname == "track_blocked" else 1
    ref = {}

    def plain():
        ref["o"] = k1.track_blocked_plain(window, codes, scal, pos, spec,
                                          *tabs)

    plain_ms = cuda_ms(plain, 1, queue_ahead=False)
    o_p = ref["o"].cpu().numpy()
    lanes = check_lanes(T)
    rels = rows_rel_err(f"{kname} on a block of {run}", o_p, o_k, K,
                        lanes=lanes, first_tol=first_tol)
    out = torch.empty((C, K, LANES), dtype=torch.float32,
                      device=window.device)
    ms = cuda_ms(lambda: launch(window, codes, scal, pos, spec, out, *tabs),
                 reps, name=f"{kname} {run}")
    n_total = float(o_p[:, :, 10].sum())
    nbytes = (stream_bytes(o_p, window.shape[0])
              + codes.numel() * 4 * (2 if spec.track_pilot else 1)
              + sum(t.numel() * 4 for t in tabs[1:])
              + scal.numel() * 4 + C * 4 + C * K * LANES * 4)
    b_ms, b_by = bound(nbytes, n_total * (
        fused_ops_per_sample(T) + (16 if spec.track_pilot else 0)
        + (FDMA_OPS_PER_SAMPLE if spec.fdma else 0)))
    res = dict(max_abs_err=float(np.abs(o_p[:, :, lanes]
                                        - o_k[:, :, lanes]).max()),
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    if entry is not None:
        kernels[entry] = dict(res)
    emit("block_vs_plain", run=run, kernel=kname, call=call, C=C, K=K,
         n_max=spec.n_max, L=spec.code_len, T=T, pilot=spec.track_pilot,
         sec_len_pilot=spec.sec_len_pilot, sec_len_data=spec.sec_len_data,
         enabled=int((scal[:, S_EN] > 0.5).sum()), cluster_ctas=cluster,
         exact_lanes=EXACT_LANES, **rels, **res,
         us_per_period=ms * 1e3 / K)
    return res


def hold_correlator_block(run: str, rec, kernels=None,
                          entry: str | None = None) -> dict:
    """K3 against its plain version on a recorded period ``rec`` of the
    eager engine in run ``run``: taps within 2e-3 relative (to
    max(|tap|, 1)), the lanes past them zero, as phase 3 holds it; timed,
    with its bound from the period's own sample counts. Goes into
    ``kernels[entry]`` where given."""
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops.slots import LANES

    (x, cq, dq, sc, taps), kw, call = rec
    got = k3.correlator(x, cq, dq, sc, taps, **kw)
    ref = k3.correlator_plain(x, cq, dq, sc, taps, **kw)
    nt = len(taps) + (1 if kw["track_pilot"] else 0)
    g, r = got.cpu().numpy()[:, 0], ref.cpu().numpy()[:, 0]
    gc = g[:, 0:2 * nt:2] + 1j * g[:, 1:2 * nt:2]
    rc = r[:, 0:2 * nt:2] + 1j * r[:, 1:2 * nt:2]
    rel = float((np.abs(gc - rc) / np.maximum(np.abs(rc), 1.0)).max())
    if not rel < 2e-3 or np.any(g[:, 2 * nt:] != 0):
        raise AssertionError(f"K3 on a period of {run} disagrees with its "
                             f"plain version: {rel}")
    out = torch.empty_like(got)
    ms = float(np.median([cuda_ms(
        lambda: k3.launch(x, cq, dq, sc, taps, out, **kw), 200,
        name=f"correlator {run}") for _ in range(5)]))
    plain_ms = cuda_ms(lambda: k3.correlator_plain(x, cq, dq, sc, taps, **kw),
                       20, queue_ahead=False)
    C, n_valid = x.shape[0], float(sc[:, 4].sum())
    nbytes = (n_valid * 8 + C * kw["code_len"] * 4 * (2 if kw["track_pilot"]
                                                       else 1)
              + sc.numel() * 4 + C * LANES * 4)
    b_ms, b_by = bound(nbytes, n_valid * k3_ops_per_sample(
        len(taps), kw["track_pilot"]))
    res = dict(max_abs_err=float(np.abs(g - r).max()), ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    if entry is not None:
        kernels[entry] = dict(res)
    emit("block_vs_plain", run=run, kernel="correlator", call=call, C=C,
         N=x.shape[1], n_valid=n_valid, L=kw["code_len"], T=len(taps),
         data_prompt=kw["track_pilot"], rel_err=rel, tol=2e-3,
         cluster_ctas=k3.correlator.cluster, **res)
    return res


def e1_signal(data_tbl, pilot_tbl, cs25, n, dops, delays, seed):
    """Galileo E1-B+C channels on sinBOC tables at E1_FS: (data - pilot) /
    sqrt(2), the data code with a random symbol each period and the pilot
    code times CS25 (chip 0 on the period that starts at the channel's
    delay, in samples), at the given Dopplers, with noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / E1_FS
    sig = np.zeros(n, np.complex64)
    for c, (dop, dly) in enumerate(zip(dops, delays)):
        u = np.floor((E1_RATE * (1 + dop / GAL_F)) * (tt - dly / E1_FS)
                     ).astype(np.int64)
        per = np.floor_divide(u, E1_LEN)
        idx = u - per * E1_LEN
        sym = np.where(rng.random(int(per.max() - per.min()) + 1) < 0.5,
                       1.0, -1.0)[per - per.min()]
        comp = (data_tbl[c][idx] * sym - pilot_tbl[c][idx] * cs25[per % 25])
        sig += (0.35 * comp * np.exp(2j * np.pi * dop * tt + 0.3j * c)
                ).astype(np.complex64)
    noise = rng.normal(size=(n, 2)).astype(np.float32) * 0.05
    return (sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


E1_CASES = (
    # name, pilot, sec_len_pilot, sec_len_data
    ("e1b", False, 1, 1),          # T = 5 without the pilot (E1-B)
    ("e1bc", True, 25, 1),         # the pilot plan's secondaries
    ("e1bc_sd4", True, 25, 4),     # tests/test_track_kernel_blocked.py's
)


def e1_kernel_phase(dev) -> None:
    """Phase 11: K1 and K2 against their plain version at the Galileo E1
    shape: 4 Msps, 8184-unit sinBOC tables, C = 8, K = 20 and 200, T = 5,
    for E1_CASES on an E1-B+C signal (channel c tracks satellite c,
    started 10 Hz off without the pilot; with it, 3 Hz off with the
    secondary engaged at its true phase, atan2, 5-period integration).
    Long-code tolerances: 2e-4 over the first two periods, 2e-3 over K,
    on check_lanes(5). (The kernels line takes K1's and K2's numbers from
    blocks of the Galileo runs themselves, phases 12-15.)"""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import e1c_secondary_chips
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.ops.slots import LANES
    from gnss_sdr_tpu_torch.receiver.plans import (
        galileo_e1b_plan,
        galileo_e1bc_plan,
    )
    from gnss_sdr_tpu_torch.tracking.fused import (
        _pack_scalars,
        build_fused_engine,
    )
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    C = 8
    bc = galileo_e1bc_plan(E1_FS, num_channels=C)
    cs25 = e1c_secondary_chips().astype(np.float32)
    dops = [1200.0, -2500.0, 3400.0, -400.0, 150.0, -3900.0, 2600.0, -1700.0]
    delays = [37.0 + 1999.0 * c for c in range(C)]
    t0 = time.perf_counter()
    sig = e1_signal(bc.data_code_table, bc.code_table, cs25,
                    int(E1_FS * 0.86), dops, delays, seed=2)
    emit("e1_signal", seconds=time.perf_counter() - t0, samples=len(sig))
    window = torch.as_tensor(sig, device=dev)
    rng = np.random.default_rng(4)
    sec_d4 = np.where(rng.random(4) < 0.5, 1.0, -1.0).astype(np.float32)
    for K in (20, 200):
        for case, pilot, sp, sd in E1_CASES:
            if pilot:
                conf = dataclasses.replace(
                    bc.trk_conf, steps_per_block=K, sec_len_pilot=sp,
                    sec_len_data=sd)
                trk = Tracker(conf, bc.code_table, bc.data_code_table,
                              bc.sec_pilot_table,
                              sec_d4 if sd == 4 else bc.sec_data_levels,
                              device=dev)
            else:
                plan = galileo_e1b_plan(E1_FS, num_channels=C,
                                        steps_per_block=K)
                conf = plan.trk_conf
                trk = Tracker(conf, plan.code_table, device=dev)
            for ch in range(C):
                trk.start_channel(ch, prn=ch + 1, code_row=ch,
                                  acq_delay_samples=delays[ch],
                                  acq_doppler_hz=dops[ch]
                                  + (3.0 if pilot else 10.0),
                                  acq_samplestamp=0, current_abs_sample=0)
            st = trk.state.replace(pos=torch.as_tensor(
                trk.pos_abs.astype(np.int32), device=dev))
            if pilot:
                on = torch.ones(C, dtype=torch.bool, device=dev)
                st = st.replace(
                    sec_active=on, use_atan2=on, narrow=on,
                    fll_active=~on,
                    integ_len=torch.full((C,), 5, dtype=torch.int32,
                                         device=dev))
            spec = build_fused_engine(conf)
            scal = _pack_scalars(conf, st)
            codes = torch.as_tensor(trk.codes, device=dev)
            tabs = ((torch.as_tensor(trk.data_codes, device=dev),
                     torch.as_tensor(trk.sec_pilot, device=dev),
                     torch.as_tensor(trk.sec_data, device=dev))
                    if pilot else ())
            args = (window, codes, scal, st.pos, spec)
            o_1 = k1.track_blocked(*args, *tabs).cpu().numpy()
            cluster = k1.track_blocked.cluster
            o_2 = k2.track_full(*args, *tabs).cpu().numpy()
            ref = {}

            def plain():
                ref["o"] = k1.track_blocked_plain(*args, *tabs)

            plain_ms = cuda_ms(plain, 1, warm=K == 20, queue_ahead=False)
            o_p = ref["o"].cpu().numpy()
            n_total = float(o_p[:, :, 10].sum())
            nbytes = (stream_bytes(o_p, window.shape[0])
                      + codes.numel() * 4 * (2 if pilot else 1)
                      + sum(t.numel() * 4 for t in tabs[1:])
                      + scal.numel() * 4 + C * 4 + C * K * LANES * 4)
            ops = n_total * (fused_ops_per_sample(5) + (16 if pilot else 0))
            b_ms, b_by = bound(nbytes, ops)
            out = torch.empty((C, K, LANES), dtype=torch.float32, device=dev)
            for kname, o_k, launch, entry, extent in (
                    ("track_blocked", o_1, k1.launch,
                     "gnss_track_blocked_smem",
                     k1.cluster_shape(C, spec.n_max, k1.sm_count(dev))[1]),
                    ("track_full", o_2, k2.launch, "gnss_track_full_smem",
                     spec.n_max)):
                rels = rows_rel_err(f"{kname} {case} C={C}", o_p, o_k, K,
                                    lanes=check_lanes(5), first_tol=2e-4)
                ms = cuda_ms(lambda: launch(*args, out, *tabs),
                             20 if K == 20 else 3,
                             name=f"{kname} {case} K={K}")
                need, limit = k1.smem_need(
                    entry, dev, spec.code_len, int(spec.interp_code), 5,
                    int(pilot), 0, extent)
                res = dict(max_abs_err=float(np.abs(
                    o_p[:, :, check_lanes(5)]
                    - o_k[:, :, check_lanes(5)]).max()),
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    msamples_per_s=n_total / (ms * 1e-3) / 1e6,
                    us_per_period=ms * 1e3 / K)
                emit("e1_fused_vs_plain", kernel=kname, case=case, C=C, K=K,
                     n_max=spec.n_max, L=spec.code_len, T=5, pilot=pilot,
                     sec_len_pilot=spec.sec_len_pilot,
                     sec_len_data=spec.sec_len_data, sec_lcm=spec.sec_lcm,
                     exact_lanes=EXACT_LANES, smem_bytes=need,
                     smem_limit=limit,
                     cluster_ctas=cluster if kname == "track_blocked"
                     else 1, **rels, **res)


def galileo_gates(status, rx, scen) -> dict:
    """tests/test_galileo.py's gates on a Galileo E1-B run; raises if one
    fails: >= 4 acquired with Doppler within 125 Hz, >= 4 ephemerides with
    sqrt_a and toe exact and the orbit within 5 m at the scenario's start,
    >= 5 fixes, mean 2D < 2 m and 3D < 5 m over fixes[3:], |clock bias| <
    0.04 s and its spread < 1e-7 s."""
    from gnss_sdr_tpu_torch.pvt.coords import ecef_to_enu
    from gnss_sdr_tpu_torch.pvt.ephemeris import eph_to_pos_vel_clock

    fails = []
    dop_err = {}
    for (sysid, prn), (dop, _) in status.acquired.items():
        dop_err[prn] = abs(dop - scen.truth_at(prn, 0.0)["doppler_hz"])
        if sysid != "E" or dop_err[prn] > 125.0:
            fails.append(f"acquisition {sysid}{prn}")
    orbit = {}
    for (_, prn), eph in rx.ephemerides.items():
        true = scen.ephs[prn]
        t = scen.cfg.tow_start_s
        orbit[prn] = float(np.linalg.norm(
            eph_to_pos_vel_clock(eph, t)[0] - eph_to_pos_vel_clock(true, t)[0]))
        if not (abs(eph.sqrt_a - true.sqrt_a) <= 2.0 ** -19 + 1e-12
                and abs(eph.toe - true.toe) < 1e-9 and orbit[prn] < 5.0):
            fails.append(f"ephemeris E{prn}")
    fixes = status.fixes
    lat, lon = np.deg2rad(scen.cfg.rx_lat_deg), np.deg2rad(scen.cfg.rx_lon_deg)
    enu = np.array([ecef_to_enu(f.pos_ecef - scen.rx_ecef, lat, lon)
                    for f in fixes[3:]]).reshape(-1, 3)
    biases = [f.clock_bias_s for f in fixes[3:]]
    e = dict(acquired=len(status.acquired),
             doppler_err_hz=max(dop_err.values(), default=math.inf),
             ephemerides=len(rx.ephemerides),
             orbit_err_m=max(orbit.values(), default=math.inf),
             subframes=status.subframes, fixes=len(fixes),
             mean_2d_m=float(np.hypot(enu[:, 0], enu[:, 1]).mean())
             if len(enu) else math.inf,
             mean_3d_m=float(np.linalg.norm(enu, axis=1).mean())
             if len(enu) else math.inf,
             clock_bias_s=fixes[-1].clock_bias_s if fixes else math.inf,
             clock_bias_std_s=float(np.std(biases)) if biases else math.inf,
             ttff_s=status.ttff_s)
    if not (e["acquired"] >= 4 and e["ephemerides"] >= 4 and e["fixes"] >= 5
            and e["mean_2d_m"] < 2.0 and e["mean_3d_m"] < 5.0
            and abs(e["clock_bias_s"]) < 0.04
            and e["clock_bias_std_s"] < 1e-7) or fails:
        raise AssertionError(f"Galileo gates failed: {e} {fails}")
    return e


def drive_receiver(rx, x: np.ndarray, fs: float):
    """tests/test_galileo.py's drive: 1 s feeds, acquisition until 4
    satellites start, a run after each feed. Returns the wall seconds and
    the blocks the first group's tracker ran."""
    tracker = rx.groups[0].tracker
    process = tracker.process_device
    blocks = [0]

    def counted(*a):
        r = process(*a)
        blocks[0] += 1
        return r

    tracker.process_device = counted
    torch.cuda.synchronize()
    t = time.perf_counter()
    chunk, fed, acquired = int(fs), 0, False
    while fed < len(x):
        n = min(chunk, len(x) - fed)
        rx.feed(x[fed:fed + n])
        fed += n
        if not acquired:
            acquired = len(rx.acquire()) >= 4
        rx.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t, blocks[0]


def galileo_python_phase(capture, scen, kernels) -> dict:
    """Phase 12: tests/test_galileo.py's receiver (galileo_e1b_plan at
    2.6 Msps, 6 channels, 20 s, seed 3) on K1, with its gates; then K1
    against its plain version on a block of the run (``track_blocked_e1b``
    in ``kernels``)."""
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import galileo_e1b_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    fs = scen.cfg.fs
    plan = galileo_e1b_plan(fs=fs, num_channels=6)
    rx = Receiver(ReceiverConfig(fs=fs, num_channels=6), plans=[plan])
    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    with record_blocks() as rec:
        wall, blocks = drive_receiver(rx, capture, fs)
    n1, n3 = k1.track_blocked.launches, k3.correlator.launches
    if not (blocks > 0 and n1 == blocks and n3 == 0):
        raise AssertionError(f"E1-B: {n1} K1 and {n3} K3 launches for "
                             f"{blocks} blocks")
    e = dict(galileo_gates(rx.status, rx, scen), blocks=blocks,
             k1_launches=n1, ephemeris_keys=sorted(rx.ephemerides),
             wall_s=wall, realtime_factor=scen.cfg.duration_s / wall)
    emit("e2e_galileo_e1b_20s", **e)
    hold_fused_block("e2e_galileo_e1b_20s", "track_blocked",
                     rec["track_blocked"], kernels, "track_blocked_e1b")
    return e


def galileo_cli_phase(capture, scen, tmp: Path, kernels) -> dict:
    """Phase 13: the .conf/CLI entry point with conf/galileo_e1_file.conf's
    keys (the filename, sampling rate and channel count rewritten to phase
    12's capture, written as ishort), through K1 and through K2, each held
    to phase 12's gates; then each kernel against its plain version on a
    block of its run (K2's as ``track_full_e1b`` in ``kernels``)."""
    from gnss_sdr_tpu_torch import main as cli
    from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
    from gnss_sdr_tpu_torch.io import encode_samples
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    t0 = time.perf_counter()
    fs = int(scen.cfg.fs)
    cap = tmp / "capture_e1.dat"
    cap.write_bytes(encode_samples(np.round(capture * 256), "ishort"))
    text = (ROOT / "conf" / "galileo_e1_file.conf").read_text()
    for old, new in (("SignalSource.filename=./capture_e1.dat",
                      f"SignalSource.filename={cap}"),
                     ("GNSS-SDR.internal_fs_sps=4000000",
                      f"GNSS-SDR.internal_fs_sps={fs}"),
                     ("SignalSource.sampling_frequency=4000000",
                      f"SignalSource.sampling_frequency={fs}"),
                     ("Channels_1B.count=8", "Channels_1B.count=6")):
        if old not in text:
            raise AssertionError(f"conf/galileo_e1_file.conf has no {old!r}")
        text = text.replace(old, new)
    text += "".join(f"PVT.{k}={tmp / v}\n" for k, v in (
        ("kml_dump_filename", "e1.kml"), ("rinex_obs_filename", "e1.obs"),
        ("rinex_nav_filename", "e1.nav")))
    conf = tmp / "galileo_e1_file.conf"
    conf.write_text(text)
    emit("galileo_cli_capture", seconds=time.perf_counter() - t0,
         bytes=cap.stat().st_size, item_type="ishort", fs=fs)

    blocks, made = [0], []
    process, init = Tracker.process_device, Receiver.__init__

    def counted(self, *a):
        r = process(self, *a)
        blocks[0] += 1
        return r

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    runs = {}
    Tracker.process_device = counted
    Receiver.__init__ = recorded
    try:
        for engine, env in (("track_blocked", None),
                            ("track_full", "perchannel")):
            blocks[0] = 0
            k1.track_blocked.launches = 0
            k2.track_full.launches = 0
            with (fused_engine(env), record_blocks() as rec,
                  contextlib.redirect_stdout(io.StringIO())):
                torch.cuda.synchronize()
                t = time.perf_counter()
                status = cli.run_from_config(FileConfiguration(conf))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            n1, n2 = k1.track_blocked.launches, k2.track_full.launches
            want = {"track_blocked": (blocks[0], 0),
                    "track_full": (0, blocks[0])}[engine]
            if not (blocks[0] > 0 and (n1, n2) == want):
                raise AssertionError(
                    f"Galileo CLI run ({engine}): {n1} K1 and {n2} K2 "
                    f"launches for {blocks[0]} blocks")
            runs[engine] = dict(
                galileo_gates(status, made[-1], scen),
                GNSS_SDR_TPU_FUSED=env,
                blocks=blocks[0], k1_launches=n1, k2_launches=n2,
                wall_s=wall, realtime_factor=scen.cfg.duration_s / wall)
            emit("galileo_cli_run", engine=engine, **runs[engine])
            hold_fused_block(f"galileo_cli_run {engine}", engine,
                             rec[engine], kernels,
                             "track_full_e1b" if env else None)
    finally:
        Tracker.process_device = process
        Receiver.__init__ = init
    return runs


def galileo_pilot_phase(capture, scen, kernels) -> dict:
    """Phase 14: tests/test_galileo_pilot.py's receiver
    (galileo_e1bc_plan at 4 Msps, 6 channels, 20 s, the pilot emitted) on
    K1, with its gates (>= 4 channels secondary-locked in NARROW with
    integ_len 5 and C/N0 > 35 dB-Hz, >= 4 ephemerides, the last fix within
    5 m), and K1 against its plain version on a block of the run
    (``track_blocked_e1bc``). Then the three engines on the same capture: a
    K1 tracker started from the run's acquisitions runs until its channels
    lock the secondary, its state goes to an eager (K3) and a K2 tracker,
    and all three run 3 blocks, held to each other by
    tests/test_fused_receiver.py's _assert_match; K2 and K3 against their
    plain versions on a block and a period of those runs
    (``track_full_e1bc``, ``correlator_e1bc``)."""
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import galileo_e1bc_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.tracking.tracker import ChannelPhase

    fs = scen.cfg.fs
    plan = galileo_e1bc_plan(fs=fs, num_channels=6)
    rx = Receiver(ReceiverConfig(fs=fs, num_channels=6), plans=[plan])
    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    with record_blocks() as rec:
        wall, blocks = drive_receiver(rx, capture, fs)
    n1, n3 = k1.track_blocked.launches, k3.correlator.launches
    if not (blocks > 0 and n1 == blocks and n3 == 0):
        raise AssertionError(f"E1-B+C: {n1} K1 and {n3} K3 launches for "
                             f"{blocks} blocks")
    trk = rx.groups[0].tracker
    integ = trk.state.integ_len.cpu().numpy()
    locked = [ch for ch in range(6) if trk.ctl[ch].sec_locked
              and trk.ctl[ch].phase == ChannelPhase.NARROW]
    cn0 = {ch: trk.ctl[ch].cn0_dbhz for ch in locked}
    err = (float(np.linalg.norm(rx.status.fixes[-1].pos_ecef - scen.rx_ecef))
           if rx.status.fixes else math.inf)
    e = dict(locked=len(locked), integ_len=[int(integ[c]) for c in locked],
             cn0_dbhz=cn0, ephemerides=len(rx.ephemerides),
             subframes=rx.status.subframes, fixes=len(rx.status.fixes),
             last_fix_3d_m=err, ttff_s=rx.status.ttff_s, blocks=blocks,
             k1_launches=n1, wall_s=wall,
             realtime_factor=scen.cfg.duration_s / wall)
    if not (len(locked) >= 4 and all(int(integ[c]) == 5 for c in locked)
            and all(v > 35.0 for v in cn0.values())
            and len(rx.ephemerides) >= 4 and err < 5.0):
        raise AssertionError(f"E1-B+C gates failed: {e}")
    emit("e2e_galileo_e1bc_20s", **e)
    hold_fused_block("e2e_galileo_e1bc_20s", "track_blocked",
                     rec["track_blocked"], kernels, "track_blocked_e1bc")

    # ---- the three engines on the same capture -------------------------
    acq = {prn: v for (_, prn), v in rx.status.acquired.items()}
    starts = [dict(ch=ch, prn=prn, code_row=plan.prn_row(prn),
                   acq_delay_samples=delay, acq_doppler_hz=dop,
                   acq_samplestamp=0, current_abs_sample=0)
              for ch, (prn, (dop, delay)) in enumerate(sorted(acq.items()))]
    counts = three_engines("e1bc_three_engines", plan,
                           capture[:int(1.6 * fs)], starts, 20, kernels,
                           "e1bc")
    kernels["track_blocked_e1bc"]["launches"] = n1
    kernels["track_full_e1bc"]["launches"] = counts["track_full"][2]
    kernels["correlator_e1bc"]["launches"] = counts["eager"][0]
    return e


def three_engines(run: str, plan, capture: np.ndarray, starts: list,
                  max_settle: int, kernels, suffix: str,
                  tols: dict | None = None) -> dict:
    """The three engines on one capture of a pilot plan: a K1 tracker
    started by ``starts`` (start_channel's arguments, as a run made them)
    runs until its channels lock the secondary (at most ``max_settle``
    blocks), its state goes to an eager (K3) and a K2 tracker, and all
    three run 3 blocks, held to each other by
    tests/test_fused_receiver.py's _assert_match on the started channels
    (or ``tols``, assert_match's keyword arguments), data-symbol boundaries
    and counts equal; K2 and K3 against their plain versions on a block
    and a period of those runs (``track_full_<suffix>``,
    ``correlator_<suffix>`` in ``kernels``). Returns the launches of each
    engine (K3, K1, K2)."""
    import copy

    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.tracking.dll_pll import TrackingState
    from gnss_sdr_tpu_torch.tracking.tracker import ChannelPhase, Tracker

    x = torch.as_tensor(capture, device="cuda")
    conf = plan.trk_conf
    trks = {}
    for engine, fused, env in (("track_blocked", True, "blocked"),
                               ("eager", False, None),
                               ("track_full", True, "perchannel")):
        with fused_engine(env):
            trks[engine] = Tracker(
                dataclasses.replace(conf, fused_tracker=fused),
                plan.code_table, plan.data_code_table, plan.sec_pilot_table,
                plan.sec_data_levels, device=x.device)
    lead = trks["track_blocked"]
    for kw in starts:
        lead.start_channel(**kw)
    started = [kw["ch"] for kw in starts]
    settle = 0
    while not all(lead.ctl[c].sec_locked for c in started
                  if lead.ctl[c].phase != ChannelPhase.LOST):
        lead.process_device(x, 0, x.shape[0])
        settle += 1
        if settle > max_settle:
            raise AssertionError(f"{run}: no secondary lock within "
                                 f"{max_settle} blocks")
    for engine in ("eager", "track_full"):
        t = trks[engine]
        t.state = TrackingState(**{
            f.name: getattr(lead.state, f.name).clone()
            for f in dataclasses.fields(TrackingState)})
        t.pos_abs = lead.pos_abs.copy()
        t.ctl = copy.deepcopy(lead.ctl)
        for name in ("codes", "data_codes", "sec_pilot", "sec_data"):
            setattr(t, name, getattr(lead, name).copy())
        t._codes_dev = None
    results, counts = {}, {}
    with record_blocks() as rec:
        for engine, t in trks.items():
            k3.correlator.launches = 0
            k1.track_blocked.launches = 0
            k2.track_full.launches = 0
            results[engine] = [t.process_device(x, 0, x.shape[0])
                               for _ in range(3)]
            torch.cuda.synchronize()
            counts[engine] = (k3.correlator.launches,
                              k1.track_blocked.launches,
                              k2.track_full.launches)
    want = {"eager": (3 * conf.steps_per_block, 0, 0),
            "track_blocked": (0, 3, 0), "track_full": (0, 0, 3)}
    if counts != want:
        raise AssertionError(f"{run}: engine launches {counts}, want {want}")
    diffs = {f"{a}_vs_{b}": [assert_match(p, q, channels=started,
                                          **(tols or {}))
                             for p, q in zip(results[a], results[b])]
             for a, b in (("eager", "track_blocked"), ("eager", "track_full"),
                          ("track_blocked", "track_full"))}
    for a, b in (("eager", "track_blocked"), ("track_blocked", "track_full")):
        for p, q in zip(results[a], results[b]):
            for k in ("data_boundary", "data_count"):
                if not np.array_equal(p.outputs[k][:, started],
                                      q.outputs[k][:, started]):
                    raise AssertionError(f"{run}: {a} and {b} disagree on {k}")
    emit(run, settle_blocks=settle, blocks=3, channels=len(started),
         launches=counts, diffs=diffs)
    hold_fused_block(run, "track_full", rec["track_full"], kernels,
                     f"track_full_{suffix}")
    hold_correlator_block(run, rec["correlator"], kernels,
                          f"correlator_{suffix}")
    return counts


def gal8_phase(capture, scen, kernels) -> dict:
    """Phase 15: bench.py's gal8 settings (galileo_e1b_plan at 4 Msps, 8
    channels, steps_per_block=250, int8_stream) on a 6 s capture; the
    realtime factor, and K1 against its plain version on a block of the
    run (``track_blocked_gal8``)."""
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import galileo_e1b_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    fs = scen.cfg.fs
    plan = galileo_e1b_plan(fs=fs, num_channels=8, steps_per_block=250)
    rx = Receiver(ReceiverConfig(fs=fs, num_channels=8, int8_stream=True),
                  plans=[plan])
    k1.track_blocked.launches = 0
    with record_blocks() as rec:
        wall, blocks = drive_receiver(rx, capture, fs)
    n1 = k1.track_blocked.launches
    if not (blocks > 0 and n1 == blocks):
        raise AssertionError(f"gal8: {n1} K1 launches for {blocks} blocks")
    e = dict(steps_per_block=250, int8_stream=True, blocks=blocks,
             k1_launches=n1, locked=len(rx.groups[0].active_channels()),
             wall_s=wall, realtime_factor=scen.cfg.duration_s / wall)
    emit("e2e_gal8_6s_bench_settings", **e)
    hold_fused_block("e2e_gal8_6s_bench_settings", "track_blocked",
                     rec["track_blocked"], kernels, "track_blocked_gal8",
                     reps=5)
    kernels["track_blocked_gal8"]["launches"] = n1
    return e


# ---- long codes and two bands: GPS L5 and Galileo E5a ---------------------

L5_LEN = 10230                  # chips of the L5 and E5a primary codes
LONG_DOPS = [1200.0, -2500.0, 3400.0, -400.0, 150.0, -3900.0, 2600.0,
             -1700.0]


def long_code_signal(plan, n, dops, delays, seed):
    """Channels c of a GPS L5 or Galileo E5a ``plan`` (its table rows c) at
    L5_FS: the pilot code times its secondary on the quadrature axis, the
    data code times the data secondary and a random symbol a secondary
    period on the in-phase axis (secondary chip 0 on the period that starts
    at the channel's delay, in samples), at the given Dopplers, with
    noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / L5_FS
    sig = np.zeros(n, np.complex64)
    sd = plan.sec_data_levels
    for c, (dop, dly) in enumerate(zip(dops, delays)):
        u = np.floor((10.23e6 * (1 + dop / 1176.45e6)) * (tt - dly / L5_FS)
                     ).astype(np.int64)
        per = np.floor_divide(u, L5_LEN)
        idx = u - per * L5_LEN
        sym_i = np.floor_divide(per, len(sd))
        sym = np.where(rng.random(int(sym_i.max() - sym_i.min()) + 1) < 0.5,
                       1.0, -1.0)[sym_i - sym_i.min()]
        sp = plan.sec_pilot_table[c]
        comp = (plan.data_code_table[c][idx] * sd[per % len(sd)] * sym
                + 1j * plan.code_table[c][idx] * sp[per % len(sp)])
        sig += (0.35 * comp * np.exp(2j * np.pi * dop * tt + 0.3j * c)
                ).astype(np.complex64)
    noise = rng.normal(size=(n, 2)).astype(np.float32) * 0.05
    return (sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


def start_long_code(plan, K: int, delays, dev, fused: bool = True):
    """A tracker of ``plan`` with K periods a block, channel c started at
    its delay 3 Hz off LONG_DOPS[c], the secondary engaged at its true
    phase, atan2 and 20-period integration."""
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    conf = dataclasses.replace(plan.trk_conf, steps_per_block=K,
                               fused_tracker=fused)
    trk = Tracker(conf, plan.code_table, plan.data_code_table,
                  plan.sec_pilot_table, plan.sec_data_levels, device=dev)
    C = len(delays)
    for ch in range(C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=delays[ch],
                          acq_doppler_hz=LONG_DOPS[ch] + 3.0,
                          acq_samplestamp=0, current_abs_sample=0)
    on = torch.ones(C, dtype=torch.bool, device=dev)
    trk.state = trk.state.replace(
        sec_active=on, use_atan2=on, narrow=on, fll_active=~on,
        integ_len=torch.full((C,), 20, dtype=torch.int32, device=dev))
    return trk


def long_code_kernel_phase(dev) -> None:
    """Phase 16: K1, K2 and K3 against their plain version at the GPS L5
    and Galileo E5a shapes: 10.4 Msps, 10230-chip tables, C = 8, T = 3
    with the pilot (NH20/NH10 counted modulo 20, CS100/CS20 modulo 100),
    20-period integration, on a signal of each plan's own codes
    (start_long_code's channels). K1 and K2 on one block of K = 20 and of
    K = 500 (bench.py's dual16 E5a block), K3 on one period of the eager
    engine from the same start; long-code tolerances (2e-4 over the first
    two periods, 2e-3 over K, check_lanes(3); K3 2e-3), each timed. (The
    kernels line takes its L5 and E5a numbers from blocks of the runs,
    phases 17-21.)"""
    from gnss_sdr_tpu_torch.receiver.plans import (
        galileo_e5a_plan,
        gps_l5_plan,
    )
    from gnss_sdr_tpu_torch.tracking.fused import (
        _pack_scalars,
        build_fused_engine,
    )

    C = 8
    delays = [37.0 + 1301.0 * c for c in range(C)]
    for name, make in (("l5", gps_l5_plan), ("e5a", galileo_e5a_plan)):
        plan = make(L5_FS, num_channels=C)
        t0 = time.perf_counter()
        sig = long_code_signal(plan, int(L5_FS * 0.53), LONG_DOPS, delays,
                               seed=5)
        emit("long_code_signal", signal=name,
             seconds=time.perf_counter() - t0, samples=len(sig))
        window = torch.as_tensor(sig, device=dev)
        for K in (20, 500):
            trk = start_long_code(plan, K, delays, dev)
            st = trk.state.replace(pos=torch.as_tensor(
                trk.pos_abs.astype(np.int32), device=dev))
            tabs = tuple(torch.as_tensor(t, device=dev) for t in (
                trk.data_codes, trk.sec_pilot, trk.sec_data))
            rec = ((window, torch.as_tensor(trk.codes, device=dev),
                    _pack_scalars(trk.conf, st), st.pos,
                    build_fused_engine(trk.conf), *tabs), {}, 0)
            for kname in ("track_blocked", "track_full"):
                hold_fused_block(f"long_code_{name}_K{K}", kname, rec,
                                 reps=20 if K == 20 else 3)
        trk = start_long_code(plan, 20, delays, dev, fused=False)
        with record_blocks() as rec:
            trk.process_device(window, 0, window.shape[0])
        hold_correlator_block(f"long_code_{name}_eager", rec["correlator"])


def count_blocks(rx) -> list[list[int]]:
    """Per group of ``rx``, a counter of the blocks its tracker runs."""
    counts = []
    for g in rx.groups:
        n, process = [0], g.tracker.process_device

        def counted(*a, _process=process, _n=n):
            r = _process(*a)
            _n[0] += 1
            return r

        g.tracker.process_device = counted
        counts.append(n)
    return counts


def enu_errors(fixes, scen) -> np.ndarray:
    """[N, 3] east/north/up errors of ``fixes`` against the scenario."""
    from gnss_sdr_tpu_torch.pvt.coords import ecef_to_enu

    lat, lon = np.deg2rad(scen.cfg.rx_lat_deg), np.deg2rad(scen.cfg.rx_lon_deg)
    return np.array([ecef_to_enu(f.pos_ecef - scen.rx_ecef, lat, lon)
                     for f in fixes]).reshape(-1, 3)


def sec_locked(g) -> list[int]:
    """The channels of group ``g`` whose secondary code is locked."""
    return [ch for ch in range(g.plan.num_channels)
            if g.tracker.ctl[ch].sec_locked]


def dual_band_gates(rx, scen) -> dict:
    """tests/test_dual_band.py's gates on the L1 + L5 run; raises if one
    fails: >= 3 L5 channels secondary-locked, each with atan2 and
    integ_len 20; CNAV decoded on >= 3 channels and >= 3 L5 channels
    anchored; >= 5 fixes, the last one using >= 2 L5 observations; mean
    2D < 2 m and 3D < 5 m over fixes[3:]."""
    g5 = next(g for g in rx.groups if g.plan.name == "L5")
    locked = sec_locked(g5)
    atan2 = g5.tracker.state.use_atan2.cpu().numpy()
    integ = g5.tracker.state.integ_len.cpu().numpy()
    cnav = [p for p, d in g5.decoders.items() if d.msgs_ok > 0]
    anchored = sum(st.anchored for st in
                   rx.obs.ch[g5.offset:g5.offset + g5.plan.num_channels])
    fixes = rx.status.fixes
    l5_used = [k for k in fixes[-1].used if k[2] == "L5"] if fixes else []
    enu = enu_errors(fixes[3:], scen)
    e = dict(acquired=len(rx.status.acquired), l5_prns=g5.channel_prn,
             l5_locked=len(locked),
             l5_atan2=[bool(atan2[c]) for c in locked],
             l5_integ_len=[int(integ[c]) for c in locked],
             cnav_decoded=len(cnav), l5_anchored=int(anchored),
             fixes=len(fixes), last_fix_l5_obs=len(l5_used),
             mean_2d_m=float(np.hypot(enu[:, 0], enu[:, 1]).mean())
             if len(enu) else math.inf,
             mean_3d_m=float(np.linalg.norm(enu, axis=1).mean())
             if len(enu) else math.inf, ttff_s=rx.status.ttff_s)
    if not (len(locked) >= 3 and all(e["l5_atan2"])
            and all(v == 20 for v in e["l5_integ_len"])
            and len(cnav) >= 3 and anchored >= 3 and len(fixes) >= 5
            and len(l5_used) >= 2 and e["mean_2d_m"] < 2.0
            and e["mean_3d_m"] < 5.0):
        raise AssertionError(f"L1 + L5 gates failed: {e}")
    return e


def dual_band_phase(caps, kernels) -> dict:
    """Phase 17: tests/test_dual_band.py's dual_band_rx from Python: GPS
    L1 C/A (5 channels, 2.6 Msps) and L5 (4 channels on the first four
    PRNs, 10.4 Msps), 32 s, seed 4, 1 s feeds of each band, through K1;
    L5 searched around each L1 Doppler by the assisted engine; held to the
    test's gates. Then K1 against its plain version on an L5 block of the
    run (``track_blocked_l5``)."""
    scen = gal_scenario("dual_l1")
    rx, nb, n1, wall, rec = dual_band_run(caps)
    e = dict(dual_band_gates(rx, scen), blocks_l1=nb[0], blocks_l5=nb[1],
             k1_launches=n1,
             l5_assisted=rx.groups[1].assisted_acq is not None,
             wall_s=wall, realtime_factor=scen.cfg.duration_s / wall)
    emit("e2e_dual_band_l1_l5_32s", **e)
    hold_fused_block("e2e_dual_band_l1_l5_32s", "track_blocked",
                     rec[("track_blocked", L5_LEN)], kernels,
                     "track_blocked_l5")
    kernels["track_blocked_l5"]["launches"] = nb[1]
    return e


def dual_band_run(caps, reacquire: bool = False, on_receiver=None,
                  **cfg_kw):
    """tests/test_dual_band.py's L1 + L5 receiver (ReceiverConfig options
    ``cfg_kw`` added) on the dual_l1/dual_l5 captures, 1 s feeds of each
    band, through K1 with the kernels' inputs recorded; returns (rx,
    blocks per group, K1 launches, wall s, recorded blocks). The test
    stops acquiring once 4 L1 and 3 L5 channels track; ``reacquire``
    goes on acquiring after each feed while an L5 channel is idle, as
    the CLI re-acquires idle channels; ``on_receiver(rx)`` is called on
    the Receiver before the run."""
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan, gps_l5_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    scen = gal_scenario("dual_l1")
    prns = tuple(scen.prns)
    rx = Receiver(ReceiverConfig(fs=FS, num_channels=5, **cfg_kw), plans=[
        gps_l1ca_plan(fs=FS, num_channels=5, search_prns=prns),
        gps_l5_plan(fs=L5_FS, num_channels=4, search_prns=prns[:4])])
    if on_receiver is not None:
        on_receiver(rx)
    blocks = count_blocks(rx)
    x1, x5 = caps["dual_l1"], caps["dual_l5"]
    c1, c5 = int(FS), int(L5_FS)
    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    acquired = False
    with record_blocks() as rec:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(int(scen.cfg.duration_s)):
            rx.feed(x1[i * c1:(i + 1) * c1], band="L1")
            rx.feed(x5[i * c5:(i + 1) * c5], band="L5")
            if not acquired:
                rx.acquire()
                acquired = (
                    len([k for k in rx.status.acquired if k[0] == "G"]) >= 4
                    and len(rx.groups[1].active_channels()) >= 3)
            elif reacquire and rx.groups[1].idle_channel() is not None:
                try:
                    rx.acquire()
                except ValueError:
                    pass        # not enough samples buffered yet
            rx.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    n1, n3 = k1.track_blocked.launches, k3.correlator.launches
    nb = [b[0] for b in blocks]
    if not (nb[1] > 0 and n1 == sum(nb) and n3 == 0):
        raise AssertionError(f"L1 + L5: {n1} K1 and {n3} K3 launches for "
                             f"{nb} blocks")
    return rx, nb, n1, wall, rec


def e5a_gates(rx, gal) -> dict:
    """tests/test_dual_band.py's gates on the E5a run; raises if one fails:
    >= 4 channels CS100-locked, >= 3 F/NAV pages decoded, >= 3 fixes with
    mean 3D < 5 m over fixes[2:]."""
    g = rx.groups[0]
    locked = sec_locked(g)
    fixes = rx.status.fixes
    err_3d = np.linalg.norm(enu_errors(fixes[2:], gal), axis=1)
    e = dict(acquired=len(rx.status.acquired), locked=len(locked),
             fnav_pages_ok=sum(d.pages_ok for d in g.decoders.values()),
             fnav_pages_bad=sum(d.pages_bad for d in g.decoders.values()),
             fixes=len(fixes),
             mean_3d_m=float(err_3d.mean()) if len(err_3d) else math.inf,
             ttff_s=rx.status.ttff_s)
    if not (len(locked) >= 4 and e["fnav_pages_ok"] >= 3 and len(fixes) >= 3
            and e["mean_3d_m"] < 5.0):
        raise AssertionError(f"E5a gates failed: {e}")
    return e


def e5a_phase(caps, kernels) -> dict:
    """Phase 18: tests/test_dual_band.py's e5a_rx from Python:
    galileo_e5a_plan alone at 10.4 Msps (5 channels, 20 s, seed 4) with
    the ephemerides injected, through K1, held to the test's gates (>= 4
    channels CS100-locked, >= 3 F/NAV pages, >= 3 fixes with mean 3D
    < 5 m over fixes[2:]); K1 against its plain version on a block of the
    run (``track_blocked_e5a``). Then the three engines on the capture
    (three_engines: K3, K1, K2; ``track_full_e5a``, ``correlator_e5a``),
    started as the run started its channels."""
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import galileo_e5a_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    gal = gal_scenario("e5a_gal")
    plan = galileo_e5a_plan(fs=L5_FS, num_channels=5,
                            search_prns=tuple(gal.prns))
    rx = Receiver(ReceiverConfig(fs=L5_FS, num_channels=5), plans=[plan])
    for p in gal.prns:
        rx.ephemerides[("E", p)] = gal.ephs[p]
    trk = rx.groups[0].tracker
    starts, start = [], trk.start_channel

    def recorded(*a, **kw):
        starts.append(dict(inspect.signature(start).bind(*a, **kw).arguments))
        return start(*a, **kw)

    trk.start_channel = recorded
    (blocks,) = count_blocks(rx)
    x, c = caps["e5a"], int(L5_FS)
    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    acquired = False
    with record_blocks() as rec:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(int(gal.cfg.duration_s)):
            rx.feed(x[i * c:(i + 1) * c], band="L5")
            if not acquired:
                acquired = len(rx.acquire()) >= 4
            rx.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    n1, n3 = k1.track_blocked.launches, k3.correlator.launches
    if not (blocks[0] > 0 and n1 == blocks[0] and n3 == 0):
        raise AssertionError(f"E5a: {n1} K1 and {n3} K3 launches for "
                             f"{blocks[0]} blocks")
    e = dict(e5a_gates(rx, gal), blocks=blocks[0], k1_launches=n1,
             wall_s=wall, realtime_factor=gal.cfg.duration_s / wall)
    emit("e2e_galileo_e5a_20s", **e)
    hold_fused_block("e2e_galileo_e5a_20s", "track_blocked",
                     rec["track_blocked"], kernels, "track_blocked_e5a")
    kernels["track_blocked_e5a"]["launches"] = n1
    counts = three_engines("e5a_three_engines", plan, x[:int(4 * L5_FS)],
                           starts, 150, kernels, "e5a")
    kernels["track_full_e5a"]["launches"] = counts["track_full"][2]
    kernels["correlator_e5a"]["launches"] = counts["eager"][0]
    return e


def project_doppler_phase() -> dict:
    """Phase 19: tests/test_dual_band.py's
    test_project_doppler_assists_secondary_band on the card: a satellite
    tracked on L1 at +1000 Hz seeds the L5 group's search with 1000 Hz x
    f_L5 / f_L1; the assisted grid has fewer than 12 bins, its offsets lie
    on the card, and the engine is cached with its offsets refreshed."""
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan, gps_l5_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.tracking import ChannelPhase

    rx = Receiver(ReceiverConfig(fs=2.6e6), plans=[
        gps_l1ca_plan(fs=2.6e6, num_channels=2, search_prns=(7, 8)),
        gps_l5_plan(fs=12.0e6, num_channels=2, search_prns=(7, 8))])
    g1, g5 = rx.groups
    g1.channel_prn[0] = 7
    g1.tracker.ctl[0].phase = ChannelPhase.WIDE
    g1.tracker.state.carrier_doppler[0] = 1000.0
    proj = rx._project_doppler(g5)
    want = 1000.0 * g5.plan.carrier_freq_hz / g1.plan.carrier_freq_hz
    eng = rx._assisted_engine(g5, proj)
    bins = len(eng.inner.conf.doppler_grid_hz())
    row7, row8 = g5.plan.prn_row(7), g5.plan.prn_row(8)
    ok = (set(proj) == {7} and abs(proj[7] - want) <= 1e-6 * want
          and bins < 12 and eng.inner._offsets.device.type == "cuda"
          and abs(eng._offsets_np[row7] - proj[7]) <= 1e-6 * want
          and eng._offsets_np[row8] == 0.0)
    table = eng.inner._offsets
    again = rx._assisted_engine(g5, {7: 500.0})
    ok = ok and (again is eng and eng.inner._offsets is table
                 and float(table[row7]) == 500.0
                 and rx._project_doppler(g1) == {})
    e = dict(projected_hz=proj.get(7), want_hz=want, assisted_bins=bins,
             offsets_device=str(table.device), cached=again is eng)
    if not ok:
        raise AssertionError(f"Doppler projection failed: {e}")
    emit("project_doppler_assists_secondary_band", **e)
    return e


def dual16_phase(caps, kernels) -> dict:
    """Phase 20: bench.py's dual16 (GPS L1 C/A, 8 channels, 1000 periods
    a block; Galileo E5a, 8 channels, 500 periods a block; int8_stream) on
    its 6 s captures, driven as bench.py's _run_e2e drives it (1 s feeds
    of each band, one acquisition, the factor over the 4 s after a 2 s
    warm-up); K1 against its plain version on an E5a block of the run
    (``track_blocked_dual16``). Returns its acquisitions per system (one
    acquisition, on the captures' first samples)."""
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import (
        galileo_e5a_plan,
        gps_l1ca_plan,
    )
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    rx = Receiver(ReceiverConfig(fs=FS, num_channels=8, int8_stream=True),
                  plans=[gps_l1ca_plan(fs=FS, num_channels=8,
                                       steps_per_block=1000),
                         galileo_e5a_plan(fs=L5_FS, num_channels=8,
                                          steps_per_block=500)])
    blocks = count_blocks(rx)
    feeds = {"L1": (caps["dual16_l1"], int(FS)),
             "L5": (caps["dual16_e5a"], int(L5_FS))}
    dur, warm = 6, 2
    k1.track_blocked.launches = 0
    with record_blocks() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(dur):
            if i == warm:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            for band, (x, c) in feeds.items():
                rx.feed(x[i * c:(i + 1) * c], band=band)
            if i == 0:
                first = rx.acquire()
            rx.run()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    nb = [b[0] for b in blocks]
    n1 = k1.track_blocked.launches
    if not (nb[1] > 0 and n1 == sum(nb)):
        raise AssertionError(f"dual16: {n1} K1 launches for {nb} blocks")
    acq = by_system(first)
    e = dict(steps_per_block=[1000, 500], int8_stream=True,
             blocks_l1=nb[0], blocks_e5a=nb[1], k1_launches=n1,
             acquired={s: sorted(v) for s, v in acq.items()},
             active=[len(g.active_channels()) for g in rx.groups],
             e5a_locked=len(sec_locked(rx.groups[1])),
             wall_s=t2 - t0, realtime_factor=dur / (t2 - t0),
             bench_realtime_factor=(dur - warm) / (t2 - t1))
    emit("e2e_dual16_6s_bench_settings", **e)
    hold_fused_block("e2e_dual16_6s_bench_settings", "track_blocked",
                     rec[("track_blocked", L5_LEN)], kernels,
                     "track_blocked_dual16", reps=3)
    kernels["track_blocked_dual16"]["launches"] = nb[1]
    return acq


def by_system(started: dict) -> dict:
    """{system: {PRN: Doppler}} of an acquisition's {(system, PRN):
    (Doppler, delay)} (GPS on L1, Galileo on E5a in the dual16 runs)."""
    return {sysid: {prn: dop for (s, prn), (dop, _) in started.items()
                    if s == sysid} for sysid in ("G", "E")}


def dual_cli_phase(caps, ref_acq, tmp: Path, kernels) -> dict:
    """Phase 21: the .conf/CLI entry point with
    conf/dual_band_gps_gal.conf's keys (two RF chains: GPS L1 C/A at
    2.6 Msps and Galileo E5a at 10.4 Msps, ibyte) on ibyte copies of phase
    20's captures (the two file names rewritten), through K1 and through
    K2; each run held to phase 20's: its first acquisition (on the same
    first samples; the CLI searches again every 2 s while a channel is
    idle, phase 20 once) starts the same PRNs per system with Doppler
    within one bin, and >= 4 E5a channels are secondary-locked.
    Then each kernel against its plain version on an E5a block of its run
    (K2's as ``track_full_dual16``)."""
    from gnss_sdr_tpu_torch import main as cli
    from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
    from gnss_sdr_tpu_torch.io import encode_samples
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    t0 = time.perf_counter()
    text = (ROOT / "conf" / "dual_band_gps_gal.conf").read_text()
    for key, cap in (("dual16_l1", "capture_l1.dat"),
                     ("dual16_e5a", "capture_e5a.dat")):
        (tmp / cap).write_bytes(encode_samples(np.round(caps[key] * 16),
                                               "ibyte"))
        old = f"filename=./{cap}"
        if old not in text:
            raise AssertionError(f"conf/dual_band_gps_gal.conf has no {old!r}")
        text = text.replace(old, f"filename={tmp / cap}")
    text += "".join(f"PVT.{k}={tmp / v}\n" for k, v in (
        ("kml_dump_filename", "dual.kml"), ("rinex_obs_filename", "dual.obs"),
        ("rinex_nav_filename", "dual.nav")))
    conf = tmp / "dual_band_gps_gal.conf"
    conf.write_text(text)
    emit("dual_cli_capture", seconds=time.perf_counter() - t0,
         item_type="ibyte", fs=[FS, L5_FS])

    blocks, made, acquisitions = {}, [], []
    process, init = Tracker.process_device, Receiver.__init__
    acquire = Receiver.acquire

    def counted(self, *a):
        r = process(self, *a)
        blocks[id(self)] = blocks.get(id(self), 0) + 1
        return r

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def acquired(self, *a, **kw):
        started = acquire(self, *a, **kw)
        acquisitions.append(started)
        return started

    runs = {}
    Tracker.process_device = counted
    Receiver.__init__ = recorded
    Receiver.acquire = acquired
    try:
        for engine, env in (("track_blocked", None),
                            ("track_full", "perchannel")):
            blocks.clear()
            acquisitions.clear()
            k1.track_blocked.launches = 0
            k2.track_full.launches = 0
            with (fused_engine(env), record_blocks() as rec,
                  contextlib.redirect_stdout(io.StringIO())):
                torch.cuda.synchronize()
                t = time.perf_counter()
                status = cli.run_from_config(FileConfiguration(conf))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            rx = made[-1]
            nb = [blocks.get(id(g.tracker), 0) for g in rx.groups]
            n1, n2 = k1.track_blocked.launches, k2.track_full.launches
            want = {"track_blocked": (sum(nb), 0),
                    "track_full": (0, sum(nb))}[engine]
            if not (nb[1] > 0 and (n1, n2) == want):
                raise AssertionError(
                    f"dual-band CLI run ({engine}): {n1} K1 and {n2} K2 "
                    f"launches for {nb} blocks")
            acq = by_system(acquisitions[0])
            steps = {g.plan.system: g.plan.acq_conf.doppler_step_hz
                     for g in rx.groups}
            dop_err = {s: max((abs(acq[s][p] - ref_acq[s][p])
                               for p in acq[s] if p in ref_acq[s]),
                              default=0.0) for s in acq}
            e5a = next(g for g in rx.groups if g.plan.name == "5X")
            runs[engine] = dict(
                GNSS_SDR_TPU_FUSED=env, bands=[g.plan.band
                                               for g in rx.groups],
                first_acquired={s: sorted(v) for s, v in acq.items()},
                acquired={s: sorted(v) for s, v in
                          by_system(status.acquired).items()},
                doppler_diff_hz=dop_err, e5a_locked=len(sec_locked(e5a)),
                fixes=len(status.fixes), blocks=nb, k1_launches=n1,
                k2_launches=n2, wall_s=wall, realtime_factor=6.0 / wall)
            emit("dual_cli_run", engine=engine, **runs[engine])
            if not (all(set(acq[s]) == set(ref_acq[s]) for s in acq)
                    and all(dop_err[s] <= steps[s] for s in acq)
                    and runs[engine]["e5a_locked"] >= 4):
                raise AssertionError(
                    f"dual-band CLI run ({engine}) disagrees with the Python "
                    f"run: {runs[engine]}, Python {ref_acq}")
            hold_fused_block(f"dual_cli_run {engine}", engine,
                             rec[(engine, L5_LEN)], kernels,
                             "track_full_dual16" if env else None)
            if env:
                kernels["track_full_dual16"]["launches"] = nb[1]
    finally:
        Tracker.process_device = process
        Receiver.__init__ = init
        Receiver.acquire = acquire
    return runs


# ---- GLONASS L1 C/A: FDMA -------------------------------------------------

GLO_FS = 3.6e6
GLO_LEN = 511                   # chips of the GLONASS C/A code
GLO_DF = 562.5e3                # Hz between frequency channels
# tests/test_glonass.py's scenario: a GNAV frame boundary 3 s in, strings
# 1-5 complete by 13 s
GLO_SCEN = dict(fs=GLO_FS, tow_start_s=7335.0, duration_s=28.0,
                cn0_dbhz=46.0, max_sats=6, seed=0)
# phase 22's channels: frequency channels from -7 to +6, whose offsets
# (up to 3.9 MHz) alias past fs / 2
GLO_KS = [-7, -5, -3, -1, 0, 2, 4, 6]
# FDMA's extra operations a sample: the ramp's reduction mod 2 pi (a
# multiply, a floor, a fused multiply-add)
FDMA_OPS_PER_SAMPLE = 3


def glonass_signal(n, dops, delays, ks, seed):
    """Channels c of the GLONASS C/A code at GLO_FS on frequency channels
    ks[c], at Dopplers dops[c] and code delays delays[c] (samples), no
    data bits, with noise."""
    from gnss_sdr_tpu_torch.codes.glonass_ca import glonass_ca_code

    rng = np.random.default_rng(seed)
    code = glonass_ca_code().astype(np.float32)
    tt = np.arange(n) / GLO_FS
    sig = np.zeros(n, np.complex64)
    for c, (dop, dly, k) in enumerate(zip(dops, delays, ks)):
        u = np.floor((0.511e6 * (1 + dop / 1.602e9)) * (tt - dly / GLO_FS)
                     ).astype(np.int64)
        sig += (0.35 * code[u % GLO_LEN] * np.exp(
            2j * np.pi * (dop + k * GLO_DF) * tt + 0.3j * c)
        ).astype(np.complex64)
    noise = rng.normal(size=(n, 2)).astype(np.float32) * 0.05
    return (sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


def fdma_kernel_phase(dev) -> None:
    """Phase 22: K1 and K2 with FDMA against their plain version at the
    GLONASS shape: glonass_l1_ca_plan at 3.6 Msps (511 chips, n_max 3602,
    T = 3), C = 8 on frequency channels -7..+6 (GLO_KS), narrow loops with
    10-period integration, on a signal of the code (glonass_signal); one
    block of K = 20 and of K = 200, the long-code tolerances on
    check_lanes(3) (hold_fused_block), each timed, its bound counting the
    FDMA operations. (The kernels line takes its GLONASS numbers from
    blocks of the runs, phases 23-25.)"""
    from gnss_sdr_tpu_torch.receiver.plans import glonass_l1_ca_plan
    from gnss_sdr_tpu_torch.tracking.fused import (
        _pack_scalars,
        build_fused_engine,
    )
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    C = len(GLO_KS)
    delays = [37.0 + 431.0 * c for c in range(C)]
    plan = glonass_l1_ca_plan(GLO_FS, num_channels=C)
    t0 = time.perf_counter()
    sig = glonass_signal(int(GLO_FS * 0.205), LONG_DOPS, delays, GLO_KS, 5)
    emit("glonass_signal", seconds=time.perf_counter() - t0,
         samples=len(sig), ks=GLO_KS)
    window = torch.as_tensor(sig, device=dev)
    for K in (20, 200):
        conf = dataclasses.replace(plan.trk_conf, steps_per_block=K)
        trk = Tracker(conf, plan.code_table, device=dev)
        for ch in range(C):
            trk.start_channel(ch, prn=ch + 1, code_row=ch,
                              acq_delay_samples=delays[ch],
                              acq_doppler_hz=LONG_DOPS[ch] + 3.0,
                              acq_samplestamp=0, current_abs_sample=0,
                              carrier_offset_hz=GLO_KS[ch] * GLO_DF)
        on = torch.ones(C, dtype=torch.bool, device=dev)
        st = trk.state.replace(
            pos=torch.as_tensor(trk.pos_abs.astype(np.int32), device=dev),
            narrow=on, fll_active=~on,
            integ_len=torch.full((C,), 10, dtype=torch.int32, device=dev))
        rec = ((window, torch.as_tensor(trk.codes, device=dev),
                _pack_scalars(conf, st), st.pos, build_fused_engine(conf)),
               {}, 0)
        for kname in ("track_blocked", "track_full"):
            hold_fused_block(f"fdma_K{K}", kname, rec,
                             reps=20 if K == 20 else 5)


def glonass_gates(rx, scen) -> dict:
    """tests/test_glonass.py::test_glonass_end_to_end_fix's gates: >= 4
    slots in the scenario, >= 4 ephemerides, a fix, and the mean 3D error
    over fixes[2:] under 10 m (4 satellites give an exactly determined
    solution; the GNAV state vectors are quantized to 0.49 m an axis).
    Returns the numbers and whether every gate holds."""
    fixes = rx.status.fixes
    errs = [float(np.linalg.norm(f.pos_ecef - scen.rx_ecef))
            for f in fixes[2:]]
    e = dict(slots=len(scen.slots), acquired=sorted(
        prn for _, prn in rx.status.acquired),
        ephemerides=len(rx.ephemerides), subframes=rx.status.subframes,
        fixes=len(fixes),
        mean_3d_m=float(np.mean(errs)) if errs else math.inf,
        ttff_s=rx.status.ttff_s)
    ok = (e["slots"] >= 4 and e["ephemerides"] >= 4 and e["fixes"] >= 1
          and e["mean_3d_m"] < 10.0)
    return e, ok


def glonass_python_phase(capture, scen, kernels) -> dict:
    """Phase 23: tests/test_glonass.py's end-to-end fix on the card:
    glonass_l1_ca_plan at 3.6 Msps, 6 channels, 28 s (seed 0) on K1, fed
    as the test feeds it (2 s, one acquisition, then 1 s a run), held to
    its gates; K1 against its plain version on a block of the run
    (``track_blocked_glo``). Returns the gates' numbers and the first
    acquisition."""
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import glonass_l1_ca_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    plan = glonass_l1_ca_plan(fs=GLO_FS, num_channels=6)
    rx = Receiver(ReceiverConfig(fs=GLO_FS, num_channels=6), plans=[plan])
    (blocks,) = count_blocks(rx)
    sec = int(GLO_FS)
    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    with record_blocks() as rec:
        torch.cuda.synchronize()
        t = time.perf_counter()
        rx.feed(capture[:2 * sec])
        first = rx.acquire()
        rx.run()
        for i in range(2, int(scen.cfg.duration_s)):
            rx.feed(capture[i * sec:(i + 1) * sec])
            rx.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    n1, n3 = k1.track_blocked.launches, k3.correlator.launches
    if not (blocks[0] > 0 and n1 == blocks[0] and n3 == 0):
        raise AssertionError(f"GLONASS: {n1} K1 and {n3} K3 launches for "
                             f"{blocks[0]} blocks")
    gates, ok = glonass_gates(rx, scen)
    e = dict(gates, first_acquired={p: d for (_, p), (d, _) in
                                    first.items()},
             blocks=blocks[0], k1_launches=n1, wall_s=wall,
             realtime_factor=scen.cfg.duration_s / wall)
    emit("e2e_glonass_28s", **e)
    if not ok:
        raise AssertionError(f"GLONASS gates failed: {e}")
    hold_fused_block("e2e_glonass_28s", "track_blocked",
                     rec["track_blocked"], kernels, "track_blocked_glo")
    kernels["track_blocked_glo"]["launches"] = n1
    return dict(e, first=first)


def fdma_engines_phase(dev, kernels) -> dict:
    """Phase 24: tests/test_fused_receiver.py::test_fused_matches_xla_fdma
    on the card: two channels of the GLONASS code at 8 Msps on slot
    offsets +562.5 kHz and -1125 kHz (Dopplers 1200 and -2500 Hz), 15
    periods a block, tracked by the eager engine (the samples wiped off in
    float64, K3 at a zero phase), by K1 and by K2 from the same start;
    the second blocks held to each other within that test's tolerances
    (equal period lengths, Doppler within 0.5 Hz, median prompt relative
    difference under 2e-2, accumulated carrier phase within 0.1 rad); K3
    against its plain version on a period of the eager run
    (``correlator_glo``)."""
    from gnss_sdr_tpu_torch.codes.glonass_ca import glonass_ca_code
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    fs, C, n = 8.0e6, 2, 300_000
    dops, offs = [1200.0, -2500.0], [562.5e3, -1125.0e3]
    code = np.tile(glonass_ca_code().astype(np.float32), (C, 1))
    tt = np.arange(n) / fs
    sig = np.zeros(n, np.complex64)
    for c in range(C):
        cph = (0.511e6 * (1 + dops[c] / 1.602e9)) * tt
        chips = code[c][np.floor(cph).astype(np.int64) % 511]
        sig += 0.5 * chips * np.exp(
            2j * np.pi * (dops[c] + offs[c]) * tt + 0.3j * c)
    rng = np.random.default_rng(5)
    sig = (sig + (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.05
           ).astype(np.complex64)
    results, counts = {}, {}
    with record_blocks() as rec:
        for engine, fused, env in (("eager", False, None),
                                   ("track_blocked", True, "blocked"),
                                   ("track_full", True, "perchannel")):
            conf = DllPllConf(
                fs=fs, code_length_chips=511, code_rate_cps=0.511e6,
                carrier_freq_hz=1.602e9, max_channels=C, steps_per_block=15,
                fdma=True, fused_tracker=fused)
            with fused_engine(env):
                trk = Tracker(conf, code, device=dev)
            for ch in range(C):
                trk.start_channel(ch, prn=ch + 1, code_row=ch,
                                  acq_delay_samples=0.0,
                                  acq_doppler_hz=dops[ch] + 20.0,
                                  acq_samplestamp=0, current_abs_sample=0,
                                  carrier_offset_hz=offs[ch])
            k3.correlator.launches = 0
            k1.track_blocked.launches = 0
            k2.track_full.launches = 0
            results[engine] = [trk.process(sig, 0) for _ in range(2)]
            torch.cuda.synchronize()
            counts[engine] = (k3.correlator.launches,
                              k1.track_blocked.launches,
                              k2.track_full.launches)
    want = {"eager": (30, 0, 0), "track_blocked": (0, 2, 0),
            "track_full": (0, 0, 2)}
    if counts != want:
        raise AssertionError(f"FDMA engine launches {counts}, want {want}")
    diffs = {}
    for a, b in (("eager", "track_blocked"), ("eager", "track_full"),
                 ("track_blocked", "track_full")):
        oa, ob = results[a][1].outputs, results[b][1].outputs
        if not np.array_equal(oa["n_samples"], ob["n_samples"]):
            raise AssertionError(f"FDMA: {a} and {b} disagree on n_samples")
        pa, pb = oa["prompt"], ob["prompt"]
        d = dict(
            doppler_hz=float(np.abs(oa["carrier_doppler"]
                                    - ob["carrier_doppler"]).max()),
            prompt_rel_median=float(np.median(np.abs(pa - pb)
                                              / (np.abs(pa) + 1e-9))),
            carrier_phase_rad=float(np.abs(oa["carrier_phase"]
                                           - ob["carrier_phase"]).max()))
        if not (d["doppler_hz"] < 0.5 and d["prompt_rel_median"] < 2e-2
                and d["carrier_phase_rad"] < 0.1):
            raise AssertionError(f"FDMA: {a} and {b} disagree: {d}")
        diffs[f"{a}_vs_{b}"] = d
    emit("fdma_three_engines", fs=fs, offsets_hz=offs, blocks=2,
         launches=counts, diffs=diffs)
    hold_correlator_block("fdma_three_engines", rec["correlator"], kernels,
                          "correlator_glo")
    kernels["correlator_glo"]["launches"] = counts["eager"][0]
    return diffs


# reference-dialect keys of a one-chain GLONASS L1 C/A receiver (the
# repository ships no GLONASS conf; phase 25 writes this one)
GLO_CONF = """[GNSS-SDR]
GNSS-SDR.internal_fs_sps=3600000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={cap}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency=3600000
SignalConditioner.implementation=Signal_Conditioner
DataTypeAdapter.implementation=Ibyte_To_Complex
InputFilter.implementation=Pass_Through
Resampler.implementation=Pass_Through
Channels_1G.count=6
Channels.in_acquisition=6
Acquisition_1G.implementation=GLONASS_L1_CA_PCPS_Acquisition
Acquisition_1G.doppler_max=5000
Acquisition_1G.doppler_step=250
Tracking_1G.implementation=GLONASS_L1_CA_DLL_PLL_Tracking
TelemetryDecoder_1G.implementation=GLONASS_L1_CA_Telemetry_Decoder
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
PVT.positioning_mode=Single
PVT.display_rate_ms=1000
PVT.kml_dump_filename={tmp}/glo.kml
PVT.rinex_obs_filename={tmp}/glo.obs
PVT.rinex_nav_filename={tmp}/glo.nav
"""


def glonass_cli_phase(capture, scen, ref, tmp: Path, kernels) -> dict:
    """Phase 25: the .conf/CLI entry point with Channels_1G keys
    (GLO_CONF, written into ``tmp``) on an ibyte copy of phase 23's
    capture, through K1 and through K2; each run held to phase 23's gates
    (glonass_gates), and its first acquisition starts phase 23's slots
    with Doppler within one bin. Then each kernel against its plain
    version on a block of its run (K2's as ``track_full_glo``)."""
    from gnss_sdr_tpu_torch import main as cli
    from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
    from gnss_sdr_tpu_torch.io import encode_samples
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    t0 = time.perf_counter()
    cap = tmp / "capture_glo.dat"
    cap.write_bytes(encode_samples(np.round(capture * 16), "ibyte"))
    conf = tmp / "glonass_l1_file.conf"
    conf.write_text(GLO_CONF.format(cap=cap, tmp=tmp))
    emit("glonass_cli_capture", seconds=time.perf_counter() - t0,
         bytes=cap.stat().st_size, item_type="ibyte", fs=GLO_FS)

    blocks, made, acquisitions = [0], [], []
    process, init = Tracker.process_device, Receiver.__init__
    acquire = Receiver.acquire

    def counted(self, *a):
        r = process(self, *a)
        blocks[0] += 1
        return r

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def acquired(self, *a, **kw):
        started = acquire(self, *a, **kw)
        acquisitions.append(started)
        return started

    ref_dop = {p: d for (_, p), (d, _) in ref.items()}
    runs = {}
    Tracker.process_device = counted
    Receiver.__init__ = recorded
    Receiver.acquire = acquired
    try:
        for engine, env in (("track_blocked", None),
                            ("track_full", "perchannel")):
            blocks[0] = 0
            acquisitions.clear()
            k1.track_blocked.launches = 0
            k2.track_full.launches = 0
            with (fused_engine(env), record_blocks() as rec,
                  contextlib.redirect_stdout(io.StringIO())):
                torch.cuda.synchronize()
                t = time.perf_counter()
                cli.run_from_config(FileConfiguration(conf))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            n1, n2 = k1.track_blocked.launches, k2.track_full.launches
            want = {"track_blocked": (blocks[0], 0),
                    "track_full": (0, blocks[0])}[engine]
            if not (blocks[0] > 0 and (n1, n2) == want):
                raise AssertionError(
                    f"GLONASS CLI run ({engine}): {n1} K1 and {n2} K2 "
                    f"launches for {blocks[0]} blocks")
            first = {p: d for (_, p), (d, _) in acquisitions[0].items()}
            step = made[-1].groups[0].plan.acq_conf.doppler_step_hz
            gates, ok = glonass_gates(made[-1], scen)
            runs[engine] = dict(
                gates, GNSS_SDR_TPU_FUSED=env,
                first_acquired=first,
                doppler_diff_hz=max((abs(first[p] - ref_dop[p])
                                     for p in first if p in ref_dop),
                                    default=0.0),
                blocks=blocks[0], k1_launches=n1, k2_launches=n2,
                wall_s=wall, realtime_factor=scen.cfg.duration_s / wall)
            emit("glonass_cli_run", engine=engine, **runs[engine])
            if not (ok and set(first) == set(ref_dop)
                    and runs[engine]["doppler_diff_hz"] <= step):
                raise AssertionError(
                    f"GLONASS CLI run ({engine}) fails its gates or "
                    f"disagrees with the Python run: {runs[engine]}, Python "
                    f"{ref_dop}")
            hold_fused_block(f"glonass_cli_run {engine}", engine,
                             rec[engine], kernels,
                             "track_full_glo" if env else None)
            if env:
                kernels["track_full_glo"]["launches"] = n2
    finally:
        Tracker.process_device = process
        Receiver.__init__ = init
        Receiver.acquire = acquire
    return runs


# ---- BeiDou B1I/B3I, GPS L2C, SBAS L1, Galileo E6B, and mc64 ---------------

# tests/test_beidou_geo.py's GEO case: PRN 3 at 4.092 Msps (2 samples a
# chip), 32 s (a 30 s D2 page cycle and the pull-in), 46 dB-Hz, 120 Hz,
# 300 chips of delay, 2 ms D2 bits and no NH code
GEO_FS = 4.092e6
GEO_EPH = dict(prn=3, week=810, toc=246400.0, af0=3.1e-4, af1=-1.8e-11,
               tgd=-4.3e-9, crs=87.3, delta_n=1.2e-9, m0=0.7654,
               cuc=4.2e-6, ecc=0.0034, cus=7.9e-6, sqrt_a=6493.41,
               toe=246400.0, cic=-6.1e-8, omega0=-1.93, cis=1.3e-7,
               i0=0.0971, crc=201.9, omega=0.42, omega_dot=-1.9e-9,
               idot=2.9e-10)
GEO_DOPPLER, GEO_DELAY_CHIPS = 120.0, 300.0


class GeoSignal:
    """tests/test_beidou_geo.py's _geo_signal, made a chunk at a time:
    B1I code chips times 2 ms D2 bits on a carrier at GEO_DOPPLER, with
    unit noise seeded by the chunk's start."""

    def __init__(self) -> None:
        from types import SimpleNamespace

        from gnss_sdr_tpu_torch.telemetry.dnav import BeidouEphemeris
        from gnss_sdr_tpu_torch.telemetry.dnav_d2 import D2Encoder

        self.cfg = SimpleNamespace(fs=GEO_FS, duration_s=32.0)
        self.enc = D2Encoder(BeidouEphemeris(**GEO_EPH),
                             {"alpha0": 1.2e-8, "beta0": 94208.0})

    def generate(self, start: int, n: int) -> np.ndarray:
        from gnss_sdr_tpu_torch.codes.beidou_b1i import beidou_b1i_code
        from gnss_sdr_tpu_torch.constants import beidou_b1i as BDS

        code = beidou_b1i_code(GEO_EPH["prn"]).astype(np.float64)
        t = (start + np.arange(n, dtype=np.float64)) / GEO_FS
        rate = BDS.CODE_RATE_CPS * (1.0 + GEO_DOPPLER / BDS.FREQ_HZ)
        chip = np.floor(t * rate - GEO_DELAY_CHIPS).astype(np.int64)
        period = np.floor_divide(chip, BDS.CODE_LENGTH_CHIPS)
        bit = np.maximum(np.floor_divide(period, 2), 0)
        lo = int(bit.min())
        bits = self.enc.bits_at(np.arange(lo, int(bit.max()) + 1))[bit - lo]
        amp = np.sqrt(10.0 ** 4.6 / GEO_FS)
        rng = np.random.default_rng((31, start))
        x = (amp * code[chip % BDS.CODE_LENGTH_CHIPS] * bits
             * np.exp(2j * np.pi * GEO_DOPPLER * t))
        x += (rng.normal(scale=np.sqrt(0.5), size=n)
              + 1j * rng.normal(scale=np.sqrt(0.5), size=n))
        return x.astype(np.complex64)


def plan_signal(plan, n, dops, delays, sec0, seed):
    """Channels c of ``plan`` (its table rows c) at its rate, at the given
    Dopplers and code delays (samples), with noise: the code times a random
    symbol each ``codes_per_bit`` periods on the in-phase axis, and on a
    BeiDou D1 plan (track_pilot) a random bit each 20 periods times NH20,
    secondary chip ``sec0[c]`` on the period that starts at the delay."""
    rng = np.random.default_rng(seed)
    fs, length = plan.fs, plan.table_length
    d1 = plan.trk_conf.track_pilot
    per_sym = 20 if d1 else plan.trk_conf.codes_per_bit
    tt = np.arange(n) / fs
    sig = np.zeros(n, np.complex64)
    for c, (dop, dly, s0) in enumerate(zip(dops, delays, sec0)):
        u = np.floor((plan.table_rate_cps * (1 + dop / plan.carrier_freq_hz))
                     * (tt - dly / fs)).astype(np.int64)
        per = np.floor_divide(u, length)
        chips = plan.code_table[c][u - per * length]
        per = per + s0
        sym_i = np.floor_divide(per, per_sym)
        sym = np.where(rng.random(int(sym_i.max() - sym_i.min()) + 1) < 0.5,
                       1.0, -1.0)[sym_i - sym_i.min()]
        if d1:
            sym = sym * plan.sec_data_levels[per % 20]
        sig += (0.35 * chips * sym * np.exp(2j * np.pi * dop * tt + 0.3j * c)
                ).astype(np.complex64)
    noise = rng.normal(size=(n, 2)).astype(np.float32) * 0.05
    return (sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


def start_plan(plan, K: int, delays, sec0, dev, fused: bool = True):
    """A tracker of ``plan`` with K periods a block, channel c started at
    its delay 3 Hz off LONG_DOPS[c] with narrow loops; on a D1 plan past
    the NH20 lock mid-symbol as Tracker._engage_secondary leaves it (the
    secondary and 20-period integration at chip ``sec0[c]``, the Costas
    discriminator kept), else integrating the plan's
    extend_correlation_symbols periods from a symbol edge."""
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    conf = dataclasses.replace(plan.trk_conf, steps_per_block=K,
                               fused_tracker=fused)
    trk = Tracker(conf, plan.code_table, plan.data_code_table,
                  plan.sec_pilot_table, plan.sec_data_levels, device=dev)
    C = len(delays)
    for ch in range(C):
        trk.start_channel(ch, prn=ch + 1, code_row=ch,
                          acq_delay_samples=delays[ch],
                          acq_doppler_hz=LONG_DOPS[ch] + 3.0,
                          acq_samplestamp=0, current_abs_sample=0)
    on = torch.ones(C, dtype=torch.bool, device=dev)
    integ = int(conf.extend_correlation_symbols)
    st = dict(narrow=on, fll_active=~on,
              integ_len=torch.full((C,), integ, dtype=torch.int32,
                                   device=dev))
    if conf.track_pilot:
        idx = torch.as_tensor(np.asarray(sec0, np.int32), device=dev)
        st.update(sec_active=on, use_atan2=~on, integ_count=idx.clone(),
                  sec_idx=idx.clone())
    trk.state = trk.state.replace(**st)
    return trk


# phase 26's shapes: name -> (plan function, rate, the two block lengths)
LAST_SHAPES = {
    "b1i": ("beidou_b1i_plan", 2.6e6, (20, 200)),
    "b3i": ("beidou_b3i_plan", 12.5e6, (20, 200)),
    "l2c": ("gps_l2c_plan", 2.6e6, (4, 40)),
    "e6b": ("galileo_e6b_plan", 10.23e6, (20, 200)),
    "sbas": ("sbas_l1_plan", 2.6e6, (20, 200)),
}


def last_plans_kernel_phase(dev) -> None:
    """Phase 26: K1, K2 and K3 against their plain version at the shapes
    of the last plans (LAST_SHAPES), C = 8, T = 3, on a signal of each
    plan's own codes (plan_signal, start_plan): BeiDou B1I (2.6 Msps) and
    B3I (12.5 Msps) in the D1 mode (pilot code = data code, NH20 on both,
    the Costas discriminator kept, 20-period integration from counters at
    (3 + 7c) mod 20, mid-symbol), GPS L2C (2.6 Msps, 52000 samples a
    20 ms period), Galileo E6B (10.23 Msps) and SBAS (2.6 Msps, 2-period
    integration). K1 and K2 on one block of K = 20 and 200 (L2C: 4 and 40,
    80 and 800 ms), held within 5e-5 relative over the first two periods
    and 2e-3 over the block on check_lanes(3), lanes 10 and 17 exact; K3
    on one period of the eager engine from the same start, within 2e-3;
    each timed. Each shape's shared memory a CTA needs (K1 at its launch
    shape, K2 with the whole period) is printed beside the card's
    limit."""
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver import plans
    from gnss_sdr_tpu_torch.tracking.fused import (
        _pack_scalars,
        build_fused_engine,
    )

    C = 8
    sec0 = [(3 + 7 * c) % 20 for c in range(C)]
    for name, (make, fs, ks) in LAST_SHAPES.items():
        plan = getattr(plans, make)(fs, num_channels=C)
        conf = plan.trk_conf
        spp = int(round(fs * conf.code_period_s))
        delays = [37.0 + 0.131 * spp * c for c in range(C)]
        t0 = time.perf_counter()
        sig = plan_signal(plan, spp * (max(ks) + 3), LONG_DOPS, delays, sec0,
                          seed=5)
        window = torch.as_tensor(sig, device=dev)
        spec = build_fused_engine(conf)
        mode = (spec.code_len, spec.n_max, int(spec.interp_code),
                spec.num_taps, int(spec.track_pilot), int(spec.fdma))
        r, width = k1.launch_shape(dev, C, spec.n_max,
                                   "gnss_track_blocked_max_clusters", C,
                                   *mode)
        smem_args = (spec.code_len, int(spec.interp_code), spec.num_taps,
                     int(spec.track_pilot), int(spec.fdma))
        k1_need, limit = k1.smem_need("gnss_track_blocked_smem", dev,
                                      *smem_args, width)
        k2_need, _ = k1.smem_need("gnss_track_full_smem", dev, *smem_args,
                                  spec.n_max)
        emit("last_plan_shape", shape=name, plan=make, fs=fs, C=C,
             n_max=spec.n_max, L=spec.code_len, pilot=spec.track_pilot,
             k1_cluster_ctas=r, k1_slice=width, k1_smem_bytes=k1_need,
             k2_smem_bytes=k2_need, smem_limit_bytes=limit,
             signal_seconds=time.perf_counter() - t0, samples=len(sig))
        for K in ks:
            trk = start_plan(plan, K, delays, sec0, dev)
            st = trk.state.replace(pos=torch.as_tensor(
                trk.pos_abs.astype(np.int32), device=dev))
            tabs = tuple(torch.as_tensor(t, device=dev) for t in (
                trk.data_codes, trk.sec_pilot, trk.sec_data)
            ) if conf.track_pilot else ()
            rec = ((window, torch.as_tensor(trk.codes, device=dev),
                    _pack_scalars(trk.conf, st), st.pos,
                    build_fused_engine(trk.conf), *tabs), {}, 0)
            for kname in ("track_blocked", "track_full"):
                hold_fused_block(f"{name}_K{K}", kname, rec,
                                 reps=20 if K == ks[0] else 3,
                                 first_tol=5e-5)
        trk = start_plan(plan, ks[0], delays, sec0, dev, fused=False)
        with record_blocks() as rec:
            trk.process_device(window, 0, window.shape[0])
        hold_correlator_block(f"{name}_eager", rec["correlator"])


def gps_bds_gates(rx, gps, bds) -> tuple[dict, bool]:
    """tests/test_beidou.py's gates (test_bds_tracking_and_telemetry,
    test_gps_bds_dual_fix): >= 3 NH20-locked B1I channels, >= 6 D1
    subframes, >= 3 BDS ephemerides each with sqrt_a within 2^-19 of the
    truth and toe exact, >= 5 fixes, the last using GPS and BeiDou with an
    inter-system bias, mean 2D < 2 m and 3D < 5 m over fixes[3:]. Returns
    the numbers and whether every gate holds."""
    gb = next(g for g in rx.groups if g.plan.system == "C")
    locked = sec_locked(gb)
    d1 = sum(d.subframes_ok for d in gb.decoders.values())
    eph = {prn: e for (s, prn), e in rx.ephemerides.items() if s == "C"}
    eph_ok = all(
        abs(e.sqrt_a - bds.ephs[p].sqrt_a) <= 2.0 ** -19 + 1e-10
        and abs(e.toe - bds.ephs[p].toe) < 1e-9 for p, e in eph.items())
    fixes = rx.status.fixes
    last = fixes[-1] if fixes else None
    enu = enu_errors(fixes[3:], gps)
    e = dict(acquired=sorted(f"{s}{p:02d}" for s, p in rx.status.acquired),
             b1i_prns=gb.channel_prn, b1i_nh20_locked=len(locked),
             d1_subframes=d1, bds_ephemerides=sorted(eph),
             bds_eph_fields_ok=eph_ok, fixes=len(fixes),
             last_fix_systems=sorted({k[0] for k in last.used}) if last
             else [], isb_m=dict(last.isb_m) if last else {},
             mean_2d_m=float(np.hypot(enu[:, 0], enu[:, 1]).mean())
             if len(enu) else math.inf,
             mean_3d_m=float(np.linalg.norm(enu, axis=1).mean())
             if len(enu) else math.inf, ttff_s=rx.status.ttff_s)
    ok = (len(locked) >= 3 and d1 >= 6 and len(eph) >= 3 and eph_ok
          and len(fixes) >= 5 and e["last_fix_systems"] == ["C", "G"]
          and bool(e["isb_m"]) and e["mean_2d_m"] < 2.0
          and e["mean_3d_m"] < 5.0)
    return e, ok


def gps_bds_phase(caps, kernels) -> dict:
    """Phase 27: tests/test_beidou.py's gps_bds_receiver from Python: GPS
    L1 C/A and BeiDou B1I (4 channels each, 2.6 Msps, 35 s, seed 1) on K1,
    fed as the test feeds it (1 s of each band, acquisition until >= 3
    satellites of each system start), held to the test's gates
    (gps_bds_gates); K1 against its plain version on a B1I block of the
    run (``track_blocked_bds``). Then the three engines on the first 4 s
    of the B1I capture, started as the run started its channels
    (three_engines past the NH20 lock: eager K3, K1, K2, within phase 24's
    tolerances: Doppler 0.5 Hz, a median prompt difference of 2e-2, the
    carrier phase 0.1 rad; ``correlator_bds``). Returns the gates' numbers
    and the first acquisition."""
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import (
        beidou_b1i_plan,
        gps_l1ca_plan,
    )
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    gps, bds = gal_scenario("bds_l1"), gal_scenario("bds_b1")
    plan = beidou_b1i_plan(fs=FS, num_channels=4, search_prns=tuple(bds.prns))
    rx = Receiver(ReceiverConfig(fs=FS, num_channels=8), plans=[
        gps_l1ca_plan(fs=FS, num_channels=4, search_prns=tuple(gps.prns)),
        plan])
    trk = rx.groups[1].tracker
    starts, start = [], trk.start_channel

    def recorded(*a, **kw):
        starts.append(dict(inspect.signature(start).bind(*a, **kw).arguments))
        return start(*a, **kw)

    trk.start_channel = recorded
    blocks = count_blocks(rx)
    xl, xb, c = caps["bds_l1"], caps["bds_b1"], int(FS)
    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    acquired, first = False, None
    with record_blocks() as rec:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(int(gps.cfg.duration_s)):
            rx.feed(xl[i * c:(i + 1) * c], band="L1")
            rx.feed(xb[i * c:(i + 1) * c], band="B1")
            if not acquired:
                got = rx.acquire()
                first = got if first is None else first
                acquired = (len([k for k in got if k[0] == "G"]) >= 3
                            and len([k for k in got if k[0] == "C"]) >= 3)
            rx.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    n1, n3 = k1.track_blocked.launches, k3.correlator.launches
    nb = [b[0] for b in blocks]
    if not (nb[1] > 0 and n1 == sum(nb) and n3 == 0):
        raise AssertionError(f"gps_bds: {n1} K1 and {n3} K3 launches for "
                             f"{nb} blocks")
    gates, ok = gps_bds_gates(rx, gps, bds)
    e = dict(gates, first_acquired=sorted(f"{s}{p:02d}" for s, p in first),
             blocks_l1=nb[0], blocks_b1=nb[1], k1_launches=n1,
             wall_s=wall, realtime_factor=gps.cfg.duration_s / wall)
    emit("e2e_gps_bds_35s", **e)
    if not ok:
        raise AssertionError(f"gps_bds gates failed: {e}")
    hold_fused_block("e2e_gps_bds_35s", "track_blocked",
                     rec[("track_blocked", 2046)], kernels,
                     "track_blocked_bds")
    kernels["track_blocked_bds"]["launches"] = nb[1]
    counts = three_engines(
        "bds_three_engines", plan, xb[:int(4 * FS)], starts, 150, kernels,
        "bds", tols=dict(prompt_tol=2e-2, dop_tol=0.5, phase_tol=0.1))
    kernels["correlator_bds"]["launches"] = counts["eager"][0]
    return dict(e, first=first)


# reference-dialect keys of a two-chain GPS L1 C/A + BeiDou B1I receiver
# (the reference's Channels_1C + Channels_B1 configuration; phase 28 writes
# it)
GPS_BDS_CONF = """[GNSS-SDR]
GNSS-SDR.internal_fs_sps=2600000
SignalSource.RF_channels=2
SignalSource0.implementation=File_Signal_Source
SignalSource0.filename={l1}
SignalSource0.item_type=ibyte
SignalSource0.sampling_frequency=2600000
SignalSource1.implementation=File_Signal_Source
SignalSource1.filename={b1}
SignalSource1.item_type=ibyte
SignalSource1.sampling_frequency=2600000
SignalConditioner0.implementation=Signal_Conditioner
DataTypeAdapter0.implementation=Ibyte_To_Complex
SignalConditioner1.implementation=Signal_Conditioner
DataTypeAdapter1.implementation=Ibyte_To_Complex
Channels_1C.count=4
Channels_B1.count=4
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_B1.implementation=BEIDOU_B1I_PCPS_Acquisition
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Tracking_B1.implementation=BEIDOU_B1I_DLL_PLL_Tracking
TelemetryDecoder_1C.implementation=GPS_L1_CA_Telemetry_Decoder
TelemetryDecoder_B1.implementation=BEIDOU_B1I_Telemetry_Decoder
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
PVT.positioning_mode=Single
PVT.display_rate_ms=1000
PVT.kml_dump_filename={tmp}/bds.kml
PVT.rinex_obs_filename={tmp}/bds.obs
PVT.rinex_nav_filename={tmp}/bds.nav
"""


def gps_bds_cli_phase(caps, ref: dict, tmp: Path, kernels) -> dict:
    """Phase 28: the .conf/CLI entry point with GPS_BDS_CONF's two RF
    chains (Channels_1C on L1, Channels_B1 on B1) on ibyte copies of phase
    27's captures, through K1 and through K2; each run held to phase 27's
    gates (gps_bds_gates), and its first acquisition starts the satellites
    of phase 27's first with Doppler within one bin. Then each kernel against its plain
    version on a B1I block of its run (K2's as ``track_full_bds``)."""
    from gnss_sdr_tpu_torch import main as cli
    from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
    from gnss_sdr_tpu_torch.io import encode_samples
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    t0 = time.perf_counter()
    paths = {}
    for key in ("bds_l1", "bds_b1"):
        paths[key] = tmp / f"capture_{key}.dat"
        paths[key].write_bytes(encode_samples(np.round(caps[key] * 16),
                                              "ibyte"))
    conf = tmp / "gps_bds.conf"
    conf.write_text(GPS_BDS_CONF.format(l1=paths["bds_l1"],
                                        b1=paths["bds_b1"], tmp=tmp))
    emit("gps_bds_cli_capture", seconds=time.perf_counter() - t0,
         item_type="ibyte", fs=[FS, FS])
    gps, bds = gal_scenario("bds_l1"), gal_scenario("bds_b1")

    blocks, made, acquisitions = {}, [], []
    process, init = Tracker.process_device, Receiver.__init__
    acquire = Receiver.acquire

    def counted(self, *a):
        r = process(self, *a)
        blocks[id(self)] = blocks.get(id(self), 0) + 1
        return r

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def acquired(self, *a, **kw):
        started = acquire(self, *a, **kw)
        acquisitions.append(started)
        return started

    runs = {}
    Tracker.process_device = counted
    Receiver.__init__ = recorded
    Receiver.acquire = acquired
    try:
        for engine, env in (("track_blocked", None),
                            ("track_full", "perchannel")):
            blocks.clear()
            acquisitions.clear()
            k1.track_blocked.launches = 0
            k2.track_full.launches = 0
            with (fused_engine(env), record_blocks() as rec,
                  contextlib.redirect_stdout(io.StringIO())):
                torch.cuda.synchronize()
                t = time.perf_counter()
                cli.run_from_config(FileConfiguration(conf))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            rx = made[-1]
            nb = [blocks.get(id(g.tracker), 0) for g in rx.groups]
            n1, n2 = k1.track_blocked.launches, k2.track_full.launches
            want = {"track_blocked": (sum(nb), 0),
                    "track_full": (0, sum(nb))}[engine]
            if not (nb[1] > 0 and (n1, n2) == want):
                raise AssertionError(
                    f"gps_bds CLI run ({engine}): {n1} K1 and {n2} K2 "
                    f"launches for {nb} blocks")
            first = acquisitions[0]
            step = max(g.plan.acq_conf.doppler_step_hz for g in rx.groups)
            dop_diff = max((abs(first[k][0] - ref[k][0]) for k in first
                            if k in ref), default=0.0)
            gates, ok = gps_bds_gates(rx, gps, bds)
            runs[engine] = dict(
                gates, GNSS_SDR_TPU_FUSED=env,
                bands=[g.plan.band for g in rx.groups],
                first_acquired=sorted(f"{s}{p:02d}" for s, p in first),
                doppler_diff_hz=dop_diff, blocks=nb, k1_launches=n1,
                k2_launches=n2, wall_s=wall,
                realtime_factor=gps.cfg.duration_s / wall)
            emit("gps_bds_cli_run", engine=engine, **runs[engine])
            if not (ok and set(first) == set(ref) and dop_diff <= step):
                raise AssertionError(
                    f"gps_bds CLI run ({engine}) fails its gates or "
                    f"disagrees with the Python run: {runs[engine]}, Python "
                    f"{sorted(ref)}")
            hold_fused_block(f"gps_bds_cli_run {engine}", engine,
                             rec[(engine, 2046)], kernels,
                             "track_full_bds" if env else None)
            if env:
                kernels["track_full_bds"]["launches"] = nb[1]
    finally:
        Tracker.process_device = process
        Receiver.__init__ = init
        Receiver.acquire = acquire
    return runs


def geo_phase(capture, kernels) -> dict:
    """Phase 29: tests/test_beidou_geo.py's B1I GEO case through the
    port's Tracker on K1: beidou_b1i_geo_plan at 4.092 Msps (2 channels,
    one started on PRN 3 at its delay, 50 Hz off its Doppler), 32 s of
    GeoSignal (made in 1 s chunks), the 2 ms bit-synced D2 symbols into
    D2Decoder as the test feeds them; held to the test's gates: the
    channel NARROW at the end, > 30 D2 subframes, a complete ephemeris with
    sqrt_a within 1e-3, m0 within 1e-8, af0 within 2^-32 and week 810. K1
    against its plain version on a block of the run
    (``track_blocked_geo``)."""
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import beidou_b1i_geo_plan
    from gnss_sdr_tpu_torch.telemetry.dnav_d2 import D2Decoder
    from gnss_sdr_tpu_torch.tracking.tracker import ChannelPhase, Tracker

    plan = beidou_b1i_geo_plan(GEO_FS, num_channels=2)
    conf = plan.trk_conf
    sps = GEO_FS / 2.046e6
    trk = Tracker(conf, plan.code_table, device="cuda")
    trk.start_channel(ch=0, prn=3, code_row=2,
                      acq_delay_samples=GEO_DELAY_CHIPS * sps,
                      acq_doppler_hz=GEO_DOPPLER - 50.0,
                      acq_samplestamp=0, current_abs_sample=0)
    dec = D2Decoder(prn=3)
    events, nblocks, num = [], 0, len(capture)
    k1.track_blocked.launches = 0
    with record_blocks() as rec:
        torch.cuda.synchronize()
        t = time.perf_counter()
        while True:
            base, w = trk.window_request()
            if base + w > num:
                break
            r = trk.process(capture[base:base + w], base)
            nblocks += 1
            out = r.outputs
            full = out["boundary"][:, 0] & (
                out["acc_samples"][:, 0] > conf.samples_per_code * 1.5)
            if full.any() and trk.ctl[0].phase == ChannelPhase.NARROW:
                events += dec.push_symbols(
                    np.sign(out["acc_prompt"][full, 0].real),
                    r.abs_sample_end[full, 0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    n1 = k1.track_blocked.launches
    if not (nblocks > 0 and n1 == nblocks):
        raise AssertionError(f"GEO: {n1} K1 launches for {nblocks} blocks")
    got, want = dec.eph, GEO_EPH
    e = dict(channel_phase=trk.ctl[0].phase.name,
             subframes_ok=dec.subframes_ok,
             subframes_bad=dec.subframes_bad,
             ephemeris_complete=any(ev["ephemeris_complete"]
                                    for ev in events),
             sqrt_a_err=abs(got.sqrt_a - want["sqrt_a"]),
             m0_err=abs(got.m0 - want["m0"]),
             af0_err=abs(got.af0 - want["af0"]), week=got.week,
             blocks=nblocks, k1_launches=n1, wall_s=wall,
             realtime_factor=num / GEO_FS / wall)
    emit("geo_b1i_d2_32s", **e)
    if not (e["channel_phase"] == "NARROW" and e["subframes_ok"] > 30
            and e["ephemeris_complete"] and e["sqrt_a_err"] < 1e-3
            and e["m0_err"] < 1e-8 and e["af0_err"] < 2.0 ** -32
            and e["week"] == 810):
        raise AssertionError(f"GEO gates failed: {e}")
    hold_fused_block("geo_b1i_d2_32s", "track_blocked", rec["track_blocked"],
                     kernels, "track_blocked_geo")
    kernels["track_blocked_geo"]["launches"] = n1
    return e


# phase 30's cases: name -> (plan function, plan keywords, PRN, Doppler Hz,
# delay in chips, C/N0 dB-Hz, Doppler and delay (samples) tolerances):
# tests/test_e6.py::test_e6_acquisition's, tests/test_sbas_qzss.py::
# test_sbas_l1_acquisition's, and one L2C (two-step zoom) and one B3I
# signal
ACQ_CASES = {
    "e6b": ("galileo_e6b_plan", dict(fs=10.23e6, doppler_max_hz=3000.0,
                                     doppler_step_hz=500.0),
            11, 1200.0, 1000.5, 47.0, 250.0, 2.0),
    "sbas": ("sbas_l1_plan", dict(fs=2.046e6), 131, -300.0, 700.5, 46.0,
             125.0, 1.5),
    "l2c": ("gps_l2c_plan", dict(fs=2.6e6), 5, 2217.0, 3100.25, 44.0, 8.0,
            1.5),
    "b3i": ("beidou_b3i_plan", dict(fs=12.5e6), 14, -1060.0, 4321.5, 47.0,
            250.0, 1.5),
}


def last_plans_acquisition_phase() -> dict:
    """Phase 30: PCPS on the card (torch.fft) for Galileo E6B, SBAS, GPS
    L2C with its two-step Doppler zoom, and BeiDou B3I, each on one
    satellite of its own code (ACQ_CASES) searched over the plan's whole
    grid: detected, with Doppler and delay inside the tolerances of the
    tests the cases come from (L2C: one fine bin of 8 Hz; B3I: one bin of
    250 Hz)."""
    from gnss_sdr_tpu_torch.acquisition import PcpsAcquisition
    from gnss_sdr_tpu_torch.receiver import plans

    out = {}
    for name, (make, kw, prn, dop, delay, cn0, dtol, stol) in (
            ACQ_CASES.items()):
        plan = getattr(plans, make)(**kw)
        conf = plan.acq_conf
        table = (plan.acq_code_table if plan.acq_code_table is not None
                 else plan.code_table)
        row = plan.prn_row(prn)
        rng = np.random.default_rng(4)
        n = conf.input_samples
        t = np.arange(n) / conf.fs
        chip = np.floor((t - delay / conf.code_rate_cps)
                        * conf.code_rate_cps).astype(np.int64)
        x = np.sqrt(10 ** (cn0 / 10) / conf.fs) * table[row][
            chip % conf.code_length_chips] * np.exp(2j * np.pi * dop * t)
        x = (x + rng.normal(scale=np.sqrt(0.5), size=n) + 1j * rng.normal(
            scale=np.sqrt(0.5), size=n)).astype(np.complex64)
        eng = PcpsAcquisition(conf, table, list(plan.search_prns),
                              device="cuda")
        t0 = time.perf_counter()
        res = eng.acquire(x[None], np.array([row]))
        torch.cuda.synchronize()
        sps = conf.fs / conf.code_rate_cps
        out[name] = dict(
            prn=prn, detected=bool(res.detected[0]),
            doppler_hz=float(res.doppler_hz[0]), truth_doppler_hz=dop,
            delay_samples=float(res.delay_samples[0]),
            truth_delay_samples=delay * sps,
            two_step=bool(conf.make_two_steps), seconds=time.perf_counter()
            - t0)
        if not (res.detected[0] and abs(res.doppler_hz[0] - dop) <= dtol
                and abs(res.delay_samples[0] - delay * sps) <= stol):
            raise AssertionError(f"{name} acquisition: {out[name]}")
    emit("last_plans_acquisition", cases=out)
    return out


def mc64_gates(first: dict, rx) -> tuple[dict, bool]:
    """mc64's first acquisition per system against its scenario: only PRNs
    in view (a GLONASS slot's antipodal twin counts as the slot: they share
    a frequency channel, and GNAV re-keys it later), at least min(4, in
    view) of them, each with Doppler within one bin of the truth."""
    from gnss_sdr_tpu_torch.constants.glonass_l1 import SLOT_TO_K

    scens = {"G": gal_scenario("mc64_gps"), "E": gal_scenario("mc64_gal"),
             "R": gal_scenario("mc64_glo"), "C": gal_scenario("mc64_bds")}
    steps = {g.plan.system: g.plan.acq_conf.doppler_step_hz
             for g in rx.groups}
    e, ok = {}, True
    for sysid, scen in scens.items():
        truth = {p: scen.truth_at(p, 0.0)["doppler_hz"] for p in scen.prns}
        if sysid == "R":
            truth.update({s: truth[p] for p in list(truth)
                          for s in SLOT_TO_K
                          if SLOT_TO_K[s] == SLOT_TO_K[p]})
        got = {p: d for (s, p), (d, _) in first.items() if s == sysid}
        err = {p: abs(d - truth[p]) for p, d in got.items() if p in truth}
        e[sysid] = dict(in_view=sorted(scen.prns), acquired=sorted(got),
                        doppler_err_hz=max(err.values(), default=0.0),
                        bin_hz=steps[sysid])
        ok = ok and (set(got) <= set(truth)
                     and len(got) >= min(4, len(scen.prns))
                     and all(v <= steps[sysid] for v in err.values()))
    return e, ok


def mc64_phase(caps, kernels) -> dict:
    """Phase 31: bench.py's mc64 from the port's plans: GPS L1 C/A (1000
    periods a block) and Galileo E1-B (250) on a shared L1 at 4 Msps,
    GLONASS L1 C/A (1000) at 3.6 Msps, BeiDou B1I (1000) at 2.6 Msps, 16
    channels each, ``ReceiverConfig(fs=4e6, num_channels=16,
    int8_stream=True)``, on its 6 s captures, driven as bench.py's _run_e2e
    drives it (1 s feeds of each band, one acquisition, the factor over
    the 4 s after a 2 s warm-up). Gates: the run reaches its end, and
    mc64_gates on its first acquisition. K1 against its plain version on
    one block of each group (``track_blocked_mc64_<group>``)."""
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver import plans as P
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    fs1, fsg, fsb = MC64_FS["L1"], MC64_FS["G1"], MC64_FS["B1"]
    rx = Receiver(ReceiverConfig(fs=fs1, num_channels=16, int8_stream=True),
                  plans=[
                      P.gps_l1ca_plan(fs=fs1, num_channels=16,
                                      steps_per_block=1000),
                      P.galileo_e1b_plan(fs=fs1, num_channels=16,
                                         steps_per_block=250),
                      P.glonass_l1_ca_plan(fs=fsg, num_channels=16,
                                           steps_per_block=1000),
                      P.beidou_b1i_plan(fs=fsb, num_channels=16,
                                        steps_per_block=1000)])
    blocks = count_blocks(rx)
    feeds = {"L1": (caps["mc64_l1"], int(fs1)),
             "G1": (caps["mc64_g1"], int(fsg)),
             "B1": (caps["mc64_b1"], int(fsb))}
    dur, warm = 6, 2
    k1.track_blocked.launches = 0
    with record_blocks() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(dur):
            if i == warm:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            for band, (x, c) in feeds.items():
                rx.feed(x[i * c:(i + 1) * c], band=band)
            if i == 0:
                first = rx.acquire()
            rx.run()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    nb = [b[0] for b in blocks]
    n1 = k1.track_blocked.launches
    if not (all(nb) and n1 == sum(nb)):
        raise AssertionError(f"mc64: {n1} K1 launches for {nb} blocks")
    gates, ok = mc64_gates(first, rx)
    e = dict(steps_per_block=[g.plan.trk_conf.steps_per_block
                              for g in rx.groups], int8_stream=True,
             blocks=nb, k1_launches=n1, first_acquisition=gates,
             active=[len(g.active_channels()) for g in rx.groups],
             b1i_nh20_locked=len(sec_locked(rx.groups[3])),
             wall_s=t2 - t0, realtime_factor=dur / (t2 - t0),
             bench_realtime_factor=(dur - warm) / (t2 - t1))
    emit("e2e_mc64_6s_bench_settings", **e)
    if not ok:
        raise AssertionError(f"mc64 acquisition gates failed: {gates}")
    for g, n in zip(rx.groups, nb):
        entry = f"track_blocked_mc64_{g.plan.name.lower()}"
        hold_fused_block("e2e_mc64_6s_bench_settings", "track_blocked",
                         rec[("track_blocked", g.plan.table_length)],
                         kernels, entry, reps=3)
        kernels[entry]["launches"] = n
    return e


# ---- acquisition engines, tracking alternates, the conditioner -------------

IF_HZ = 250e3                   # the IF the conditioned CLI run removes
IF_TAPS = 65                    # its FIR, linear phase: (65 - 1) / 2 samples late
# phase 32's false-alarm rate per searched row: its seven runs search 32 to
# 50 rows each, so at 1e-5 a false detection comes about once in 300 calls
# (at the plans' 1e-3 it would come in one call of five)
ACQ_PFA = 1e-5


def acq_truth(src, prns, sample: float) -> dict:
    """{prn: Doppler} of ``src``'s satellites at a window's middle."""
    return {p: float(src.truth_at(p, sample)["doppler_hz"]) for p in prns}


def hold_engine(run: str, name: str, eng, ref, x: np.ndarray, prns: list,
                rows: np.ndarray, spc: int, step: float, truth: dict,
                must: set | None = None) -> dict:
    """One acquisition engine on the first window of a capture against the
    PCPS result ``ref`` on that window, timed: it detects every satellite
    of ``must`` (PCPS's detections unless given) and no satellite outside
    the scenario; where both detect, the Doppler lies within one PCPS bin
    (``step``) and the delay within one sample of PCPS's; a satellite only
    the engine detects lies within one bin of the scenario's Doppler."""
    n = getattr(eng, "win", None) or eng.conf.input_samples
    xe = np.ascontiguousarray(np.broadcast_to(x[:n], (len(rows), n)))
    res = eng.acquire(xe, rows)
    ms = cuda_ms(lambda: eng.acquire(xe, rows), 3, queue_ahead=False,
                 name=f"{name} {run}")
    det = {p for p, d in zip(prns, res.detected) if d}
    ref_det = {p for p, d in zip(prns, ref.detected) if d}
    must = ref_det if must is None else must
    idx = {p: i for i, p in enumerate(prns)}
    dop_diff = lag_diff = truth_diff = 0.0
    for p in det:
        i = idx[p]
        if p in ref_det:
            dop_diff = max(dop_diff, abs(res.doppler_hz[i]
                                         - ref.doppler_hz[i]))
            d = abs(res.delay_samples[i] - ref.delay_samples[i]) % spc
            lag_diff = max(lag_diff, min(d, spc - d))
        elif p in truth:
            truth_diff = max(truth_diff, abs(res.doppler_hz[i] - truth[p]))
    e = dict(run=run, engine=name, window=n, detected=sorted(det),
             pcps_detected=sorted(ref_det), must=sorted(must),
             missed_of_pcps=sorted(ref_det - det),
             doppler_diff_hz=dop_diff, delay_diff_samples=lag_diff,
             only_engine_truth_diff_hz=truth_diff, doppler_step_hz=step,
             ms_per_acquire=ms, rows=len(rows))
    emit("acq_engine", **e)
    if not (must <= det and det <= set(truth) and dop_diff <= step
            and lag_diff <= 1.0 and truth_diff <= step):
        raise AssertionError(f"{name} on {run} disagrees with PCPS: {e}")
    return dict(e, res=res)


def acq_engines_phase(gps_cap, gps_scen, caps) -> dict:
    """Phase 32: the acquisition engine variants on the first acquisition
    window of three captures, each against PCPS on that window
    (hold_engine), every engine and PCPS at a Pfa of ACQ_PFA: fine-Doppler (tests/test_acq_engines.py's 500 Hz coarse
    step, 4 ms coherent, 4 iterations: its Doppler within 500 / 2**4 Hz
    of the scenario's), Tong and QuickSync on gps8's; Tong, QuickSync and
    CCCWSR (4092 chips at 1.023 Mchip/s, the E1-B code without subcarrier)
    on e1b's; noncoherent I/Q on e5a's. QuickSync folds one code period
    into two halves before its search, which adds the other half's noise
    and code to each cell: on these windows its search settles on a wrong
    cell for some satellites PCPS finds (on the CPU too, where it equals
    the JAX engine), so it must find one satellite at least, and what it
    finds is held as the others are. Then measure_roc at
    tests/test_roc.py's settings, for both statistics, with its gates."""
    from gnss_sdr_tpu_torch import acquisition as A
    from gnss_sdr_tpu_torch.acquisition.roc import measure_roc
    from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1b_code
    from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
    from gnss_sdr_tpu_torch.receiver.plans import (
        galileo_e1b_plan,
        galileo_e5a_plan,
        gps_l1ca_plan,
    )

    out = {}

    def run_window(run, plan, x, src, engines):
        prns = list(plan.search_prns)
        rows = np.array([plan.prn_row(p) for p in prns])
        table = (plan.acq_code_table if plan.acq_code_table is not None
                 else plan.code_table)
        pcps = A.PcpsAcquisition(plan.acq_conf, table, prns)
        n = pcps.conf.input_samples
        xp = np.ascontiguousarray(np.broadcast_to(x[:n], (len(rows), n)))
        ref = pcps.acquire(xp, rows)
        pcps_ms = cuda_ms(lambda: pcps.acquire(xp, rows), 3,
                          queue_ahead=False, name=f"pcps {run}")
        emit("acq_engine", run=run, engine="pcps", window=n,
             detected=[p for p, d in zip(prns, ref.detected) if d],
             ms_per_acquire=pcps_ms, rows=len(rows))
        truth = acq_truth(src, list(src.prns), n / 2)
        res = {"pcps_ms": pcps_ms}
        for name, eng, eng_rows in engines:
            # QuickSync's folded search loses satellites PCPS finds (see
            # the docstring): it must find one at least
            must = set() if name == "quicksync" else None
            res[name] = hold_engine(run, name, eng, ref, x, prns,
                                    rows if eng_rows is None else eng_rows,
                                    plan.acq_conf.samples_per_code,
                                    plan.acq_conf.doppler_step_hz, truth,
                                    must)
            if not res[name]["detected"]:
                raise AssertionError(f"{name} on {run} detects nothing")
        return res, truth

    def at_pfa(plan):
        plan.acq_conf = dataclasses.replace(plan.acq_conf, pfa=ACQ_PFA)
        return plan

    # gps8
    plan = at_pfa(gps_l1ca_plan(FS, num_channels=8))
    prns = list(plan.search_prns)
    fconf = dataclasses.replace(plan.acq_conf, doppler_step_hz=500.0,
                                coherent_integration_periods=4, max_dwells=1)
    fine = A.FineDopplerAcquisition(fconf, plan.code_table, prns,
                                    iterations=4)
    res, truth = run_window("gps8", plan, gps_cap, gps_scen, [
        ("fine_doppler", fine, None),
        ("tong", A.TongAcquisition(plan.acq_conf, plan.code_table, prns),
         None),
        ("quicksync", A.QuickSyncAcquisition(plan.acq_conf, plan.code_table,
                                             prns), None)])
    fr = res["fine_doppler"]["res"]
    fine_err = max(abs(fr.doppler_hz[i] - truth[p])
                   for i, p in enumerate(prns) if fr.detected[i])
    fine_bound = fconf.doppler_step_hz / 2 ** fine.iterations
    emit("acq_fine_doppler_truth", run="gps8", max_err_hz=fine_err,
         bound_hz=fine_bound)
    if not fine_err <= fine_bound:
        raise AssertionError(f"fine Doppler {fine_err} Hz from the truth, "
                             f"bound {fine_bound}")
    out["gps8"] = {k: v["ms_per_acquire"] if isinstance(v, dict) else v
                   for k, v in res.items()}

    # e1b: Tong and QuickSync on the plan's 8184-unit sinBOC table; CCCWSR
    # on the raw E1-B chips at the chip rate (the engine builds both
    # subcarrier replicas itself)
    plan = at_pfa(galileo_e1b_plan(fs=GAL_SCENARIOS["e1b"]["fs"],
                                   num_channels=6))
    prns = list(plan.search_prns)
    cconf = dataclasses.replace(plan.acq_conf, code_length_chips=4092,
                                code_rate_cps=1.023e6)
    chips = np.stack([galileo_e1b_code(p) for p in prns])
    res, _ = run_window("e1b", plan, caps["e1b"], gal_scenario("e1b"), [
        ("tong", A.TongAcquisition(plan.acq_conf, plan.code_table, prns),
         None),
        ("quicksync", A.QuickSyncAcquisition(plan.acq_conf, plan.code_table,
                                             prns), None),
        ("cccwsr", A.CccwsrAcquisition(cconf, chips, prns),
         np.arange(len(prns)))])
    out["e1b"] = {k: v["ms_per_acquire"] if isinstance(v, dict) else v
                  for k, v in res.items()}

    # e5a: the data code (PCPS's table) on I, the pilot on Q
    plan = at_pfa(galileo_e5a_plan(fs=L5_FS, num_channels=5))
    prns = list(plan.search_prns)
    res, _ = run_window("e5a", plan, caps["e5a"], capture_source("e5a"), [
        ("noncoh_iq", A.NoncoherentIQAcquisition(
            plan.acq_conf, plan.acq_code_table, plan.code_table, prns),
         None)])
    out["e5a"] = {k: v["ms_per_acquire"] if isinstance(v, dict) else v
                  for k, v in res.items()}

    # tests/test_roc.py
    for statistic in ("max_to_input_power", "peak1_peak2"):
        conf = A.AcqConfig(fs=FS, code_length_chips=1023,
                           code_rate_cps=1.023e6, doppler_max_hz=5000.0,
                           doppler_step_hz=250.0, max_dwells=1, pfa=0.03,
                           statistic=statistic)
        t = time.perf_counter()
        roc = measure_roc(conf, gps_l1_ca_code_table(),
                          cn0_list=(35.0, 41.0, 47.0), trials=16,
                          pfa_trials=64)
        pds = [r["pd"] for r in roc["pd_curve"]]
        last = roc["pd_curve"][2]
        emit("acq_roc", **roc, seconds=time.perf_counter() - t)
        if not (roc["measured_pfa"] <= 6.5 / 64 and pds[2] >= 0.95
                and pds[2] >= pds[0] - 0.1 and last["doppler_err_hz"] <= 150.0
                and last["delay_err_samples"] <= 1.5):
            raise AssertionError(f"ROC gates failed: {roc}")
    return out


def kf_cases_phase() -> dict:
    """Phase 33: tests/test_kf_tracking.py's two cases (GPS_L1_CA_KF's
    EKF from FLL pull-in, 2.2 s at 2.6 Msps) through the port's Tracker on
    the card, where the Kalman mode runs the eager engine (K3 once a
    period), with that test's gates: the converging case's Doppler within
    3 Hz of the truth over its last 20 blocks, bit sync, NARROW and C/N0 in
    (40, 52) dB-Hz; the 8 Hz/s ramp within 5 Hz at its end."""
    from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.simulate import (
        SatelliteSignalParams,
        generate_baseband,
    )
    from gnss_sdr_tpu_torch.tracking import ChannelPhase, DllPllConf, Tracker

    sps_chip = FS / 1.023e6
    conf = DllPllConf(fs=FS, code_length_chips=1023, code_rate_cps=1.023e6,
                      carrier_freq_hz=1575.42e6, kf=True,
                      enable_fll_pull_in=True, pull_in_time_s=0.25,
                      extend_correlation_symbols=20, max_channels=4,
                      steps_per_block=20)
    rng = np.random.default_rng(21)
    cases = {
        "converges": (SatelliteSignalParams(
            prn=5, cn0_dbhz=46.0, doppler_hz=-1234.0, delay_chips=400.0,
            nav_bits=rng.choice([-1.0, 1.0], size=200),
            carrier_phase_rad=1.1), 22, 400.0 * sps_chip + 0.5, 90.0),
        "ramp": (SatelliteSignalParams(
            prn=9, cn0_dbhz=48.0, doppler_hz=500.0, doppler_rate_hz_s=8.0,
            delay_chips=100.0), 23, 100.0 * sps_chip, -60.0),
    }
    out = {}
    for name, (sat, seed, delay, dop_err) in cases.items():
        x = generate_baseband([sat], FS, int(FS * 2.2), seed=seed)
        trk = Tracker(conf, gps_l1_ca_code_table())
        trk.start_channel(ch=0, prn=sat.prn, code_row=sat.prn - 1,
                          acq_delay_samples=delay,
                          acq_doppler_hz=sat.doppler_hz + dop_err,
                          acq_samplestamp=0, current_abs_sample=0)
        k3.correlator.launches = 0
        results = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(100):
            base, w = trk.window_request()
            if base + w > len(x):
                break
            results.append(trk.process(x[base:base + w], base))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n3 = k3.correlator.launches
        if n3 != len(results) * conf.steps_per_block:
            raise AssertionError(f"KF {name}: {n3} K3 launches for "
                                 f"{len(results)} blocks")
        if name == "converges":
            dops = np.concatenate([r.outputs["carrier_doppler"][:, 0]
                                   for r in results[-20:]])
            events = [e for r in results for e in r.events]
            e = dict(doppler_err_hz=float(abs(dops.mean() - sat.doppler_hz)),
                     bit_sync=(0, "bit_sync") in events,
                     narrow=trk.ctl[0].phase == ChannelPhase.NARROW,
                     cn0_dbhz=float(trk.ctl[0].cn0_dbhz))
            ok = (len(results) >= 90 and e["doppler_err_hz"] < 3.0
                  and e["bit_sync"] and e["narrow"]
                  and 40.0 < e["cn0_dbhz"] < 52.0)
        else:
            last = results[-1]
            expect = sat.doppler_hz + 8.0 * last.abs_sample_end[-1, 0] / FS
            e = dict(doppler_err_hz=float(abs(
                last.outputs["carrier_doppler"][-1, 0] - expect)))
            ok = e["doppler_err_hz"] < 5.0
        out[name] = dict(e, blocks=len(results), k3_launches=n3,
                         wall_s=wall, realtime_factor=2.2 / wall)
        emit("kf_case", case=name, **out[name])
        if not ok:
            raise AssertionError(f"KF case {name} fails its gates: {e}")
    return out


def kf_receiver_phase(capture, scen, kernels) -> dict:
    """Phase 34: the Receiver with GPS_L1_CA_KF_Tracking's plan (the
    factory's: gps_l1ca_plan with ``kf`` set) on gps8's capture, 1 s
    feeds. The Kalman mode keeps the eager engine, so every period is one
    K3 launch. After 12 s of signal the run's whole wall is projected;
    within 150 s it goes on to 32 s and is held to the position gates,
    else it stops there and holds its locks (>= 4 channels NARROW) and
    each locked channel's Doppler within 5 Hz of the truth. K3 against
    its plain version on a period of the run (``correlator_kf``)."""
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.tracking import ChannelPhase

    plan = gps_l1ca_plan(FS, num_channels=8)
    plan.trk_conf = dataclasses.replace(plan.trk_conf, kf=True)
    rx = Receiver(ReceiverConfig(fs=FS, num_channels=8), plans=[plan])
    (blocks,) = count_blocks(rx)
    dur = int(scen.cfg.duration_s)
    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    chunk, acquired, projected = int(FS), False, None
    with record_blocks() as rec:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(dur):
            rx.feed(capture[i * chunk:(i + 1) * chunk])
            if not acquired:
                acquired = len(rx.acquire()) >= 4
            rx.run()
            if i + 1 == 12:
                torch.cuda.synchronize()
                projected = (time.perf_counter() - t) * dur / 12
                if projected > 150.0:
                    break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    fed_s = i + 1
    n1, n3 = k1.track_blocked.launches, k3.correlator.launches
    steps = plan.trk_conf.steps_per_block
    if not (blocks[0] > 0 and n1 == 0 and n3 == blocks[0] * steps):
        raise AssertionError(f"KF run: {n1} K1 and {n3} K3 launches for "
                             f"{blocks[0]} blocks")
    trk = rx.groups[0].tracker
    act = trk.active_channels()
    e = dict(signal_s=fed_s, projected_wall_s=projected, blocks=blocks[0],
             k3_launches=n3, wall_s=wall, realtime_factor=fed_s / wall)
    if fed_s == dur:
        e.update(position_gates(rx.status, scen))
    else:
        dop = trk.state.carrier_doppler.cpu().numpy()
        errs = [abs(float(dop[c]) - scen.truth_at(
            g_prn, trk.pos_abs[c])["doppler_hz"])
            for c, g_prn in ((c, rx.groups[0].channel_prn[c]) for c in act)]
        narrow = sum(trk.ctl[c].phase == ChannelPhase.NARROW for c in act)
        e.update(locked=len(act), narrow=int(narrow),
                 max_doppler_err_hz=max(errs, default=math.inf))
        if not (narrow >= 4 and e["max_doppler_err_hz"] < 5.0):
            raise AssertionError(f"KF run fails its 12 s gates: {e}")
    emit("e2e_kf_gps8", **e)
    hold_correlator_block("e2e_kf_gps8", rec["correlator"], kernels,
                          "correlator_kf")
    kernels["correlator_kf"]["launches"] = n3
    return e


def conf_cli_run(run: str, conf: Path, scen, ref_first: dict,
                 delay_offset: float = 0.0, ttff=(10.0, 32.0),
                 on_receiver=None, keep: dict | None = None) -> dict:
    """The .conf/CLI entry point on ``conf`` through K1, held to the
    position gates (first fix inside ``ttff``) and to ``ref_first``
    (phase 7's first acquisition: the same satellites, Doppler within one
    bin, delay within one sample once ``delay_offset`` samples, a
    filter's group delay, are taken off). Times each plan's loop closer
    (``after_block``) where it has one and reports its share of the wall.
    ``on_receiver(rx)`` is called as soon as the CLI has built its
    Receiver (a watcher thread may start there); ``keep`` receives the
    Receiver, every acquisition's started channels and the CLI's
    output."""
    from gnss_sdr_tpu_torch import main as cli
    from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    blocks, made, acquisitions, closer_s = [0], [], [], [0.0]
    process, init, acquire = (Tracker.process_device, Receiver.__init__,
                              Receiver.acquire)

    def counted(self, *a):
        r = process(self, *a)
        blocks[0] += 1
        return r

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)
        if on_receiver is not None:
            on_receiver(self)
        for g in self.groups:
            if g.loop_closer is not None:
                after = g.loop_closer.after_block

                def timed(*b, _after=after):
                    t = time.perf_counter()
                    _after(*b)
                    closer_s[0] += time.perf_counter() - t

                g.loop_closer.after_block = timed

    def acquired(self, *a, **kw):
        started = acquire(self, *a, **kw)
        acquisitions.append(started)
        return started

    Tracker.process_device = counted
    Receiver.__init__ = recorded
    Receiver.acquire = acquired
    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            torch.cuda.synchronize()
            t = time.perf_counter()
            status = cli.run_from_config(FileConfiguration(conf))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        Tracker.process_device = process
        Receiver.__init__ = init
        Receiver.acquire = acquire
    if keep is not None:
        keep.update(rx=made[-1], acquisitions=acquisitions,
                    stdout=out.getvalue())
    n1, n3 = k1.track_blocked.launches, k3.correlator.launches
    if not (blocks[0] > 0 and n1 == blocks[0] and n3 == 0):
        raise AssertionError(f"{run}: {n1} K1 and {n3} K3 launches for "
                             f"{blocks[0]} blocks")
    first = acquisitions[0]
    spc = made[-1].groups[0].plan.acq_conf.samples_per_code
    step = made[-1].groups[0].plan.acq_conf.doppler_step_hz
    dd = [abs(first[k][0] - ref_first[k][0]) for k in first
          if k in ref_first]
    lags = [abs(first[k][1] - delay_offset - ref_first[k][1]) % spc
            for k in first if k in ref_first]
    ld = [min(d, spc - d) for d in lags]
    e = dict(position_gates(status, scen, ttff), blocks=blocks[0],
             k1_launches=n1, first_acquired=sorted(p for _, p in first),
             phase7_first_acquired=sorted(p for _, p in ref_first),
             doppler_diff_hz=max(dd, default=0.0),
             delay_diff_samples=max(ld, default=0.0),
             delay_offset_samples=delay_offset,
             trk_engine=made[-1].groups[0].plan.trk_engine,
             closer_s=closer_s[0], closer_share=closer_s[0] / wall,
             wall_s=wall, realtime_factor=scen.cfg.duration_s / wall)
    emit(run, **e)
    if not (set(first) == set(ref_first) and e["doppler_diff_hz"] <= step
            and e["delay_diff_samples"] <= 1.0):
        raise AssertionError(f"{run}: first acquisition differs from "
                             f"phase 7's: {e}")
    return e


def gaussian_cli_phase(cap: Path, scen, ref_first, tmp: Path) -> dict:
    """Phase 35: conf/gps_l1_gaussian.conf's keys (GPS_L1_CA_Gaussian_
    Tracking: the CKF loop closer after each block) on phase 7's ibyte
    copy of gps8's capture ``cap``, through K1 (conf_cli_run)."""
    text = (ROOT / "conf" / "gps_l1_gaussian.conf").read_text().replace(
        "SignalSource.filename=./capture_l1.dat",
        f"SignalSource.filename={cap}")
    if str(cap) not in text:
        raise AssertionError("conf/gps_l1_gaussian.conf has no filename key")
    conf = tmp / "gps_l1_gaussian.conf"
    conf.write_text(text + f"SignalSource.sampling_frequency={int(FS)}\n")
    e = conf_cli_run("cli_gaussian", conf, scen, ref_first)
    if e["trk_engine"] != "gaussian":
        raise AssertionError(f"the Gaussian conf built {e['trk_engine']}")
    return e


def tcp_phase() -> dict:
    """Phase 36: tests/test_tcp_connector.py's loop on the card: the
    tracker's internal loops dead, the NCO moved only by
    SimpleLoopServer's commands over a localhost socket, with that test's
    gates (> 30 records, the 4 Hz error pulled within 2 Hz, moved by more
    than 2 Hz)."""
    from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.simulate import (
        SatelliteSignalParams,
        generate_baseband,
    )
    from gnss_sdr_tpu_torch.tracking import DllPllConf, Tracker
    from gnss_sdr_tpu_torch.tracking.tcp_connector import (
        SimpleLoopServer,
        TcpConnectorTracking,
        TcpLoopClient,
    )

    true_dop = 640.0
    sat = SatelliteSignalParams(prn=9, cn0_dbhz=48.0, doppler_hz=true_dop,
                                delay_chips=120.0)
    x = generate_baseband([sat], FS, int(FS * 1.5), seed=9)
    conf = DllPllConf(fs=FS, code_length_chips=1023, code_rate_cps=1.023e6,
                      carrier_freq_hz=1575.42e6, pll_bw_hz=1e-4,
                      dll_bw_hz=1e-5, enable_fll_pull_in=False,
                      max_channels=2, steps_per_block=10)
    srv = SimpleLoopServer(pll_bw_hz=8.0)
    tracker = Tracker(conf, gps_l1_ca_code_table())
    tracker.start_channel(ch=0, prn=9, code_row=8,
                          acq_delay_samples=120.0 * FS / 1.023e6,
                          acq_doppler_hz=true_dop - 4.0,
                          acq_samplestamp=0, current_abs_sample=0)
    tcp = TcpConnectorTracking(tracker, TcpLoopClient(port=srv.port), [0])
    k1.track_blocked.launches = 0
    dops = []
    t = time.perf_counter()
    try:
        while True:
            base, w = tracker.window_request()
            if base + w > len(x):
                break
            r = tcp.process(x[base:base + w], base)
            dops.append(float(r.outputs["carrier_doppler"][-1, 0]))
    finally:
        tcp.client.close()
        srv.close()
    e = dict(records=srv.records_seen, blocks=len(dops),
             k1_launches=k1.track_blocked.launches,
             first_doppler_hz=dops[0], last_doppler_hz=dops[-1],
             wall_s=time.perf_counter() - t)
    emit("tcp_loop", **e)
    if not (srv.records_seen > 30 and abs(dops[-1] - true_dop) < 2.0
            and abs(dops[0] - dops[-1]) > 2.0
            and k1.track_blocked.launches == len(dops)):
        raise AssertionError(f"TCP loop fails its gates: {e}")
    return e


def xlating_cli_phase(capture, scen, ref_first, tmp: Path) -> dict:
    """Phase 37a: gps8's capture moved to an IF of +250 kHz in NumPy,
    written as ibyte, through the CLI with conf/gps_l1_file.conf's keys
    and a Freq_Xlating_Fir_Filter at that IF (IF_TAPS taps, on the card),
    through K1 (conf_cli_run: the acquired delays lag phase 7's by the
    FIR's group delay)."""
    from gnss_sdr_tpu_torch.io import encode_samples

    t0 = time.perf_counter()
    cap = tmp / "capture_if.dat"
    step = 1 << 22
    with open(cap, "wb") as f:
        for s in range(0, len(capture), step):
            k = np.arange(s, min(s + step, len(capture)))
            y = capture[s:s + step] * np.exp(2j * np.pi * IF_HZ / FS * k)
            f.write(encode_samples(np.round(y * 16), "ibyte"))
    text = (ROOT / "conf" / "gps_l1_file.conf").read_text().replace(
        "SignalSource.filename=./capture_l1.dat",
        f"SignalSource.filename={cap}").replace(
        "InputFilter.implementation=Pass_Through",
        "InputFilter.implementation=Freq_Xlating_Fir_Filter\n"
        f"InputFilter.IF={int(IF_HZ)}\nInputFilter.taps_length={IF_TAPS}")
    if "Freq_Xlating" not in text or str(cap) not in text:
        raise AssertionError("conf/gps_l1_file.conf lacks the keys to edit")
    text += "".join(f"PVT.{k}={tmp / v}\n" for k, v in (
        ("kml_dump_filename", "pvt_if.kml"),
        ("rinex_obs_filename", "obs_if.rnx"),
        ("rinex_nav_filename", "nav_if.rnx")))
    conf = tmp / "gps_l1_if.conf"
    conf.write_text(text)
    emit("cli_if_capture", seconds=time.perf_counter() - t0, if_hz=IF_HZ,
         bytes=cap.stat().st_size)
    return conf_cli_run("cli_freq_xlating", conf, scen, ref_first,
                        delay_offset=(IF_TAPS - 1) / 2)


def conditioner_stages_phase(capture) -> dict:
    """Phase 37b: 1 s of gps8's capture (with a CW tone and pulses added)
    through each conditioner stage on the card and on the CPU: the FIR
    with decimation 2, the notch, pulse blanking, both resamplers (2.6 to
    2.046 Msps) and a 4-element beamformer (the capture with per-element
    steering phases); each within 1e-5 of the CPU output's largest sample
    (the direct resampler and pulse blanking equal), timed on the card."""
    from gnss_sdr_tpu_torch import conditioner as tc

    x = capture[:int(FS)].astype(np.complex64)
    x = x + (3.0 * np.exp(2j * np.pi * 0.11 * np.arange(x.size))).astype(
        np.complex64)
    x[::9973] *= 40.0
    taps = tc.design_fir(65, FS, (0.0, 0.45 * FS / 2)).astype(np.float32)
    ratio = FS / 2.046e6
    n_out = int((x.size - 10) / ratio)
    w = tc.steering_weights(4, 0.5, 20.0)
    xs = np.stack([x * np.conj(w[k]) * 2.0 for k in range(4)])
    stages = {
        "fir_decim2": lambda v, d: tc.fir_apply(v, torch.as_tensor(
            taps, device=d), 2),
        "notch": lambda v, d: tc.notch_filter_block(v),
        "pulse_blanking": lambda v, d: tc.pulse_blanking_block(v),
        "direct_resample": lambda v, d: tc.direct_resample(v, ratio, n_out),
        "polyphase_resample": lambda v, d: tc.polyphase_resample(
            v, ratio, n_out, 4.0),
    }
    out = {}
    for name, fn in stages.items():
        a = fn(torch.as_tensor(x), "cpu").numpy()
        xd = torch.as_tensor(x, device="cuda")
        b = fn(xd, "cuda").cpu().numpy()
        ms = cuda_ms(lambda: fn(xd, "cuda"), 5, name=f"conditioner {name}")
        err = float(np.abs(a - b).max() / np.abs(a).max())
        exact = name in ("direct_resample", "pulse_blanking")
        out[name] = dict(rel_err=err, ms=ms, samples=x.size)
        emit("conditioner_stage", stage=name, **out[name])
        if not (a.shape == b.shape and (np.array_equal(a, b) if exact
                                        else err <= 1e-5)):
            raise AssertionError(f"conditioner {name}: card and CPU "
                                 f"disagree ({err})")
    a = tc.Beamformer(w, device="cpu").process(xs)
    bf = tc.Beamformer(w)
    b = bf.process(xs)
    err = float(np.abs(a - b).max() / np.abs(a).max())
    out["beamformer"] = dict(rel_err=err, elements=4,
                             gain_vs_element=float(np.abs(b).mean()
                                                   / np.abs(xs[0]).mean()))
    emit("conditioner_stage", stage="beamformer", **out["beamformer"])
    if not err <= 1e-5:
        raise AssertionError(f"beamformer: card and CPU disagree ({err})")
    return out


# the JAX tracker's host dtypes for a dump file's arrays (its unpacker
# widens integer leaves to int64; tests/test_torch_host_options.py holds
# the port's files to the JAX package's)
DUMP_DTYPES = {"prompt": np.complex64, "taps": np.complex64,
               "boundary": np.bool_, "acc_prompt": np.complex64,
               "acc_samples": np.int64, "carrier_doppler": np.float32,
               "code_freq": np.float64, "carrier_phase": np.float64,
               "rem_code_phase": np.float64, "n_samples": np.int64,
               "abs_sample_end": np.int64}


def check_dumps(run: str, trk: Path, acq: Path, periods: int,
                channels: int, attempts: int) -> dict:
    """A run's tracking and acquisition dump files: the JAX dump's keys
    and dtypes, ``periods`` x ``channels`` rows (the blocks times K), one
    acquisition row per PRN searched; raises if not."""
    t = np.load(trk)
    a = np.load(acq)["acquisitions"]
    bad = {k: str(t[k].dtype) for k in t.files
           if t[k].dtype != DUMP_DTYPES.get(k)}
    e = dict(tracking_keys=sorted(t.files), tracking_bytes=trk.stat().st_size,
             periods=int(t["prompt"].shape[0]),
             channels=int(t["prompt"].shape[1]), want_periods=periods,
             acquisition_rows=len(a), want_rows=attempts,
             acquisition_fields=list(a.dtype.names), wrong_dtypes=bad)
    if not (sorted(t.files) == sorted(DUMP_DTYPES) and not bad
            and all(t[k].shape[:2] == (periods, channels) for k in t.files)
            and len(a) == attempts and a.dtype.names[0] == "prn"):
        raise AssertionError(f"{run}: dump files {e}")
    return e


def count_attempts(rx, attempts: list) -> None:
    """Adds to ``attempts[0]`` the PRNs that each acquisition of ``rx``'s
    first group searches: one acquisition-dump row each."""
    g = rx.groups[0]
    acquire = g.acq.acquire

    def counted(x, rows, *a, **kw):
        attempts[0] += len(rows)
        return acquire(x, rows, *a, **kw)

    g.acq.acquire = counted


def dyn_pvtkf_phase(capture, scen, tmp: Path) -> dict:
    """Phase 38, gps8-dyn-pvtkf: tests/test_dynamic.py's moving receiver
    (12/-8 m/s ENU, 6 channels, 32 s, seed 1) with the PVT Kalman filter
    (``enable_pvt_kf``; not the tracking Kalman mode of phase 34) and
    ``carrier_smoothing_epochs=100``, 1 s feeds, through K1, with the
    tracking and acquisition dumps on (``plan.dump_filename``,
    ``plan.acq_dump_filename``). Gates: the test's (>= 8 fixes, 3D
    position RMSE < 10 m and velocity RMSE < 1 m/s over fixes[3:]); K1
    once a block; the dump files with the JAX dump's keys and dtypes, the
    blocks times K periods and one acquisition row per PRN searched."""
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    plan = gps_l1ca_plan(FS, num_channels=6)
    plan.dump_filename = str(tmp / "tracking_dyn.npz")
    plan.acq_dump_filename = str(tmp / "acquisition_dyn.npz")
    rx = Receiver(ReceiverConfig(fs=FS, num_channels=6, enable_pvt_kf=True,
                                 carrier_smoothing_epochs=100), plans=[plan])
    attempts = [0]
    count_attempts(rx, attempts)
    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    wall, blocks = drive_receiver(rx, capture, FS)
    n1, n3 = k1.track_blocked.launches, k3.correlator.launches
    t = time.perf_counter()
    rx.close()
    flush_s = time.perf_counter() - t
    if not (blocks > 0 and n1 == blocks and n3 == 0):
        raise AssertionError(f"gps8-dyn-pvtkf: {n1} K1 and {n3} K3 "
                             f"launches for {blocks} blocks")
    fixes = rx.status.fixes
    pos = [np.linalg.norm(f.pos_ecef - scen.rx_ecef_at(
        f.tow_s - scen.cfg.tow_start_s)) for f in fixes[3:]]
    vel = [np.linalg.norm(f.vel_ecef - scen.rx_vel_ecef) for f in fixes[3:]]
    e = dict(fixes=len(fixes), pvt_kf=type(rx.pvt_kf).__name__,
             pos_rmse_3d_m=float(np.sqrt(np.mean(np.square(pos))))
             if pos else math.inf,
             vel_rmse_3d_mps=float(np.sqrt(np.mean(np.square(vel))))
             if vel else math.inf,
             ttff_s=rx.status.ttff_s, blocks=blocks, k1_launches=n1,
             dump_flush_s=flush_s, wall_s=wall,
             realtime_factor=scen.cfg.duration_s / wall)
    e.update(check_dumps("gps8-dyn-pvtkf", tmp / "tracking_dyn.npz",
                         tmp / "acquisition_dyn.npz",
                         blocks * plan.trk_conf.steps_per_block, 6,
                         attempts[0]))
    emit("e2e_gps8_dyn_pvtkf", **e)
    if not (e["fixes"] >= 8 and e["pos_rmse_3d_m"] < 10.0
            and e["vel_rmse_3d_mps"] < 1.0):
        raise AssertionError(f"gps8-dyn-pvtkf gates failed: {e}")
    return e


# phase 39's gates on the PPP-refined fixes, mean 2D and 3D m over
# fixes[3:]: the JAX package's _refine_ppp gives 6.034 / 13.84 m on this
# run's sequence (replayed on the CPU through both packages, bit-equal to
# the port's fixes on the card), where phase 17's LS fixes give 0.81 /
# 1.96 m; phase 17's own gates (2 / 5 m) are out of the reference's
# reach on 4 dual-band satellites over 32 s (ROADMAP section 3)
PPP_GATES = (6.1, 13.9)
# tests/test_tides.py:89-99's ocean-loading table (station WTZR)
BLQ_WTZR = """$$ Ocean loading displacement
$$ COMMENT
  WTZR
$$ M2 S2 N2 K2 K1 O1 P1 Q1 MF MM SSA
  .00325 .00112 .00069 .00031 .00117 .00087 .00039 .00017 .00009 .00005 .00004
  .00103 .00036 .00023 .00010 .00026 .00013 .00009 .00003 .00002 .00001 .00001
  .00049 .00017 .00011 .00005 .00052 .00039 .00017 .00008 .00003 .00002 .00001
   -54.3  -27.9  -74.0  -25.5  -58.9  -96.0  -60.8 -131.0    6.1    3.4    1.9
    72.5  105.1   52.1  106.5   43.0   27.0   41.7   17.9 -170.8 -176.3 -179.4
    88.0  118.8   68.7  119.5  -27.4  -54.1  -29.0  -79.7    6.6    1.7    0.8
"""


def write_ppp_replay(path: Path, seq: list, wavelengths: list) -> None:
    """Phase 39's sequence as gzipped JSON: per epoch the LS fix, its
    clock bias, t_rx, the usable observation rows, the keys of their
    ephemerides (an index into one table of distinct ephemerides, each
    with its dataclass's module under the package and its name) and the
    PPP-refined fix; the observables channels' wavelengths beside it."""
    import gzip

    table, index = [], {}

    def eph_ref(v):
        rec = [type(v).__module__.split(".", 1)[1], type(v).__name__,
               {k: (x.item() if isinstance(x, np.generic) else x)
                for k, x in dataclasses.asdict(v).items()}]
        key = json.dumps(rec, sort_keys=True)
        if key not in index:
            index[key] = len(table)
            table.append(rec)
        return index[key]

    def row(o):
        return {k: (x.item() if isinstance(x, np.generic) else x)
                for k, x in dataclasses.asdict(o).items()}

    epochs = [dict(ls_pos=q["ls_pos"].tolist(),
                   clock_bias_s=float(q["clock_bias_s"]),
                   t_rx=float(q["t_rx"]),
                   ephemerides=[[k[0], int(k[1]), eph_ref(v)]
                                for k, v in sorted(q["ephemerides"].items())],
                   rows=[row(o) for o in q["rows"]],
                   ppp_pos=q["ppp_pos"].tolist()) for q in seq]
    with gzip.open(path, "wt") as f:
        json.dump(dict(wavelengths=[float(w) for w in wavelengths],
                       ephemerides=table, epochs=epochs), f)


def ppp_phase(caps, ref: dict, tmp: Path) -> dict:
    """Phase 39, l1l5-ppp: phase 17's L1 + L5 receiver on its capture
    with positioning_mode="PPP_Static", earth_tide=2 (solid, pole and
    ocean tides), phwindup and the BLQ table of tests/test_tides.py read
    by the port's ``read_blq``, through K1; idle L5 channels re-acquired
    after each feed (the filter needs 4 satellites on both bands, and
    phase 17's loop stops acquiring at 3 on L5). Gates: the PPP filter
    refined epochs, every one valid; as many fixes as phase 17 (``ref``);
    the refined fixes within PPP_GATES over fixes[3:]. Each epoch's LS
    and PPP errors are reported side by side, and the run's (LS fix,
    observations, ephemerides, t_rx) sequence is saved under chiprun_out/
    for a replay through both packages' ``_refine_ppp``
    (tests/test_torch_host_options.py holds a copy)."""
    from gnss_sdr_tpu_torch.pvt.coords import ecef_to_enu
    from gnss_sdr_tpu_torch.pvt.tides import read_blq

    blq_path = tmp / "wtzr.blq"
    blq_path.write_text(BLQ_WTZR)
    blq = read_blq(blq_path, "WTZR")
    scen = gal_scenario("dual_l1")
    epochs, valid, ppp_s, seq = [0], [0], [0.0], []

    def watch(rx):
        process, refine = rx.ppp.process_epoch, rx._refine_ppp

        def counted(*a, **kw):
            t = time.perf_counter()
            psol = process(*a, **kw)
            ppp_s[0] += time.perf_counter() - t
            epochs[0] += 1
            valid[0] += bool(psol.valid)
            return psol

        def refined(sol, usable, t_rx):
            ls = sol.pos_ecef.copy()
            # the ephemerides of this epoch (an L5 satellite's key may
            # hold the CNAV or the LNAV ephemeris, whichever came last)
            ephs = {k: dataclasses.replace(v)
                    for k, v in rx.ephemerides.items()
                    if k in {(o.system, o.prn) for o in usable}}
            seq.append(dict(ls_pos=ls, clock_bias_s=sol.clock_bias_s,
                            t_rx=t_rx, ephemerides=ephs,
                            rows=[dataclasses.replace(o) for o in usable]))
            refine(sol, usable, t_rx)
            seq[-1]["ppp_pos"] = sol.pos_ecef.copy()

        rx.ppp.process_epoch = counted
        rx._refine_ppp = refined

    rx, nb, n1, wall, _ = dual_band_run(
        caps, reacquire=True, on_receiver=watch,
        positioning_mode="PPP_Static", earth_tide=2, phwindup=True, blq=blq)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    write_ppp_replay(ROOT / "chiprun_out" / "l1l5_ppp_replay.json.gz", seq,
                     [c.wavelength_m for c in rx.obs.ch])
    lat = np.deg2rad(scen.cfg.rx_lat_deg)
    lon = np.deg2rad(scen.cfg.rx_lon_deg)

    def err(p):
        enu = ecef_to_enu(p - scen.rx_ecef, lat, lon)
        return float(np.hypot(enu[0], enu[1])), float(np.linalg.norm(enu))

    side = [(*err(q["ls_pos"]), *err(q["ppp_pos"])) for q in seq]
    ls = np.array([r[:2] for r in side[3:]]).reshape(-1, 2)
    enu = enu_errors(rx.status.fixes[3:], scen)
    e = dict(fixes=len(rx.status.fixes), phase17_fixes=ref["fixes"],
             l5_prns=rx.groups[1].channel_prn,
             ppp_mode=rx.ppp.mode, oload=rx.ppp.oload is blq,
             ppp_epochs=epochs[0], ppp_valid=valid[0],
             ppp_ms_per_epoch=1e3 * ppp_s[0] / max(epochs[0], 1),
             ppp_share=ppp_s[0] / wall,
             refine_calls=len(seq),
             mean_2d_m=float(np.hypot(enu[:, 0], enu[:, 1]).mean())
             if len(enu) else math.inf,
             mean_3d_m=float(np.linalg.norm(enu, axis=1).mean())
             if len(enu) else math.inf,
             ls_mean_2d_m=float(ls[:, 0].mean()) if len(ls) else math.inf,
             ls_mean_3d_m=float(ls[:, 1].mean()) if len(ls) else math.inf,
             phase17_mean_2d_m=ref["mean_2d_m"],
             phase17_mean_3d_m=ref["mean_3d_m"], gates_m=PPP_GATES,
             ls_vs_ppp_2d_3d_m=[[round(v, 4) for v in r] for r in side[::10]],
             blocks_l1=nb[0], blocks_l5=nb[1], k1_launches=n1, wall_s=wall,
             realtime_factor=scen.cfg.duration_s / wall)
    emit("e2e_l1l5_ppp", **e)
    if not (epochs[0] > 0 and valid[0] == epochs[0]
            and e["fixes"] == ref["fixes"]
            and e["mean_2d_m"] < PPP_GATES[0]
            and e["mean_3d_m"] < PPP_GATES[1]):
        raise AssertionError(f"l1l5-ppp gates failed: {e}")
    return e


def osnma_phase(capture, scen, ref: dict) -> dict:
    """Phase 40, e1b-osnma: phase 12's E1-B receiver on its capture with
    ``osnma=True`` and ``osnma_strict=True``, through K1. The capture
    carries no signer, so no satellite authenticates. Gates: the same
    decoded pages and ephemerides as phase 12 (``ref``); the OSNMA manager
    anchored every Galileo channel the observables anchored (>= 4); zero
    fixes, since the strict filter drops every unauthenticated Galileo
    satellite and the run is Galileo only. Reports the OSNMA fields the
    manager received (none is a valid outcome on an unsigned capture)."""
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import galileo_e1b_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    fs = scen.cfg.fs
    rx = Receiver(ReceiverConfig(fs=fs, num_channels=6, osnma=True,
                                 osnma_strict=True),
                  plans=[galileo_e1b_plan(fs=fs, num_channels=6)])
    fields, push = [0], rx.osnma.push_fields

    def counted(gch, prn, week, eph, flds):
        fields[0] += len(flds)
        return push(gch, prn, week, eph, flds)

    rx.osnma.push_fields = counted
    k1.track_blocked.launches = 0
    wall, blocks = drive_receiver(rx, capture, fs)
    n1 = k1.track_blocked.launches
    anchored = sorted(c for c, st in enumerate(rx.obs.ch) if st.anchored)
    e = dict(subframes=rx.status.subframes,
             phase12_subframes=ref["subframes"],
             ephemeris_keys=sorted(rx.ephemerides),
             obs_anchored=anchored, osnma_anchored=sorted(rx.osnma._anchor),
             osnma_fields=fields[0], authenticated=sorted(rx.osnma.auth_ok),
             kroot_verified=rx.osnma.rx.kroot_verified,
             fixes=len(rx.status.fixes), blocks=blocks, k1_launches=n1,
             wall_s=wall, realtime_factor=scen.cfg.duration_s / wall)
    emit("e2e_e1b_osnma", **e)
    if not (blocks > 0 and n1 == blocks
            and e["subframes"] == ref["subframes"]
            and [list(k) for k in e["ephemeris_keys"]]
            == [list(k) for k in ref["ephemeris_keys"]]
            and len(anchored) >= 4 and set(anchored) <= set(rx.osnma._anchor)
            and e["fixes"] == 0):
        raise AssertionError(f"e1b-osnma gates failed: {e}")
    return e


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _status_reply(conn) -> str:
    """One ``status`` reply of the telecommand server: up to its fix
    line."""
    buf = b""
    while b"fix:" not in buf or not buf.endswith(b"\r\n"):
        data = conn.recv(4096)
        if not data:
            break
        buf += data
    return buf.decode()


def ctl_cli_phase(gps_conf: Path, scen, ref_first: dict, tmp: Path) -> dict:
    """Phase 41, gps8-ctl: conf/gps_l1_file.conf's keys (phase 7's conf on
    its ibyte copy of gps8's capture) through the CLI twice, through K1,
    with the control plane on.

    Run A, cold: ``GNSS-SDR.assistance_xml`` names a missing file, which
    the run writes at its end; the telecommand server on a free port with
    a client thread that sends ``status`` once at once (a row per channel,
    ``fix: none``) and once after the first fix (a ``fix: lat`` line);
    SUPL against 127.0.0.1 on a closed port; the tracking and acquisition
    dumps. Run B, warm: run A's XML loaded; a command FIFO with a writer
    thread that sends ``reset`` once the receiver has its first fix.

    Gates: run A meets phase 7's gates and first acquisition; prints
    ``SUPL assistance failed``; its XML holds every ephemeris it decoded;
    its dumps load as phase 38's. Run B's TTFF is below run A's and below
    17 s (tests/test_ttff.py's bound); after the reset it has no channel
    left, acquires again and fixes again before the end; its fixes meet
    the position gates. The threads read only host state (the channel
    controls, PRNs and fixes); the reset is applied on the main thread
    between blocks."""
    import socket
    import stat
    import threading

    from gnss_sdr_tpu_torch.receiver import telecommand
    from gnss_sdr_tpu_torch.receiver.assistance import load_assistance

    base = gps_conf.read_text()
    xml = tmp / "assist.xml"
    port = _free_port()
    common = f"GNSS-SDR.assistance_xml={xml}\n"
    conf_a = tmp / "ctl_a.conf"
    conf_a.write_text(base + common + "".join(f"{k}={v}\n" for k, v in (
        ("GNSS-SDR.telecommand_enabled", "true"),
        ("GNSS-SDR.telecommand_tcp_port", port),
        ("GNSS-SDR.SUPL_gps_enabled", "true"),
        ("GNSS-SDR.SUPL_gps_ephemeris_server", "127.0.0.1"),
        ("GNSS-SDR.SUPL_gps_ephemeris_port", _free_port()),
        ("Tracking_1C.dump", "true"),
        ("Tracking_1C.dump_filename", tmp / "tracking_1C.npz"),
        ("Acquisition_1C.dump", "true"),
        ("Acquisition_1C.dump_filename", tmp / "acquisition_1C.npz"))))
    done = threading.Event()
    replies: dict = {}
    attempts = [0]

    def client(rx):
        while not done.is_set():
            try:
                conn = socket.create_connection(("127.0.0.1", port),
                                                timeout=10)
                break
            except OSError:
                time.sleep(0.05)
        else:
            return
        with conn:
            conn.recv(128)                          # banner
            conn.sendall(b"status\n")
            replies["early"] = _status_reply(conn)
            while not rx.status.fixes and not done.is_set():
                time.sleep(0.05)
            conn.sendall(b"status\n")
            replies["after_fix"] = _status_reply(conn)
            conn.sendall(b"exit\n")

    threads = []

    def start(target, prepare=None):
        def on_receiver(rx):
            if prepare is not None:
                prepare(rx)
            th = threading.Thread(target=target, args=(rx,), daemon=True)
            threads.append(th)
            th.start()
        return on_receiver

    keep_a: dict = {}
    try:
        a = conf_cli_run("cli_ctl_cold", conf_a, scen, ref_first,
                         on_receiver=start(
                             client, lambda rx: count_attempts(rx, attempts)),
                         keep=keep_a)
    finally:
        done.set()
        for th in threads:
            th.join(timeout=10)
    rx_a = keep_a["rx"]
    early = replies.get("early", "")
    rows = [ln for ln in early.splitlines() if ln.strip().split()[1:2]
            == [rx_a.groups[0].plan.name]]
    saved = load_assistance(xml)
    decoded = sorted(rx_a.ephemerides)
    e = dict(run_a_ttff_s=a["ttff_s"], run_a_fixes=a["fixes"],
             run_a_factor=a["realtime_factor"],
             status_rows=len(rows),
             early_fix_none="fix: none" in early,
             after_fix_line=next((ln for ln in replies.get(
                 "after_fix", "").splitlines() if ln.startswith("fix:")),
                 None),
             supl_failed=[ln for ln in keep_a["stdout"].splitlines()
                          if ln.startswith("SUPL assistance failed")],
             xml_ephemerides=sorted(saved["ephemerides"]),
             decoded_ephemerides=decoded)
    e["dumps"] = check_dumps(
        "cli_ctl_cold", tmp / "tracking_1C.npz", tmp / "acquisition_1C.npz",
        a["blocks"] * rx_a.groups[0].plan.trk_conf.steps_per_block,
        rx_a.groups[0].plan.num_channels, attempts[0])
    if not (len(rows) == 8 and e["early_fix_none"]
            and (e["after_fix_line"] or "").startswith("fix: lat")
            and e["supl_failed"] and decoded
            and e["xml_ephemerides"] == decoded):
        emit("cli_ctl", **e)
        raise AssertionError(f"gps8-ctl run A gates failed: {e}")

    # run B, warm, with a command FIFO and a reset after the first fix
    fifo = tmp / "cmd.fifo"
    conf_b = tmp / "ctl_b.conf"
    conf_b.write_text(base + common + f"GNSS-SDR.command_fifo={fifo}\n")
    done.clear()
    threads.clear()
    applied: list = []
    dispatch = telecommand.dispatch_command

    def recorded(receiver, cmd):
        g = receiver.groups[0]
        before = len(g.active_channels())
        dispatch(receiver, cmd)
        applied.append(dict(cmd=cmd, active_before=before,
                            active_after=len(g.active_channels()),
                            fixes=len(receiver.status.fixes),
                            stream_s=receiver._stream_end / FS))

    def writer(rx):
        while not done.is_set() and not (
                fifo.exists() and stat.S_ISFIFO(fifo.stat().st_mode)
                and rx.status.fixes):
            time.sleep(0.05)
        if done.is_set():
            return
        fd = os.open(fifo, os.O_WRONLY)
        os.write(fd, b"reset\n")
        os.close(fd)

    telecommand.dispatch_command = recorded
    keep_b: dict = {}
    try:
        b = conf_cli_run("cli_ctl_warm", conf_b, scen, ref_first,
                         ttff=(0.0, 17.0), on_receiver=start(writer),
                         keep=keep_b)
    finally:
        telecommand.dispatch_command = dispatch
        done.set()
        for th in threads:
            th.join(timeout=10)
    rx_b = keep_b["rx"]
    reset = applied[0] if applied else {}
    e.update(run_b_ttff_s=b["ttff_s"], run_b_fixes=b["fixes"],
             run_b_factor=b["realtime_factor"], reset=reset,
             acquisitions_b=len(keep_b["acquisitions"]),
             reacquired=[sorted(p for _, p in s)
                         for s in keep_b["acquisitions"][1:] if s],
             active_at_end=len(rx_b.groups[0].active_channels()),
             fixes_after_reset=len(rx_b.status.fixes) - reset.get(
                 "fixes", len(rx_b.status.fixes)),
             fifo_removed=not fifo.exists())
    emit("cli_ctl", **e)
    if not (b["ttff_s"] < a["ttff_s"] and b["ttff_s"] < 17.0
            and [x["cmd"] for x in applied] == ["reset"]
            and reset["active_before"] > 0 and reset["active_after"] == 0
            and e["active_at_end"] >= 4 and e["fixes_after_reset"] > 0
            and e["fifo_removed"]):
        raise AssertionError(f"gps8-ctl gates failed: {e}")
    return e


def start_ttff_trials():
    """Phase 42's ``ttff`` trials of seed 1, cold over the tool's 32 s and
    warm over tests/test_ttff.py's 17 s (the tool's own warm trial stops at
    12 s, before this seed's warm fix: ROADMAP section 3), one worker
    process each, started before the Galileo captures so that the trials'
    signal generation overlaps the capture pool, where the main process
    measures nothing on the card. Returns the pool and the pending
    results; the pool's exit handler stops its workers if a phase fails
    first."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(2)
    return pool, (time.perf_counter(), pool.map_async(
        ttff_trial, [(False, 32.0), (True, 17.0)], chunksize=1))


def tools_phase(ttff_pool, ttff_pending) -> dict:
    """Phase 42, the port's tools on the card: ``front_end_cal.calibrate``
    on tests/test_aux.py's case (a 3210 Hz LO error; within 60 Hz, RMS
    residual < 60 Hz); ``bench_micro`` at a few repetitions (the seven
    benches, every row positive); ``ttff``'s trials from
    ``start_ttff_trials`` (both fix, warm below cold and below 17 s; the
    receiver through K1 in each). Their lines are printed."""
    from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig
    from gnss_sdr_tpu_torch.tools import bench_micro, front_end_cal

    scen = GpsScenario(ScenarioConfig(fs=FS, tow_start_s=7314.0,
                                      duration_s=0.2, cn0_dbhz=46.0,
                                      max_sats=8, seed=2))
    x = scen.generate(0, int(0.12 * FS))
    x = (x * np.exp(2j * np.pi * 3210.0 * np.arange(len(x)) / FS)).astype(
        np.complex64)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cal = front_end_cal.calibrate(x, FS, scen.ephs, scen.rx_ecef, 7314.0)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t
    fe = dict(ok=cal["ok"], f_offset_hz=cal.get("f_offset_hz"),
              ppm=cal.get("ppm"), resid_rms_hz=cal.get("resid_rms_hz"),
              prns=[r[0] for r in cal["rows"]], seconds=cal_s)
    emit("tool_front_end_cal", **fe)
    if not (cal["ok"] and abs(cal["f_offset_hz"] - 3210.0) < 60.0
            and cal["resid_rms_hz"] < 60.0):
        raise AssertionError(f"front_end_cal gates failed: {fe}")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = bench_micro.run(reps=5)
    print(out.getvalue(), end="", flush=True)
    names = {b.__name__ for b in bench_micro.ALL}
    bm = dict(rows=len(rows), benches=len(names),
              positive=all(r["value"] > 0 for r in rows))
    emit("tool_bench_micro", **bm)
    if not (len(names) == 7 and rows and bm["positive"]):
        raise AssertionError(f"bench_micro gates failed: {bm}")

    t0, pending = ttff_pending
    t = time.perf_counter()
    with ttff_pool:
        (cold, n_cold, w_cold), (warm, n_warm, w_warm) = pending.get(
            timeout=600)
    tt = dict(lines=[f"cold trial 0: TTFF {cold} s  (wall {w_cold:.0f} s)",
                     f"warm trial 0: TTFF {warm} s  (wall {w_warm:.0f} s)"],
              cold_ttff_s=cold, warm_ttff_s=warm,
              k1_launches=[n_cold, n_warm], since_start_s=t - t0,
              waited_s=time.perf_counter() - t)
    emit("tool_ttff", **tt)
    if not (cold is not None and warm is not None and warm < cold
            and warm < 17.0 and n_cold > 0 and n_warm > 0):
        raise AssertionError(f"ttff gates failed: {tt}")
    return dict(front_end_cal=fe, ttff=tt, bench_micro=rows)


def start_acquired(trk, plan, res, prns: list) -> list:
    """Start ``trk``'s channels on the strongest detections of ``res``
    (PCPS over ``prns`` on the capture's first samples), one channel a
    detection; returns the PRNs started."""
    order = [i for i in np.argsort(-res.test_statistic) if res.detected[i]]
    started = []
    for ch, i in enumerate(order[:plan.num_channels]):
        trk.start_channel(ch, prn=prns[i], code_row=plan.prn_row(prns[i]),
                          acq_delay_samples=float(res.delay_samples[i]),
                          acq_doppler_hz=float(res.doppler_hz[i]),
                          acq_samplestamp=0, current_abs_sample=0)
        started.append(prns[i])
    return started


def run_tracker(trk, capture: np.ndarray, blocks: int) -> tuple:
    """``blocks`` blocks of ``trk`` over the capture from its window
    requests; (BlockResults, wall s)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = []
    for _ in range(blocks):
        base, w = trk.window_request()
        out.append(trk.process(capture[base:base + w], base))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def assert_blocks_equal(run: str, a: list, b: list) -> None:
    """Two runs' BlockResults bit for bit: every output, every absolute
    sample stamp and every FSM event."""
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        for k, v in x.outputs.items():
            if not np.array_equal(v, y.outputs[k]):
                raise AssertionError(f"{run}: block {i} output {k} differs")
        if not (np.array_equal(x.abs_sample_end, y.abs_sample_end)
                and x.events == y.events):
            raise AssertionError(f"{run}: block {i} stamps or events differ")


def sharded_tracker_phase(capture, kernels) -> dict:
    """Phase 43: the gps8 plan's Tracker on the mesh (cuda:0, cuda:0)
    against the same Tracker unsharded, both started from one PCPS
    acquisition on the gps8 capture's first samples, over 101 blocks
    (2.02 s): every per-period output, sample stamp and FSM event
    bit-equal (each channel's arithmetic is its own and each shard of 4
    channels launches K1 with the unsharded launch's cluster size), K1
    launched twice a block. One shard's K1 block is held to its plain
    version (``track_blocked_shard2``). Then 3 blocks under
    ``GNSS_SDR_TPU_FUSED=perchannel``: K2 twice a block, bit-equal to K2
    unsharded, one shard's block held to its plain version
    (``track_full_shard2``)."""
    from gnss_sdr_tpu_torch.acquisition import PcpsAcquisition
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.parallel import make_channel_mesh
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    plan = gps_l1ca_plan(FS, num_channels=8)
    prns = list(plan.search_prns)
    acq = PcpsAcquisition(plan.acq_conf, plan.code_table, prns,
                          device="cuda")
    n = plan.acq_conf.input_samples
    res = acq.acquire(np.broadcast_to(capture[:n], (len(prns), n)),
                      np.array([plan.prn_row(p) for p in prns]))
    mesh = make_channel_mesh(["cuda:0", "cuda:0"])
    blocks = 101

    def tracker(sharded: bool):
        trk = Tracker(plan.trk_conf, plan.code_table, device="cuda",
                      mesh=mesh if sharded else None)
        return trk, start_acquired(trk, plan, res, prns)

    trk1, started = tracker(False)
    if len(started) < 4:
        raise AssertionError(f"sharded tracker: {len(started)} detections")
    k1.track_blocked.launches = 0
    ref, wall1 = run_tracker(trk1, capture, blocks)
    n_ref = k1.track_blocked.launches
    trk2, _ = tracker(True)
    k1.track_blocked.launches = 0
    with record_blocks() as rec:
        got, wall2 = run_tracker(trk2, capture, blocks)
    n_sh = k1.track_blocked.launches
    if not (n_ref == blocks and n_sh == 2 * blocks):
        raise AssertionError(f"sharded tracker: K1 launches {n_ref} "
                             f"unsharded, {n_sh} sharded, {blocks} blocks")
    assert_blocks_equal("sharded tracker (K1)", ref, got)
    locked = len(trk2.active_channels())
    hold_fused_block("gps8_shard2", "track_blocked", rec["track_blocked"],
                     kernels, "track_blocked_shard2")
    kernels["track_blocked_shard2"]["launches"] = n_sh

    with fused_engine("perchannel"):
        trk3, _ = tracker(False)
        trk4, _ = tracker(True)
    k2.track_full.launches = 0
    ref2, _ = run_tracker(trk3, capture, 3)
    k2.track_full.launches = 0
    with record_blocks() as rec2:
        got2, _ = run_tracker(trk4, capture, 3)
    n_k2 = k2.track_full.launches
    if n_k2 != 6:
        raise AssertionError(f"sharded tracker: {n_k2} K2 launches, want 6")
    assert_blocks_equal("sharded tracker (K2)", ref2, got2)
    hold_fused_block("gps8_shard2_perchannel", "track_full",
                     rec2["track_full"], kernels, "track_full_shard2")
    kernels["track_full_shard2"]["launches"] = n_k2
    e = dict(mesh=[str(d) for d in mesh.devices], prns=started,
             blocks=blocks, signal_s=blocks * 0.02, locked=locked,
             k1_launches_unsharded=n_ref, k1_launches_sharded=n_sh,
             k2_launches_sharded=n_k2, bit_equal=True,
             wall_unsharded_s=wall1, wall_sharded_s=wall2,
             ms_per_block_unsharded=wall1 * 1e3 / blocks,
             ms_per_block_sharded=wall2 * 1e3 / blocks)
    emit("sharded_tracker_gps8", **e)
    return e


def sharded_receiver_phase(drive, capture, scen, phase6: dict,
                           kernels) -> dict:
    """Phase 44: phase 6's 32 s gps8 run with ``num_devices=1``: the
    Receiver's one-shard mesh on cuda:0 goes to the Tracker, PCPS and the
    assisted engine (a shard on the Tracker's own card runs the engine on
    the whole state, with nothing split or gathered), held
    to phase 6's gates (mean 2D < 2 m, 3D < 5 m), its realtime factor
    beside phase 6's from this call; K1 once a block, held to its plain
    version on a block of the run (``track_blocked_sharded_rx``). Then
    ``num_devices`` one past the card count raises RuntimeError."""
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    k1.track_blocked.launches = 0
    with record_blocks() as rec:
        rx, blocks, wall = drive(ReceiverConfig(fs=FS, num_channels=8,
                                                num_devices=1), capture)
    n1 = k1.track_blocked.launches
    if not (rx.mesh is not None and rx.mesh.size == 1
            and rx.tracker.mesh is rx.mesh
            and rx.groups[0].acq.mesh is rx.mesh):
        raise AssertionError("num_devices=1 did not take the sharded path")
    if not (blocks > 0 and n1 == blocks):
        raise AssertionError(f"{n1} K1 launches for {blocks} blocks")
    e = dict(position_gates(rx.status, scen), mesh=[str(d) for d in
                                                    rx.mesh.devices],
             locked=len(rx.tracker.active_channels()), blocks=blocks,
             k1_launches=n1, wall_s=wall, realtime_factor=32.0 / wall,
             phase6_realtime_factor=phase6["realtime_factor"],
             phase6_mean_2d_m=phase6["mean_2d_m"])
    hold_fused_block("gps8_num_devices_1", "track_blocked",
                     rec["track_blocked"], kernels,
                     "track_blocked_sharded_rx")
    kernels["track_blocked_sharded_rx"]["launches"] = n1
    too_many = torch.cuda.device_count() + 1
    try:
        Receiver(ReceiverConfig(fs=FS, num_channels=8 * too_many,
                                num_devices=too_many))
    except RuntimeError as err:
        e["beyond_cards"] = str(err)
    else:
        raise AssertionError(f"num_devices={too_many} did not raise")
    emit("e2e_gps8_32s_num_devices_1", **e)
    return e


def distributed_phase(kernels) -> dict:
    """Phase 45: ``parallel.dryrun.dryrun_multichip(1)`` on the card: three
    blocks of the tiny tracker on a one-card mesh (K1), a sharded PCPS over
    32 PRNs, and two ``tools/dist_worker.py`` ranks (gloo, both on cuda:0,
    4 shards of one channel each, the eager engine: K3 each period of each
    shard) gathering the [4, 8] Doppler rows to rank 0. The gathered rows
    equal this process's unsharded eager rows on the card bit for bit, and
    the CPU eager engine's (K3's plain version) within
    tests/test_torch_dll_pll.py's 0.1 Hz. K3 at the ranks' shape (C = 1)
    is held to its plain version on a period of the same run made in this
    process over 8 one-channel shards (``correlator_dist``, launches: the
    ranks' own counts). The dry run's in-process K1 blocks (C = 2, three
    on the one-card mesh) are counted and one is held to its plain
    version (``track_blocked_dryrun``)."""
    from gnss_sdr_tpu_torch.parallel.distributed import (
        dryrun_conf,
        dryrun_inputs,
        run_blocks,
    )
    from gnss_sdr_tpu_torch.parallel.dryrun import dryrun_multichip
    from gnss_sdr_tpu_torch.parallel.sharding import (
        make_channel_mesh,
        make_sharded_track_block,
    )
    from gnss_sdr_tpu_torch.tracking.dll_pll import track_block

    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1

    t = time.perf_counter()
    k1.track_blocked.launches = 0
    with record_blocks() as rec_dry:
        run = dryrun_multichip(1)
    n_dry = k1.track_blocked.launches
    dry_s = time.perf_counter() - t
    rows, launches = run["dist"]["rows"], run["dist"]["launches"]
    conf = dryrun_conf(8)

    def rows_on(dev, fn=None):
        state, window, codes = dryrun_inputs(conf, dev)
        eng = fn or (lambda s, w, c: track_block(conf, s, w, c))
        return run_blocks(eng, state, window, codes, 3).cpu().numpy()

    card, cpu = rows_on("cuda"), rows_on("cpu")
    with record_blocks() as rec:
        shards = rows_on("cuda", make_sharded_track_block(
            dataclasses.replace(conf, fused_tracker=False),
            make_channel_mesh(["cuda:0"] * 8)))
    want = [4 * conf.steps_per_block * 3] * 2
    e = dict(rows_shape=list(rows.shape), k3_launches_per_rank=launches,
             in_process_fused=run["fused"], in_process_k1_launches=n_dry,
             max_abs_vs_cpu_hz=float(np.abs(rows - cpu).max()),
             bit_equal_card=bool(np.array_equal(rows, card)),
             bit_equal_8_shards=bool(np.array_equal(rows, shards)),
             dryrun_s=dry_s)
    emit("distributed_two_ranks", **e)
    if not (rows.shape == (conf.steps_per_block, 8) and launches == want
            and run["fused"] and n_dry == 3 and e["bit_equal_card"]
            and e["bit_equal_8_shards"] and e["max_abs_vs_cpu_hz"] < 0.1):
        raise AssertionError(f"distributed gates failed: {e}")
    hold_correlator_block("dist_rank_shard", rec["correlator"], kernels,
                          "correlator_dist")
    kernels["correlator_dist"]["launches"] = sum(launches)
    hold_fused_block("dryrun_multichip_1", "track_blocked",
                     rec_dry["track_blocked"], kernels,
                     "track_blocked_dryrun")
    kernels["track_blocked_dryrun"]["launches"] = n_dry
    return e


def scaling_phase(kernels) -> dict:
    """Phase 46: ``tools/scaling.py`` at 1, 2 and 4 shards, all on cuda:0
    (``--cards 1``; 32 channels, 20 periods a block, 10 timed blocks after
    one warm-up): ms per block and the ratio to one shard, the shards'
    overhead on one card, not scaling. Each shard count runs the tool
    once, launching K1 once per shard and block at C = 32, 16 and 8 (each
    its own cluster shape); one block of each is held to its plain
    version (``track_blocked_scaling{1,2,4}``)."""
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.tools import scaling

    times, launches = {}, {}
    for n in (1, 2, 4):
        k1.track_blocked.launches = 0
        with record_blocks() as rec:
            times.update(scaling.main(["--shards", str(n), "--cards", "1"]))
        launches[n] = k1.track_blocked.launches
        name = f"track_blocked_scaling{n}"
        hold_fused_block(f"scaling_{n}_shards", "track_blocked",
                         rec["track_blocked"], kernels, name)
        kernels[name]["launches"] = launches[n]
    e = dict(ms_per_block={n: t * 1e3 for n, t in times.items()},
             ratio={n: t / times[1] for n, t in times.items()},
             k1_launches=launches,
             k1_block_ms={n: kernels[f"track_blocked_scaling{n}"]["ms"]
                          for n in times})
    emit("scaling_one_card", **e)
    if not (sorted(times) == [1, 2, 4]
            and all(launches[n] == 11 * n for n in launches)):
        raise AssertionError(f"scaling gates failed: {e}")
    return e


def ttff_trial(args) -> tuple:
    """One ``tools/ttff.py`` trial of seed 1 on the card in a worker
    process: (warm, duration s) -> (TTFF s or None, K1 launches, wall s)."""
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.tools import ttff

    warm, duration = args
    k1.track_blocked.launches = 0
    t = time.perf_counter()
    got = ttff.run_trial(seed=1, duration_s=duration, warm=warm)
    torch.cuda.synchronize()
    return got, k1.track_blocked.launches, time.perf_counter() - t



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
    from gnss_sdr_tpu_torch.ops import _build
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.tracking.tracker import Tracker

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.manual_seed(0)

    # ---- 1. device -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds)
    # registers, stack frame and spills of K1-K4 and P1 (ptxas -v), one
    # entry per instantiation: K1 and K2 per tap count, pilot mode, FDMA
    # and replica form, K3 per tap count,
    # replica form and data prompt, K4 per tap count and replica form, P1
    # per variant and cluster size (R = 1, 2, 4, 8; narrow has one)
    found = _build.kernel_resources(_build.build_log)
    res = {}
    for kname, tag, want in (("track_blocked", "BlockedLoop", 16),
                             ("track_full", "track_full_kernel", 16),
                             ("correlator", "correlator_kernel", 8),
                             ("track_simple", "SimpleLoop", 4),
                             ("probe", "probe_", 41)):
        res[kname] = {n: r for n, r in found.items() if tag in n}
        if len(res[kname]) != want:
            raise AssertionError(f"build log names {len(res[kname])} "
                                 f"{kname} kernels, want {want}")
    emit("kernel_resources", kernels=res)

    tbl = gps_l1_ca_code_table().astype(np.float32)
    kernels = {}

    # ---- 3. K3 against its plain version ---------------------------------
    k3_phase(dev, tbl, kernels)
    C = 8

    # ---- 4. K1 and K2 against their plain version, K = 20 and 1000 -------
    # (K2's plain version is K1's: the two kernels compute the same rows);
    # at the receiver's C = 8 (K1 in clusters of 8 CTAs) and at C = 132
    # (K1 at one CTA a channel, one channel per SM)
    dops = [1200.0, -2500.0, 3400.0, -400.0, 150.0, -3900.0, 2600.0, -1700.0]
    delays = [37.0 + 311.0 * c for c in range(C)]
    sig = synthetic_signal(tbl, int(FS * 1.12), dops, delays, seed=1)
    for n_ch in (C, 132):
        fused_phase(dev, tbl, sig, dops, delays, n_ch,
                    kernels if n_ch == C else None)

    # ---- 5. the three engines over the same blocks -----------------------
    # eager (K3 per period), fused through K1, fused through K2
    plan = gps_l1ca_plan(FS, num_channels=C)
    results = {}
    counts = {}
    for engine, fused, env in (("eager", False, None),
                               ("track_blocked", True, "blocked"),
                               ("track_full", True, "perchannel")):
        conf = dataclasses.replace(plan.trk_conf, fused_tracker=fused)
        with fused_engine(env):
            trk = Tracker(conf, tbl, device=dev)
        for ch in range(C):
            trk.start_channel(ch, prn=ch + 1, code_row=ch,
                              acq_delay_samples=delays[ch],
                              acq_doppler_hz=dops[ch] + 30.0,
                              acq_samplestamp=0, current_abs_sample=0)
        k3.correlator.launches = 0
        k1.track_blocked.launches = 0
        k2.track_full.launches = 0
        results[engine] = [trk.process(sig, 0) for _ in range(3)]
        torch.cuda.synchronize()
        counts[engine] = (k3.correlator.launches, k1.track_blocked.launches,
                          k2.track_full.launches)
    steps = plan.trk_conf.steps_per_block
    want = {"eager": (3 * steps, 0, 0), "track_blocked": (0, 3, 0),
            "track_full": (0, 0, 3)}
    if counts != want:
        raise AssertionError(f"engine launches {counts}, want {want}")
    diffs = {f"{a}_vs_{b}": [assert_match(x, y) for x, y in
                             zip(results[a], results[b])]
             for a, b in (("eager", "track_blocked"), ("eager", "track_full"),
                          ("track_blocked", "track_full"))}
    kernels["correlator"]["launches"] = counts["eager"][0]
    emit("three_engines", blocks=3, launches=counts, diffs=diffs)

    # ---- 6. end to end: gps8 on the 32 s scenario ------------------------
    t0 = time.perf_counter()
    scen = gal_scenario("gps8")
    capture = make_captures(["gps8"], check=("gps8", 3))["gps8"]
    emit("capture", seconds=time.perf_counter() - t0, sats=len(scen.prns),
         samples=len(capture))

    def drive(cfg: ReceiverConfig, x: np.ndarray):
        rx = Receiver(cfg)
        tracker = rx.tracker
        process = tracker.process_device
        blocks = [0]

        def counted(*a):
            r = process(*a)
            blocks[0] += 1
            return r

        tracker.process_device = counted
        torch.cuda.synchronize()
        t = time.perf_counter()
        chunk, fed, acquired = int(FS), 0, False
        while fed < len(x):
            n = min(chunk, len(x) - fed)
            rx.feed(x[fed:fed + n])
            fed += n
            if not acquired:
                acquired = len(rx.acquire()) >= 4
            rx.run()
        torch.cuda.synchronize()
        return rx, blocks[0], time.perf_counter() - t

    k1.track_blocked.launches = 0
    k3.correlator.launches = 0
    rx, blocks, wall = drive(ReceiverConfig(fs=FS, num_channels=8), capture)
    k1_launches, k3_main = k1.track_blocked.launches, k3.correlator.launches
    if not (blocks > 0 and k1_launches == blocks):
        raise AssertionError(f"{k1_launches} K1 launches for {blocks} blocks")
    e2e = dict(position_gates(rx.status, scen),
               locked=len(rx.tracker.active_channels()),
               blocks=blocks, k1_launches=k1_launches, k3_launches=k3_main,
               k1_launches_per_signal_s=k1_launches / 32.0,
               wall_s=wall, realtime_factor=32.0 / wall)
    emit("e2e_gps8_32s", **e2e)
    kernels["track_blocked"]["launches"] = k1_launches

    # bench.py gps8 settings: 1000 periods per block, int8 stream
    x6 = capture[:int(6 * FS)]
    rx6, blocks6, wall6 = drive(ReceiverConfig(
        fs=FS, num_channels=8, steps_per_block=1000, int8_stream=True), x6)
    emit("e2e_gps8_6s_bench_settings", steps_per_block=1000,
         int8_stream=True, blocks=blocks6,
         locked=len(rx6.tracker.active_channels()), wall_s=wall6,
         realtime_factor=6.0 / wall6)

    # ---- 7. the .conf/CLI path, through K1 and through K2 ----------------
    # (its ibyte copy of the capture and its conf are read again by phases
    # 35 and 41)
    gps_tmp = tempfile.TemporaryDirectory()
    runs = cli_phase(capture, scen, Path(gps_tmp.name))
    kernels["track_full"]["launches"] = runs["track_full"]["k2_launches"]

    # ---- 8. K4 against its plain version ---------------------------------
    k4_phase(dev, tbl, sig, dops, delays, kernels)

    # ---- 9. the kernel bench (K2 and K4), K1 at its shape ----------------
    kbench_phase(dev, kernels)

    # ---- 10. the primitive-cost probe (P1) -------------------------------
    probe_phase(dev, kernels)

    # ---- 11. K1 and K2 at the Galileo E1 shape --------------------------
    e1_kernel_phase(dev)

    # ---- the Galileo, dual-band and GLONASS captures, in worker processes,
    # beside phase 42's ttff trials
    ttff_pool, ttff_pending = start_ttff_trials()
    gal_caps = make_captures([k for k in CAPTURES if k != "gps8"],
                             check=("e5a", 3))

    # ---- 12. Galileo E1-B from Python (K1) -------------------------------
    e1b = galileo_python_phase(gal_caps["e1b"], gal_scenario("e1b"), kernels)
    kernels["track_blocked_e1b"]["launches"] = e1b["k1_launches"]

    # ---- 13. Galileo E1-B through the CLI, K1 and K2 ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        gruns = galileo_cli_phase(gal_caps["e1b"], gal_scenario("e1b"),
                                  Path(tmp), kernels)
    kernels["track_full_e1b"]["launches"] = gruns["track_full"]["k2_launches"]

    # ---- 14. Galileo E1-B+C with the pilot, and the three engines --------
    galileo_pilot_phase(gal_caps["e1bc"], gal_scenario("e1bc"), kernels)

    # ---- 15. gal8 at bench.py's settings ---------------------------------
    gal8_phase(gal_caps["gal8"], gal_scenario("gal8"), kernels)

    # ---- 16. K1, K2 and K3 at the GPS L5 and Galileo E5a shapes ----------
    long_code_kernel_phase(dev)

    # ---- 17. GPS L1 + L5 from Python (K1, assisted L5 acquisition) -------
    l1l5 = dual_band_phase(gal_caps, kernels)

    # ---- 18. Galileo E5a alone, assisted start; the three engines ---------
    e5a_phase(gal_caps, kernels)

    # ---- 19. the Doppler projection on the card --------------------------
    project_doppler_phase()

    # ---- 20. dual16 at bench.py's settings -------------------------------
    ref_acq = dual16_phase(gal_caps, kernels)

    # ---- 21. conf/dual_band_gps_gal.conf through the CLI, K1 and K2 ------
    with tempfile.TemporaryDirectory() as tmp:
        dual_cli_phase(gal_caps, ref_acq, Path(tmp), kernels)

    # ---- 22. K1 and K2 with FDMA at the GLONASS shape --------------------
    fdma_kernel_phase(dev)

    # ---- 23. GLONASS L1 C/A from Python (K1) ------------------------------
    glo = glonass_python_phase(gal_caps["glo"], gal_scenario("glo"), kernels)

    # ---- 24. the three engines under FDMA ---------------------------------
    fdma_engines_phase(dev, kernels)

    # ---- 25. GLONASS through the CLI (Channels_1G), K1 and K2 -------------
    with tempfile.TemporaryDirectory() as tmp:
        glonass_cli_phase(gal_caps["glo"], gal_scenario("glo"), glo["first"],
                          Path(tmp), kernels)

    # ---- 26. K1, K2 and K3 at the last plans' shapes ---------------------
    last_plans_kernel_phase(dev)

    # ---- 27. GPS L1 + BeiDou B1I from Python (K1); three engines on B1I --
    bds = gps_bds_phase(gal_caps, kernels)

    # ---- 28. GPS L1 + BeiDou B1I through the CLI, K1 and K2 --------------
    with tempfile.TemporaryDirectory() as tmp:
        gps_bds_cli_phase(gal_caps, bds["first"], Path(tmp), kernels)

    # ---- 29. BeiDou B1I GEO (D2) through the Tracker (K1) ----------------
    geo_phase(gal_caps["geo"], kernels)

    # ---- 30. acquisition of E6B, SBAS, L2C and B3I ------------------------
    last_plans_acquisition_phase()

    # ---- 31. mc64 at bench.py's settings ---------------------------------
    mc64_phase(gal_caps, kernels)

    # ---- 32. the acquisition engines against PCPS; the ROC sweep ---------
    acq_engines_phase(capture, scen, gal_caps)

    # ---- 33. the Kalman mode's Tracker cases (eager engine, K3) ----------
    kf_cases_phase()

    # ---- 34. gps8 with GPS_L1_CA_KF_Tracking (eager engine, K3) ----------
    kf_receiver_phase(capture, scen, kernels)

    # ---- 35-37. the Gaussian closer and the IF-shifted capture through the
    # CLI (K1), the TCP loop, the conditioner stages on card and CPU -------
    with tempfile.TemporaryDirectory() as tmp:
        gaussian_cli_phase(Path(gps_tmp.name) / "capture_l1.dat", scen,
                           runs["first_acquired"], Path(tmp))
    tcp_phase()
    with tempfile.TemporaryDirectory() as tmp:
        xlating_cli_phase(capture, scen, runs["first_acquired"], Path(tmp))
    conditioner_stages_phase(capture)

    # ---- 38. gps8-dyn-pvtkf: the PVT Kalman filter and the dumps (K1) -----
    with tempfile.TemporaryDirectory() as tmp:
        dyn_pvtkf_phase(gal_caps["dyn"], gal_scenario("dyn"), Path(tmp))

    # ---- 39. l1l5-ppp: PPP_Static with the tides on phase 17's run (K1) ---
    with tempfile.TemporaryDirectory() as tmp:
        ppp_phase(gal_caps, l1l5, Path(tmp))

    # ---- 40. e1b-osnma: OSNMA strict mode on phase 12's run (K1) ----------
    osnma_phase(gal_caps["e1b"], gal_scenario("e1b"), e1b)

    # ---- 41. gps8-ctl: the CLI's control plane, cold and warm (K1) --------
    with tempfile.TemporaryDirectory() as tmp:
        ctl_cli_phase(Path(gps_tmp.name) / "gps_l1_file.conf", scen,
                      runs["first_acquired"], Path(tmp))
    gps_tmp.cleanup()

    # ---- 42. the tools: front_end_cal, ttff, bench_micro -----------------
    tools_phase(ttff_pool, ttff_pending)

    # ---- 43. the gps8 Tracker on two shards of cuda:0 (K1, K2) ------------
    sharded_tracker_phase(capture, kernels)

    # ---- 44. gps8's 32 s run with num_devices=1 (K1) ---------------------
    sharded_receiver_phase(drive, capture, scen, e2e, kernels)

    # ---- 45. the two-process run on the card (gloo, K3) ------------------
    distributed_phase(kernels)

    # ---- 46. the scaling tool on one card (K1) ---------------------------
    scaling_phase(kernels)

    # ---- 47. kernels -----------------------------------------------------
    meta = {
        "track_blocked": dict(
            route="cuda", source="gnss_sdr_tpu_torch/csrc/track_blocked.cu",
            replaces="gnss_sdr_tpu/ops/track_kernel_blocked.py:148"),
        "track_full": dict(
            route="cuda", source="gnss_sdr_tpu_torch/csrc/track_full.cu",
            replaces="gnss_sdr_tpu/ops/track_kernel.py:476"),
        "correlator": dict(
            route="cuda", source="gnss_sdr_tpu_torch/csrc/correlator.cu",
            replaces="gnss_sdr_tpu/ops/correlator.py:46"),
        "track_simple": dict(
            route="cuda", source="gnss_sdr_tpu_torch/csrc/track_simple.cu",
            replaces="gnss_sdr_tpu/ops/track_kernel.py:107"),
        "probe": dict(
            route="cuda", source="gnss_sdr_tpu_torch/csrc/probe.cu",
            replaces="tools/mosaic_probe.py:50"),
    }
    for case in ("e1b", "e1bc"):
        meta[f"track_blocked_{case}"] = meta["track_blocked"]
        meta[f"track_full_{case}"] = meta["track_full"]
    meta["correlator_e1bc"] = meta["correlator"]
    meta["track_blocked_gal8"] = meta["track_blocked"]
    for case in ("l5", "e5a", "dual16"):
        meta[f"track_blocked_{case}"] = meta["track_blocked"]
    meta["track_full_e5a"] = meta["track_full"]
    meta["track_full_dual16"] = meta["track_full"]
    meta["correlator_e5a"] = meta["correlator"]
    meta["track_blocked_glo"] = meta["track_blocked"]
    meta["track_full_glo"] = meta["track_full"]
    meta["correlator_glo"] = meta["correlator"]
    for case in ("bds", "geo", "mc64_1c", "mc64_1b", "mc64_1g", "mc64_b1"):
        meta[f"track_blocked_{case}"] = meta["track_blocked"]
    meta["track_full_bds"] = meta["track_full"]
    meta["correlator_bds"] = meta["correlator"]
    meta["correlator_kf"] = meta["correlator"]
    for case in ("shard2", "sharded_rx", "dryrun", "scaling1", "scaling2",
                 "scaling4"):
        meta[f"track_blocked_{case}"] = meta["track_blocked"]
    meta["track_full_shard2"] = meta["track_full"]
    meta["correlator_dist"] = meta["correlator"]
    for n in meta:
        if not kernels[n].get("launches"):
            raise AssertionError(f"{n}: no launch on its path")
    table = [{"name": n, **meta[n], "launches": kernels[n]["launches"],
              "max_abs_err": kernels[n]["max_abs_err"],
              "ms": kernels[n]["ms"], "plain_ms": kernels[n]["plain_ms"],
              "bound_ms": kernels[n]["bound_ms"],
              "bound_by": kernels[n]["bound_by"], "library_ms": None,
              **({"variants": kernels[n]["variants"]} if n == "probe"
                 else {})}
             for n in meta]
    emit("done", seconds=time.perf_counter() - t_start,
         host_paced_timings=HOST_PACED)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
