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
gal8 settings; each run held to its test's gates, and each kernel it ran
held to its plain version on a block of the run's own inputs. Every phase
prints one JSON line; any failure exits nonzero. The last two lines are
the kernel table and ``{"ok": true, "device": {...}}``. Needs a CUDA
device and the repository's ``gnss_sdr_tpu_torch`` package; imports no
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


def position_gates(status, scen) -> dict:
    """The receiver's fixes against tests/test_position.py's gates; raises
    if one fails."""
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
             and 10.0 < e["ttff_s"] < 32.0)
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


def assert_match(a, b, prompt_tol=5e-3, dop_tol=0.1) -> dict:
    """tests/test_fused_receiver.py's _assert_match on two BlockResults;
    returns the measured differences."""
    for k in ("n_samples", "pos_end", "boundary"):
        if not np.array_equal(a.outputs[k], b.outputs[k]):
            raise AssertionError(f"engines disagree on {k}")
    pa, pb = a.outputs["prompt"], b.outputs["prompt"]
    diffs = {
        "doppler_hz": float(np.abs(a.outputs["carrier_doppler"]
                                   - b.outputs["carrier_doppler"]).max()),
        "prompt_rel_median": float(np.median(np.abs(pa - pb)
                                             / (np.abs(pa) + 1e-9))),
        "carrier_phase_rad": float(np.abs(a.outputs["carrier_phase"]
                                          - b.outputs["carrier_phase"]).max()),
        "rem_code_phase_chips": float(np.abs(
            a.outputs["rem_code_phase"] - b.outputs["rem_code_phase"]).max()),
    }
    limits = {"doppler_hz": dop_tol, "prompt_rel_median": prompt_tol,
              "carrier_phase_rad": 1e-3, "rem_code_phase_chips": 1e-3}
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
    through K1 and through K2, and the CLI itself as a subprocess."""
    from gnss_sdr_tpu_torch import main as cli
    from gnss_sdr_tpu_torch.config.configuration import FileConfiguration
    from gnss_sdr_tpu_torch.io import encode_samples
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
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

    runs = {}
    Tracker.process_device = counted
    try:
        for engine, env in (("track_blocked", None),
                            ("track_full", "perchannel")):
            blocks[0] = 0
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
    finally:
        Tracker.process_device = process

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
_SCEN_CACHE: dict = {}


def gal_scenario(kind: str):
    """The Galileo scenario ``kind`` (one per process)."""
    from gnss_sdr_tpu_torch.simulate.galileo import (
        GalileoScenario,
        GalileoScenarioConfig,
    )

    if kind not in _SCEN_CACHE:
        _SCEN_CACHE[kind] = GalileoScenario(
            GalileoScenarioConfig(**GAL_SCENARIOS[kind]))
    return _SCEN_CACHE[kind]


def gal_capture(kind: str) -> np.ndarray:
    """The whole capture of scenario ``kind``, made in the tests' 1 s
    chunks (the scenario's noise is seeded by the chunk's start, so these
    are the tests' samples)."""
    scen = gal_scenario(kind)
    fs = int(scen.cfg.fs)
    total = int(scen.cfg.duration_s * scen.cfg.fs)
    return np.concatenate([scen.generate(s, min(fs, total - s))
                           for s in range(0, total, fs)])


@contextlib.contextmanager
def record_blocks(every: int = 64):
    """Keep a copy of the inputs of the kernel calls the tracking engines
    make (tracking/fused.py's ``track_blocked`` and ``track_full``,
    tracking/dll_pll.py's ``correlator``): of calls 0, 1, 2, 4, 8, ... and
    of every ``every``-th, the latest per kernel, as ``{kernel: (args,
    kwargs, call index)}``. A kernel can then be held to its plain version
    on a block of the run itself."""
    from gnss_sdr_tpu_torch.tracking import dll_pll, fused

    kept, saved = {}, []

    def wrap(mod, attr):
        fn = getattr(mod, attr)
        calls = [0]

        def recorded(*args, **kw):
            i = calls[0]
            calls[0] += 1
            if i & (i - 1) == 0 or i % every == 0:
                kept[attr] = (tuple(a.clone() if isinstance(a, torch.Tensor)
                                    else a for a in args), dict(kw), i)
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
                     entry: str | None = None, reps: int = 20) -> dict:
    """K1 (``kname`` "track_blocked") or K2 ("track_full") against its
    plain version (K1's) on a recorded block ``rec`` of the run ``run``:
    the long-code bounds (2e-4 relative over the first two periods, 2e-3
    over the block, tests/test_track_kernel_blocked.py) on check_lanes(T),
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
                        lanes=lanes, first_tol=2e-4)
    out = torch.empty((C, K, LANES), dtype=torch.float32,
                      device=window.device)
    ms = cuda_ms(lambda: launch(window, codes, scal, pos, spec, out, *tabs),
                 reps, name=f"{kname} {run}")
    n_total = float(o_p[:, :, 10].sum())
    nbytes = (stream_bytes(o_p, window.shape[0])
              + codes.numel() * 4 * (2 if spec.track_pilot else 1)
              + sum(t.numel() * 4 for t in tabs[1:])
              + scal.numel() * 4 + C * 4 + C * K * LANES * 4)
    b_ms, b_by = bound(nbytes, n_total * (fused_ops_per_sample(T)
                                          + (16 if spec.track_pilot else 0)))
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


def hold_correlator_block(run: str, rec, kernels, entry: str) -> dict:
    """K3 against its plain version on a recorded period ``rec`` of the
    eager engine in run ``run``: taps within 2e-3 relative (to
    max(|tap|, 1)), the lanes past them zero, as phase 3 holds it; timed,
    with its bound from the period's own sample counts."""
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
                    int(pilot), extent)
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
             k1_launches=n1, wall_s=wall,
             realtime_factor=scen.cfg.duration_s / wall)
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
    import copy

    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1
    from gnss_sdr_tpu_torch.receiver.plans import galileo_e1bc_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.tracking.dll_pll import TrackingState
    from gnss_sdr_tpu_torch.tracking.tracker import ChannelPhase, Tracker

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
    x = torch.as_tensor(capture[:int(1.6 * fs)], device="cuda")
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
    for ch, (prn, (dop, delay)) in enumerate(sorted(acq.items())):
        lead.start_channel(ch, prn=prn, code_row=plan.prn_row(prn),
                           acq_delay_samples=delay, acq_doppler_hz=dop,
                           acq_samplestamp=0, current_abs_sample=0)
    started = list(range(len(acq)))
    settle = 0
    while not all(lead.ctl[c].sec_locked for c in started
                  if lead.ctl[c].phase != ChannelPhase.LOST):
        lead.process_device(x, 0, x.shape[0])
        settle += 1
        if settle > 20:
            raise AssertionError("no secondary lock within 20 blocks")
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
        raise AssertionError(f"E1-B+C engine launches {counts}, want {want}")
    diffs = {f"{a}_vs_{b}": [assert_match(p, q) for p, q in
                             zip(results[a], results[b])]
             for a, b in (("eager", "track_blocked"), ("eager", "track_full"),
                          ("track_blocked", "track_full"))}
    for a, b in (("eager", "track_blocked"), ("track_blocked", "track_full")):
        for p, q in zip(results[a], results[b]):
            for k in ("data_boundary", "data_count"):
                if not np.array_equal(p.outputs[k], q.outputs[k]):
                    raise AssertionError(f"E1-B+C {a} and {b} disagree on {k}")
    emit("e1bc_three_engines", settle_blocks=settle, blocks=3,
         channels=len(started), launches=counts, diffs=diffs)
    hold_fused_block("e1bc_three_engines", "track_full", rec["track_full"],
                     kernels, "track_full_e1bc")
    hold_correlator_block("e1bc_three_engines", rec["correlator"], kernels,
                          "correlator_e1bc")
    kernels["track_blocked_e1bc"]["launches"] = n1
    kernels["track_full_e1bc"]["launches"] = counts["track_full"][2]
    kernels["correlator_e1bc"]["launches"] = counts["eager"][0]
    return e


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
    from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig
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
    # entry per instantiation: K1 and K2 per tap count, pilot mode and
    # replica form, K3 per tap count,
    # replica form and data prompt, K4 per tap count and replica form, P1
    # per variant and cluster size (R = 1, 2, 4, 8; narrow has one)
    found = _build.kernel_resources(_build.build_log)
    res = {}
    for kname, tag, want in (("track_blocked", "BlockedLoop", 8),
                             ("track_full", "track_full_kernel", 8),
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
    scen = GpsScenario(ScenarioConfig(
        fs=FS, tow_start_s=7314.0, duration_s=32.0, cn0_dbhz=46.0,
        rx_clock_bias_s=2.1e-4, max_sats=8, min_elevation_deg=15.0, seed=1))
    capture = scen.generate(0, scen.total_samples)
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
    with tempfile.TemporaryDirectory() as tmp:
        runs = cli_phase(capture, scen, Path(tmp))
    kernels["track_full"]["launches"] = runs["track_full"]["k2_launches"]

    # ---- 8. K4 against its plain version ---------------------------------
    k4_phase(dev, tbl, sig, dops, delays, kernels)

    # ---- 9. the kernel bench (K2 and K4), K1 at its shape ----------------
    kbench_phase(dev, kernels)

    # ---- 10. the primitive-cost probe (P1) -------------------------------
    probe_phase(dev, kernels)

    # ---- 11. K1 and K2 at the Galileo E1 shape --------------------------
    e1_kernel_phase(dev)

    # ---- the Galileo captures --------------------------------------------
    gal_caps = {}
    for kind in GAL_SCENARIOS:
        t0 = time.perf_counter()
        gal_caps[kind] = gal_capture(kind)
        emit("galileo_capture", scenario=kind,
             seconds=time.perf_counter() - t0, samples=len(gal_caps[kind]))

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

    # ---- 16. kernels -----------------------------------------------------
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
