"""The traced run's device side: the profiler's events, the card's busy
and idle time over the window, K1's device time and its least time from
the benchmark's own counts of its bytes and operations.

The profiler records the card's activity only. The window is marked on
the card by a spin kernel launched at its start and at its end, each
right after a synchronisation at a known host time (``mark``); the two
marks tie the host's ``perf_counter`` clock, on which the harness's
spans are read, to the trace's.

Counts are copies of ``chip_smoke.py``'s (``bound``, ``stream_bytes``,
``fused_ops_per_sample``, ``hold_fused_block``'s byte count), on the host
outputs the tracker already copied back: each period's samples
[end - n, end) of every channel active in the block, a sample that
several channels read counted once.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

CARD_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA's data sheet
CARD_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
# operations per channel-sample, counted from the kernels' inner loops
# (csrc/): phase fma 2, sincosf ~20, wipeoff 6, code phase fma 2, and per
# tap the replica ~12 plus 4 for the two products and sums; the pilot
# mode's data prompt adds one tap's 16
FUSED_OPS_PER_SAMPLE = 2 + 20 + 6 + 2 + 3 * (12 + 4)
LANES = 128
MAX_SLOTS = 64                  # float32 state slots a channel, at most
K1_NAME = ("cluster_track_kernel", "BlockedLoop")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK_NAME = "spin_kernel"       # torch.cuda._sleep's kernel
MARK_CYCLES = 10_000


def fused_ops_per_sample(num_taps: int, pilot: bool) -> int:
    return FUSED_OPS_PER_SAMPLE + (num_taps - 3) * (12 + 4) + (
        16 if pilot else 0)


def union_samples(start: np.ndarray, stop: np.ndarray) -> int:
    """Samples covered by the ranges [start, stop), each counted once."""
    order = np.argsort(start, kind="stable")
    start, stop = start[order], stop[order]
    reach = np.maximum.accumulate(stop)
    before = np.concatenate([start[:1], reach[:-1]])
    return int(np.clip(stop - np.maximum(start, before), 0, None).sum())


def k1_counts(block) -> dict:
    """Bytes and operations one K1 launch needs, for a tracked block
    (``drive.TrackedBlock``): the stream's samples (complex64) once, the
    code tables, the packed state (at most MAX_SLOTS float32 a channel)
    and positions in, the [C, K, 128] float32 rows out; operations per
    channel-sample over the periods of every channel active (WIDE or
    NARROW) when the block began."""
    act = [i for i, p in enumerate(block.before) if p in ("WIDE", "NARROW")]
    n = block.outputs["n_samples"][:, act].astype(np.int64).ravel()
    end = block.abs_sample_end[:, act].astype(np.int64).ravel()
    c, k = len(block.before), block.abs_sample_end.shape[0]
    sizes = block.k1
    nbytes = (union_samples(end - n, end) * 8 + sizes["tables_bytes"]
              + c * (MAX_SLOTS + 1) * 4 + c * k * LANES * 4)
    ops = float(n.sum()) * fused_ops_per_sample(sizes["num_taps"],
                                                sizes["pilot"])
    return {"bytes": float(nbytes), "ops": ops}


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time and what sets it: bytes over the memory rate or
    operations over the float32 rate."""
    t = {"bytes": nbytes / CARD_BYTES_PER_S, "operations": ops / CARD_F32_FLOPS}
    by = max(t, key=t.get)
    return t[by], by


def mark() -> float:
    """Mark the trace: wait for the card, read the host clock, launch one
    spin kernel and wait for it. Returns the host time."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(MARK_CYCLES)
    torch.cuda.synchronize()
    return t


def read_trace(prof) -> list[dict]:
    """The profiler's events as chrome-trace dicts (written under TMPDIR,
    read and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="rxbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _merge(iv: list) -> list:
    out: list = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans: list, times: list) -> list[str]:
    """The innermost of the nested ``spans`` (start, end, name), sorted by
    start, open at each of the ascending ``times``; "harness" where none
    is."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "harness")
    return out


def analyse(events: list[dict], intervals: list, marks: list) -> dict:
    """Busy and idle time of the device between the two marks, K1's
    device seconds, the device operations that took most time, and the
    longest idle gaps labelled by the innermost host span open at their
    middle. ``intervals`` are the spans' (start, end, name) and ``marks``
    the two marks' times, on the host's clock; each mark's spin kernel
    starts the stated time after its host time, the same for both."""
    spins = sorted(float(e["ts"]) for e in events
                   if e.get("cat") == "kernel"
                   and MARK_NAME in str(e.get("name", "")))
    if len(spins) < 2 or len(marks) != 2:
        raise RuntimeError(f"the trace holds {len(spins)} window marks")
    w0, w1 = spins[0], spins[-1]
    # trace microseconds per host second: 1e6 where the trace's clock is
    # the host's, as the profiler states it
    scale = (w1 - w0) / (marks[1] - marks[0])
    if abs(scale * 1e-6 - 1.0) > 0.01:
        raise RuntimeError(f"the trace's clock runs {scale * 1e-6!r} times "
                           "the host's between the window marks")
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and MARK_NAME not in str(e.get("name", ""))
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    iv = [[max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))]
          for e in dev]
    busy = _merge([x for x in iv if x[1] > x[0]])
    busy_us = sum(e - s for s, e in busy)
    ops: dict[str, float] = {}
    k1_us = 0.0
    k1_n = 0
    for e in dev:
        name = e.get("name", "?")
        ops[name] = ops.get(name, 0.0) + float(e["dur"])
        if e.get("cat") == "kernel" and all(p in name for p in K1_NAME):
            k1_us += float(e["dur"])
            k1_n += 1
    spans = sorted(((w0 + (a - marks[0]) * scale, w0 + (b - marks[0]) * scale,
                     name) for a, b, name in intervals),
                   key=lambda s: (s[0], -s[1]))
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    labels = _innermost(spans, [(s + e) / 2 for s, e in gaps])
    idle_by: dict[str, float] = {}
    for (s, e), label in zip(gaps, labels):
        idle_by[label] = idle_by.get(label, 0.0) + (e - s) * 1e-6
    longest = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])
    labelled = [[labels[i], (gaps[i][1] - gaps[i][0]) * 1e-6]
                for i in longest[:10]]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "k1_s": k1_us * 1e-6, "k1_launches": k1_n,
            "clock_scale": scale * 1e-6,
            "device_ops": [[n[:120], v * 1e-6] for n, v in top],
            "idle_gaps": labelled, "idle_by_span": idle_by}
