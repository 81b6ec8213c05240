"""Primitive-cost probe (P1): kernel bodies inside a K-period loop.

Counterpart of ``tools/mosaic_probe.py``. Each of eleven kernel bodies
(staging copies, lane gathers, the selection product, transcendentals,
narrow-vector op chains, row stores) runs inside a K = 2000 loop in one
launch of ``csrc/probe.cu``; ``timed`` reports ns per period, and a
variant's cost is its margin over the baseline. Every variant's result is
consumed by a full sum, and gather indices vary per lane, as in the TPU
probe.

Each variant has a plain PyTorch version of one period: ``FUNCTIONS``
maps the names of the harness variants to ``f(i, acc, src) -> v`` with
``src`` the (BR, 128) tile seen as [C, ROWS_P, 128] and ``acc`` the [C]
per-channel accumulators; ``staging``, ``narrow`` and ``out store`` have
their own steps. ``probe`` launches the CUDA variant for CUDA tensors and
runs ``probe_plain`` for CPU tensors. Both return the (8, 128) output,
each channel's float32 sum(v) at the first and the last period [C, 2],
and, for ``out store``, the (C, 200, 128) buffer.

On the card one channel is a thread-block cluster of R CTAs, the
trackers' mapping: R comes from their rule
(``ops/track_kernel_blocked.py::cluster_shape``, 4 at C = 32 on 132 SMs),
and ``ranks`` picks another power of two <= 8 (R = 1: one CTA with a CTA
barrier). Each period's total is consumed as the trackers consume their
taps: one cluster barrier and a gather of the R CTAs' partials over
distributed shared memory. ``staging`` copies its rows by ``cp.async.bulk``
on an mbarrier.

One deliberate difference from the TPU harness: the (704, 128) tile does
not fit one CTA's shared memory, so each channel is its own cluster and
the accumulator ``acc = acc + sum(v) * 1e-20 + 1`` is per channel where
the TPU's couples all 704 rows. The harness output is ~K either way; the
per-channel sums are what the checks compare.

    python -m gnss_sdr_tpu_torch.tools.mosaic_probe
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device
from gnss_sdr_tpu_torch.ops import _build
from gnss_sdr_tpu_torch.ops.track_kernel_blocked import cluster_shape, sm_count

K = 2000         # periods per launch
C = 32           # channels
ROWS_P = 22      # sample rows per period per channel
BR = C * ROWS_P  # blocked rows
LANES = 128
OUT_ROWS = 200   # rows of the out-store buffer per channel
X_ROWS = 4096    # rows of the input
ITERS = 30

f32 = torch.float32


def _c(v, dev) -> torch.Tensor:
    """A 0-dim float32 constant: float32 arithmetic in the plain versions."""
    return torch.tensor(np.float32(v), dtype=f32, device=dev)


def lane_idx(i: int, dev) -> torch.Tensor:
    """Per-lane index in [0, 128) as float32 [128]
    (``mosaic_probe.py:85-91``)."""
    base = torch.arange(LANES, dtype=f32, device=dev) * _c(0.97, dev)
    idxf = base + _c(float(i % 31), dev)
    return idxf - _c(128.0, dev) * torch.floor(idxf * _c(1.0 / 128.0, dev))


def baseline(i, acc, src):
    return src + acc[:, None, None]


def gather1(i, acc, src):
    idx = lane_idx(i, src.device).to(torch.int64)
    return (src + acc[:, None, None])[..., idx]


def gather3(i, acc, src):
    idx = lane_idx(i, src.device).to(torch.int64)
    s = src + acc[:, None, None]
    return (s[..., idx] + s[..., (idx + 1).clamp(0, LANES - 1)]
            + s[..., (idx + 2).clamp(0, LANES - 1)])


def qloop8(i, acc, src):
    """The 8-pass q-row select of the TPU probe: q = idx*8 // 128 is in
    [0, 8) and r = idx*8 - 128 q < 128, so exactly one pass keeps its
    gather and the function is one gather at r."""
    dev = src.device
    idxf = lane_idx(i, dev) * _c(8.0, dev)
    q = torch.floor(idxf * _c(1.0 / 128.0, dev))
    r = (idxf - q * _c(128.0, dev)).to(torch.int64)
    return (src + acc[:, None, None])[..., r]


def sincos(i, acc, src):
    s = src + acc[:, None, None]
    return torch.cos(s) + torch.sin(s)


def vec20(i, acc, src):
    dev = src.device
    a, b = _c(1.000001, dev), _c(1e-8, dev)
    v = src + acc[:, None, None]
    for _ in range(20):
        v = v * a + b
    return v


def matreduce(i, acc, src):
    """The (C, BR) @ (BR, 128) selection product: each channel's column
    sums over its ROWS_P rows, [C, 128]."""
    return (src + acc[:, None, None]).sum(dim=1)


def lanereduce8(i, acc, src):
    """Eight lane reductions of each row, scaled by 1..8: [C, ROWS_P, 8]."""
    dev = src.device
    s = src + acc[:, None, None]
    return torch.stack([(s * _c(1.0 + j, dev)).sum(dim=2) for j in range(8)],
                       dim=2)


# the variants of the common harness (mosaic_probe.py:64-78), in the order
# of csrc/probe.cu's Variant enum
FUNCTIONS = {
    "baseline": baseline,
    "gather1": gather1,
    "gather3": gather3,
    "qloop8": qloop8,
    "sincos": sincos,
    "vec20": vec20,
    "matreduce": matreduce,
    "lanereduce8": lanereduce8,
}
VARIANTS = [*FUNCTIONS, "staging", "narrow", "out store"]
VARIANT_ID = {v: i for i, v in enumerate(VARIANTS)}
# the TPU probe's row labels (mosaic_probe.py:193-205)
LABELS = {
    "baseline": "baseline load+sum (704,128)",
    "gather1": "1 lane-gather",
    "gather3": "3 lane-gathers (consecutive)",
    "qloop8": "qloop8 gather",
    "sincos": "sin+cos",
    "vec20": "20 vec ops",
    "matreduce": "matmul reduce (32,704)@(704,128)",
    "lanereduce8": "8 lane-reduces + concat",
    "staging": "staging 2C x 22-row copies",
    "narrow": "150 narrow ops (32,1)",
    "out store": "out store (32,1,128)",
}


def staging_step(acc, x):
    """One period of the staging kernel (``mosaic_probe.py:149-161``):
    each channel's rows [r0, r0 + 22) and [r0 + 1, r0 + 23) of ``x``,
    r0 = int(100 + acc * 1e-20); returns both [C, ROWS_P, 128] copies."""
    dev = x.device
    r0 = (_c(100.0, dev) + acc * _c(1e-20, dev)).to(torch.int64)
    rows = r0[:, None] + torch.arange(ROWS_P, device=dev)[None, :]
    return x[rows], x[rows + 1]


def narrow_step(v):
    """One period of the narrow kernel (``mosaic_probe.py:169-176``, 150
    multiply-adds) on the (C,) vector."""
    a, b = _c(1.000001, v.device), _c(1e-8, v.device)
    for _ in range(150):
        v = v * a + b
    return v


def probe_plain(variant: str, x: torch.Tensor, k: int):
    """The coupled K-period harness of ``variant`` in plain PyTorch, per
    channel: (out [8, 128], sums [C, 2], big [C, 200, 128] or None)."""
    dev = x.device
    sums = torch.zeros((C, 2), dtype=f32, device=dev)
    eps, one = _c(1e-20, dev), _c(1.0, dev)
    acc = torch.zeros(C, dtype=f32, device=dev)
    big = None

    def record(i, total):
        if i == 0:
            sums[:, 0] = total
        if i == k - 1:
            sums[:, 1] = total

    if variant in FUNCTIONS:
        src = x[:BR].reshape(C, ROWS_P, LANES)
        fn = FUNCTIONS[variant]
        for i in range(k):
            total = fn(i, acc, src).reshape(C, -1).sum(dim=1)
            record(i, total)
            acc = acc + total * eps + one
        out = acc[0].expand(8, LANES).clone()
    elif variant == "staging":
        for i in range(k):
            scr, scr2 = staging_step(acc, x)
            total = scr.reshape(C, -1).sum(dim=1)
            record(i, total)
            acc = acc + total * eps + one
        out = acc[0] + scr2[0, 0:8]
    elif variant == "narrow":
        v = x[:C, 0].clone()
        for i in range(k):
            v = narrow_step(v)
            record(i, v)
        out = (v[0:8, None] * torch.ones((8, LANES), dtype=f32,
                                         device=dev)).contiguous()
    elif variant == "out store":
        big = torch.zeros((C, OUT_ROWS, LANES), dtype=f32, device=dev)
        rows = x[:C]
        for i in range(k):
            row = rows + acc[:, None]
            big[:, i % OUT_ROWS] = row
            record(i, row.sum(dim=1))
            acc = acc + one
        out = acc[0] + big[0, 0:8]
    else:
        raise ValueError(f"unknown probe variant {variant!r}")
    return out, sums, big


# The kernel's per-channel sums against the plain version's: float32 sums
# of the same terms in another order (a block-wide tree on the card), so
# |got - ref| <= SUMS_TOL * (|ref| + TERMS), TERMS = 2816 the terms of one
# channel's sum, each of order one
SUMS_TOL = 1e-5
TERMS = ROWS_P * LANES


def sums_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / (|ref| + TERMS); within SUMS_TOL when they agree."""
    return float(((got.double() - ref.double()).abs()
                  / (ref.double().abs() + TERMS)).max())


def check_input(x: torch.Tensor) -> None:
    if (x.dtype != f32 or tuple(x.shape) != (X_ROWS, LANES)
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"x must be contiguous, 16-byte aligned float32 "
                         f"[{X_ROWS}, {LANES}]")


def ranks_for(sms: int) -> int:
    """CTAs per channel on a card of ``sms`` multiprocessors: the trackers'
    rule for C channels of ROWS_P * LANES elements."""
    return cluster_shape(C, ROWS_P * LANES, sms)[0]


def check_ranks(ranks) -> None:
    if ranks is not None and (not isinstance(ranks, int) or ranks < 1
                              or ranks > 8 or ranks & (ranks - 1)):
        raise ValueError(f"ranks must be a power of two <= 8, not {ranks!r}")


def probe(variant: str, x: torch.Tensor, k: int = K, *, ranks=None):
    """P1's ``variant`` over ``k`` periods: the CUDA kernel for a CUDA
    ``x``, in clusters of ``ranks`` CTAs a channel (None: ``ranks_for``
    the card), ``probe_plain`` for a CPU one."""
    check_input(x)
    check_ranks(ranks)
    if variant not in VARIANT_ID:
        raise ValueError(f"unknown probe variant {variant!r}")
    if k < 1:
        raise ValueError("k must be >= 1")
    if x.device.type == "cpu":
        return probe_plain(variant, x, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty((8, LANES), dtype=f32, device=x.device)
    sums = torch.empty((C, 2), dtype=f32, device=x.device)
    big = None
    if variant == "out store":
        big = torch.zeros((C, OUT_ROWS, LANES), dtype=f32, device=x.device)
    launch(variant, x, out, sums, big, k, ranks)
    return out, sums, big


def launch(variant: str, x, out, sums, big, k: int, ranks=None) -> None:
    """Launch P1's ``variant`` on checked CUDA tensors, on the current
    stream, without synchronising; raises if the launch fails. Records the
    cluster size in ``probe.cluster``."""
    check_ranks(ranks)
    if ranks is None:
        ranks = ranks_for(sm_count(x.device))
    fn = _build.library().gnss_probe
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(VARIANT_ID[variant], x.data_ptr(), out.data_ptr(),
                sums.data_ptr(), 0 if big is None else big.data_ptr(), k,
                ranks, stream)
    _build.check(rc, f"gnss_probe({variant})")
    probe.launches += 1
    probe.cluster = ranks


probe.launches = 0
probe.cluster = None


def probe_input(device) -> torch.Tensor:
    """The TPU probe's input: (4096, 128) float32 normal from seed 0."""
    x = np.random.default_rng(0).normal(size=(X_ROWS, LANES))
    return torch.as_tensor(x.astype(np.float32), device=device)


def timed(name: str, variant: str, reps: int = 2, *, k: int = K,
          iters: int = ITERS, device="cuda", ranks=None) -> float:
    """Best over ``reps`` of ``iters`` launches, in ns per period, after one
    warm-up launch; on the card by CUDA events."""
    dev = resolve_device(device)
    x = probe_input(dev)
    probe(variant, x, k, ranks=ranks)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    best = math.inf
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                probe(variant, x, k, ranks=ranks)
            end.record()
            torch.cuda.synchronize(dev)
            dt = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                probe(variant, x, k, ranks=ranks)
            dt = time.perf_counter() - t0
        best = min(best, dt / (iters * k) * 1e9)
    print(f"{name:36s} {best:10.1f} ns/period", flush=True)
    return best


def run_all(*, k: int = K, iters: int = ITERS, reps: int = 2,
            device="cuda", ranks=None) -> dict:
    """Every variant through ``timed``: {variant: ns per period}."""
    dev = resolve_device(device)
    return {v: timed(LABELS[v], v, reps, k=k, iters=iters, device=dev,
                     ranks=ranks)
            for v in VARIANTS}


def main(argv=None) -> int:
    ns = run_all()
    base = ns["baseline"]
    for v in VARIANTS[1:]:
        print(f"{LABELS[v]:36s} {ns[v] - base:+10.1f} ns/period over "
              "baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
