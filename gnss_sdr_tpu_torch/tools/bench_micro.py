"""Micro-benchmark suite mirroring the reference's tests/benchmarks/.

Counterpart of ``tools/bench_micro.py``, with the same seven benches,
names and units (reference analogs: Google Benchmark binaries,
tests/benchmarks/):
  benchmark_copy         -> packed-capture sample decode (io/formats.py)
  benchmark_atan2        -> PLL discriminators (tracking/discriminators.py),
                            on the device
  benchmark_detector     -> acquisition peak statistic over a PCPS grid,
                            torch ops on the device
  benchmark_preamble     -> LNAV preamble correlation over a symbol stream
  benchmark_crypto       -> OSNMA primitives (SHA-256, HMAC-SHA-256)
  benchmark_osnma        -> TESLA key chain walk
  benchmark_reed_solomon -> Galileo CED RS(255,223) encode + decode

The copy, preamble, crypto, OSNMA and Reed-Solomon benches run the port's
NumPy copies on the host. Device work is timed with a
``torch.cuda.synchronize()`` before each clock read, so no queued launch
is timed. Each bench prints one JSON line per row:
{"bench": ..., "value": ..., "unit": ...}.

    python -m gnss_sdr_tpu_torch.tools.bench_micro [--reps N] [--only NAME]

Runs on the card by default and raises without one; ``--device cpu`` (or
``run(..., device="cpu")``) runs the device benches on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import hmac as hmac_mod
import json
import time

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, reps: int, dev: torch.device | None = None) -> float:
    """Seconds per call of ``fn`` over ``reps`` calls after one warm-up;
    with a CUDA ``dev`` the device is synchronised before each clock
    read."""
    fn()  # warm-up (first launch, caches)
    if dev is not None:
        _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if dev is not None:
        _sync(dev)
    return (time.perf_counter() - t0) / reps


def bench_copy(reps: int, dev: torch.device):
    from gnss_sdr_tpu_torch.io.formats import decode_samples, encode_samples

    n = 1 << 20
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    raw2 = encode_samples(x, "2bit_cpx")
    dt = timeit(lambda: decode_samples(raw2, "2bit_cpx"), reps)
    yield {"bench": "copy_decode_2bit", "value": n / dt / 1e6,
           "unit": "Msamples/s"}
    raw8 = encode_samples(x, "ibyte")
    dt = timeit(lambda: decode_samples(raw8, "ibyte"), reps)
    yield {"bench": "copy_decode_ibyte", "value": n / dt / 1e6,
           "unit": "Msamples/s"}


def bench_atan2(reps: int, dev: torch.device):
    from gnss_sdr_tpu_torch.tracking.discriminators import (
        pll_atan2,
        pll_costas_atan,
    )

    n = 1 << 16
    p_i = torch.randn(n, generator=torch.Generator().manual_seed(0)).to(dev)
    p_q = torch.randn(n, generator=torch.Generator().manual_seed(1)).to(dev)
    dt = timeit(lambda: pll_costas_atan(p_i, p_q), reps, dev)
    yield {"bench": "atan_costas", "value": n / dt / 1e6, "unit": "Mops/s"}
    dt = timeit(lambda: pll_atan2(p_i, p_q), reps, dev)
    yield {"bench": "atan2_4quad", "value": n / dt / 1e6, "unit": "Mops/s"}


def detect(g: torch.Tensor):
    """Peak statistic over [rows, bins, delays] grids: the flat argmax per
    row and the peak over the row's mean power (pcps_acquisition.cc
    compute_statistics analog)."""
    flat = g.reshape(g.shape[0], -1)
    idx = torch.argmax(flat, dim=1)
    peak = torch.take_along_dim(flat, idx[:, None], dim=1)[:, 0]
    power = flat.mean(dim=1)
    return idx, peak / power


def bench_detector(reps: int, dev: torch.device):
    grid = np.abs(np.random.default_rng(2).standard_normal(
        (8, 25, 4096))).astype(np.float32)
    g = torch.as_tensor(grid, device=dev)
    dt = timeit(lambda: detect(g), reps, dev)
    yield {"bench": "detector_cfar", "value": grid.size / dt / 1e6,
           "unit": "Mcells/s"}


def bench_preamble(reps: int, dev: torch.device):
    from gnss_sdr_tpu_torch.telemetry.lnav import PREAMBLE_BITS

    sym = np.random.default_rng(3).choice(
        [-1.0, 1.0], size=1 << 16).astype(np.float32)
    pre = (PREAMBLE_BITS * 2 - 1).astype(np.float32)

    def corr():
        return np.convolve(sym, pre[::-1], mode="valid")

    dt = timeit(corr, reps)
    yield {"bench": "preamble_corr", "value": len(sym) / dt / 1e6,
           "unit": "Msymbols/s"}


def bench_crypto(reps: int, dev: torch.device):
    data = bytes(range(256)) * 16
    key = b"k" * 32
    dt = timeit(lambda: hashlib.sha256(data).digest(), reps)
    yield {"bench": "sha256_4k", "value": len(data) / dt / 1e6, "unit": "MB/s"}
    dt = timeit(
        lambda: hmac_mod.new(key, data, hashlib.sha256).digest(), reps)
    yield {"bench": "hmac_sha256_4k", "value": len(data) / dt / 1e6,
           "unit": "MB/s"}


def bench_osnma(reps: int, dev: torch.device):
    from gnss_sdr_tpu_torch.telemetry.osnma import (
        ChainParams,
        tesla_previous_key,
    )

    params = ChainParams(hash_func=0, mac_func=0, key_size_bits=128,
                         tag_size_bits=40, alpha=0x25D9E58)

    def walk():
        k = b"\x42" * 16
        for i in range(100):
            k = tesla_previous_key(params, k, 100 - i)
        return k

    dt = timeit(walk, max(1, reps // 4))
    yield {"bench": "tesla_chain_walk", "value": 100 / dt / 1e3,
           "unit": "kkeys/s"}


def bench_reed_solomon(reps: int, dev: torch.device):
    from gnss_sdr_tpu_torch.telemetry.reed_solomon import ReedSolomon

    rs = ReedSolomon()          # Galileo CED RS(255,32)
    info = (np.arange(rs.k, dtype=np.uint8) * 7 + 3).astype(np.uint8)
    code = rs.encode(info)
    corrupted = code.copy()
    corrupted[5] ^= 0xA5
    corrupted[40] ^= 0x5A
    dt = timeit(lambda: rs.encode(info), max(1, reps // 4))
    yield {"bench": "rs_encode_ced", "value": 1 / dt, "unit": "codewords/s"}
    dt = timeit(lambda: rs.decode(corrupted), max(1, reps // 4))
    yield {"bench": "rs_decode_2err", "value": 1 / dt, "unit": "codewords/s"}


ALL = [bench_copy, bench_atan2, bench_detector, bench_preamble,
       bench_crypto, bench_osnma, bench_reed_solomon]


def run(reps: int = 20, only: str = "", device="cuda") -> list[dict]:
    """Every bench whose function name contains ``only``; prints and
    returns its rows."""
    dev = resolve_device(device)
    rows = []
    for b in ALL:
        if only and only not in b.__name__:
            continue
        for row in b(reps, dev):
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the atan2 and detector benches "
                         "(default cuda)")
    args = ap.parse_args(argv)
    run(args.reps, args.only, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
