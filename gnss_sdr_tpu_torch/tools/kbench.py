"""Fused-tracker micro-benchmark: K2 and K4 at C = 32, K = 200.

Counterpart of ``tools/kbench.py``, to its protocol: a random-noise window
from seed 0, the GPS L1 C/A codes of PRN 1-32, the same seed scalars, and
each launch's last row repacked into the next launch's scalars with the
position reset to 0; one warm-up launch (which builds the kernels), then
``iters`` launches timed with CUDA events after ``torch.cuda.synchronize``.
Prints ``{kind}: Msps us/ch-period (build s)`` per variant.

Variants: ``full`` runs K2 (``track_full``, int32 positions, as the
receiver calls it) and ``simple`` runs K4 (``track_simple``). The TPU
tool's ``-qloop``/``-window2`` suffixes name TPU table layouts; they are
accepted and map to the one CUDA kernel of the kind.

    python -m gnss_sdr_tpu_torch.tools.kbench [variant ...]

From Python, ``run(kind, C=..., K=..., iters=..., device="cpu")`` runs the
plain versions at a small size.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device
from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu_torch.ops import track_kernel as tk
from gnss_sdr_tpu_torch.ops.slots import num_scalars
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
from gnss_sdr_tpu_torch.tracking.dll_pll import tap_offsets_chips

FS = 2.6e6
CHANNELS = 32
STEPS = 200
ITERS = 10
KINDS = ("full", "simple")
REPLICAS = ("qloop", "window2")


def parse_variant(variant: str) -> str:
    """The kind of ``full``, ``simple`` or the TPU tool's
    ``{kind}-{qloop,window2}``."""
    kind, _, replica = variant.partition("-")
    if kind not in KINDS or (replica and replica not in REPLICAS):
        raise ValueError(f"unknown kbench variant {variant!r}")
    return kind


def build(kind: str, *, C: int = CHANNELS, K: int = STEPS, device="cuda"):
    """The configuration, kernel spec and inputs of ``tools/kbench.py``'s
    ``build`` and ``run`` (``:40-87``): returns (conf, spec, window, codes,
    scal0) on ``device``."""
    dev = resolve_device(device)
    conf = DllPllConf(
        fs=FS, code_length_chips=1023, code_rate_cps=1.023e6,
        carrier_freq_hz=1575.42e6, max_channels=C, steps_per_block=K)
    kw = dict(fs=FS, code_rate_cps=1.023e6, carrier_freq_hz=1575.42e6,
              pll_order=conf.pll_filter_order,
              dll_order=conf.dll_filter_order, interp_code=conf.interp_code)
    taps = np.asarray(tap_offsets_chips(conf))
    if kind == "full":
        spec = tk.make_full_spec(K, conf.max_step_samples, 1023, taps, **kw)
        ns = num_scalars(conf.num_taps)
    elif kind == "simple":
        spec = tk.make_simple_spec(K, conf.max_step_samples, 1023, taps,
                                   pll_bw_hz=35.0, dll_bw_hz=2.0, **kw)
        ns = tk.SIMPLE_SCALARS
    else:
        raise ValueError(f"unknown kbench kind {kind!r}")

    n_win = conf.window_samples
    npadw = ((n_win + 127) // 128 + 32) * 128
    rng = np.random.default_rng(0)
    wr = rng.normal(size=(npadw // 128, 128)).astype(np.float32)
    wi = rng.normal(size=(npadw // 128, 128)).astype(np.float32)
    window = torch.as_tensor((wr.ravel() + 1j * wi.ravel()).astype(
        np.complex64), device=dev)
    codes = torch.as_tensor(
        gps_l1_ca_code_table()[np.arange(C) % 32].astype(np.float32),
        device=dev)
    scal0 = np.zeros((C, ns), np.float32)
    scal0[:, 1] = 0.3
    scal0[:, 4] = np.linspace(-4000, 4000, C)
    scal0[:, 7] = 1
    if kind == "full":
        scal0[:, 10] = 1
        scal0[:, 17] = 35.0
        scal0[:, 18] = 2.0
    return conf, spec, window, codes, torch.as_tensor(scal0, device=dev)


def repack(out: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    """The next launch's scalars from the last row (``tools/kbench.py:89-99``):
    position 0, the NCO and integrator lanes, enabled, slots 10+ kept."""
    c, ns = scal.shape
    last = out[:, -1, :]
    zeros = torch.zeros((c,), dtype=torch.float32, device=out.device)
    cols = [zeros, last[:, 13], last[:, 12], last[:, 14], last[:, 11],
            last[:, 15], last[:, 16], torch.ones_like(zeros),
            last[:, 18], last[:, 19]]
    cols += [scal[:, j] for j in range(10, ns)]
    return torch.stack(cols, dim=1).contiguous()


def run(variant: str, *, C: int = CHANNELS, K: int = STEPS,
        iters: int = ITERS, device="cuda") -> dict:
    """One variant to ``tools/kbench.py``'s protocol; prints its line and
    returns {kind, msps, us_per_ch_period, build_s, checksum}, the checksum
    being the float32 sum of lanes 2 and 10 over the ``iters`` timed
    launches."""
    kind = parse_variant(variant)
    if kind != variant:
        print(f"{variant}: the TPU table layout maps to the one CUDA kernel "
              f"of {kind!r}", flush=True)
    conf, spec, window, codes, scal0 = build(kind, C=C, K=K, device=device)
    dev = window.device
    cuda = dev.type == "cuda"
    pos0 = torch.zeros((C,), dtype=torch.int32, device=dev)

    def fused(scal):
        if kind == "full":
            # position slot 0 is 0 in every launch: int32 positions 0
            return tk.track_full(window, codes, scal, pos0, spec)
        return tk.track_simple(window, codes, scal, spec)

    def run_once(chk, scal):
        out = fused(scal)
        chk2 = chk + out[:, :, 2].sum() + out[:, :, 10].sum()
        return chk2, repack(out, scal)

    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    chk, scal = run_once(zero, scal0)
    sync()
    build_s = time.perf_counter() - t0

    chk, scal = zero, scal0
    sync()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            chk, scal = run_once(chk, scal)
        end.record()
        sync()
        dt = start.elapsed_time(end) * 1e-3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            chk, scal = run_once(chk, scal)
        dt = time.perf_counter() - t0
    msps = iters * C * K * conf.samples_per_code / dt / 1e6
    us_per_chper = dt / (iters * C * K) * 1e6
    print(f"{kind}: {msps:8.1f} Msps  {us_per_chper:6.3f} us/ch-period  "
          f"(build {build_s:.1f}s)", flush=True)
    return dict(kind=kind, msps=msps, us_per_ch_period=us_per_chper,
                build_s=build_s, checksum=float(chk))


def main(argv=None) -> int:
    variants = list(argv if argv is not None else sys.argv[1:]) or list(KINDS)
    for v in variants:
        run(v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
