"""Channel-sharding scaling harness.

Counterpart of ``tools/scaling.py``: runs the sharded tracking block
(``parallel/sharding.py``) at 1, 2, 4 and 8 shards and reports the time
per block, the channel-samples per second and the ratio to one shard::

    python -m gnss_sdr_tpu_torch.tools.scaling [--channels 32] \\
        [--steps 20] [--iters 10] [--shards 1 2 4 8] [--cards N] \\
        [--device cuda|cpu]

The shards are placed by ``parallel.sharding.device_mesh``: on CUDA (the
default; raises without a card) one card a shard, which raises when the
host has fewer cards than shards, or spread over ``--cards`` cards; on
the CPU all there. With ``--cards 1`` every shard shares one card, so
the ratio measures the shards' overhead (one launch and one slice of the
packed block per shard), not scaling: ideal is flat. From Python,
``run(...)`` returns the same numbers.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device
from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu_torch.parallel.sharding import (
    device_mesh,
    make_sharded_track_block,
)
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
from gnss_sdr_tpu_torch.tracking.dll_pll import init_state


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_mesh(n: int, channels: int, steps: int, iters: int,
               device="cuda", cards: int | None = None) -> float:
    """Seconds per sharded block over ``n`` shards on ``cards`` cards
    (``device_mesh``; wall clock, after one warm-up block; every block
    from the same start)."""
    conf = DllPllConf(
        fs=2.6e6, code_length_chips=1023, code_rate_cps=1.023e6,
        carrier_freq_hz=1575.42e6, max_channels=channels,
        steps_per_block=steps)
    mesh = device_mesh(n, device, cards)
    home = mesh.devices[0]
    state = init_state(conf, home).replace(
        enabled=torch.ones(channels, dtype=torch.bool, device=home),
        carrier_doppler=torch.tensor(
            np.linspace(-4000, 4000, channels).astype(np.float32),
            device=home))
    rng = np.random.default_rng(0)
    w = conf.window_samples
    window = torch.tensor(
        (rng.normal(size=w) + 1j * rng.normal(size=w)).astype(np.complex64),
        device=home)
    codes = torch.tensor(
        gps_l1_ca_code_table()[np.arange(channels) % 32].astype(np.float32),
        device=home)
    fn = make_sharded_track_block(conf, mesh)
    pos0 = state.pos
    st, _ = fn(state, window, codes)
    for d in mesh.distinct():
        _sync(d)
    t0 = time.perf_counter()
    for _ in range(iters):
        st, outs = fn(st.replace(pos=pos0), window, codes)
    for d in mesh.distinct():
        _sync(d)
    return (time.perf_counter() - t0) / iters


def run(shards=(1, 2, 4, 8), channels: int = 32, steps: int = 20,
        iters: int = 10, device="cuda", cards: int | None = None) -> dict:
    """{shards: seconds per block} for each shard count that divides the
    channels; ``cards`` as ``device_mesh`` takes it (at most the shard
    count)."""
    resolve_device(device)
    return {n: bench_mesh(n, channels, steps, iters, device,
                          None if cards is None else min(cards, n))
            for n in shards if channels % n == 0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--cards", type=int, default=None,
                    help="CUDA cards the shards spread over (default: one "
                         "a shard)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    place = (f"shards on {args.cards} card(s)" if args.cards
             else "one card a shard")
    print(f"device {args.device}, {count} device(s), {place}", flush=True)
    results = run(args.shards, args.channels, args.steps, args.iters,
                  args.device, args.cards)
    samples = args.channels * args.steps * 2600
    for n, dt in results.items():
        print(f"shards={n}: {dt * 1e3:8.3f} ms/block  "
              f"{samples / dt / 1e6:9.1f} Msamples/s", flush=True)
    if 1 in results:
        for n, dt in results.items():
            if n != 1:
                print(f"shards={n}: time ratio vs 1 shard "
                      f"{dt / results[1]:6.3f}", flush=True)
    return results


if __name__ == "__main__":
    main()
