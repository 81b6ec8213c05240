"""Multi-process channel sharding over ``torch.distributed``.

Counterpart of ``gnss_sdr_tpu/parallel/distributed.py``, with
``torch.distributed`` in place of ``jax.distributed``. The receiver maps
onto several processes as it maps onto several devices:

- the channel axis splits over the ranks, each rank's range further over
  its local shards (``parallel/sharding.py``);
- the sample window is replicated: every rank builds the same window;
- the per-period [S, C] rows are small; an all-gather brings every rank's
  channel range to every rank (the PVT host among them).

``initialize`` takes the process group's address, size and rank from the
caller: nothing on the host announces a cluster. The caller names the
backend: ``"nccl"`` where each rank owns its own card, ``"gloo"`` on the
CPU and where ranks share one card (NCCL refuses two ranks on one GPU).
With gloo the rows are gathered as host tensors, as the JAX package's
``process_allgather`` returns numpy.

This module is driven by a real two-process run
(``gnss_sdr_tpu_torch/tools/dist_worker.py``, spawned by
``tests/test_torch_distributed.py`` and ``parallel/dryrun.py``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
from gnss_sdr_tpu_torch.tracking.dll_pll import TrackingState, init_state


def initialize(init_method: str, world_size: int, rank: int,
               backend: str) -> None:
    """Join the process group (``init_method`` e.g.
    ``tcp://localhost:<port>``)."""
    import torch.distributed as dist

    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def dryrun_conf(channels: int, steps_per_block: int = 4) -> DllPllConf:
    """The dry runs' small tracking configuration: 1023 chips at 1.25
    samples a chip (the JAX dry run's ``_tiny_conf``)."""
    return DllPllConf(
        fs=1.023e6 * 1.25,
        code_length_chips=1023,
        code_rate_cps=1.023e6,
        carrier_freq_hz=1575.42e6,
        max_channels=channels,
        steps_per_block=steps_per_block,
    )


def dryrun_inputs(conf: DllPllConf, device) -> tuple:
    """(state, window, codes) of the dry runs, as the JAX package builds
    them: every channel enabled, Dopplers ``linspace(-2000, 2000, C)``,
    a complex normal window from ``default_rng(0)`` and the GPS codes of
    rows ``arange(C) % 32``."""
    c = conf.max_channels
    state = init_state(conf, device)
    state = state.replace(
        enabled=torch.ones(c, dtype=torch.bool, device=device),
        carrier_doppler=torch.tensor(
            np.linspace(-2000.0, 2000.0, c).astype(np.float32),
            device=device))
    rng = np.random.default_rng(0)
    n = conf.window_samples
    window = torch.tensor(
        (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64),
        device=device)
    codes = torch.tensor(
        gps_l1_ca_code_table()[np.arange(c) % 32].astype(np.float32),
        device=device)
    return state, window, codes


def run_blocks(fn, state: TrackingState, window, codes,
               blocks: int) -> torch.Tensor:
    """``blocks`` blocks of ``fn`` (an engine with ``track_block``'s
    contract), each from the start position; the last block's [S, C]
    carrier Doppler rows."""
    pos0 = state.pos
    new_state, outs = fn(state, window, codes)
    for _ in range(blocks - 1):
        new_state, outs = fn(new_state.replace(pos=pos0), window, codes)
    return outs["carrier_doppler"].to(torch.float32)


def distributed_dryrun(steps_per_block: int = 4, blocks: int = 3,
                       channels_per_device: int = 1, local_shards: int = 1,
                       device="cuda") -> np.ndarray:
    """One signal group's channels sharded over every rank's shards.

    The group holds ``channels_per_device`` channels for each of the
    world's ``world_size * local_shards`` shards. Each rank tracks its
    contiguous channel range through the eager engine (K3 a period on the
    card), split over its ``local_shards`` shards on its device; returns
    the full [S, C] carrier-Doppler rows of the last of ``blocks`` blocks,
    all-gathered to every rank.
    """
    import torch.distributed as dist

    from gnss_sdr_tpu_torch.parallel.sharding import (
        make_channel_mesh,
        make_sharded_track_block,
        rank_device,
        shard_state,
    )

    world, rank = dist.get_world_size(), dist.get_rank()
    dev = rank_device(device, rank)
    c = channels_per_device * local_shards * world
    conf = dryrun_conf(c, steps_per_block)
    state, window, codes = dryrun_inputs(conf, dev)
    # this rank's channel range, split again over its local shards
    ranks = make_channel_mesh([dev] * world)
    (a, b), mine = ranks.ranges(c)[rank], shard_state(state, ranks)[rank]
    local = replace(conf, max_channels=b - a, fused_tracker=False)
    fn = make_sharded_track_block(local,
                                  make_channel_mesh([dev] * local_shards))
    rows = run_blocks(fn, mine, window, codes[a:b], blocks)
    # epoch gather to every rank: host tensors under gloo, device tensors
    # under NCCL
    if dist.get_backend() != "nccl":
        rows = rows.cpu()
    parts = [torch.empty_like(rows) for _ in range(world)]
    dist.all_gather(parts, rows.contiguous())
    return torch.cat(parts, dim=1).cpu().numpy()
