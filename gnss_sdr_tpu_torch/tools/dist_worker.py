"""One rank of the two-process distributed dry run.

Counterpart of ``tools/dist_worker.py``::

    python -m gnss_sdr_tpu_torch.tools.dist_worker <rank> <world> <port> \\
        <local_shards> [--device cuda|cpu] [--backend gloo|nccl]

Joins the ``torch.distributed`` group at ``tcp://localhost:<port>``, runs
the channel-sharded tracking dry run (``parallel/distributed.py``) with
``local_shards`` shards on this rank's device, and prints the gathered
Doppler rows as ``DIST_ROWS <json>`` (rank 0 only). Every rank also
prints ``DIST_LAUNCHES <json>``, the kernel launches it made (K3 on the
card). ``--device`` is ``cuda`` by default, which raises without a card;
``--backend`` is ``gloo`` by default (the CPU, or ranks sharing a card),
``nccl`` where each rank owns its own card.

Spawned by ``tests/test_torch_distributed.py`` and
``gnss_sdr_tpu_torch.parallel.dryrun.dryrun_multichip``.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("local_shards", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from gnss_sdr_tpu_torch import resolve_device
    from gnss_sdr_tpu_torch.ops import correlator as k3
    from gnss_sdr_tpu_torch.parallel import distributed

    resolve_device(args.device)
    if args.device == "cpu":
        torch.set_num_threads(1)        # the ranks share the host's cores
    distributed.initialize(f"tcp://localhost:{args.port}", args.world,
                           args.rank, args.backend)
    try:
        k3.correlator.launches = 0
        rows = distributed.distributed_dryrun(
            local_shards=args.local_shards, device=args.device)
        print("DIST_LAUNCHES " + json.dumps(
            {"rank": args.rank, "correlator": k3.correlator.launches}),
            flush=True)
        if args.rank == 0:
            print("DIST_ROWS " + json.dumps(rows.tolist()), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
