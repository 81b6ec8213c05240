"""The multi-device dry run.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``: three
sharded tracking blocks over an n-device channel mesh, a sharded PCPS
over 32 PRNs on the same mesh, and the two-process run
(``tools/dist_worker.py``) with the channel rows gathered to rank 0.

    from gnss_sdr_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(1)                  # on the card
    dryrun_multichip(2, device="cpu")    # two CPU shards

On CUDA the mesh is ``cuda:0`` .. ``cuda:n-1`` and raises when fewer cards
are present; the two ranks use gloo and share the host's cards (rank r on
card ``r % count``).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(world: int = 2, local_shards: int = 4, device="cuda",
                backend: str = "gloo", timeout: float = 240.0) -> dict:
    """``world`` ranks of ``tools/dist_worker.py`` as processes; returns
    ``{"rows": [S, C] array from rank 0, "launches": [per-rank K3
    launches]}``. Raises ``RuntimeError`` with a worker's output when one
    exits non-zero."""
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "gnss_sdr_tpu_torch.tools.dist_worker",
             str(rank), str(world), str(port), str(local_shards),
             "--device", str(device), "--backend", backend],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=dict(os.environ))
        for rank in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"dist_worker rank {rank} exited {p.returncode}:\n{so}\n{se}")
    rows, launches = None, [0] * world
    for so, _ in outs:
        for line in so.splitlines():
            if line.startswith("DIST_ROWS "):
                rows = np.asarray(json.loads(line[len("DIST_ROWS "):]),
                                  np.float32)
            elif line.startswith("DIST_LAUNCHES "):
                rec = json.loads(line[len("DIST_LAUNCHES "):])
                launches[rec["rank"]] = rec["correlator"]
    if rows is None:
        raise RuntimeError("rank 0 printed no rows")
    return {"rows": rows, "launches": launches}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 240.0) -> dict:
    """Sharded tracking (three blocks, 2 channels a device) and PCPS over
    an ``n_devices`` mesh, then the two-process run with 4 shards a rank
    (``timeout`` s at most); returns the rows, the acquisition statistics
    and the two-process result."""
    from gnss_sdr_tpu_torch.acquisition import AcqConfig, PcpsAcquisition
    from gnss_sdr_tpu_torch.parallel.distributed import (
        dryrun_conf,
        dryrun_inputs,
        run_blocks,
    )
    from gnss_sdr_tpu_torch.parallel.sharding import (
        device_mesh,
        make_sharded_track_block,
    )

    mesh = device_mesh(n_devices, device)
    home = mesh.devices[0]
    conf = dryrun_conf(2 * n_devices)
    state, window, codes = dryrun_inputs(conf, home)
    fn = make_sharded_track_block(conf, mesh)
    rows = run_blocks(fn, state, window, codes, 3).cpu().numpy()
    assert rows.shape == (conf.steps_per_block, conf.max_channels)

    # sharded batched acquisition over the same mesh (hypothesis axis)
    from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code_table

    acq_conf = AcqConfig(fs=conf.fs, code_length_chips=1023,
                         code_rate_cps=1.023e6, doppler_max_hz=2000.0,
                         doppler_step_hz=500.0)
    acq = PcpsAcquisition(acq_conf, gps_l1_ca_code_table(),
                          list(range(1, 33)), mesh=mesh, device=home)
    rng = np.random.default_rng(1)
    n = acq_conf.input_samples
    xb = np.broadcast_to(
        (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64),
        (2 * n_devices, n))
    res = acq.acquire(xb, np.arange(2 * n_devices) % 32)
    assert res.test_statistic.shape == (2 * n_devices,)
    print(f"dryrun_multichip OK: {n_devices} devices, {conf.max_channels} "
          f"channels, {conf.steps_per_block} periods x3 blocks "
          f"({'fused' if fn.fused else 'eager'}) + sharded acquisition; "
          f"doppler row0: {rows[0, :4]}", flush=True)

    dist = run_workers(2, 4, device=home.type, timeout=timeout)
    print("dryrun_multichip 2-process OK: 2 ranks x 4 shards, channel "
          "shards gathered to rank 0", flush=True)
    return {"rows": rows, "fused": fn.fused,
            "acq_statistic": res.test_statistic, "dist": dist}
