"""gnss_sdr_tpu_torch — the GPS L1 C/A, L2C and L5, QZSS L1 C/A and L5,
SBAS L1, Galileo E1, E5a, E5b and E6B, GLONASS L1 and L2 C/A (FDMA) and
BeiDou B1I and B3I (D1 and GEO D2) receiver of ``gnss_sdr_tpu`` on
PyTorch and CUDA, on one band or several, from Python or
from a ``.conf`` file (``python -m gnss_sdr_tpu_torch.main -c
<file.conf>``).

The package mirrors ``gnss_sdr_tpu``'s module paths and public names. The
JAX package stays the reference; this one imports neither it nor JAX.
Pure-NumPy modules (codes, constants, config, I/O sources and formats,
output writers, telemetry, observables, PVT, the scenario simulators) are
copies of the JAX package's files. Tracking runs through hand-written CUDA
kernels under ``csrc/``: the K-period fused tracker in two mappings, a
thread-block cluster of CTAs per channel (K1,
``ops/track_kernel_blocked.py``) and one CTA per channel (K2,
``ops/track_kernel.py``, under ``GNSS_SDR_TPU_FUSED=perchannel``), and the
one-period correlator (K3, ``ops/correlator.py``). The kernel-bench tools
(``tools/kbench.py``, ``tools/mosaic_probe.py``) add the simple fused
tracker (K4, ``ops/track_kernel.py``) and the primitive-cost probe (P1).
Each kernel has a plain PyTorch version beside it, which the wrappers use
only for tensors that lie on the CPU. A group's channels shard over
several devices (``parallel/``: ``ReceiverConfig.num_devices``, the
``mesh`` of ``Tracker`` and of the PCPS engines, a two-process run over
``torch.distributed``).

Device policy: entry points take a ``device`` and default to ``"cuda"``.
Without CUDA they raise unless the caller asked for ``"cpu"``; there is no
silent fallback.

Dtype policy: bulk per-sample tensors are complex64/float32; per-channel
NCO and time state (code phase, code frequency, accumulated carrier
phase) is float64.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

SAMPLE_DTYPE = torch.complex64


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``device``; raises if CUDA was asked for and
    is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def canonical_device(device) -> torch.device:
    """``device`` with its CUDA index filled in ("cuda" -> "cuda:<current
    device>"), so that two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
