"""Per-channel fused tracker (kernel K2).

Counterpart of ``gnss_sdr_tpu/ops/track_kernel.py:476-959``
(``make_fused_tracker_full``): one launch runs K code periods of
closed-loop DLL/PLL(/FLL) tracking for C channels, one channel per warp
(``csrc/track_full.cu``). Its semantics, inputs and output rows are K1's
(``ops/track_kernel_blocked.py``): a complex64 window [W], the float32
chip table [C, L], the float32 scalar block [C, 24 + 2T + 1] of
``ops/slots.py`` and int32 positions [C]; the output is float32
[C, K, 128]. Only the mapping of the loop onto the card differs, so K2's
plain version is K1's, ``track_blocked_plain``.

``track_full`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.
``tracking/fused.py`` selects K2 when ``GNSS_SDR_TPU_FUSED=perchannel``.

Modes: T = 3 taps, PLL/DLL orders 1-3, FLL assist, the atan2 flag,
extended integration and both replica forms. Pilot/secondary tracking,
FDMA and T = 5 raise ``NotImplementedError``, as for K1.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from gnss_sdr_tpu_torch.ops.slots import LANES
from gnss_sdr_tpu_torch.ops.track_kernel_blocked import (
    BlockedSpec,
    check_inputs,
    launch_entry,
    make_blocked_spec,
    track_blocked_plain,
)

# K2 computes what K1 computes on the same inputs
track_full_plain = track_blocked_plain


@dataclasses.dataclass(frozen=True)
class FullSpec(BlockedSpec):
    """K1's static configuration, naming the per-channel kernel."""

    kernel: ClassVar[str] = "track_full"


def make_full_spec(n_periods: int, n_max: int, code_len: int, tap_offsets,
                   **kw) -> FullSpec:
    """``make_blocked_spec``'s arguments and checks, for K2."""
    spec = make_blocked_spec(n_periods, n_max, code_len, tap_offsets, **kw)
    return FullSpec(**{f.name: getattr(spec, f.name)
                       for f in dataclasses.fields(spec)})


def track_full(window, codes, scalars, pos, spec: BlockedSpec) -> torch.Tensor:
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    check_inputs(window, codes, scalars, pos, spec)
    if window.device.type == "cpu":
        return track_full_plain(window, codes, scalars, pos, spec)
    if window.device.type != "cuda":
        raise ValueError(f"unsupported device {window.device}")
    out = torch.empty((scalars.shape[0], spec.n_periods, LANES),
                      dtype=torch.float32, device=window.device)
    launch(window, codes, scalars, pos, spec, out)
    return out


def launch(window, codes, scalars, pos, spec: BlockedSpec,
           out: torch.Tensor) -> None:
    """Launch K2 on checked CUDA inputs into ``out`` [C, K, 128], on the
    current stream, without synchronising."""
    launch_entry("gnss_track_full", window, codes, scalars, pos, spec, out)
    track_full.launches += 1


track_full.launches = 0
