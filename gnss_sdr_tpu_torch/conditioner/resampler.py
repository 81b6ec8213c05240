"""Sample-rate conversion (reference: src/algorithms/resampler/).

Counterpart of ``gnss_sdr_tpu/conditioner/resampler.py``:

- ``direct_resample`` <- Direct_Resampler (nearest input sample per output
  tick, adapters/direct_resampler_conditioner.cc);
- ``polyphase_resample`` <- Mmse_Resampler (GR's 8-tap MMSE fractional
  interpolator, adapters/mmse_resampler_conditioner.cc), re-expressed as a
  windowed-sinc gather: each output sample is a T-tap dot product at its
  fractional input position, all outputs computed at once on the tensor's
  device.

Both are block functions: given a block and the resampling ratio they
produce the requested number of output samples; the streaming conditioner
carries the fractional position from block to block.
"""

from __future__ import annotations

import numpy as np
import torch


def direct_resample(
    x: torch.Tensor, ratio_in_per_out: float, n_out: int, frac0: float = 0.0
) -> torch.Tensor:
    """Nearest-sample decimation/interpolation.

    x: [N] input block; output[k] = x[round(frac0 + k * ratio)].
    """
    pos = frac0 + ratio_in_per_out * torch.arange(
        n_out, dtype=torch.float64, device=x.device)
    idx = torch.clamp(torch.round(pos).to(torch.int64), 0, x.shape[0] - 1)
    return x[idx]


def polyphase_resample(
    x: torch.Tensor,
    ratio_in_per_out: float,
    n_out: int,
    frac0: float = 0.0,
    num_taps: int = 8,
) -> torch.Tensor:
    """Fractional resampling with an on-the-fly windowed-sinc kernel.

    Rather than precomputing GR's 128-phase MMSE tap bank and snapping to
    the nearest phase, the taps are evaluated exactly at each output's
    fractional offset (sinc x raised-cosine window), so there is no
    phase-quantization noise. x must provide ``num_taps`` guard samples
    beyond the last read position.
    """
    half = num_taps // 2
    dev = x.device
    pos = float(frac0) + float(ratio_in_per_out) * torch.arange(
        n_out, dtype=torch.float64, device=dev)
    base = torch.floor(pos)
    mu = (pos - base).to(torch.float32)                          # [n_out]
    k = torch.arange(-half + 1, half + 1, dtype=torch.float32, device=dev)
    t = k[None, :] - mu[:, None]                                 # [n_out, T]
    window = torch.cos(np.pi * t / (2 * half)) ** 2
    h = torch.sinc(t) * torch.where(torch.abs(t) < half, window, 0.0)
    h = h / torch.sum(h, dim=1, keepdim=True)
    idx = torch.clamp(
        base.to(torch.int64)[:, None] + k.to(torch.int64)[None, :],
        0, x.shape[0] - 1)
    windows = x[idx]                                             # [n_out, T]
    re = torch.sum(windows.real * h, dim=1)
    im = torch.sum(windows.imag * h, dim=1)
    return torch.complex(re, im)
