"""Antenna-array beamformer (reference Beamformer_Filter analog,
src/algorithms/input_filter/adapters/beamformer_filter.cc +
gnuradio_blocks/beamformer.cc: fixed complex weights summing 8 array
channels into one stream).

Counterpart of ``gnss_sdr_tpu/conditioner/beamformer.py``: the weights
apply as one weighted sum over the element axis on the beamformer's
device, with optional phase-steering weight synthesis for a uniform
linear array: w_k = exp(-j 2*pi (d/lambda) k sin(theta)) / sqrt(N).
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sdr_tpu_torch import resolve_device


def steering_weights(n_elements: int, spacing_wavelengths: float,
                     steer_deg: float) -> np.ndarray:
    """Uniform-linear-array phase-steering weights toward ``steer_deg``."""
    k = np.arange(n_elements)
    phase = -2.0 * np.pi * spacing_wavelengths * k * np.sin(
        np.deg2rad(steer_deg))
    return (np.exp(1j * phase) / np.sqrt(n_elements)).astype(np.complex64)


class Beamformer:
    """Fixed-weight beamformer over an [N_elements, T] sample block, on
    ``device`` ("cuda" by default; without a card that raises unless "cpu"
    is asked for)."""

    def __init__(self, weights: np.ndarray, *,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self.weights = np.asarray(weights, dtype=np.complex64)
        self._w = torch.as_tensor(self.weights, device=self.device)

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: [N_elements, T] complex -> [T] complex64 beamformed stream."""
        x = np.asarray(x, dtype=np.complex64)
        if x.ndim != 2 or x.shape[0] != len(self.weights):
            raise ValueError(
                f"beamformer expects [{len(self.weights)}, T] input, "
                f"got {x.shape}")
        xt = torch.as_tensor(x, device=self.device)
        return torch.sum(self._w[:, None] * xt, dim=0).cpu().numpy()


class ArrayConditioner:
    """Array_Signal_Conditioner analog: beamform [N, T] element streams to
    one stream, then run the regular conditioner chain on it."""

    def __init__(self, beamformer: Beamformer, inner) -> None:
        self.beamformer = beamformer
        self.inner = inner

    @property
    def cfg(self):
        return getattr(self.inner, "cfg", None)

    def process(self, raw: np.ndarray) -> np.ndarray:
        raw = np.asarray(raw)
        if raw.ndim == 1:
            raise ValueError(
                "Array_Signal_Conditioner needs a multichannel source "
                "([N_elements, T]); use Signal_Conditioner for one stream")
        return self.inner.process(self.beamformer.process(raw))
