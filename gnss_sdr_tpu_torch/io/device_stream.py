"""Device-resident sample stream buffer.

Counterpart of ``gnss_sdr_tpu/io/device_stream.py``. The receiver's
tracking loop reads overlapping windows of the sample stream; each chunk
is uploaded once into a fixed-length rolling complex64 buffer on the
device, and the tracker reads its samples there
(``Tracker.process_device``). This is the device's counterpart of GNU
Radio's circular buffers between blocks: the "read pointers" are the
per-channel sample positions inside the tracking kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sdr_tpu_torch import SAMPLE_DTYPE, resolve_device
from gnss_sdr_tpu_torch.utils import trace


class DeviceStream:
    """Rolling complex64 [L] device buffer holding the last L stream samples.

    Absolute indexing: stream sample ``s`` lives at ``window[s - base]`` for
    ``base <= s < end``; the region before the first fed sample reads as
    zeros (base is negative until the buffer fills)."""

    def __init__(self, length_samples: int, *,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self.length = int(length_samples)
        self._buf = torch.zeros(self.length, dtype=SAMPLE_DTYPE,
                                device=self.device)
        self.end = 0                      # absolute end of fed samples
        self._i8_scale: float | None = None

    @property
    def base(self) -> int:
        return self.end - self.length

    def append(self, chunk: np.ndarray, quantize_i8: bool = False) -> None:
        """Append one chunk (complex host array).

        ``quantize_i8``: upload the chunk as int8 I/Q [N, 2] and widen on
        the device (a quarter of the bytes); the scale locks on the first
        chunk's RMS (tracking is scale-invariant, and a per-chunk scale
        would amplitude-modulate the stream mid-block)."""
        n = len(chunk)
        if n == 0:
            return
        with trace.span("feed.upload"):
            host = np.asarray(chunk, np.complex64)
            if quantize_i8:
                with trace.span("feed.quantize"):
                    host = self._quantize(host)
                dev_i8 = torch.as_tensor(host, device=self.device)
                new = torch.view_as_complex(
                    dev_i8.to(torch.float32) * self._i8_scale)
            else:
                new = torch.as_tensor(host, device=self.device)
            trace.count("h2d.feed.copies")
            trace.count("h2d.feed.bytes", host.nbytes)
            if n >= self.length:
                self._buf = new[-self.length:].contiguous()
            else:
                self._buf = torch.cat([self._buf[n:], new])
            self.end += n

    def _quantize(self, chunk: np.ndarray) -> np.ndarray:
        """The chunk as int8 I/Q [N, 2] at the locked scale."""
        if self._i8_scale is None:
            rms = float(np.sqrt(np.mean(np.abs(chunk) ** 2))) or 1.0
            # +-4 sigma spans the int8 range
            self._i8_scale = 4.0 * rms / 127.0
        s = self._i8_scale
        i8 = np.empty((len(chunk), 2), np.int8)
        i8[:, 0] = np.clip(np.round(chunk.real / s), -127, 127)
        i8[:, 1] = np.clip(np.round(chunk.imag / s), -127, 127)
        return i8

    @property
    def window(self) -> torch.Tensor:
        return self._buf
