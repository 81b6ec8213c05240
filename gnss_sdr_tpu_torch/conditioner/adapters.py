"""Data-type adapters (reference: src/algorithms/data_type_adapter/).

Counterpart of ``gnss_sdr_tpu/conditioner/adapters.py``: the capture's
integer formats widen to complex64 on the tensor's device (the reference's
Ibyte_To_Complex, Ishort_To_Complex, Byte_To_Short and
Cshort_To_Gr_Complex adapters), so a pipeline can ship raw integers to the
card, a quarter to an eighth of the bytes of complex64. Every adapter is a
plain cast: the values are exact in float32, so the result equals the JAX
adapters' bit for bit.
"""

from __future__ import annotations

import torch


def _pairs_to_complex(iq: torch.Tensor) -> torch.Tensor:
    x = iq.to(torch.float32).reshape(-1, 2)
    return torch.complex(x[:, 0], x[:, 1])


def ibyte_to_complex(iq: torch.Tensor) -> torch.Tensor:
    """Interleaved int8 I,Q [2N] -> complex64 [N] (Ibyte_To_Complex)."""
    return _pairs_to_complex(iq)


def ishort_to_complex(iq: torch.Tensor) -> torch.Tensor:
    """Interleaved int16 I,Q [2N] -> complex64 [N] (Ishort_To_Complex)."""
    return _pairs_to_complex(iq)


def byte_to_complex(b: torch.Tensor) -> torch.Tensor:
    """Real int8 [N] -> complex64 [N] with zero Q (Byte_To_Short; real IF
    streams are shifted to baseband by the freq-xlating filter)."""
    return b.to(torch.float32).to(torch.complex64)


def short_to_complex(s: torch.Tensor) -> torch.Tensor:
    """Real int16 [N] -> complex64 [N]."""
    return s.to(torch.float32).to(torch.complex64)


def cshort_to_complex(iq: torch.Tensor) -> torch.Tensor:
    """[N, 2] or interleaved [2N] int16 -> complex64 (Cshort_To_Gr_Complex)."""
    return _pairs_to_complex(iq)


ADAPTERS = {
    "ibyte": ibyte_to_complex,
    "cbyte": ibyte_to_complex,
    "ishort": ishort_to_complex,
    "cshort": cshort_to_complex,
    "byte": byte_to_complex,
    "short": short_to_complex,
    "passthrough": lambda x: x.to(torch.complex64),
}
