"""Signal conditioner role: data-type adapters and the pass-through chain.

The FIR, frequency-translating FIR, notch and pulse-blanking filters, the
resamplers and the beamformer are not ported yet (ROADMAP queue item 13);
``SignalConditioner`` raises ``NotImplementedError`` when one is
configured."""

from gnss_sdr_tpu_torch.conditioner.adapters import ADAPTERS
from gnss_sdr_tpu_torch.conditioner.conditioner import (
    ConditionerConfig,
    PassThrough,
    SignalConditioner,
)

__all__ = ["ADAPTERS", "ConditionerConfig", "PassThrough",
           "SignalConditioner"]
