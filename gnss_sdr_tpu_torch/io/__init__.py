# Copied from gnss_sdr_tpu/io/__init__.py; only the package imports are rewritten.
"""Signal sources and sample-format ingest (reference signal_source role)."""

from gnss_sdr_tpu_torch.io.formats import (
    bytes_per_sample,
    decode_samples,
    encode_samples,
    item_format_names,
)
from gnss_sdr_tpu_torch.io.sources import (
    ArraySignalSource,
    FifoSignalSource,
    FileMeta,
    FileSignalSource,
    GeneratorSignalSource,
    MultichannelFileSignalSource,
    SignalSource,
    TimestampedFileSignalSource,
    TimeTag,
    UdpSignalSource,
    Valve,
)
from gnss_sdr_tpu_torch.io.labsat import LabsatSignalSource, encode_labsat_file
from gnss_sdr_tpu_torch.io.net_sources import RtlTcpSignalSource, ZmqSignalSource
from gnss_sdr_tpu_torch.io.ion_gsms import IonGsmsSignalSource

__all__ = [
    "ArraySignalSource",
    "FifoSignalSource",
    "FileMeta",
    "FileSignalSource",
    "GeneratorSignalSource",
    "IonGsmsSignalSource",
    "LabsatSignalSource",
    "MultichannelFileSignalSource",
    "RtlTcpSignalSource",
    "SignalSource",
    "TimeTag",
    "TimestampedFileSignalSource",
    "UdpSignalSource",
    "Valve",
    "ZmqSignalSource",
    "bytes_per_sample",
    "decode_samples",
    "encode_labsat_file",
    "encode_samples",
    "item_format_names",
]
